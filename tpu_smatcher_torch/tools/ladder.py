"""Optimization-ladder ablation of the port (the counterpart of
scripts/ladder.py): each engine's implementation stack, rung by rung,
every rung count-parity-checked against datagen.count_matches (exit 1 on
the first failure).

  oracle            reference-semantics Python oracle (oracles.ORACLES),
                    on a small prefix — the correctness bottom rung
  numpy             vectorized numpy table scan (ops/numpy_ref), same prefix
  portable          the engine's portable torch scan (fastpath=False), in
                    place of the reference's jnp rung
  engine            the engine's stage-chain fast path (EngineFastPath:
                    stages / stages_flat), synchronous count
  engine-pipelined  the same, 5 count_async scans in flight
  fast-pipelined    the shared fast backend (make_fast), 5 in flight

The portable rung scans the whole text on the card (the prefix on the
CPU); engine, engine-pipelined and fast-pipelined run on the card only.
Times are the host clock around calls that end in a read of the count
(the best of --reps after a warm-up; oracle rungs run once).

    python -m tpu_smatcher_torch.tools.ladder [--n BYTES] [--m M] [--p P]
        [--sigma S] [--engines ac,wm,...] [--device cuda|cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

#: the parity prefix of the full-text rungs (the reference's)
PARITY_N = 1 << 22


def timed(fn, reps, warm=True):
    """(best seconds of fn() over reps, its last result)."""
    if warm:
        fn()
    best, out = None, None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best, out


def numpy_scan(name, tb):
    """The numpy_ref scan of engine `name` over its tables (build_tables)."""
    from tpu_smatcher_torch.ops import numpy_ref
    main, vt = tb["main"], tb.get("verify")
    if name == "ac":
        return lambda t: numpy_ref.scan_ac_flat_np(t, main)
    if name == "wm":
        return lambda t: numpy_ref.scan_wm_np(t, main, vt)
    if name.startswith("sog"):
        return lambda t: numpy_ref.scan_sog_np(t, main, vt)
    if name == "sh":
        return lambda t: numpy_ref.scan_sh_np(t, main)
    if name == "sbom":
        return lambda t: numpy_ref.scan_sbom_np(t, main, vt)
    raise ValueError(f"no numpy scan for {name!r}")


class ParityError(AssertionError):
    pass


def ladder(*, n=1 << 26, m=8, p=1000, sigma=4, oracle_n=1 << 17, reps=3,
           engines=("ac", "wm", "sog8", "sh", "sbom"), device="cuda",
           log=print) -> list[dict]:
    """The rungs' rows; raises ParityError on the first rung whose count
    differs from datagen's."""
    import torch
    from tpu_smatcher_torch import make_engine, make_fast
    from tpu_smatcher_torch.core import datagen
    from tpu_smatcher_torch.core.alphabet import Alphabet
    from tpu_smatcher_torch.engines import _device, build_tables
    from tpu_smatcher_torch.ops.common import active_fastpath
    from tpu_smatcher_torch.oracles import ORACLES

    dev = _device(device)
    on_card = dev.type == "cuda"
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(n, ab, seed=7)
    pats = datagen.generate_patterns(text, p, m, ab, frac_present=0.5,
                                     seed=8)
    small = text[:oracle_n]
    truth_small = datagen.count_matches(small, pats)
    ppre = text[:min(n, PARITY_N)]
    truth_pre = datagen.count_matches(ppre, pats)
    tdev = torch.from_numpy(text if on_card else small).to(dev)
    pdev = torch.from_numpy(ppre).to(dev)
    rows = []

    def emit(engine, rung, nbytes, secs, count, expect):
        row = {"engine": engine, "rung": rung, "bytes": nbytes,
               "seconds": round(secs, 5),
               "bytes_per_s": round(nbytes / secs, 1), "count": int(count),
               "parity": count == expect, "device": dev.type}
        rows.append(row)
        log(json.dumps(row))
        if count != expect:
            raise ParityError(f"PARITY FAILURE {engine}/{rung}: {count} != "
                              f"{expect}")

    for name in engines:
        orc = ORACLES[name]
        dt, c = timed(lambda: orc(small, pats.codes, pats.sigma), 1,
                      warm=False)
        emit(name, "oracle", len(small), dt, c, truth_small)

        scan = numpy_scan(name, build_tables(name, pats, device=dev))
        dt, c = timed(lambda: scan(small), reps)
        emit(name, "numpy", len(small), dt, c, truth_small)

        eng = make_engine(name, pats, device=dev, fastpath=False)
        dt, _ = timed(lambda: eng.count(tdev), reps)
        emit(name, "portable", int(tdev.shape[0]), dt, eng.count(pdev),
             truth_pre)

        if on_card:
            eng4 = make_engine(name, pats, device=dev)
            fp4 = active_fastpath(eng4)
            if fp4 is None:
                raise ParityError(f"{name}: no fast path at m={m}")
            dt, _ = timed(lambda: eng4.count(tdev), reps)
            emit(name, "engine", n, dt, eng4.count(pdev), truth_pre)

            def eng_pipelined():
                fs = [fp4.count_async(tdev) for _ in range(5)]
                return [f.result() for f in fs]
            dt, _ = timed(eng_pipelined, reps)
            emit(name, "engine-pipelined", n, dt / 5, eng4.count(pdev),
                 truth_pre)

    if on_card:
        fast = make_fast(pats, device=dev)

        def pipelined():
            fs = [fast.count_async(tdev) for _ in range(5)]
            return [f.result() for f in fs]
        dt, _ = timed(pipelined, reps)
        emit("fast", "fast-pipelined", n, dt / 5, fast.count(pdev),
             truth_pre)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 26)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--p", type=int, default=1000)
    ap.add_argument("--sigma", type=int, default=4)
    ap.add_argument("--oracle-n", type=int, default=1 << 17)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--engines", default="ac,wm,sog8,sh,sbom")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="ladder.jsonl")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("ladder: CUDA is not available (pass --device cpu)",
                  file=sys.stderr)
            return 1
    try:
        rows = ladder(n=args.n, m=args.m, p=args.p, sigma=args.sigma,
                      oracle_n=args.oracle_n, reps=args.reps,
                      engines=args.engines.split(","), device=args.device)
    except ParityError as e:
        print(e, file=sys.stderr)
        return 1
    if args.out:
        with open(args.out, "w") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
