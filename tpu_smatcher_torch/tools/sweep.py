"""Benchmark sweep of the port (the counterpart of scripts/sweep.py, the
execute.sh analogue of the reference, execute.sh:9-56).

Loops engines x p_size {1000, 8000} x the reference's six corpus shapes
(random sigma=2, E.coli sigma=4, A_thaliana.fna sigma=4, swiss-prot
sigma=20, A_thaliana.faa sigma=20, world192 sigma=128 — sizes from
main.c:38-118), generated synthetically at the same (n, sigma) from the
reference sweep's seeds (text 1, patterns 2, frac_present=0.5, m=8);
nothing is downloaded.

Checks, each failing the run (exit 1): the engines' counts agree at full
size; each engine's count on the first 1 MiB equals datagen's; every
repeat's summed count equals q x the single count (no int32 wrap).  One
JSON line per (corpus, p_size, engine) goes to --out.

Rates: bytes_per_s is the synchronous count's (host clock, best of
--reps).  device_bytes_per_s is the reference's differencing, (t(q) -
t(1)) / (q - 1), over count_repeat_async(text, q) — q scans enqueued back
to back from the host, timed by CUDA events ("method": "cuda_events"; on
the CPU by the host clock, "host_clock") — with q sized so that q scans
fill about --window seconds, and capped so that q x count < 2^31 (the
repeat's count is int32).  A fast path that overflows on a match-dense
cell cannot be timed that way: its line keeps the synchronous rate, as in
the reference.

  python -m tpu_smatcher_torch.tools.sweep               # corpora at 1/16
  python -m tpu_smatcher_torch.tools.sweep --full        # reference sizes
  python -m tpu_smatcher_torch.tools.sweep --engines fast ac --out s.jsonl
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

#: (name, n, sigma) — main.c:38-118 / execute.sh:16-51
CORPORA = [
    ("random2", 3_999_744, 2),
    ("ecoli", 4_628_736, 4),
    ("athaliana_fna", 116_234_496, 4),
    ("swissprot", 177_649_920, 20),
    ("athaliana_faa", 10_821_888, 20),
    ("world192", 1_903_104, 128),
]

P_SIZES = [1000, 8000]           # execute.sh:9
DEFAULT_ENGINES = ["fast", "ac", "wm", "sh", "sbom", "sog8"]
#: the datagen gate's prefix
GATE_N = 1 << 20
#: the device window q scans should fill, seconds (the reference's)
WINDOW_S = 0.35
Q_MAX = 8192
INT32_MAX = (1 << 31) - 1


def card_info() -> str | None:
    """nvidia-smi's name and power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def route_of(eng, n: int) -> str:
    """The path a count of n bytes takes: FastScanner's tier and route, or
    an engine fast path's stage chain ('portable' without one)."""
    from tpu_smatcher_torch.ops.common import active_fastpath
    from tpu_smatcher_torch.ops.fast import FastScanner, stages_for
    if isinstance(eng, FastScanner):
        if eng.ft.exact:
            return "exact"
        return eng._pick_path(n, stages_for(eng.ft, n, eng.cap))[0]
    fp = active_fastpath(eng)
    if fp is None:
        return "portable"
    chain, _, _ = fp._stages(n)
    return "+".join(kind for kind, _ in chain)


def timed_result(fn, cuda: bool):
    """(seconds, fn().result()): CUDA events around the enqueue on the
    card (the future is read after the end event), the host clock on the
    CPU."""
    if not cuda:
        t0 = time.perf_counter()
        r = fn().result()
        return time.perf_counter() - t0, r
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fut = fn()
    b.record()
    r = fut.result()
    b.synchronize()
    return a.elapsed_time(b) / 1e3, r


def device_rate(rep, tdev, count: int, *, cuda: bool, window: float,
                reps: int):
    """(seconds per scan, spread, q) by the reference's differencing over
    rep(tdev, q), or None when the repeat overflows.  q x count stays below
    2^31; a repeat whose sum is not q x count raises AssertionError."""

    def run(q):
        dt, got = timed_result(lambda: rep(tdev, q), cuda)
        assert got == q * count, \
            f"repeat of {q} summed {got}, not {q} x {count}"
        return dt

    q_cap = max(2, INT32_MAX // max(count, 1))
    try:
        run(1)                                   # warm-up
        d_est = max(min(run(1), run(1)), 1e-6)   # min: one spike must
        # not shrink q; power-of-two q as the reference's
        q = max(4, min(Q_MAX, 1 << round(window / d_est).bit_length()))
        q = min(q, q_cap)

        def measure(q):
            dts = sorted((run(q) - run(1)) / (q - 1) for _ in range(reps))
            med = dts[len(dts) // 2]
            sp = round((dts[-1] - dts[0]) / med, 4) if med > 0 else None
            return med, sp

        dev, spread = measure(q)
        if (dev <= 0 or spread is None or spread > 0.5) and \
                min(Q_MAX, q * 8, q_cap) > q:
            # sub-ms scans with a mis-sized q: escalate once
            q = min(Q_MAX, q * 8, q_cap)
            dev, spread = measure(q)
    except OverflowError:
        return None
    return dev, spread, q


def sweep(corpora=CORPORA, p_sizes=P_SIZES, engines=DEFAULT_ENGINES, *,
          m: int = 8, device: str = "cuda", scale: int = 1, reps: int = 3,
          window: float = WINDOW_S, out: str | None = None,
          log=print) -> dict:
    """Run the sweep over corpora of (name, n, sigma); returns {"records":
    [...], "failures": [lines], "seconds"}.  Each corpus has n // scale
    bytes."""
    import torch
    from tpu_smatcher_torch import make_engine, make_fast
    from tpu_smatcher_torch.core import datagen
    from tpu_smatcher_torch.core.alphabet import Alphabet
    from tpu_smatcher_torch.engines import _device
    from tpu_smatcher_torch.ops.common import active_fastpath

    dev = _device(device)
    card = card_info() if dev.type == "cuda" else None
    method = "cuda_events" if dev.type == "cuda" else "host_clock"
    records, failures = [], []
    t_start = time.perf_counter()

    def emit(rec):
        records.append(rec)
        if out:
            with open(out, "a") as fh:
                fh.write(json.dumps(rec) + "\n")

    def fail(msg, **rec):
        failures.append(msg)
        log(f"  FAIL {msg}")
        emit(rec)

    for name, n_full, sigma in corpora:
        n = n_full // scale
        ab = Alphabet.of_size(sigma)
        text = datagen.generate_text(n, ab, seed=1)
        tdev = torch.from_numpy(text).to(dev)
        gate_n = min(n, GATE_N)
        for p_size in p_sizes:
            pats = datagen.generate_patterns(text, p_size, m, ab,
                                             frac_present=0.5, seed=2)
            gate = datagen.count_matches(text[:gate_n], pats)
            counts = {}
            for eng_name in engines:
                base = {"corpus": name, "n": n, "sigma": sigma,
                        "p_size": p_size, "engine": eng_name}
                try:
                    eng = (make_fast(pats, device=dev) if eng_name == "fast"
                           else make_engine(eng_name, pats, device=dev))
                    t0 = time.perf_counter()
                    c = eng.count(tdev)
                    t_first = time.perf_counter() - t0
                    times = []
                    for _ in range(reps):
                        t0 = time.perf_counter()
                        c = eng.count(tdev)
                        times.append(time.perf_counter() - t0)
                    best = min(times)
                    got_gate = eng.count(tdev[:gate_n])
                    counts[eng_name] = c
                    if got_gate != gate:
                        fail(f"{name} p={p_size} {eng_name}: {got_gate} on "
                             f"the first {gate_n} bytes, datagen {gate}",
                             **base, gate_mismatch=[got_gate, gate])
                        continue
                    rep = getattr(eng, "count_repeat_async", None)
                    if rep is None:
                        fp = active_fastpath(eng)
                        rep = None if fp is None else fp.count_repeat_async
                    rate = None if rep is None else device_rate(
                        rep, tdev, c, cuda=dev.type == "cuda",
                        window=window, reps=reps)
                    if rate is None or rate[0] <= 0:
                        best_dev, spread, q = best, None, 0
                    else:
                        best_dev, spread, q = rate
                    rec = {**base, "m": m, "matches": int(c),
                           "scan_s": round(best, 5),
                           "first_scan_s": round(t_first, 4),
                           "bytes_per_s": round(n / best, 1),
                           "device_scan_s": round(best_dev, 6),
                           "device_bytes_per_s": round(n / best_dev, 1),
                           "queue": q, "spread": spread, "method": method,
                           "backend": dev.type, "card": card,
                           "route": route_of(eng, n), "gate_n": gate_n,
                           "gate": int(gate),
                           "overflow": rep is not None and rate is None}
                    emit(rec)
                    log(f"  {name} p={p_size} {eng_name:5s} {c} matches  "
                        f"{n / best / 1e9:.3f} GB/s (device "
                        f"{n / best_dev / 1e9:.3f}, q={q}, spread {spread}, "
                        f"{rec['route']})")
                except Exception as e:     # recorded; fails the run
                    fail(f"{name} p={p_size} {eng_name}: "
                         f"{type(e).__name__} {e}", **base, error=repr(e))
            if len(set(counts.values())) > 1:
                fail(f"MISMATCH at {name} p={p_size}: {counts}",
                     corpus=name, p_size=p_size, mismatch=counts)
        del tdev
    secs = time.perf_counter() - t_start
    log(table(records))
    log(f"SWEEP {'FAILED' if failures else 'PASSED'} {len(failures)} "
        f"({len([r for r in records if 'matches' in r])} lines, "
        f"{secs:.1f} s, {card or dev.type})")
    return {"records": records, "failures": failures, "seconds": secs}


def table(records) -> str:
    """Device GB/s per (corpus, p_size) row and engine column."""
    rows = [r for r in records if "device_bytes_per_s" in r]
    engines = list(dict.fromkeys(r["engine"] for r in rows))
    lines = ["device GB/s  " + " ".join(f"{e:>8s}" for e in engines)]
    cells = {(r["corpus"], r["p_size"], r["engine"]): r for r in rows}
    for key in dict.fromkeys((r["corpus"], r["p_size"]) for r in rows):
        vals = []
        for e in engines:
            r = cells.get((*key, e))
            vals.append("       -" if r is None else
                        f"{r['device_bytes_per_s'] / 1e9:8.2f}"
                        + ("*" if r["overflow"] else ""))
        lines.append(f"{key[0]:>13s} p={key[1]:<5d} " + " ".join(vals))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engines", nargs="+", default=DEFAULT_ENGINES)
    ap.add_argument("--p-sizes", nargs="+", type=int, default=P_SIZES)
    ap.add_argument("--m", type=int, default=8)       # execute.sh:16
    ap.add_argument("--full", action="store_true",
                    help="reference corpus sizes (default: scaled to 1/16)")
    ap.add_argument("--corpora", nargs="+", default=None,
                    help="subset of corpus names (default: all six)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--window", type=float, default=WINDOW_S,
                    help="seconds q repeated scans should fill")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="sweep.jsonl")
    args = ap.parse_args(argv)
    corpora = CORPORA
    if args.corpora:
        unknown = set(args.corpora) - {c[0] for c in CORPORA}
        if unknown:
            ap.error(f"unknown corpora: {sorted(unknown)}")
        corpora = [c for c in CORPORA if c[0] in args.corpora]
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("sweep: CUDA is not available (pass --device cpu)",
                  file=sys.stderr)
            return 1
    scale = 1 if args.full else 16
    print(f"sweep: device={args.device} scale=1/{scale} -> {args.out}",
          file=sys.stderr)
    res = sweep(corpora, args.p_sizes, args.engines, m=args.m,
                device=args.device, scale=scale, reps=args.reps, window=args.window, out=args.out,
                log=lambda s: print(s, file=sys.stderr, flush=True))
    return 1 if res["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
