"""Time this checkout's cascade kernel against other checkouts' on one card,
in one process, interleaved, on bench.py's m=32 p=10k tier (256 MiB DNA,
text seed 7, pattern seed 40, the route's own (k1, kt)).

    python3 -m tpu_smatcher_torch.ab_cascade OTHER_CHECKOUT [...] [--reps N]

Each checkout's csrc/cascade.cu is built with this checkout's nvcc flags
into this checkout's build/ directory and bound by its C interface
(tsm_cascade), which every build must share.  Every build's output must
equal this one's.  Each rep launches every build once, in an order that
rotates from rep to rep, timed by CUDA events; the script prints each
build's median ms and its ratio to this checkout's.  Two builds in one
process see the same clocks and the same inputs, which two runs of
chip_smoke.py do not."""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import statistics
import subprocess
import sys


def _csrc(checkout: str) -> str:
    return os.path.join(os.path.abspath(checkout), "tpu_smatcher_torch", "csrc")


def build(checkout: str, label: str):
    """The tsm_cascade function of checkout's csrc/cascade.cu, bound."""
    from tpu_smatcher_torch import _build
    src = os.path.join(_csrc(checkout), "cascade.cu")
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for name in sorted(os.listdir(_csrc(checkout))):
        if name == "cascade.cu" or name.endswith(".cuh"):
            with open(os.path.join(_csrc(checkout), name), "rb") as f:
                h.update(f.read())
    out = os.path.join(_build.BUILD_DIR,
                       f"ab_cascade_{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", out,
                        src], check=True)
    fn = ctypes.CDLL(out).tsm_cascade
    fn.argtypes = _build.SOURCES["cascade.cu"]["tsm_cascade"]
    fn.restype = ctypes.c_int
    print(f"{label}: {src} -> {out}", flush=True)
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="+", help="checkout roots to time")
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("ab_cascade: CUDA is not available", file=sys.stderr)
        return 1
    from tpu_smatcher_torch.core import datagen
    from tpu_smatcher_torch.core.alphabet import Alphabet
    from tpu_smatcher_torch.ops import cuda_filter as cf
    from tpu_smatcher_torch.ops.common import cdiv
    from tpu_smatcher_torch.ops.fast import FastScanner, build_fast, stages_for

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    builds = [("this", build(here, "this"))]
    builds += [(o, build(o, o)) for o in args.others]

    n, m = 1 << 28, 32
    ab = Alphabet.dna()
    text = datagen.generate_text(n, ab, seed=7)
    pats = datagen.generate_patterns(text, 10_000, m, ab, frac_present=0.5,
                                     seed=8 + m)
    ft = build_fast(pats.codes, 4, device="cuda")
    eng = FastScanner(ft)
    route, k1, kt = eng._pick_path(n, stages_for(ft, n, eng.cap))
    assert route == "cascade", route
    t = torch.from_numpy(text).cuda()
    bitmaps = ft.bitmaps[:kt]
    rows = cdiv(n - m + 1, cf.ROW)
    cd = cf._cd_host(ft.cd(kt), kt)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    dev = torch.cuda.current_device()

    def launch(fn):
        slots = torch.empty((rows, cf.ROW_SLOTS), dtype=torch.int32,
                            device="cuda")
        ovf = torch.zeros((), dtype=torch.int32, device="cuda")
        rc = fn(t.data_ptr(), n, m, bitmaps.data_ptr(), kt,
                int(bitmaps.shape[1]) * 32, k1, cd, slots.data_ptr(), rows,
                ovf.data_ptr(), dev, stream)
        assert rc == 0, f"launch failed: cudaError {rc}"
        return slots, ovf

    want = launch(builds[0][1])
    for label, fn in builds[1:]:
        got = launch(fn)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), \
            f"{label}: output differs from this checkout's"
    times = {label: [] for label, _ in builds}
    for rep in range(args.reps + 1):
        order = builds[rep % len(builds):] + builds[:rep % len(builds)]
        for label, fn in order:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            launch(fn)
            b.record()
            torch.cuda.synchronize()
            if rep:                                    # rep 0 warms up
                times[label].append(a.elapsed_time(b))
    base = statistics.median(times["this"])
    print(f"cascade m={m} p=10k n=2^28 k1={k1} kt={kt}, median of "
          f"{args.reps} interleaved reps:")
    for label, ts in times.items():
        med = statistics.median(ts)
        print(f"  {label}: {med:.3f} ms (min {min(ts):.3f}, max "
              f"{max(ts):.3f}), {med / base:.3f}x this")
    return 0


if __name__ == "__main__":
    sys.exit(main())
