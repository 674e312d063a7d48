"""Time this checkout's main-path filter kernels against other checkouts'
on one card, in one process, interleaved, on bench.py's five tiers (256 MiB
DNA, text seed 7, pattern seed 8 at m=8 and 8+m otherwise): the unguarded
exact count (tsm_exact_count) at m=8 p=10k, and the cascade (tsm_cascade)
at m=16 p=10k, m=32 p=10k, m=32 p=30k and m=32 p=100k with each route's
own (k1, kt).

    python3 -m tpu_smatcher_torch.ab_cascade OTHER_CHECKOUT [...] [--reps N]

Each checkout's csrc/exact_count.cu and csrc/cascade.cu are built with this
checkout's nvcc flags into this checkout's build/ directory and bound by
their C interfaces, which every build must share (this checkout's
argtypes).  Every build's output must equal this one's.  Each rep launches
every build once, in an order that rotates from rep to rep, timed by CUDA
events; the script prints the card, and per tier each build's median ms
and its ratio to this checkout's.  Two builds in one process see the same
clocks and the same inputs, which two runs of chip_smoke.py do not."""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import statistics
import subprocess
import sys

#: kernel name -> (source, C function)
KERNELS = {"exact_count": ("exact_count.cu", "tsm_exact_count"),
           "cascade": ("cascade.cu", "tsm_cascade")}
#: bench.py's tiers: (name, m, p)
TIERS = (("exact", 8, 10_000), ("fp16", 16, 10_000), ("fp", 32, 10_000),
         ("fp32_p30k", 32, 30_000), ("fp32_p100k", 32, 100_000))


def _csrc(checkout: str) -> str:
    return os.path.join(os.path.abspath(checkout), "tpu_smatcher_torch", "csrc")


def build(checkout: str, label: str, kernel: str):
    """The C function of `kernel` in checkout's csrc, bound."""
    from tpu_smatcher_torch import _build
    source, fname = KERNELS[kernel]
    src = os.path.join(_csrc(checkout), source)
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for name in sorted(os.listdir(_csrc(checkout))):
        if name == source or name.endswith(".cuh"):
            with open(os.path.join(_csrc(checkout), name), "rb") as f:
                h.update(f.read())
    stem = os.path.splitext(source)[0]
    out = os.path.join(_build.BUILD_DIR, f"ab_{stem}_{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", out,
                        src], check=True)
    fn = getattr(ctypes.CDLL(out), fname)
    fn.argtypes = _build.SOURCES[source][fname]
    fn.restype = ctypes.c_int
    print(f"{label}: {src} -> {out}", flush=True)
    return fn


def launcher(text, eng):
    """(kernel name, label, launch(fn) -> outputs) of one tier's main-path
    filter kernel on text."""
    import torch
    from tpu_smatcher_torch.ops import cuda_filter as cf
    from tpu_smatcher_torch.ops.common import bits_per_char, cdiv
    from tpu_smatcher_torch.ops.fast import stages_for
    ft = eng.ft
    n, m = int(text.shape[0]), ft.m
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    dev = torch.cuda.current_device()
    if ft.exact:
        bm = ft.bitmaps[0]

        def launch(fn):
            out = torch.zeros((), dtype=torch.int32, device="cuda")
            rc = fn(text.data_ptr(), n, m, bits_per_char(ft.sigma), ft.sigma,
                    0, bm.data_ptr(), int(bm.shape[0]), out.data_ptr(), dev,
                    stream)
            assert rc == 0, f"launch failed: cudaError {rc}"
            return (out,)
        return "exact_count", f"m={m}", launch
    route, k1, kt = eng._pick_path(n, stages_for(ft, n, eng.cap))
    assert route == "cascade", route
    bitmaps = ft.bitmaps[:kt]
    rows = cdiv(n - m + 1, cf.ROW)
    cd = cf._cd_host(ft.cd(kt), kt)

    def launch(fn):
        slots = torch.empty((rows, cf.ROW_SLOTS), dtype=torch.int32,
                            device="cuda")
        ovf = torch.zeros((), dtype=torch.int32, device="cuda")
        rc = fn(text.data_ptr(), n, m, bitmaps.data_ptr(), kt,
                int(bitmaps.shape[1]) * 32, k1, cd, slots.data_ptr(), rows,
                ovf.data_ptr(), dev, stream)
        assert rc == 0, f"launch failed: cudaError {rc}"
        return slots, ovf
    return "cascade", f"m={m} k1={k1} kt={kt}", launch


def time_builds(builds, launch, reps):
    """{label: [ms per rep]}: every build once per rep, in an order that
    rotates from rep to rep, after one warm-up rep."""
    import torch
    times = {label: [] for label, _ in builds}
    for rep in range(reps + 1):
        order = builds[rep % len(builds):] + builds[:rep % len(builds)]
        for label, fn in order:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            launch(fn)
            b.record()
            torch.cuda.synchronize()
            if rep:
                times[label].append(a.elapsed_time(b))
    return times


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
    from tpu_smatcher_torch.ops.fast import FastScanner, build_fast

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    roots = [("this", here)] + [(o, o) for o in args.others]
    builds = {k: [(label, build(root, label, k)) for label, root in roots]
              for k in KERNELS}

    n = 1 << 28
    ab = Alphabet.dna()
    text = datagen.generate_text(n, ab, seed=7)
    t = torch.from_numpy(text).cuda()
    for name, m, p in TIERS:
        pats = datagen.generate_patterns(text, p, m, ab, frac_present=0.5,
                                         seed=8 if m == 8 else 8 + m)
        eng = FastScanner(build_fast(pats.codes, 4, device="cuda"))
        kernel, shape, launch = launcher(t, eng)
        kb = builds[kernel]
        want = launch(kb[0][1])
        for label, fn in kb[1:]:
            got = launch(fn)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                f"{name} {label}: output differs from this checkout's"
        times = time_builds(kb, launch, args.reps)
        base = statistics.median(times["this"])
        print(f"tier {name} (p={p}): {kernel} {shape} n=2^28, median of "
              f"{args.reps} interleaved reps:")
        for label, ts in times.items():
            med = statistics.median(ts)
            print(f"  {label}: {med:.3f} ms (min {min(ts):.3f}, max "
                  f"{max(ts):.3f}), {med / base:.3f}x this", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
