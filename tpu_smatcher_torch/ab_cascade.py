"""Time this checkout's main-path kernels against other checkouts' on one
card, in one process, interleaved, on bench.py's 256 MiB DNA corpus
(text seed 7; pattern seed 8 at m=8 and 8+m otherwise):

  exact_count   the unguarded exact count (tsm_exact_count), m=8 p=10k
  exact_mask    the exact tier's mask (tsm_exact_mask), m=8 p=10k, over
                the whole text and over 8 consecutive pieces of positions'
                size after its first overflow (FastScanner._drive), each a
                view at an odd address
  exact_count_guard  the guarded exact count (tsm_exact_count, guard=1),
                m=8 p=10k, on the text + m-1 pad bytes as core() calls it;
                and the exact kernels also at sigma 8 (m=5) and sigma 20
                (m=2 and m=3), each on a 256 MiB text over that alphabet
                (text seed 7, p=10k with pattern seed 8)
  cascade       the cascade (tsm_cascade) at m=16 p=10k, m=32 p=10k, m=32
                p=30k and m=32 p=100k, each with its route's (k1, kt); with
                --widths, each tier's tables at every stage width from
                16,384 to 262,144 bits instead, each with the (k1, kt) the
                router gives that width, phase 1's shared-memory bytes and
                the candidates the cascade leaves (compacted)
  filter_slots  filter.cu's slots mode (tsm_filter_slots) on slot32: m=32
                p=1000 at 4,096-bit stages, the slot route's 7 stages
  filter_mask   filter.cu's mask mode (tsm_filter_mask) on dense32's dense
                pass (the slot32 set, pattern 0 planted every 256 bytes over
                [1 MiB, 3 MiB), its k stages), on saturated (the 4 MiB
                prefix, p=10k at 4096-bit stages, its k stages) and on the
                fp m=32 p=10k positions / matches piece (the whole text, its
                k stages)
  stages        the engines' stage chain (tsm_stages) on each engine's own
                main-path calls: ac m=8 (the exact wid, count mode, the
                flat call), wm m=8 and sog8 (wm / sog + the exact wid,
                count), and ac, wm and sog32 at m=32 (stage 0 + the fpset
                stages: count_async's slots mode and count()'s mask mode),
                on bench.py's p=10k sets
  verify        the cascade route's verify (tsm_verify_live) on the
                compacted candidates of the fp tier (m=32 p=10k), made by
                the plain cascade and compaction; a checkout without
                csrc/verify.cu is left out of this kernel's comparison

    python3 -m tpu_smatcher_torch.ab_cascade OTHER_CHECKOUT [...] [--reps N]
        [--kernels NAME ...]
    python3 -m tpu_smatcher_torch.ab_cascade checkout/parent --kernels stages
    python3 -m tpu_smatcher_torch.ab_cascade checkout/parent
        --kernels exact_count exact_count_guard exact_mask
    python3 -m tpu_smatcher_torch.ab_cascade --widths [OTHER_CHECKOUT ...]

Each checkout's csrc source of a kernel is built with this checkout's nvcc
flags and that checkout's headers into this checkout's build/ directory and
bound by its C interface, which every build must share (this checkout's
argtypes).  Every build's output must equal this one's.  Each rep launches
every build once, in an order that rotates from rep to rep, timed by CUDA
events; the script prints the card, and per input each build's median ms
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
           "exact_count_guard": ("exact_count.cu", "tsm_exact_count"),
           "exact_mask": ("exact_count.cu", "tsm_exact_mask"),
           "cascade": ("cascade.cu", "tsm_cascade"),
           "filter_slots": ("filter.cu", "tsm_filter_slots"),
           "filter_mask": ("filter.cu", "tsm_filter_mask"),
           "stages": ("stages.cu", "tsm_stages"),
           "verify": ("verify.cu", "tsm_verify_live")}
#: bench.py's tiers: (name, m, p)
TIERS = (("exact", 8, 10_000), ("fp16", 16, 10_000), ("fp", 32, 10_000),
         ("fp32_p30k", 32, 30_000), ("fp32_p100k", 32, 100_000))
#: (sigma, m) of the exact kernels' other alphabets: the pair table's
#: widest gram at sigma 8, one within it and one past it at sigma 20
EXACT_ALPHABETS = ((8, 5), (20, 2), (20, 3))
#: the stage widths --widths times the cascade at
SWEEP_WIDTHS = (16384, 32768, 65536, 131072, 262144)
#: the filter kernels' inputs: (name, kernel)
CELLS = (("slot32", "filter_slots"), ("dense32", "filter_mask"),
         ("saturated", "filter_mask"), ("fp_matches", "filter_mask"))
#: the stage-chain cells: (engine, m), each on bench.py's p=10k set of its m
STAGE_CELLS = (("ac", 8), ("wm", 8), ("sog8", 8), ("ac", 32), ("wm", 32),
               ("sog32", 32))
MiB = 1 << 20


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
    from tpu_smatcher_torch.ops.common import bits_per_char
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
    return "cascade", f"m={m} k1={k1} kt={kt}", cascade_launch(text, ft, k1,
                                                                 kt)


def cascade_launch(text, ft, k1, kt):
    """launch(fn) -> (slots, ovf) of tsm_cascade on text with the first kt
    stages of ft, k1 of them in phase 1."""
    import torch
    from tpu_smatcher_torch.ops import cuda_filter as cf
    from tpu_smatcher_torch.ops.common import cdiv
    n, m = int(text.shape[0]), ft.m
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    dev = torch.cuda.current_device()
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
    return launch


def width_sweep(text, t, builds, reps):
    """The cascade on each fp tier's tables at every width of SWEEP_WIDTHS,
    with the (k1, kt) the router gives that width (a width with no
    cascade split is reported and skipped).  Prints the width the port's
    rule (h100_stage_bits) picks from the tier's stage-0 fills, then per
    width the times, phase 1's shared-memory bytes and the candidates the
    cascade leaves."""
    from tpu_smatcher_torch.core import datagen
    from tpu_smatcher_torch.core.alphabet import Alphabet
    from tpu_smatcher_torch.ops import cuda_filter as cf
    from tpu_smatcher_torch.ops.fast import (STAGE_WIDTHS, FastScanner,
                                             build_fast, h100_stage_bits,
                                             stages_for)
    n = int(t.shape[0])
    for name, m, p in TIERS:
        if m == 8:                        # the exact tier has no stages
            continue
        pats = datagen.generate_patterns(text, p, m, Alphabet.dna(),
                                         frac_present=0.5, seed=8 + m)
        engs = {sb: FastScanner(build_fast(pats.codes, 4, stage_bits=sb,
                                           device="cuda"))
                for sb in STAGE_WIDTHS}
        fill0 = {sb: e.ft.density for sb, e in engs.items()}
        print(f"tier {name} (m={m} p={p}): rule {h100_stage_bits(fill0)}, "
              f"stage-0 fills "
              + ", ".join(f"{sb}: {d:.4f}" for sb, d in fill0.items()),
              flush=True)
        for sb in SWEEP_WIDTHS:
            eng = engs[sb]
            cost = eng._route_costs(n, stages_for(eng.ft, n, eng.cap))
            if "cascade" not in cost:
                print(f"  {sb} bits: no cascade split (fill "
                      f"{fill0[sb]:.4f})", flush=True)
                continue
            _, k1, kt = cost["cascade"]
            launch = cascade_launch(t, eng.ft, k1, kt)
            _, o, n_cand = cf.compact_rows_plain(*launch(builds[0][1]),
                                                 cap=eng.cap)
            compare(builds, f"tier {name} (p={p}) at {sb} bits",
                    f"cascade m={m} k1={k1} kt={kt} phase-1 "
                    f"{k1 * sb // 8} B, candidates {int(n_cand)} (cap "
                    f"{eng.cap}, overflow {int(o)}), route "
                    f"{min(cost, key=lambda r: cost[r][0])}, n={n}", launch,
                    reps)


def verify_launcher(text, eng):
    """(label, launch(fn) -> outputs) of tsm_verify_live on the cascade
    route's compacted candidates of text, which the plain cascade and
    compaction make (so this checkout's _build libraries stay out of the
    process)."""
    import torch
    from tpu_smatcher_torch.ops import cuda_filter as cf
    from tpu_smatcher_torch.ops.fast import stages_for
    ft = eng.ft
    n, m = int(text.shape[0]), ft.m
    route, k1, kt = eng._pick_path(n, stages_for(ft, n, eng.cap))
    assert route == "cascade", route
    slots, ovf = cf.cascade_plain(text, ft.bitmaps[:kt], m=m, k1=k1,
                                  cd=ft.cd(kt))
    idxs, _, n_cand = cf.compact_rows_plain(slots, ovf, cap=eng.cap)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    dev = torch.cuda.current_device()

    def launch(fn):
        count = torch.empty((), dtype=torch.int32, device="cuda")
        rc = fn(text.data_ptr(), n, m, idxs.data_ptr(), int(idxs.shape[0]),
                n_cand.data_ptr(), ft.bucket_ids.data_ptr(),
                ft.bucket_fp2.data_ptr(), ft.lmax, ft.eb, int(ft.slot_ok),
                ft.packed.data_ptr(), ft.words, count.data_ptr(), dev,
                stream)
        assert rc == 0, f"launch failed: cudaError {rc}"
        return (count,)
    return f"m={m} n_cand={int(n_cand)} cap={eng.cap}", launch


def exact_launchers(t, eng):
    """[(kernel, cell, label, launch(fn) -> outputs)] of the exact tier's
    guarded kernels as the main paths call them: exact_mask over the whole
    text and over 8 consecutive pieces of the size of positions' pieces
    after its first overflow (cap/2 matches at the text's density), views
    at odd addresses; the guarded count over the text + m-1 pad bytes (as
    core() calls it)."""
    import torch
    from tpu_smatcher_torch.ops import cuda_filter as cf
    from tpu_smatcher_torch.ops.common import bits_per_char, cdiv
    ft = eng.ft
    m, sigma, bm = ft.m, ft.sigma, ft.bitmaps[0]
    bits, nw = bits_per_char(sigma), int(bm.shape[0])
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    dev = torch.cuda.current_device()
    owned = int(t.shape[0]) - m + 1
    total = int(cf.exact_count_plain(t, bm, m=m, sigma=sigma))
    chunk = max(eng.cap // 2, min(-(-owned // 2),
                                  (eng.cap // 2) * owned // total))
    # the pieces begin one byte past positions' own (multiples of chunk,
    # even on the bench corpus), so that every one is at an odd address
    pieces = [t[s + 1:s + 1 + chunk + m - 1]
              for s in range(chunk, 9 * chunk, chunk)]
    ext = torch.cat([t, torch.full((m - 1,), sigma, dtype=torch.uint8,
                                   device="cuda")])

    def masks(views):
        def launch(fn):
            out = []
            for v in views:
                n = int(v.shape[0])
                rows = cdiv(n - m + 1, cf.ROW)
                mask = torch.empty((rows, cf.ROW), dtype=torch.int8,
                                   device="cuda")
                rc = fn(v.data_ptr(), n, m, bits, sigma, bm.data_ptr(), nw,
                        mask.data_ptr(), rows, dev, stream)
                assert rc == 0, f"launch failed: cudaError {rc}"
                out.append(mask)
            return tuple(out)
        return launch

    def guarded(fn):
        out = torch.zeros((), dtype=torch.int32, device="cuda")
        rc = fn(ext.data_ptr(), int(ext.shape[0]), m, bits, sigma, 1,
                bm.data_ptr(), nw, out.data_ptr(), dev, stream)
        assert rc == 0, f"launch failed: cudaError {rc}"
        return (out,)
    offsets = sorted({v.data_ptr() % 16 for v in pieces})
    return [("exact_mask", "text", f"m={m} n=2^28", masks([t])),
            ("exact_mask", "pieces", f"m={m} 8 pieces of {chunk} starts, "
             f"addresses {offsets} mod 16", masks(pieces)),
            ("exact_count_guard", "padded", f"m={m} n=2^28+{m - 1}",
             guarded)]


def filter_launcher(text, ft, k, kernel):
    """(label, launch(fn) -> outputs) of filter.cu's mask or slots mode on
    text with the first k stages of ft."""
    import torch
    from tpu_smatcher_torch.ops import cuda_filter as cf
    from tpu_smatcher_torch.ops.common import cdiv
    n, m = int(text.shape[0]), ft.m
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    dev = torch.cuda.current_device()
    bitmaps = ft.bitmaps[:k]
    stage_bits = int(bitmaps.shape[1]) * 32
    cd = cf._cd_host(ft.cd(k), k)
    label = f"n={n} m={m} k={k} stage_bits={stage_bits}"
    if kernel == "filter_mask":
        rows = cdiv(n - m + 1, cf.ROW)

        def launch(fn):
            mask = torch.empty((rows, cf.ROW), dtype=torch.int8,
                               device="cuda")
            rc = fn(text.data_ptr(), n, m, bitmaps.data_ptr(), k, stage_bits,
                    cd, mask.data_ptr(), rows, dev, stream)
            assert rc == 0, f"launch failed: cudaError {rc}"
            return (mask,)
        return label, launch
    n_sub = cdiv(n - m + 1, cf.SUB_BLOCK)

    def launch(fn):
        pos = torch.empty((n_sub, cf.BLOCK_SLOTS), dtype=torch.int32,
                          device="cuda")
        counts = torch.empty((n_sub,), dtype=torch.int32, device="cuda")
        rc = fn(text.data_ptr(), n, m, bitmaps.data_ptr(), k, stage_bits, cd,
                pos.data_ptr(), counts.data_ptr(), n_sub, dev, stream)
        assert rc == 0, f"launch failed: cudaError {rc}"
        return pos, counts
    return label, launch


def cell_input(cell, text, t):
    """(device text, tables, k) of a filter kernel's input: the stages the
    cell's own path gives the kernel."""
    import torch
    from tpu_smatcher_torch.core import datagen
    from tpu_smatcher_torch.core.alphabet import Alphabet
    from tpu_smatcher_torch.ops.fast import (FastScanner, build_fast,
                                             stages_for)
    ab = Alphabet.dna()
    p = 1000 if cell in ("slot32", "dense32") else 10_000
    pats = datagen.generate_patterns(text, p, 32, ab, frac_present=0.5,
                                     seed=40)
    if cell == "saturated":
        t = t[:4 * MiB]
    # slot32, dense32 and saturated at the slot route's 4,096-bit stages
    # (the default width gives slot32's set to the cascade); fp_matches at
    # the main path's
    ft = build_fast(pats.codes, 4, stage_bits=None if cell == "fp_matches"
                    else 4096, device="cuda")
    eng = FastScanner(ft)
    n = int(t.shape[0])
    k = stages_for(ft, n, eng.cap)
    if cell == "slot32":
        route, _, k = eng._pick_path(n, k)
        assert route == "slot", route
    elif cell == "dense32":
        idx = (torch.arange(MiB, 3 * MiB, 256, device="cuda")[:, None]
               + torch.arange(32, device="cuda"))
        t = t.clone()
        t[idx] = torch.from_numpy(pats.codes[0]).cuda()
    return t, ft, k


def stage_calls(text, t, name, m):
    """The stages() calls of engine `name`'s main paths on t: count_async
    (count mode at m=8, slots mode at m=32) and, at m=32, count() (mask
    mode), as (text, chain, tables, kwargs).  The paths run on the plain
    versions (the same outputs, so the same calls), which keeps this
    checkout's _build libraries out of the process: only the builds under
    comparison are loaded."""
    from tpu_smatcher_torch import make_engine
    from tpu_smatcher_torch.core import datagen
    from tpu_smatcher_torch.core.alphabet import Alphabet
    from tpu_smatcher_torch.ops import cuda_engines as ce
    from tpu_smatcher_torch.ops import cuda_filter as cf
    pats = datagen.generate_patterns(text, 10_000, m, Alphabet.dna(),
                                     frac_present=0.5,
                                     seed=8 if m == 8 else 8 + m)
    eng = make_engine(name, pats, device="cuda")
    calls, real = [], ce.stages

    def spy(text, chain, tables, **kw):
        calls.append((text, chain, tables, kw))
        kw = {k: v for k, v in kw.items() if k != "flat"}
        return ce.stages_plain(text, chain, tables, **kw)

    wrappers = [(cf, w) for w in ("exact_count", "exact_mask", "cascade",
                                  "filter_slots", "filter_mask",
                                  "words_view")]
    saved = [(mod, w, getattr(mod, w)) for mod, w in wrappers]
    for mod, w, _ in saved:
        setattr(mod, w, getattr(mod, f"{w}_plain"))
    ce.stages = spy
    try:
        eng.count_async(t).result()
        if m == 32:
            eng.count(t)
    finally:
        ce.stages = real
        for mod, w, fn in saved:
            setattr(mod, w, fn)
    return calls


def stages_launcher(text, chain, tables, kw):
    """(label, launch(fn) -> outputs) of tsm_stages on one recorded call."""
    import torch
    from tpu_smatcher_torch.ops import cuda_engines as ce
    n, m, mode = int(text.shape[0]), kw["m"], kw["mode"]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    dev = torch.cuda.current_device()
    desc, ptrs, cd = ce.chain_args(chain, tables)
    label = (f"{'+'.join(k for k, _ in chain)} {mode} n={n} m={m}"
             f"{' guard' if kw.get('guard') else ''}")

    def launch(fn):
        out0, out1, n_out = ce.stage_outputs(mode, n - m + 1, "cuda")
        rc = fn(text.data_ptr(), n, m, kw["sigma"], int(kw.get("guard", 0)),
                ce.MODES[mode], desc, ptrs, len(chain), cd, out0.data_ptr(),
                None if out1 is None else out1.data_ptr(), n_out, dev,
                stream)
        assert rc == 0, f"launch failed: cudaError {rc}"
        return (out0,) if out1 is None else (out0, out1)
    return label, launch


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


def compare(kb, name, what, launch, reps):
    """Every build's output against this checkout's, then their times."""
    import torch
    want = launch(kb[0][1])
    for label, fn in kb[1:]:
        got = launch(fn)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), \
            f"{name} {label}: output differs from this checkout's"
    times = time_builds(kb, launch, reps)
    base = statistics.median(times["this"])
    print(f"{name}: {what}, median of {reps} interleaved reps:")
    for label, ts in times.items():
        med = statistics.median(ts)
        print(f"  {label}: {med:.3f} ms (min {min(ts):.3f}, max "
              f"{max(ts):.3f}), {med / base:.3f}x this", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="*", help="checkout roots to time")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--kernels", nargs="+", choices=sorted(KERNELS),
                    default=sorted(KERNELS), help="kernels to time")
    ap.add_argument("--widths", action="store_true",
                    help="time the cascade alone, on each fp tier at every "
                    "stage width from 16,384 to 262,144 bits")
    args = ap.parse_args(argv)
    if args.widths:
        args.kernels = ["cascade"]
    elif not args.others:
        ap.error("name a checkout to time against, or pass --widths")

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
    builds = {k: [(label, build(root, label, k)) for label, root in roots
                  if os.path.exists(os.path.join(_csrc(root), KERNELS[k][0]))]
              for k in args.kernels}

    n = 1 << 28
    ab = Alphabet.dna()
    text = datagen.generate_text(n, ab, seed=7)
    t = torch.from_numpy(text).cuda()
    if args.widths:
        width_sweep(text, t, builds["cascade"], args.reps)
        return 0
    for name, m, p in TIERS:
        if not {"exact_count", "cascade"} & set(builds):
            break
        pats = datagen.generate_patterns(text, p, m, ab, frac_present=0.5,
                                         seed=8 if m == 8 else 8 + m)
        eng = FastScanner(build_fast(pats.codes, 4, device="cuda"))
        kernel, shape, launch = launcher(t, eng)
        if kernel in builds:
            compare(builds[kernel], f"tier {name} (p={p})",
                    f"{kernel} {shape} n=2^28", launch, args.reps)
    exact = {"exact_count", "exact_mask", "exact_count_guard"} & set(builds)
    if exact - {"exact_count"}:
        pats = datagen.generate_patterns(text, 10_000, 8, ab,
                                         frac_present=0.5, seed=8)
        eng = FastScanner(build_fast(pats.codes, 4, device="cuda"))
        for kernel, cell, shape, launch in exact_launchers(t, eng):
            if kernel in builds:
                compare(builds[kernel], f"exact {cell}", f"{kernel} {shape}",
                        launch, args.reps)
    for sigma, m in EXACT_ALPHABETS if exact else ():
        abs_ = Alphabet.of_size(sigma)
        txt = datagen.generate_text(n, abs_, seed=7)
        ts = torch.from_numpy(txt).cuda()
        pats = datagen.generate_patterns(txt, 10_000, m, abs_,
                                         frac_present=0.5, seed=8)
        eng = FastScanner(build_fast(pats.codes, sigma, device="cuda"))
        cells = [("exact_count", "text", launcher(ts, eng)[1:])]
        cells += [(k, c, (shape, launch))
                  for k, c, shape, launch in exact_launchers(ts, eng)]
        for kernel, cell, (shape, launch) in cells:
            if kernel in builds:
                compare(builds[kernel], f"exact sigma={sigma} {cell}",
                        f"{kernel} {shape}", launch, args.reps)
        del ts
    for cell, kernel in CELLS:
        if kernel not in builds:
            continue
        tc, ft, k = cell_input(cell, text, t)
        shape, launch = filter_launcher(tc, ft, k, kernel)
        compare(builds[kernel], f"cell {cell}", f"{kernel} {shape}", launch,
                args.reps)
    if "verify" in builds:
        pats = datagen.generate_patterns(text, 10_000, 32, ab,
                                         frac_present=0.5, seed=40)
        shape, launch = verify_launcher(
            t, FastScanner(build_fast(pats.codes, 4, device="cuda")))
        compare(builds["verify"], "tier fp (p=10k)", f"verify {shape}",
                launch, args.reps)
    for name, m in STAGE_CELLS if "stages" in builds else ():
        for call in stage_calls(text, t, name, m):
            shape, launch = stages_launcher(*call)
            compare(builds["stages"], f"engine {name} m={m}",
                    f"stages {shape}", launch, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
