"""Smoke run of the PyTorch/CUDA port (tpu_smatcher_torch) on one GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the torch, CUDA
   and nvcc versions; fails without CUDA;
2. builds the CUDA kernels from tpu_smatcher_torch/csrc with nvcc, and the
   native host library (tpu_smatcher_torch/native) with the host's C++
   compiler;
3. holds each kernel against its plain torch version on the card, exactly
   (integers: tolerance 0), over texts of up to 16 MiB, short and ragged
   texts, long patterns, narrow and wide stages and match-dense texts; the
   unguarded exact count and the cascade also on start counts around
   their runs and tiles, at m=1 (and 4097 for the cascade), sigma=256, a
   text at an odd address (exact count), and 131,072-bit stages with phase
   1 in shared memory and past it, rows overflowing (cascade); exact_mask
   and the exact count, guard on and off, on views at every address mod
   16, start counts around their run, mask row and tile, a positions
   piece of about 2^18 starts at an odd address and n = m, at sigma 2 to
   256 (sigma 20 with bytes in [20, 32)) over a random bitmap;
   filter_mask and filter_slots also on start counts around their run,
   mask row and tile at m = 1, 31 and 4097, sigma = 4 and 256, on views
   at every address mod 16, on 4096- to 2^18-bit stages (k = 1 and 32)
   in shared memory and past it, and on a launch above 48 KB of shared
   memory after a smaller one; the stage chain (stages, stages_flat) on
   every engine's chain at sigma 2 to 256, and on start counts around its
   run, mask row and tile, views at every address mod 16, dirty runs, m =
   3 to 4097 (sog at 34), 32 fp stages of 2^17 and 2^18 bits, chains
   outside the engines' and launches above 48 KB around a smaller one;
   verify_count_live at m = 5, 8, 13 and 32, eb 0 and above, with and
   without fp2's slot choice, on no candidate, a -1 tail, exactly cap and
   more than cap candidates, a match at the last window start, on views
   at 0 to 3 bytes in;
4. drives the main paths through make_fast / FastScanner, each with the
   launch counters set to 0 just before it and read just after:
   - bench.py's five tiers on its 256 MiB DNA corpus (seed 7): each count
     equals the 4 MiB ground-truth gate on the prefix, the JAX package's
     logged full-corpus count (BENCH_r05.json) and the plain versions'
     count, on the cascade route with no retry;
   - slot32: DNA m=32 p=1000 at 4096-bit stages, the slot route; the count
     equals the gate, the plain versions' count and the cascade route's
     count;
   - dense32: the slot32 text with pattern 0 planted every 256 bytes over
     2 MiB; the scanner adapts through the sync ladder within 6 retries,
     then counts on the dense mask pass without retrying, exact throughout;
   - saturated: 4 MiB, p=10k at 4096-bit stages (no cascade split): the
     mask route overflows and the budget-piece sync ladder counts exactly;
   - positions: the exact tier's positions (38,046,940 on the 256 MiB
     corpus, split into ~1,200 pieces), matches and count_per_pattern
     (the window-id histogram), each against the ground truth on the 4 MiB
     prefix and the plain exact_mask over the whole text; core() on the
     text padded with sigma (the guarded count); count_stack of the corpus
     cut into 8 rows; count_repeat_async; the fp tier's (m=32 p=10k)
     positions, matches and count_per_pattern against the ground truth;
     dense32's and saturated's positions (saturated's pieces split);
   - engines: the seven named engines (make_engine) on the bench sets;
   - mixed: the corpus written as FASTA (60-byte lines, two records) and
     the union of the m = 8, 16, 32 p=10k sets as a FASTA file of 30,000
     shuffled records, loaded back (load_fasta, MixedPatternSet.from_fasta)
     and checked byte for byte; make_mixed(...).count equal to the sum of
     the three BENCH_r05.json counts (38,057,563) and each group to its
     own, through count, count_file at two chunks, scan_many and the wm and
     ac families; mixed positions, matches and count_per_pattern on the 4
     MiB prefix against datagen; fast tables (m = 8, 32) and wm tables (m =
     32) through save_tables / load_tables on the card; scan();
   - distributed, world size 1 on NCCL in this process: make_distributed
     over the five tiers and the eleven engines, each count through the
     halo exchange and the all-reduce equal to its anchor and to the
     single-device count (count, count_async, scan_many); the ladder's
     step 1 (dense32's text) and step 2 (2 MiB of 'A' at cap 1024);
     DistributedPositions (fp m=32 over the corpus, the exact tier over
     the 4 MiB prefix); sigma = 256 on a 64 MiB byte text against the
     single-device counts;
   - distributed, world size 2 on gloo: two processes of this script
     (--rank R 2 DIR), both on cuda:0, read their halves of the corpus
     file and count the three anchors through make_distributed("fast"),
     one engine per stage kind, and pattern 0 of the m=8 set planted
     across the rank boundary at offsets -7 to 0;
   - the command line: --algo all --verify on the 4 MiB prefix and on the
     corpus, --stream --positions (m=32) on the corpus, and `python -m
     tpu_smatcher_torch.cli ... --devices 2`;
   - native: the port's host library (tpu_smatcher_torch/native) built
     with the host's C++ compiler; the five table builders at m=32 p=100k
     natively and with numpy, timed, the tables equal; the full-corpus
     host truth of the five tiers (count_cpu_native) against make_fast's
     counts and the BENCH_r05.json anchors, and against the numpy oracle
     on the 1 MiB prefix, timed; match_enum_native over the corpus against
     make_fast(m=32 p=10k).matches; load_fasta of the corpus as FASTA with
     the native encoder and with numpy, the same bytes;
   - conformance: the reference TPU smoke's cells the phases above lack
     (protein m=32 p=400 over 4 MiB through count, positions, the five
     engines, a checkpoint, count_file / positions_file, matches and
     scan_many; m=256 and m=1024; the full fingerprint collision, exact
     over 8 scans and then retrying no more; the sigma=20 p=4000
     match-dense set), each against datagen;
   - the tools (tpu_smatcher_torch/tools): the soak's 60 trials (12 on
     four gloo ranks sharing cuda:0), the sweep at the reference's full
     corpus sizes (12 shapes x 6 engines, equal across engines and to
     datagen on each 1 MiB prefix, q x count below 2^31) and the ladder
     at its defaults, every rung at parity;
5. times each path (median per-scan over 5 reps, CUDA events) on the
   kernels and on the plain versions (the mixed scan beside the sum of its
   groups' make_fast tiers; the world-1 distributed count beside
   make_fast's at each tier, and the world-2 ranks' own times), each
   kernel against its plain version
   and its bound, and words_view against one PyTorch call; the cascade
   route's epilogue (replacing no TPU kernel) on the fp tier's cascade
   output, 2^21 rows: the compaction (compact_rows) against
   compact_valrows, and the verify of its ~28k candidates
   (verify_count_live) against verify_count over the word view, each
   against its bytes bound, one call at a time on a cold L2.
   Each kernel is
   first held against its plain version, exactly, on the inputs the main
   paths gave it (the cascade at every bench tier's stages, filter_mask
   at dense32's 7 and saturated's 32 stages, exact_mask over the whole
   corpus and over one positions piece, the guarded count over the padded
   one), and the positions phase
   is profiled per path, as are the sweep's twelve shapes through
   make_fast (pipelined and single scans; the host's time per scan on the
   smallest shape).  The launches are also weighted by the size they
   ran at, and the filter launches at addresses that are not 16-byte
   aligned (views) counted; each timed stage chain prints the fraction of
   starts passing each set of its stages.  A bound charges the work the
   function needs (rolling fingerprints and window ids; a stage chain's
   stages in their cheapest order), not what the kernels do today.  Each profile line holds the port's kernel events
   against their launches.

Any failed check raises: the exit code is then non-zero and no result
line is printed.  The last line is {"ok": true, "device": {...}}.
"""

import contextlib
import functools
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

#: bench.py's tiers: (name, m, p, full-corpus count the JAX package logged)
TIERS = (("exact", 8, 10_000, 38_046_940),
         ("fp16", 16, 10_000, 5_623),
         ("fp", 32, 10_000, 5_000),
         ("fp32_p30k", 32, 30_000, 15_000),
         ("fp32_p100k", 32, 100_000, 49_993))
N_FULL = 1 << 28          # bench.py's 256 MiB corpus
N_GATE = 1 << 22          # bench.py's 4 MiB correctness gate
REPS = 5
MiB = 1 << 20
#: the slot32 / dense32 / saturated cells: m=32, bench.py's pattern seed
M_CELL = 32
PAT_SEED = 8 + M_CELL
#: the stage width of the slot32 / dense32 / saturated cells: the slot
#: route's (the default width gives slot32's set to the cascade, whose row
#: slots hold dense32's plants without an overflow)
SLOT_BITS = 4096
#: dense32's plants of pattern 0: every 256 bytes over [1 MiB, 3 MiB)
PLANTS = range(MiB, 3 * MiB, 256)
#: the engines' overflow cell: the windows of a random TANDEM_UNIT-byte
#: unit at its first TANDEM_PATS starts join the slot32 set, and the unit
#: repeats back to back over [TANDEM_AT, 2 * TANDEM_AT) of a TANDEM_N-byte
#: prefix: ~72 matches a 128-start row, more than the engine's chain and
#: the cascade keep a row, within the row-dense pass's 128 (a scan of at
#: most 2^17 starts)
TANDEM_UNIT, TANDEM_PATS, TANDEM_SEED = 71, 40, 71
TANDEM_N, TANDEM_AT = 1 << 17, 1 << 15
MAX_RETRIES = 6
#: the mixed phase: the lengths of bench.py's p=10k sets it unites, and the
#: seed of the shuffle of its FASTA pattern file
MIXED_M = (8, 16, 32)
MIXED_SEED = 9
#: the distributed phase: the world-2 ranks' engines, one per stage kind
#: (the exact chain, wm, sog, the wid + fpset chain), each on bench.py's
#: p=10k set of its m; the offsets from the rank boundary at which they
#: plant pattern 0 of the m=8 set; how long the ranks may take
W2_ENGINES = (("ac", 8), ("wm", 8), ("sog8", 8), ("ac", 32), ("wm", 32),
              ("sog32", 32))
W2_OFFSETS = range(-7, 1)
W2_TIMEOUT_S = 600
#: the tools' phases: the kernels each must launch (others may, as the
#: router decides), and the sweep's timing window, seconds (the tool's
#: default is 0.35)
CONFORMANCE_KERNELS = ("cascade", "compact_valrows", "verify",
                       "filter_mask", "filter_slots", "words_view", "stages",
                       "stages_flat")
SOAK_KERNELS = ("exact_count", "exact_mask", "filter_mask", "filter_slots",
                "words_view", "stages", "stages_flat")
SWEEP_KERNELS = ("exact_count", "words_view", "stages", "stages_flat")
LADDER_KERNELS = ("exact_count", "stages", "stages_flat")
SWEEP_WINDOW_S = 0.1
#: the sweep shapes' timings: scans per pipelined repeat
SWEEP_PIPELINE = 16
#: the sigma = 256 cases: a 64 MiB byte text, not a multiple of 8
S256_N = 64 * MiB - 3
#: the ladder's step-2 cell: 'A'*16 over an all-'A' text at cap 1024
ALL_MATCH_N, ALL_MATCH_CAP = 2 * MiB, 1024
#: filter.cu's run and tile (one 16,384-start sub-block)
FILTER_RUN, FILTER_TILE = 32, 16384

#: the ported kernels, by their launch counter's name (counters()): (the
#: wrapper's module, the wrapper, source, the TPU kernel it replaces, or
#: for compact_valrows and verify the XLA code that ran there)
_EXACT_CU = "tpu_smatcher_torch/csrc/exact_count.cu"
_STAGES_CU = "tpu_smatcher_torch/csrc/stages.cu"
_PF = "tpu_smatcher/ops/pallas_filter.py"
_PE = "tpu_smatcher/ops/pallas_engines.py"
_CF = "tpu_smatcher_torch.ops.cuda_filter"
_CE = "tpu_smatcher_torch.ops.cuda_engines"
KERNELS = {
    "exact_count": (_CF, "exact_count", _EXACT_CU, f"{_PF}:886"),
    "exact_count_guard": (_CF, "exact_count", _EXACT_CU, f"{_PF}:202"),
    "exact_mask": (_CF, "exact_mask", _EXACT_CU, f"{_PF}:220"),
    "cascade": (_CF, "cascade", "tpu_smatcher_torch/csrc/cascade.cu",
                f"{_PF}:758"),
    "filter_mask": (_CF, "filter_mask", "tpu_smatcher_torch/csrc/filter.cu",
                    f"{_PF}:1052"),
    "filter_slots": (_CF, "filter_slots",
                     "tpu_smatcher_torch/csrc/filter.cu", f"{_PF}:559"),
    "words_view": (_CF, "words_view", "tpu_smatcher_torch/csrc/words.cu",
                   f"{_PF}:1011"),
    "stages": (_CE, "stages", _STAGES_CU, f"{_PE}:115"),
    "stages_flat": (_CE, "stages", _STAGES_CU, f"{_PE}:213"),
    "compact_valrows": (_CF, "compact_rows",
                        "tpu_smatcher_torch/csrc/compact.cu",
                        "none: XLA code on the TPU, "
                        "tpu_smatcher/ops/fast.py:compact_valrows"),
    "verify": (_CF, "verify_count_live", "tpu_smatcher_torch/csrc/verify.cu",
               "none: XLA code on the TPU, "
               "tpu_smatcher/ops/fast.py:verify_chunked"),
}
WRAPPERS = sorted({(mod, w) for mod, w, _, _ in KERNELS.values()})
#: bytes written before each cold_ms call, to evict the 50 MB L2 (a count
#: compacts slots the cascade wrote ~1.5 ms before, L2 long since turned
#: over, and verifies against tables last read a count before), and cycles of device spin ahead of the write (~1 ms), so the host
#: has enqueued the write, the events and the call when the device gets there
L2_FLUSH_BYTES = 256 * MiB
COLD_SPIN_CYCLES = 2_000_000

#: the engines phase: (name, m) of the eleven engines, each on bench.py's
#: p=10k pattern set of its m
ENGINE_RUNS = (("ac", 8), ("sh", 8), ("sbom", 8), ("wm", 8), ("sog8", 8),
               ("sog16", 16), ("ac", 32), ("sh", 32), ("sbom", 32),
               ("wm", 32), ("sog32", 32))
#: one engine per stage kind, profiled and its stage kernel timed: the
#: exact tier (count mode) and the fingerprint tier (its async mode)
PROFILED = (("ac", 8), ("wm", 8), ("sog8", 8), ("ac", 32), ("sh", 32),
            ("wm", 32), ("sog32", 32))
#: the engine whose stage-kernel time goes into the kernels line
JSON_TIMED = {"stages_flat": ("ac", 8), "stages": ("wm", 8)}

#: peak rates of one H100 SXM at 700 W: HBM bytes/s, and int32 operations/s
#: (half the 67 TFLOP/s float32 rate: 64 int32 lanes per SM against 128
#: float32 ones; a multiply-add counts 2, as an FMA does)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
#: The bounds charge each function the operations it needs, not what the
#: kernels do.  The fingerprint multipliers are odd, so invertible mod
#: 2^16, and a fingerprint rolls from one start to the next in O(1):
#: fp(i) = fp(i+1) * M + t[i] - t[i+m] * M^m, two multiply-adds for each of
#: the three (the cascade, filter.cu and stages.cu roll them).
ROLLING_FP_OPS = 3 * 2 * 2
#: one stage test: key = f0 + C*f1 + D*f2 (2 multiply-adds), the mask, the
#: word index and the bit test
STAGE_TEST_OPS = 8
#: one exact-tier start: the rolling window id (shift, or, mask), the bit
#: test (word index, bit index, shift, and) and the sum
EXACT_START_OPS = 8
#: the pad guard per start: the distance to the last byte >= sigma rolls
#: in O(1) (a compare and a select as the byte enters, a compare of the
#: distance with m)
GUARD_START_OPS = 3
#: the engines' value and bitmap stages, per start: (the rolling update
#: that, where the stage rolls, every start needs; the test of a start that
#: reaches the stage)
#:   wid  the window id rolls (shift, or, mask); the bit test (word index,
#:        bit index, shift, and, and into the hit)
#:   wm   the 3-char hash rolls (multiply-add, mask); the table read and the
#:        compare with 0
#:   sog  the shift-or register E = (E << 1) | T[g] with the gram g rolling
#:        (multiply-add, mask, the table read, shift, or); the test of
#:        E's check bit (shift, and)
STAGE_OPS = {"wid": (3, 5), "wm": (3, 2), "sog": (6, 2)}


def start_key_ops(kind, params, m):
    """A stage's key for one start computed from its window's bytes, the
    alternative to its rolling update where few starts reach the stage:
    wid's d bytes (shift, or each), wm's hash (two multiply-adds), sog's
    m-2 grams (each its index by two multiply-adds, the table read, its bit
    by shift and and, the or into the start's hit), and three Horner
    fingerprints over the m bytes (a multiply-add per byte each)."""
    if kind == "wid":
        return 2 * params[1]
    if kind == "wm":
        return 4
    if kind == "sog":
        return 8 * (m - 2)
    return 6 * m


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=REPS):
    """Median ms of fn() over reps after one warm-up, by CUDA events;
    fn's result is read back (synchronised) inside each rep."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
        del out
    return statistics.median(times)


def cold_ms(fn, reps=REPS):
    """Median ms of one fn() call on a cold L2, by CUDA events around the
    call alone: each rep spins the device, writes L2_FLUSH_BYTES, then
    runs fn; fn's result is read back (synchronised) inside each rep."""
    import torch
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(COLD_SPIN_CYCLES)
        flush.fill_(1)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
        del out
    return statistics.median(times)


def device_info():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from tpu_smatcher_torch import _build
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc}")
    return smi


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper replaced by its plain torch version, so the
    main path's own code runs on the card without the kernels."""
    import importlib
    saved = [(importlib.import_module(mod), w) for mod, w in WRAPPERS]
    saved = [(mod, w, getattr(mod, w)) for mod, w in saved]
    try:
        for mod, w, _ in saved:
            setattr(mod, w, getattr(mod, f"{w}_plain"))
        yield
    finally:
        for mod, w, fn in saved:
            setattr(mod, w, fn)


def counters():
    """Every kernel's launch count: cuda_filter.LAUNCHES, and
    EPILOGUE_LAUNCHES for the kernels that replace no TPU kernel."""
    from tpu_smatcher_torch.ops import cuda_filter as cf
    return {**cf.LAUNCHES, **cf.EPILOGUE_LAUNCHES}


def reset_launches():
    from tpu_smatcher_torch.ops import cuda_filter as cf
    for launches in (cf.LAUNCHES, cf.EPILOGUE_LAUNCHES):
        for k in launches:
            launches[k] = 0


def launched(fn):
    """(fn(), the launches fn made, by kernel)."""
    before = counters()
    out = fn()
    return out, {k: v - before[k] for k, v in counters().items()}


def read_launches(path, kernels, total):
    """The counts of the path just driven; each of its kernels must have
    launched, and each cascade launch its compaction and its verify.  Adds
    them to total."""
    got = counters()
    log(f"  {path} launches: {got}")
    for k in kernels:
        assert got[k] > 0, f"{path}: {k} never launched"
    assert got["cascade"] == got["compact_valrows"] == got["verify"], \
        f"{path}: cascade launches without their epilogue kernels"
    for k, v in got.items():
        total[k] += v


@contextlib.contextmanager
def sized_launches():
    """Every kernel wrapper behind a spy that adds the length of the text
    of each launch it makes to the first yielded dict, under the LAUNCHES
    name the launch counted, so launches can be weighted by the size they
    ran at (compact_rows: the starts its slot rows cover), counts in the
    second the launches on a text whose address is not 16-byte aligned (a
    view at an offset), and adds in the third the length of each
    stage-chain launch's text under its chain_kind."""
    import collections
    import importlib
    from tpu_smatcher_torch.ops import cuda_engines as ce
    from tpu_smatcher_torch.ops import cuda_filter as cf
    scanned = {k: 0 for k in counters()}
    unaligned = {k: 0 for k in counters()}
    chains = collections.Counter()
    saved = [(importlib.import_module(mod), w) for mod, w in WRAPPERS]
    saved = [(mod, w, getattr(mod, w)) for mod, w in saved]

    def spy(real, stage_chain):
        def call(text, *args, **kw):
            before = counters()
            out = real(text, *args, **kw)
            size = int(text.shape[0]) * cf.ROW if text.dim() == 2 \
                else int(text.numel())
            for k, v in counters().items():
                scanned[k] += (v - before[k]) * size
                unaligned[k] += (v - before[k]) * (text.data_ptr() % 16 != 0)
            if stage_chain:
                chains[chain_kind(args[0], kw)] += int(text.numel())
            return out
        return call

    try:
        for mod, w, fn in saved:
            setattr(mod, w, spy(fn, fn is ce.stages))
        yield scanned, unaligned, chains
    finally:
        for mod, w, fn in saved:
            setattr(mod, w, fn)


def chain_kind(chain, kw):
    """A stage-chain launch's kind: its flat flag, stage kinds and mode."""
    return (f"{'stages_flat' if kw.get('flat') else 'stages'} "
            f"{'+'.join(k for k, _ in chain)} {kw['mode']}")


def size_weighted(total, scanned, per_kernel, chains, chain_times):
    """Each kernel's launches on the main paths weighted by the size they
    ran at: the MiB they scanned over 256 MiB, times the kernel's ms at 256
    MiB (linear in the size; a launch's fixed cost of a few microseconds
    is not in it); stages and stages_flat per chain kind, at the time and
    bound of that kind where one was timed.  Logs the kernels by that
    estimate and its excess over the bound, largest first."""
    est = {k: (scanned[k] / (256 * MiB) * per_kernel[k]["ms"],
               scanned[k] / (256 * MiB) * per_kernel[k]["bound_ms"])
           for k in total}
    for name in ("stages", "stages_flat"):
        parts = [(kind, n, chain_times.get(kind, (
            per_kernel[name]["ms"], per_kernel[name]["bound_ms"])))
            for kind, n in chains.items() if kind.split()[0] == name]
        est[name] = (sum(n / (256 * MiB) * t for _, n, (t, _) in parts),
                     sum(n / (256 * MiB) * b for _, n, (_, b) in parts))
        log(f"{name} launches by chain kind (MiB scanned, ms and bound per "
            "256 MiB):")
        for kind, n, (t, b) in sorted(parts):
            note = "" if kind in chain_times else \
                f" (not timed: {name}'s JSON-line time)"
            log(f"  {kind}: {n / MiB:.1f} MiB, {t:.3f} ms, bound {b:.4f}"
                f"{note}")
    rows = []
    for k, n in total.items():
        ms, bnd = est[k]
        rows.append((ms - bnd, k, n, scanned[k] / MiB, ms))
    log("size-weighted launches (kernel: launches, MiB scanned, est. ms = "
        "MiB / 256 x ms at 256 MiB, est. ms over the bound):")
    for over, k, n, mib, ms in sorted(rows, reverse=True):
        log(f"  {k}: {n}, {mib:.1f} MiB, {ms:.3f} ms, {over:.3f} ms")


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for a kernel's work
# ---------------------------------------------------------------------------

def bound(nbytes, ops):
    """(ms, what bounds it): bytes over the HBM rate or int32 operations
    over the int32 rate, whichever is larger."""
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = ops / INT32_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def stage_tests(ft, k):
    """Expected stage tests per start of a filter that stops at its first
    miss over the first k stages: sum_s prod_{j<s} fill_j, from the
    tables' measured fills (the text is uniform random)."""
    fills = ft.stage_fills or (ft.density,) * len(ft.bitmaps)
    tests, alive = 0.0, 1.0
    for s in range(k):
        tests += alive
        alive *= fills[s]
    return tests


def fp_filter_ops(ft, n, k):
    """int32 operations the fp-tier filters need over n bytes: per start,
    three rolling fingerprint updates and the stage tests."""
    return (n - ft.m + 1) * (ROLLING_FP_OPS
                             + STAGE_TEST_OPS * stage_tests(ft, k))


def stage_bytes(ft, k):
    return k * ft.stage_bits // 8


# ---------------------------------------------------------------------------
# kernel vs plain
# ---------------------------------------------------------------------------

class Checks:
    """Kernel-vs-plain comparisons; every one must be exact."""

    def __init__(self):
        self.max_err = {k: 0 for k in KERNELS}

    def _err(self, name, err, label):
        self.max_err[name] = max(self.max_err[name], err)
        assert err == 0, f"{name} kernel != plain on {label}"

    def same(self, name, got, want, label):
        """A kernel's output (a tensor or a tuple of them) against its plain
        version's on the same inputs, exactly."""
        import torch
        torch.cuda.synchronize()
        err = _diff(got, want)
        log(f"  {name} {label}: kernel vs plain max_abs_err {err}")
        self._err(name, err, label)

    def exact(self, label, text, pats, offset=0):
        """The unguarded exact count against its plain version on
        text[offset:] (an odd offset is an unaligned address)."""
        import torch
        from tpu_smatcher_torch.ops import cuda_filter as cf
        from tpu_smatcher_torch.ops.fast import build_fast
        ft = build_fast(pats.codes, pats.sigma, device="cuda")
        t = torch.from_numpy(text).cuda()[offset:]
        k = int(cf.exact_count(t, ft.bitmaps[0], m=ft.m, sigma=ft.sigma))
        torch.cuda.synchronize()
        p = int(cf.exact_count_plain(t, ft.bitmaps[0], m=ft.m,
                                     sigma=ft.sigma))
        log(f"  exact_count {label}: n={int(t.shape[0])} m={ft.m} "
            f"sigma={ft.sigma} kernel={k} plain={p}")
        self._err("exact_count", abs(k - p), label)

    def exact_guarded(self, label, text, pats):
        """exact_mask and the guarded exact_count against their plain
        versions (and each other), on text that may hold bytes >= sigma."""
        import torch
        from tpu_smatcher_torch.ops import cuda_filter as cf
        from tpu_smatcher_torch.ops.fast import build_fast
        ft = build_fast(pats.codes, pats.sigma, device="cuda")
        t = torch.from_numpy(text).cuda()
        args = dict(m=ft.m, sigma=ft.sigma)
        mask = cf.exact_mask(t, ft.bitmaps[0], **args)
        k = int(cf.exact_count(t, ft.bitmaps[0], guard=True, **args))
        torch.cuda.synchronize()
        pm = cf.exact_mask_plain(t, ft.bitmaps[0], **args)
        p = int(cf.exact_count_plain(t, ft.bitmaps[0], guard=True, **args))
        log(f"  exact_mask / exact_count_guard {label}: n={len(text)} "
            f"m={ft.m} sigma={ft.sigma} kernel={k} plain={p} "
            f"mask sum={int(mask.sum())}")
        self._err("exact_mask", int((mask.int() - pm.int()).abs().max()),
                  label)
        self._err("exact_count_guard", abs(k - p), label)
        assert int(mask.sum()) == k, f"mask sum != guarded count on {label}"

    def cascade(self, label, text, pats, stage_bits=None, want_ovf=None):
        import torch
        from tpu_smatcher_torch.ops import cuda_filter as cf
        from tpu_smatcher_torch.ops.fast import (FastScanner, build_fast,
                                                 stages_for)
        ft = build_fast(pats.codes, pats.sigma, stage_bits=stage_bits,
                        device="cuda")
        eng = FastScanner(ft)
        n = len(text)
        _, k1, kt = eng._route_costs(n, stages_for(ft, n, eng.cap))["cascade"]
        t = torch.from_numpy(text).cuda()
        args = dict(m=ft.m, k1=k1, cd=ft.cd(kt))
        ks, ko = cf.cascade(t, ft.bitmaps[:kt], **args)
        torch.cuda.synchronize()
        ps, po = cf.cascade_plain(t, ft.bitmaps[:kt], **args)
        err = max(int((ks.long() - ps.long()).abs().max()),
                  abs(int(ko) - int(po)))
        log(f"  cascade {label}: n={n} m={ft.m} sigma={ft.sigma} k1={k1} "
            f"kt={kt} survivors={int((ks >= 0).sum())} ovf={int(ko)}")
        self._err("cascade", err, label)
        assert want_ovf is None or int(ko) == want_ovf, label

    def cascade_stages(self, label, text, bitmaps, m, k1):
        """The cascade on given stage bitmaps ((kt, words) int32 numpy) and
        the first kt (C, D) pairs, against its plain version."""
        import torch
        from tpu_smatcher_torch.ops import cuda_filter as cf
        from tpu_smatcher_torch.ops.fast import STAGE_CD
        t = torch.from_numpy(text).cuda()
        bm = torch.from_numpy(bitmaps).cuda()
        kt = int(bm.shape[0])
        args = dict(m=m, k1=k1, cd=STAGE_CD[:kt])
        got = cf.cascade(t, bm, **args)
        self.same("cascade", got, cf.cascade_plain(t, bm, **args),
                  f"{label}: n={len(text)} m={m} k1={k1} kt={kt} "
                  f"stage_bits={bm.shape[1] * 32} survivors "
                  f"{int((got[0] >= 0).sum())} ovf {int(got[1])}")

    def filters(self, label, text, pats, stage_bits):
        """filter_mask and filter_slots at k = 1 and 3, and words_view on
        the aligned text and at a one-byte offset.  Returns the number of
        sub-blocks that held more than BLOCK_SLOTS candidates."""
        import torch
        from tpu_smatcher_torch.ops import cuda_filter as cf
        from tpu_smatcher_torch.ops.fast import build_fast, words_len
        ft = build_fast(pats.codes, pats.sigma, stage_bits=stage_bits,
                        device="cuda")
        t = torch.from_numpy(text).cuda()
        n = len(text)
        crowded = 0
        for k in (1, 3):
            k = min(k, len(ft.bitmaps))
            args = dict(m=ft.m, cd=ft.cd(k))
            mask = cf.filter_mask(t, ft.bitmaps[:k], **args)
            pos, counts = cf.filter_slots(t, ft.bitmaps[:k], **args)
            torch.cuda.synchronize()
            pm = cf.filter_mask_plain(t, ft.bitmaps[:k], **args)
            pp, pc = cf.filter_slots_plain(t, ft.bitmaps[:k], **args)
            self._err("filter_mask", int((mask.int() - pm.int()).abs().max()),
                      label)
            self._err("filter_slots",
                      max(int((pos.long() - pp.long()).abs().max()),
                          int((counts.long() - pc.long()).abs().max())),
                      label)
            assert int(counts.sum()) == int(mask.sum()), label
            over = int((counts > cf.BLOCK_SLOTS).sum())
            crowded += over
            log(f"  filter {label}: n={n} m={ft.m} sigma={ft.sigma} "
                f"stage_bits={ft.stage_bits} k={k} "
                f"candidates={int(counts.sum())} sub-blocks over 16: {over}")
        nw = words_len(n, ft.words)
        for off in (0, 1):
            tt = t[off:]
            got = cf.words_view(tt, nw)
            torch.cuda.synchronize()
            want = cf.words_view_plain(tt, nw)
            self._err("words_view",
                      int((got.long() - want.long()).abs().max()),
                      f"{label} offset {off}")
        return crowded


    def filter_stages(self, label, t, bitmaps, m):
        """filter_mask and filter_slots on the device text t and stage
        bitmaps ((k, words) int32 on the device) with the first k (C, D)
        pairs, against their plain versions.  Returns the sub-blocks'
        counts."""
        import torch
        from tpu_smatcher_torch.ops import cuda_filter as cf
        from tpu_smatcher_torch.ops.fast import STAGE_CD
        k = int(bitmaps.shape[0])
        args = dict(m=m, cd=STAGE_CD[:k])
        desc = (f"{label}: n={int(t.shape[0])} address%16="
                f"{t.data_ptr() % 16} m={m} k={k} stage_bits="
                f"{int(bitmaps.shape[1]) * 32}")
        mask = cf.filter_mask(t, bitmaps, **args)
        pos, counts = cf.filter_slots(t, bitmaps, **args)
        torch.cuda.synchronize()
        self._err("filter_mask", _diff(mask, cf.filter_mask_plain(
            t, bitmaps, **args)), desc)
        self._err("filter_slots", _diff((pos, counts), cf.filter_slots_plain(
            t, bitmaps, **args)), desc)
        assert int(counts.sum()) == int(mask.sum()), desc
        return counts

    def stages(self, label, text, chain, tables, m, sigma, quiet=False):
        """The stage-chain kernel against stages_plain in all three modes,
        guard on and off (and the flat call where the chain allows it), on
        text (numpy, or a tensor on the card: a view at any address).
        Returns the candidates."""
        import torch
        from tpu_smatcher_torch.ops import cuda_engines as ce
        t = text if torch.is_tensor(text) else torch.from_numpy(text).cuda()
        flat_ok = all(k in ("wid", "fpset") for k, _ in chain)
        errs, cands = {}, 0
        for mode in ("count", "mask", "slots"):
            for guard in (False, True):
                flat = flat_ok and not guard
                kw = dict(m=m, sigma=sigma, mode=mode, guard=guard)
                got = ce.stages(t, chain, tables, flat=flat, **kw)
                torch.cuda.synchronize()
                want = ce.stages_plain(t, chain, tables, **kw)
                name = "stages_flat" if flat else "stages"
                errs[name, mode, guard] = _diff(got, want)
                self._err(name, errs[name, mode, guard],
                          f"{label} {mode} guard={guard}")
                cands += int(want) if mode == "count" else 0
        if not quiet:
            log(f"  stages {label}: n={int(t.shape[0])} chain "
                f"{[k for k, _ in chain]}, max_abs_err {max(errs.values())} "
                f"over {len(errs)} (mode, guard) calls")
        return cands


def _diff(got, want):
    """Max abs difference of a kernel's output (a tensor or a tuple of
    them) and its plain version's; shapes must agree."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape, f"shape {tuple(g.shape)} != {tuple(w.shape)}"
        if g.numel() and not torch.equal(g, w):
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def stage_checks(ck, case):
    """stages / stages_flat against stages_plain on each engine's chain
    (prefix, suffix and exact wid, fpset, wm, sog), sigma in {2, 4, 20,
    256}, m in {8, 32}, long, ragged and short texts, bytes >= sigma
    planted where the alphabet leaves room."""
    import numpy as np
    from tpu_smatcher_torch import make_engine
    log("kernel vs plain (stages, stages_flat: every stage kind and mode, "
        "guard on and off, tolerance 0):")
    for sigma in (2, 4, 20, 256):
        for m in (8, 32):
            n = 4 * MiB + 77
            text, pats = case(sigma, n, m, 2000, seed=sigma + m)
            if sigma < 256:
                at = np.random.default_rng(m).integers(0, n, 1 + n // 512)
                text[at[::2]] = sigma
                text[at[1::2]] = 255
            names = ["ac", "sh", "wm"] + ([f"sog{m}"] if sigma <= 16 else [])
            for name in names:
                fp = make_engine(name, pats).fast_path
                for nn in (n, 1001, m):
                    chain, tables, _ = fp._stages(nn)
                    ck.stages(f"{name} sigma={sigma} m={m} n={nn}",
                              text[:nn].copy(), chain, tables, m, sigma)
    stage_edge_checks(ck)


def stage_edge_checks(ck):
    """stages / stages_flat against stages_plain on kernel_cases' stage-chain
    edge cases (those of tests/test_torch_cuda.py): start counts around the
    kernel's run, a mask row and its tile, on views at every address mod
    16, with bytes >= sigma planted (the wid stage's per-start runs,
    lookups past the value tables, windows the guard drops) and the guard
    at sigma = 256, for every chain kind EngineFastPath builds, sog at m =
    34 and wid + fpset at m = 4097; 32 fp stages of 2^17 and 2^18 bits
    (past shared memory) alone and behind each stage 0; chains outside
    EngineFastPath's (the kernel's generic instantiation); and launches
    above 48 KB of shared memory around a smaller one."""
    from tpu_smatcher_torch import kernel_cases as kc
    log("kernel vs plain (stages, stages_flat: runs, rows, tiles, addresses, "
        "dirty runs, m = 3 to 4097, wide fp stages, generic chains, "
        "tolerance 0):")
    for sigma, m, kind in kc.STAGE_EDGE_CASES:
        views, chain, tables = kc.stage_edge_case(sigma, m, kind, "cuda")
        cands = sum(ck.stages(f"{kind} sigma={sigma} m={m}", v, chain,
                              tables, m, sigma, quiet=True) for v in views)
        assert cands, f"stages edges {kind} sigma={sigma} m={m}"
        log(f"  stages {kind} sigma={sigma} m={m} chain "
            f"{[k for k, _ in chain]}: {len(views)} start counts at "
            f"addresses 0..15 mod 16, every mode, guard on and off: "
            f"{cands} candidates, max_abs_err 0")
    for stage_bits in (131072, 262144):
        for t, chain, tables, m in kc.wide_fp_cases(stage_bits, "cuda"):
            ck.stages(f"{[k for k, _ in chain]} with 32 x {stage_bits}-bit "
                      f"fp stages m={m}", t, chain, tables, m, 4, quiet=True)
        log(f"  stages 32 x {stage_bits}-bit fp stages past shared memory, "
            f"alone and behind wid / wm / sog at m = 32 and 4097 (aligned "
            f"and at address 3 mod 16): max_abs_err 0")
    for sigma, m in kc.GENERIC_CASES:
        t, chains = kc.generic_case(sigma, m, "cuda")
        for chain, tables in chains:
            ck.stages(f"generic sigma={sigma} m={m}", t, chain, tables, m,
                      sigma)
    for t, chain, tables, m in kc.smaller_launch_cases("cuda"):
        ck.stages("around a smaller launch", t, chain, tables, m, 4,
                  quiet=True)
    log("  stages launches above 48 KB of shared memory (97 KB, 85 KB), "
        "then one below (34 KB), then 97 KB again: max_abs_err 0")


def kernel_checks():
    import numpy as np
    from tpu_smatcher_torch.core import datagen
    from tpu_smatcher_torch import kernel_cases as kc
    from tpu_smatcher_torch.kernel_cases import (EXACT_PAIR_TILE,
                                                 exact_edge_starts,
                                                 random_stages)
    from tpu_smatcher_torch.core.alphabet import Alphabet
    from tpu_smatcher_torch.core.patterns import PatternSet

    def case(sigma, n, m, p, seed):
        ab = Alphabet.of_size(sigma)
        text = datagen.generate_text(n, ab, seed=seed)
        pats = datagen.generate_patterns(text, p, m, ab, frac_present=0.5,
                                         seed=seed + 1)
        return text, pats

    ck = Checks()
    log("kernel vs plain (exact, tolerance 0):")
    for sigma, m in ((2, 8), (2, 16), (4, 8)):
        for n in (16 * MiB + 77, MiB + 5, 1000, 100, m):
            text, pats = case(sigma, max(n, 4 * m), m, 200, seed=n + m)
            ck.exact(f"sigma={sigma}", text[:n].copy(), pats)
    zeros = np.zeros(MiB + 3, np.uint8)                   # every start hits
    ck.exact("all-match", zeros,
             PatternSet(np.zeros((1, 8), np.uint8), Alphabet.dna()))
    # start counts around a run and a tile, m=1, sigma=256, and a text at
    # an odd address (staged from the aligned address below it)
    for sigma, m, p in ((4, 8, 200), (4, 1, 2), (256, 2, 200)):
        text, pats = case(sigma, 3 * EXACT_PAIR_TILE, m, p, seed=sigma + m)
        for s in exact_edge_starts():
            ck.exact(f"sigma={sigma} {s} starts", text[:m - 1 + s].copy(),
                     pats)
        text, pats = case(sigma, 4 * MiB + 5, m, p, seed=sigma + m)
        ck.exact(f"sigma={sigma} odd address", text, pats, offset=1)

    log("kernel vs plain (exact_mask, guarded exact_count, tolerance 0):")
    for sigma, m in ((2, 16), (4, 8), (20, 3), (256, 2)):
        for n in (16 * MiB + 77, MiB + 5, 1000, 100, m):
            text, pats = case(sigma, max(n, 4 * m), m, 200, seed=n + sigma)
            text = text[:n].copy()
            if sigma < 256:                  # bytes >= sigma, the pad first
                at = np.random.default_rng(n).integers(0, n, 1 + n // 512)
                text[at[::2]] = sigma
                text[at[1::2]] = 255
            ck.exact_guarded(f"sigma={sigma}", text, pats)
    alias = np.zeros(23, np.uint8)
    alias[16:] = 4                           # a shard padded with sigma
    ck.exact_guarded("pad alias", alias, PatternSet(
        np.array([[0, 0, 0, 0, 0, 0, 1, 0]], np.uint8), Alphabet.dna()))
    exact_edge_checks(ck)

    log("kernel vs plain (cascade, tolerance 0):")
    for m in (8, 16, 32, 129, 513):
        for sigma, n in ((4, 16 * MiB + 77), (20, MiB + 3)):
            if sigma == 4 and m == 8:       # DNA m=8 is the exact tier
                continue
            text, pats = case(sigma, n, m, 10_000, seed=m + sigma)
            ck.cascade(f"sigma={sigma}", text, pats)
    text, pats = case(20, 20_000, 16, 3000, seed=3)
    for n in (16, 100, 1000, 1001):                        # n=m, n<128, ragged
        ck.cascade(f"short n={n}", text[:n].copy(), pats)
    dense_text, pats = case(4, 4 * MiB, 32, 3000, seed=5)
    run = len(dense_text) // 4
    dense_text[run:run + 4000] = 0                         # match-dense run
    codes = pats.codes.copy()
    codes[0] = 0
    dense_pats = PatternSet(codes, pats.alphabet)
    ck.cascade("match-dense", dense_text, dense_pats, stage_bits=32768,
               want_ovf=1)
    text, pats = case(4, 3 * kc.CASCADE_TILE + 64, 32, 3000, seed=11)
    for s in kc.cascade_edge_starts():              # run, row and tile edges
        ck.cascade(f"{s} starts", text[:31 + s].copy(), pats)
    text, pats = case(256, MiB + 3, 16, 10_000, seed=12)
    ck.cascade("sigma=256", text, pats)
    # 131,072-bit stages (p=100k's width) with phase 1 in shared memory (k1
    # = 6: 96 KB, 12: 192 KB) or past it (14: 224 KB), m = 1 and 4097,
    # bytes up to 255; bits set with probability 0.8, so rows overflow
    rng = np.random.default_rng(13)
    for k1 in (6, 12, 14):
        stages = random_stages(k1 + 2, 131072, 0.8, seed=k1)
        for m in (1, 32, 4097):
            text = rng.integers(0, 256, m - 1 + 4 * MiB + 77).astype(np.uint8)
            ck.cascade_stages("random stages", text, stages, m, k1)

    log("kernel vs plain (filter_mask, filter_slots, words_view, "
        "tolerance 0):")
    crowded = 0
    for sigma, m in ((20, 8), (4, 16), (4, 32), (4, 129), (4, 513)):
        for n, stage_bits in ((16 * MiB + 77, 4096), (MiB + 3, 131072)):
            text, pats = case(sigma, n, m, 3000, seed=m + sigma + 1)
            crowded += ck.filters(f"sigma={sigma}", text, pats, stage_bits)
    text, pats = case(20, 20_000, 16, 3000, seed=3)
    for n in (16, 100, 1001):                              # n=m, n<128, ragged
        for stage_bits in (4096, 131072):
            ck.filters(f"short n={n}", text[:n].copy(), pats, stage_bits)
    ck.filters("match-dense", dense_text, dense_pats, 32768)
    assert crowded > 0, "no sub-block held more than 16 candidates"
    filter_edge_checks(ck)
    verify_edge_checks(ck)
    stage_checks(ck, case)
    return ck


def verify_edge_checks(ck):
    """verify_count_live against its plain version on kernel_cases' verify
    edge cases (m = 5, 8, 13, 32; eb 0 and above; fp2's slot choice and
    every slot; n_cand 0, below, at and above cap; a match at the last
    window start), on the text and on views 1 to 3 bytes in."""
    import torch
    from tpu_smatcher_torch import kernel_cases as kc
    from tpu_smatcher_torch.ops import cuda_filter as cf
    log("kernel vs plain (verify_count_live: word ends, buckets, slot "
        "choice, candidate counts, addresses, tolerance 0):")
    for case in kc.VERIFY_EDGE_CASES:
        text, idxs, n_cand, ft, truth = kc.verify_edge_case(*case, "cuda")
        for off in range(4):
            ids = idxs if off == 0 else torch.where(idxs >= off, idxs - off,
                                                    -1)
            args = (text[off:], ids, n_cand, ft)
            got = cf.verify_count_live(*args)
            ck.same("verify", got, cf.verify_count_live_plain(*args),
                    f"m={case[0]} slot_ok={case[1]} eb={ft.eb} {case[3]} "
                    f"offset {off}")
            assert off or int(got) == truth, f"verify {case}: {int(got)}"


def exact_edge_checks(ck):
    """exact_mask and exact_count, guard on and off, against their plain
    versions on kernel_cases' exact edge cases (views at every address mod
    16, start counts around the run, a mask row and the tile, a positions
    piece at an odd address, n = m; bytes >= sigma planted, a random
    bitmap), each mask summing to the guarded count."""
    import torch
    from tpu_smatcher_torch import kernel_cases as kc
    from tpu_smatcher_torch.ops import cuda_filter as cf
    for sigma, m in kc.EXACT_EDGE_CASES:
        views, bm = kc.exact_edge_case(sigma, m, "cuda")
        args = dict(m=m, sigma=sigma)
        dropped = 0
        for i, t in enumerate(views):
            label = f"edge sigma={sigma} m={m} view {i}"
            mask = cf.exact_mask(t, bm, **args)
            k = int(cf.exact_count(t, bm, guard=True, **args))
            u = int(cf.exact_count(t, bm, **args))
            torch.cuda.synchronize()
            ck._err("exact_mask",
                    _diff(mask, cf.exact_mask_plain(t, bm, **args)), label)
            ck._err("exact_count_guard", abs(k - int(cf.exact_count_plain(
                t, bm, guard=True, **args))), label)
            ck._err("exact_count", abs(u - int(cf.exact_count_plain(
                t, bm, **args))), label)
            assert int(mask.sum()) == k, f"mask sum != guarded count, {label}"
            dropped += u - k
        assert (dropped > 0) == (sigma < 256), f"guard, sigma={sigma}"
        starts = [int(v.shape[0]) - m + 1 for v in views[16:]]
        log(f"  exact edge sigma={sigma} m={m}: {len(views)} views (every "
            f"address mod 16; starts {starts}), guard dropped {dropped}: "
            f"max_abs_err 0")


def filter_edge_checks(ck):
    """filter_mask and filter_slots on start counts around their run, a
    mask row and a tile, at m = 1, 31 and 4097 and sigma = 4 and 256, on
    views at every address mod 16 (staged from the aligned address below
    them), with crowded and sparse sub-blocks; on 4096- to 2^18-bit stages,
    k = 1 and 32, in shared memory and past it (bits set with probability
    0.8, bytes up to 255); and three launches above 48 KB of shared memory,
    the middle one smaller."""
    import numpy as np
    import torch
    from tpu_smatcher_torch.kernel_cases import edge_starts, random_stages
    log("kernel vs plain (filter_mask, filter_slots: runs, rows, tiles, "
        "addresses, stage widths, tolerance 0):")
    rng = np.random.default_rng(21)
    starts = sorted(set(edge_starts(FILTER_RUN, FILTER_TILE))
                    | {127, 128, 129})
    crowded = 0
    for sigma in (4, 256):
        for m in (1, 31, 4097):
            text = rng.integers(0, sigma, m - 1 + 2 * FILTER_TILE + 64
                                ).astype(np.uint8)
            full = torch.from_numpy(text).cuda()
            stages = [torch.from_numpy(random_stages(k, bits, fill, seed=m))
                      .cuda() for k, bits, fill in ((1, 4096, 0.5),
                                                    (3, 16384, 0.2))]
            for i, s in enumerate(starts):
                t = full[i % 16:i % 16 + m - 1 + s]
                for bm in stages:
                    counts = ck.filter_stages(f"sigma={sigma} {s} starts", t,
                                              bm, m)
                    crowded += int((counts > 16).sum())
            log(f"  filter sigma={sigma} m={m}: {len(starts)} start counts "
                f"{starts} at addresses 0..15 mod 16, k=1 and 3: "
                f"max_abs_err 0")
    assert crowded > 0, "no crowded sub-block in the edge checks"
    for stage_bits in (4096, 16384, 131072, 262144):
        for k in (1, 32):
            bm = torch.from_numpy(random_stages(k, stage_bits, 0.8,
                                                seed=k + stage_bits)).cuda()
            for m in (32, 4097):
                t = torch.from_numpy(rng.integers(
                    0, 256, m - 1 + MiB + 77).astype(np.uint8)).cuda()
                ck.filter_stages("wide stages", t, bm, m)
                counts = ck.filter_stages("wide stages", t[3:], bm, m)
                log(f"  filter stage_bits={stage_bits} k={k} m={m}, "
                    f"aligned and at address 3 mod 16: candidates "
                    f"{int(counts.sum())}, max_abs_err 0")
    t = torch.from_numpy(rng.integers(0, 4, 3 * FILTER_TILE).astype(
        np.uint8)).cuda()
    wide = torch.from_numpy(random_stages(2, 262144, 0.5, seed=1)).cuda()
    mid = torch.from_numpy(random_stages(13, 32768, 0.8, seed=2)).cuda()
    for bm in (wide, mid, wide):       # 64 KB, 52 KB, then 64 KB again
        ck.filter_stages("after a smaller large launch", t, bm, 32)
    log("  filter launches above 48 KB of shared memory, the middle one "
        "smaller: max_abs_err 0")


# ---------------------------------------------------------------------------
# the main paths
# ---------------------------------------------------------------------------

def plain_count(eng, t):
    """The scanner's current async pass with every kernel replaced by its
    plain version: (count, overflow) as python values."""
    with plain_kernels():
        fn = eng._device_count_dense if eng._match_dense else \
            eng._device_count
        c, o = fn(t)
        return int(c), int(o)


def cascade_route_count(ft, t):
    """The cascade route's count of t, forced past the router: the route's
    own function with the stage counts its cost entry gives."""
    from tpu_smatcher_torch.ops.fast import FastScanner, stages_for
    eng = FastScanner(ft)
    n = int(t.shape[0])
    _, k1, kt = eng._route_costs(n, stages_for(ft, n, eng.cap))["cascade"]
    c, o = eng._route_count(t, "cascade", k1, kt)
    return int(c), int(o)


def route_of(eng, n):
    from tpu_smatcher_torch.ops.fast import stages_for
    if eng.ft.exact:
        return "exact"
    return eng._pick_path(n, stages_for(eng.ft, n, eng.cap))


def tiers_path(text, tdev, total):
    """bench.py's five tiers through make_fast(pats).count.  Returns the
    engines, and each tier's pattern codes and ground-truth match starts
    on the 4 MiB prefix, by name."""
    import numpy as np
    from tpu_smatcher_torch import make_fast
    from tpu_smatcher_torch.core import datagen
    from tpu_smatcher_torch.core.alphabet import Alphabet

    ab = Alphabet.dna()
    engines, checks, codes, gates = [], [], {}, {}
    reset_launches()
    for name, m, p, anchor in TIERS:
        pats = datagen.generate_patterns(text, p, m, ab, frac_present=0.5,
                                         seed=8 if m == 8 else 8 + m)
        eng = make_fast(pats)
        gate = eng.count(tdev[:N_GATE])
        full = eng.count(tdev)
        engines.append((name, eng))
        codes[name] = pats.codes
        checks.append((name, pats, anchor, gate, full))
    read_launches("tiers", ("exact_count", "cascade", "compact_valrows",
                            "verify"), total)
    for (name, pats, anchor, gate, full), (_, eng) in zip(checks, engines):
        gates[name] = np.flatnonzero(datagen.match_starts(text[:N_GATE],
                                                          pats))
        truth = len(gates[name])
        plain, o = plain_count(eng, tdev)
        route = route_of(eng, N_FULL)
        log(f"tier {name} (m={pats.m} p={pats.p_size}) route={route}: gate "
            f"{gate} (truth {truth}), full {full} (anchor {anchor}), plain "
            f"{plain}, fallback_scans {eng.fallback_scans}")
        assert gate == truth, f"{name}: 4 MiB gate {gate} != {truth}"
        assert full == anchor, f"{name}: full count {full} != {anchor}"
        assert plain == full and not o, f"{name}: plain {plain} != {full}"
        assert route == "exact" or route[0] == "cascade", f"{name}: {route}"
        assert eng.fallback_scans == 0, f"{name}: overflow retry taken"
    return engines, codes, gates


def slot_scanner(pats, device="cuda"):
    """A FastScanner over pats' tables at SLOT_BITS-bit stages."""
    from tpu_smatcher_torch.ops.fast import FastScanner, build_fast
    return FastScanner(build_fast(pats.codes, pats.sigma,
                                  stage_bits=SLOT_BITS, device=device))


def slot32_path(text, tdev, total):
    """DNA m=32 p=1000 at SLOT_BITS-bit stages: the slot route."""
    from tpu_smatcher_torch.core import datagen
    from tpu_smatcher_torch.core.alphabet import Alphabet

    pats = datagen.generate_patterns(text, 1000, M_CELL, Alphabet.dna(),
                                     frac_present=0.5, seed=PAT_SEED)
    reset_launches()
    eng = slot_scanner(pats)
    gate = eng.count(tdev[:N_GATE])
    full = eng.count(tdev)
    read_launches("slot32", ("filter_slots", "words_view"), total)
    truth = datagen.count_matches(text[:N_GATE], pats)
    plain, o = plain_count(eng, tdev)
    casc, co = cascade_route_count(eng.ft, tdev)
    route = route_of(eng, N_FULL)
    log(f"slot32 (m={M_CELL} p=1000) route={route}: gate {gate} (truth "
        f"{truth}), full {full}, plain {plain}, cascade route {casc}, "
        f"fallback_scans {eng.fallback_scans}")
    assert route[0] == "slot", f"slot32 routed {route}"
    assert gate == truth, f"slot32: gate {gate} != {truth}"
    assert plain == full and not o, f"slot32: plain {plain} != {full}"
    assert casc == full and not co, f"slot32: cascade {casc} != {full}"
    assert eng.fallback_scans == 0, "slot32: overflow retry taken"
    return pats, eng, gate, full


def dense32_path(text, tdev, pats, gate0, full0, total):
    """The slot32 text with pattern 0 planted every 256 bytes over 2 MiB:
    the scanner's first scans overflow the slot route's sub-blocks and
    retry through the sync ladder; it adapts within MAX_RETRIES and then
    counts on the dense mask pass without retrying."""
    import torch
    from tpu_smatcher_torch.core import datagen

    p0 = pats.codes[0]
    idx = (torch.arange(PLANTS.start, PLANTS.stop, PLANTS.step,
                        device="cuda")[:, None]
           + torch.arange(M_CELL, device="cuda"))
    t2 = tdev.clone()
    t2[idx] = torch.from_numpy(p0).cuda()
    prefix = datagen.plant(text[:N_GATE], p0, PLANTS)
    gate_truth = datagen.count_matches(prefix, pats)
    # every planted byte lies in the 4 MiB prefix, and so does every
    # window over one: the full count moves by the prefix's change
    truth = full0 + gate_truth - gate0
    reset_launches()
    eng = slot_scanner(pats)
    counts, scans = [], []
    for _ in range(MAX_RETRIES + 1):
        before = eng.fallback_scans
        counts.append(eng.count(t2))
        scans.append(eng.fallback_scans)
        if eng.fallback_scans == before:
            break
    retries = eng.fallback_scans
    steady = [eng.count(t2) for _ in range(3)]
    gate = slot_scanner(pats).count(t2[:N_GATE])
    read_launches("dense32", ("filter_slots", "filter_mask", "words_view"),
                  total)
    plain, o = plain_count(eng, t2)
    casc, co = cascade_route_count(eng.ft, t2)
    log(f"dense32 ({len(PLANTS)} plants of pattern 0): gate {gate} (truth "
        f"{gate_truth}), counts {counts} then {steady} (truth {truth}), "
        f"fallback_scans after each {scans}, _k_extra {eng._k_extra}, "
        f"_match_dense {eng._match_dense}, plain {plain}, cascade route "
        f"{casc}")
    assert gate == gate_truth, f"dense32: gate {gate} != {gate_truth}"
    assert counts + steady == [truth] * (len(counts) + 3), "dense32 count"
    assert 1 <= retries <= MAX_RETRIES, f"dense32: {retries} retries"
    assert eng._match_dense, "dense32 did not switch to the dense pass"
    assert eng.fallback_scans == retries, "dense32 kept retrying"
    assert plain == truth and not o, f"dense32: plain {plain} != {truth}"
    assert casc == truth and not co, f"dense32: cascade {casc} != {truth}"
    return eng, t2, truth


def saturated_path(text, tdev, total):
    """4 MiB, p=10k at 4096-bit stages: every stage ~0.9 full, no cascade
    split; the mask route overflows and the sync ladder scans budget-sized
    pieces on the dense pass."""
    from tpu_smatcher_torch.core import datagen
    from tpu_smatcher_torch.core.alphabet import Alphabet
    from tpu_smatcher_torch.ops.fast import FastScanner, build_fast, stages_for

    pats = datagen.generate_patterns(text, 10_000, M_CELL, Alphabet.dna(),
                                     frac_present=0.5, seed=PAT_SEED)
    t3 = tdev[:N_GATE]
    reset_launches()
    eng = FastScanner(build_fast(pats.codes, 4, stage_bits=SLOT_BITS,
                                 device="cuda"))
    got = eng.count(t3)
    read_launches("saturated", ("filter_mask", "words_view"), total)
    ft = eng.ft
    k = stages_for(ft, N_GATE, eng.cap)
    pieces = N_GATE * ft.density ** k > eng.cap / 4 and k >= len(ft.bitmaps)
    truth = datagen.count_matches(text[:N_GATE], pats)
    with plain_kernels():
        plain = FastScanner(ft).count(t3)
    log(f"saturated (4 MiB, p=10k, 4096-bit stages, fill {ft.density:.3f}, "
        f"{len(ft.bitmaps)} stages) route={route_of(eng, N_GATE)}: count "
        f"{got} (truth {truth}), plain {plain}, budget pieces {pieces}, "
        f"fallback_scans {eng.fallback_scans}")
    assert route_of(eng, N_GATE)[0] == "mask"
    assert pieces and eng.fallback_scans == 1, "saturated: not the ladder"
    assert got == truth == plain, f"saturated: {got} / {plain} != {truth}"
    return eng, t3, pats.codes


def timed(fn):
    """(fn's result, host-clock seconds to it, the device synchronised)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def positions_path(text, tdev, engines, codes, dense, sat, total):
    """Positions, attribution, the guarded core and the batch API on
    bench.py's corpus: the exact tier (m=8 p=10k) and the fp tier (m=32
    p=10k) of the tiers path, then dense32's and saturated's texts.  Every
    call is driven with the launch counters at 0, then checked."""
    import numpy as np
    import torch
    from tpu_smatcher_torch.core import datagen
    from tpu_smatcher_torch.ops import cuda_filter as cf

    eng, fp = dict(engines)["exact"], dict(engines)["fp"]
    anchor, fp_anchor = TIERS[0][3], TIERS[2][3]
    m = eng.m
    d_eng, t2, d_truth = dense
    s_eng, t3, s_pats = sat
    ext = torch.cat([tdev, torch.full((m - 1,), eng.sigma, dtype=torch.uint8,
                                      device="cuda")])
    rows = tdev.view(8, -1)
    secs = {}
    reset_launches()
    pos, secs["exact positions"] = timed(lambda: eng.positions(tdev))
    (pm, ids), secs["exact matches"] = timed(lambda: eng.matches(tdev))
    per, secs["exact count_per_pattern"] = timed(
        lambda: eng.count_per_pattern(tdev))
    core_c, core_o = (int(x) for x in eng.core(ext))
    stack = eng.count_stack(rows)
    row_counts = eng.scan_many(list(rows))
    count = eng.count(tdev)
    rep3 = eng.count_repeat_async(tdev, 3).result()
    fpos, secs["fp positions"] = timed(lambda: fp.positions(tdev))
    (fpm, fids), secs["fp matches"] = timed(lambda: fp.matches(tdev))
    fper, secs["fp count_per_pattern"] = timed(
        lambda: fp.count_per_pattern(tdev))
    fstack = fp.count_stack(rows)
    frows = fp.scan_many(list(rows))
    dpos = d_eng.positions(t2)
    before = cf.LAUNCHES["filter_mask"]
    spos, secs["saturated positions"] = timed(lambda: s_eng.positions(t3))
    sat_pieces = cf.LAUNCHES["filter_mask"] - before
    read_launches("positions", ("exact_mask", "exact_count_guard",
                                "exact_count", "filter_mask", "words_view"),
                  total)
    log("positions phase (host clock): " + ", ".join(
        f"{k} {v:.3f} s" for k, v in secs.items()))

    # the exact tier against the plain mask, the oracle and itself
    bm = eng.ft.bitmaps[0]
    want = torch.nonzero(cf.exact_mask_plain(tdev, bm, m=m, sigma=eng.sigma)
                         .view(-1)).view(-1).cpu().numpy()
    pats = codes["exact"]
    gate = np.flatnonzero(datagen.match_starts(text[:N_GATE], pats))
    head = pos[pos < N_GATE - m + 1]
    unguarded = int(cf.exact_count_plain(ext, bm, m=m, sigma=eng.sigma))
    log(f"exact positions: {len(pos)} (anchor {anchor}), gate prefix "
        f"{len(head)} (oracle {len(gate)}); count_per_pattern sum "
        f"{int(per.sum())}; core on text + {m - 1} pad bytes {core_c} "
        f"(overflow {core_o}; unguarded {unguarded}); count_stack of 8 rows "
        f"{stack} (rows {sum(row_counts)}); count_repeat_async x3 {rep3} "
        f"(count {count})")
    assert len(pos) == anchor, f"exact positions {len(pos)} != {anchor}"
    assert np.array_equal(pos, want), "exact positions != plain exact_mask"
    assert np.array_equal(head, gate), "exact positions != gate oracle"
    assert np.array_equal(pm, pos), "exact matches' positions"
    assert np.array_equal(ids[:len(gate)],
                          datagen.match_ids(text, gate, pats)), "exact ids"
    assert count > eng.cap // 2, "count_per_pattern did not histogram"
    assert np.array_equal(np.bincount(ids, minlength=len(pats)), per), \
        "exact count_per_pattern != bincount of the matches' ids"
    assert (core_c, core_o) == (anchor, 0), f"core {core_c} != {anchor}"
    assert stack == sum(row_counts), f"count_stack {stack}"
    assert count == anchor and rep3 == 3 * count, f"repeat {rep3}"

    fpats = codes["fp"]
    log(f"fp positions: {len(fpos)} (anchor {fp_anchor}), matches "
        f"{len(fpm)}, count_per_pattern sum {int(fper.sum())}, count_stack "
        f"of 8 rows {fstack} (rows {sum(frows)}); dense32 "
        f"positions {len(dpos)} (count {d_truth}); saturated positions "
        f"{len(spos)} in {sat_pieces} pieces")
    assert len(fpos) == fp_anchor and np.array_equal(fpm, fpos), "fp pos"
    assert fstack == sum(frows), f"fp count_stack {fstack}"
    assert np.array_equal(fids, datagen.match_ids(text, fpos, fpats)), \
        "fp ids != datagen.match_ids"
    assert np.array_equal(np.bincount(fids, minlength=len(fpats)), fper), \
        "fp count_per_pattern"
    assert len(dpos) == d_truth, f"dense32 positions {len(dpos)}"
    sat_gate = np.flatnonzero(datagen.match_starts(text[:N_GATE], s_pats))
    assert np.array_equal(spos, sat_gate), "saturated positions != oracle"
    assert sat_pieces > 1, "saturated positions did not split"
    return ext, fpos


def bench_pattern_sets(codes):
    """bench.py's p=10k pattern sets of the tiers path, by m."""
    from tpu_smatcher_torch.core.alphabet import Alphabet
    from tpu_smatcher_torch.core.patterns import PatternSet
    return {m: PatternSet(codes[name], Alphabet.dna())
            for name, m, p, _ in TIERS if p == 10_000}


def engines_path(text, tdev, codes, fp_pos, dense_pats, total):
    """The seven named engines through make_engine(..., device="cuda") on
    bench.py's corpus and pattern sets: the eleven counts (count and
    count_async, no retry) against the BENCH_r05.json anchors, the guarded
    core, positions, scan_many and count_repeat_async, a tandem repeat
    through the wm engine, and each family's portable scan on the 4 MiB
    prefix.  Each
    group is driven with the launch counters at 0, then checked."""
    import numpy as np
    import torch
    from tpu_smatcher_torch import make_engine
    from tpu_smatcher_torch.core import datagen
    from tpu_smatcher_torch.ops import cuda_filter as cf

    pats = bench_pattern_sets(codes)
    anchors = {m: a for _, m, p, a in TIERS if p == 10_000}
    t0 = time.perf_counter()
    engines = {(name, m): make_engine(name, pats[m])
               for name, m in ENGINE_RUNS}
    log(f"engines: tables of {len(engines)} engines built in "
        f"{time.perf_counter() - t0:.1f} s; stage 0: " + ", ".join(
            f"{name} m={m} {e.fast_path.stage0}"
            for (name, m), e in engines.items() if m != 16))
    for group, want, other in ((("ac", "sh", "sbom"), "stages_flat", "stages"),
                               (("wm", "sog8", "sog16", "sog32"), "stages",
                                "stages_flat")):
        reset_launches()
        got = {}
        for (name, m), eng in engines.items():
            if name in group:
                got[name, m] = (eng.count(tdev),
                                eng.count_async(tdev).result())
        read_launches(f"engines {'/'.join(group)}", (want, "words_view"),
                      total)
        assert cf.LAUNCHES[other] == 0, f"{group}: {other} launched"
        for (name, m), (c, a) in got.items():
            fp = engines[name, m].fast_path
            log(f"engine {name} m={m}: count {c}, count_async {a} (anchor "
                f"{anchors[m]}), chain {[k for k, _ in fp._stages(N_FULL)[0]]}")
            assert c == a == anchors[m], f"{name} m={m}: {c} / {a}"
            assert fp._fallback is None and not fp._use_fallback_async, \
                f"{name} m={m}: retried"

    anchor = anchors[8]
    reset_launches()
    ext = torch.cat([tdev, torch.full((7,), 4, dtype=torch.uint8,
                                      device="cuda")])
    core_c, core_o = (int(x) for x in engines["wm", 8].fast_path.core(ext))
    read_launches("engines core", ("stages",), total)
    assert cf.LAUNCHES["stages_flat"] == 0
    log(f"engine wm m=8 core on the corpus + 7 pad bytes: {core_c} "
        f"(overflow {core_o})")
    assert (core_c, core_o) == (anchor, 0), f"core {core_c}"

    reset_launches()
    wm32, ac32 = engines["wm", 32], engines["ac", 32]
    wpos, apos = wm32.positions(tdev), ac32.positions(tdev)
    epos = engines["ac", 8].positions(tdev[:N_GATE])
    rows = tdev.view(8, -1)
    many = wm32.scan_many(list(rows))
    rep3 = wm32.fast_path.count_repeat_async(tdev, 3).result()
    read_launches("engines positions / batch", (
        "stages", "stages_flat", "words_view", "exact_mask"), total)
    gate = np.flatnonzero(datagen.match_starts(text[:N_GATE], pats[8]))
    row_len = N_FULL // 8
    row_want = [int(((fp_pos >= r * row_len)
                     & (fp_pos <= (r + 1) * row_len - 32)).sum())
                for r in range(8)]
    log(f"engine positions: wm m=32 {len(wpos)}, ac m=32 {len(apos)} "
        f"(make_fast {len(fp_pos)}); ac m=8 on the 4 MiB prefix {len(epos)} "
        f"(oracle {len(gate)}); wm m=32 scan_many of 8 rows {many} (windows "
        f"inside each row {row_want}); count_repeat_async x3 {rep3}")
    assert np.array_equal(wpos, fp_pos) and np.array_equal(apos, fp_pos)
    assert np.array_equal(epos, gate), "engine exact positions != oracle"
    assert many == row_want, "engine scan_many"
    assert rep3 == 3 * anchors[32], f"engine count_repeat_async {rep3}"

    # the tandem repeat through the wm engine: the first async scan
    # overflows the chain's row slots and retries exactly, then scans are
    # pinned to the fallback FastScanner, whose cascade overflows its row
    # slots until its ladder adapts within MAX_RETRIES (at the default
    # stage width dense32's plants, ~1 a row, overflow neither)
    from tpu_smatcher_torch.core.patterns import PatternSet
    unit = np.random.default_rng(TANDEM_SEED).integers(
        0, 4, TANDEM_UNIT).astype(np.uint8)
    t_pats = PatternSet(np.concatenate([
        dense_pats.codes,
        np.lib.stride_tricks.sliding_window_view(unit, M_CELL)[:TANDEM_PATS]
    ]), dense_pats.alphabet)
    host = text[:TANDEM_N].copy()
    host[TANDEM_AT:2 * TANDEM_AT] = np.resize(unit, TANDEM_AT)
    t_truth = datagen.count_matches(host, t_pats)
    t5 = torch.from_numpy(host).cuda()
    reset_launches()
    eng = make_engine("wm", t_pats)
    fp = eng.fast_path

    def fb_retries():
        return fp._fallback.fallback_scans if fp._fallback else 0

    counts, after = [], []
    for _ in range(MAX_RETRIES + 2):
        before = (fp._use_fallback_async, fb_retries())
        counts.append(eng.count_async(t5).result())
        after.append(fb_retries())
        if (fp._use_fallback_async, fb_retries()) == before:
            break
    steady = [eng.count_async(t5).result() for _ in range(3)]
    read_launches("engines tandem", ("stages", "cascade", "filter_mask",
                                     "words_view"), total)
    log(f"engine wm on the tandem repeat ({TANDEM_PATS} of {t_pats.p_size} "
        f"patterns, {TANDEM_AT} bytes of a {TANDEM_UNIT}-byte unit in "
        f"{TANDEM_N}): counts {counts} then {steady} (truth {t_truth}), "
        f"pinned to the fallback {fp._use_fallback_async}, the fallback's "
        f"retries after each {after}, its dense pass "
        f"{fp._fallback._match_dense if fp._fallback else None}")
    assert counts + steady == [t_truth] * (len(counts) + 3), "tandem wm"
    assert fp._use_fallback_async, "tandem: the engine never overflowed"
    assert 1 <= fb_retries() <= MAX_RETRIES, f"{fb_retries()} retries"
    assert after[-1] == fb_retries(), "tandem: the fallback kept retrying"

    reset_launches()
    portable = {}
    t0 = time.perf_counter()
    for name in ("ac", "sh", "sbom", "wm", "sog8"):
        portable[name] = make_engine(name, pats[8], fastpath=False).count(
            tdev[:N_GATE])
    secs = time.perf_counter() - t0
    got = counters()
    log(f"engine portable scans (fastpath=False) on the 4 MiB prefix: "
        f"{portable} (gate {len(gate)}), {secs:.1f} s, launches {got}")
    assert set(portable.values()) == {len(gate)}, "portable scans"
    assert not any(got.values()), "a portable scan launched a kernel"
    return engines


def fasta_record(header, raw, width=60):
    """The pieces of one FASTA record: its header line, then `raw` in
    lines of `width` bytes."""
    import numpy as np
    full = raw.size // width * width
    body = np.concatenate([raw[:full].reshape(-1, width),
                           np.full((full // width, 1), ord("\n"),
                                   np.uint8)], axis=1)
    tail = raw[full:].tobytes()
    return [header + b"\n", body.tobytes(), tail + b"\n" * bool(tail)]


def write_corpus_fasta(path, text, ab):
    """The corpus as FASTA: 60-byte lines, two records, through the port's
    Alphabet.decode."""
    import numpy as np
    raw = np.frombuffer(ab.decode(text), np.uint8)
    half = raw.size // 2
    with open(path, "wb") as f:
        for part in (fasta_record(b">chr1 bench.py corpus, seed 7, first "
                                  b"half", raw[:half])
                     + fasta_record(b">chr2 second half", raw[half:])):
            f.write(part)


def write_mixed_files(tmp, text, pats):
    """The corpus as FASTA (write_corpus_fasta), the corpus raw, and
    bench.py's p=10k sets of every MIXED_M as one FASTA record each, in
    shuffled order.  Returns the three paths, each set's rows in file order
    and the shuffle."""
    import numpy as np
    ab = pats[MIXED_M[0]].alphabet
    fasta, bare, pfa = (f"{tmp}/corpus.fa", f"{tmp}/corpus.bin",
                        f"{tmp}/patterns.fa")
    write_corpus_fasta(fasta, text, ab)
    text.tofile(bare)
    rows = [r for m in MIXED_M for r in pats[m].codes]
    order = np.random.default_rng(MIXED_SEED).permutation(len(rows))
    with open(pfa, "wb") as f:
        f.write(b"".join(b">p%d len %d\n%s\n" % (i, rows[j].size,
                                                  ab.decode(rows[j]))
                         for i, j in enumerate(order)))
    return fasta, bare, pfa, order


def mixed_path(text, tdev, codes, gates, total):
    """Mixed lengths, the FASTA front end, table checkpoints and scan() on
    bench.py's corpus: the corpus and the union of the m = 8, 16, 32 p=10k
    sets written as FASTA and loaded back (load_fasta,
    MixedPatternSet.from_fasta); make_mixed(...).count against the sum of
    the BENCH_r05.json anchors and each group against its own; count_file
    at two chunks, scan_many, the wm and ac families; positions, matches
    and count_per_pattern on the 4 MiB prefix against datagen (the tiers'
    gates); fast tables
    (m = 8, 32) and wm tables (m = 32) through save_tables / load_tables
    on the card; scan().  Each group is driven with the launch counters at
    0, then checked.  Returns the mixed scanner."""
    import tempfile
    import numpy as np
    import tpu_smatcher_torch as ts
    from tpu_smatcher_torch import make_mixed
    from tpu_smatcher_torch.core import checkpoint, corpus
    from tpu_smatcher_torch.core.patterns import MixedPatternSet
    from tpu_smatcher_torch.engines import (attach_fastpath, build_tables,
                                            make_engine_from_tables)

    pats = bench_pattern_sets(codes)
    anchors = {m: a for _, m, p, a in TIERS if p == 10_000}
    want = sum(anchors[m] for m in MIXED_M)
    ab = pats[8].alphabet
    secs = {}
    with tempfile.TemporaryDirectory() as tmp:
        (fasta, bare, pfa, order), secs["write FASTA and raw files"] = \
            timed(lambda: write_mixed_files(tmp, text, pats))
        cp, secs["load_fasta (256 MiB)"] = timed(
            lambda: corpus.load_fasta(fasta, ab))
        mx, secs["MixedPatternSet.from_fasta"] = timed(
            lambda: MixedPatternSet.from_fasta(pfa, ab))
        assert cp.n == text.size and np.array_equal(cp.codes, text), \
            "load_fasta != the corpus"
        assert mx.lengths == MIXED_M, f"lengths {mx.lengths}"
        base = np.cumsum([0] + [pats[m].p_size for m in MIXED_M])
        for i, (g, gids) in enumerate(zip(mx.groups, mx.ids)):
            src = order[gids] - base[i]
            assert np.array_equal(np.sort(src), np.arange(g.p_size)), \
                f"m={g.m}: ids"
            assert np.array_equal(g.codes, pats[g.m].codes[src]), \
                f"m={g.m}: rows"
        gate = {m: gates[name] for name, m, p, _ in TIERS
                if p == 10_000 and m in MIXED_M}
        gate_sum = sum(len(v) for v in gate.values())

        reset_launches()
        eng = make_mixed(mx)
        count = eng.count(tdev)
        subs = [s.count(tdev) for s in eng.scanners]
        many = eng.scan_many([tdev, tdev[:N_GATE]])
        read_launches("mixed count", ("exact_count", "cascade",
                                      "compact_valrows", "verify"), total)
        reset_launches()
        files = {}
        for chunk in (1 << 28, 64 * MiB):
            files[chunk], secs[f"count_file, chunk {chunk // MiB} MiB"] = \
                timed(lambda: eng.count_file(bare, chunk=chunk))
        read_launches("mixed count_file", ("exact_count", "cascade",
                                           "compact_valrows", "verify"),
                      total)
        log(f"mixed (lengths {mx.lengths}, p={mx.p_size}): count {count} "
            f"(anchor {want}), groups {subs} (anchors "
            f"{[anchors[m] for m in MIXED_M]}), scan_many of the corpus and "
            f"its 4 MiB prefix {many} (gate {gate_sum}), count_file "
            f"{files}")
        assert count == want, f"mixed count {count} != {want}"
        assert subs == [anchors[m] for m in MIXED_M], f"groups {subs}"
        assert many == [want, gate_sum], f"mixed scan_many {many}"
        assert set(files.values()) == {want}, f"count_file {files}"

        for family, kern in (("wm", "stages"), ("ac", "stages_flat")):
            reset_launches()
            fam = make_mixed(mx, engine=family).count(tdev)
            read_launches(f"mixed {family}", (kern, "words_view"), total)
            log(f"mixed engine={family}: count {fam}")
            assert fam == want, f"mixed {family} {fam} != {want}"

        reset_launches()
        tg = tdev[:N_GATE]
        (starts, lens), secs["positions (4 MiB)"] = timed(
            lambda: eng.positions(tg))
        (ms, ids), secs["matches (4 MiB)"] = timed(lambda: eng.matches(tg))
        per, secs["count_per_pattern (4 MiB)"] = timed(
            lambda: eng.count_per_pattern(tg))
        read_launches("mixed positions", ("exact_mask", "filter_mask",
                                          "words_view"), total)
        log(f"mixed positions on the 4 MiB prefix: {len(starts)} (gate "
            f"{gate_sum}), matches {len(ms)}, count_per_pattern sum "
            f"{int(per.sum())}")
        id_len = np.zeros(mx.p_size, np.int64)
        for g, gids in zip(mx.groups, mx.ids):
            id_len[gids] = g.m
            by_id = np.zeros((mx.p_size, g.m), np.uint8)
            by_id[gids] = g.codes
            sel = id_len[ids] == g.m
            assert np.array_equal(starts[lens == g.m], gate[g.m]), \
                f"m={g.m} positions"
            assert np.array_equal(ms[sel], gate[g.m]), f"m={g.m} matches"
            # each reported id's pattern occurs at its start
            win = text[ms[sel][:, None] + np.arange(g.m)]
            assert np.array_equal(win, by_id[ids[sel]]), f"m={g.m} ids"
        assert int(per.sum()) == gate_sum == len(ms), "count_per_pattern"

        reset_launches()
        for name, m in (("fast", 8), ("fast", 32), ("wm", 32)):
            path = f"{tmp}/{name}{m}.npz"
            tables, b_s = timed(lambda: build_tables(name, pats[m]))
            checkpoint.save_tables(path, tables)
            loaded, l_s = timed(lambda: checkpoint.load_tables(path))
            e = make_engine_from_tables(name, loaded)
            extra = ""
            if name == "wm":
                gate_c = e.count(tdev[:N_GATE])    # the portable scan
                extra = f", portable scan on the 4 MiB prefix {gate_c}"
                assert gate_c == len(gate[m]), f"{name}{m} portable"
                attach_fastpath(e, name, pats[m].codes, pats[m].sigma)
            c = e.count(tdev)
            log(f"checkpoint {name} m={m}: build {b_s:.3f} s, load "
                f"{l_s:.3f} s (host clock), count {c} (anchor "
                f"{anchors[m]}){extra}")
            assert c == anchors[m], f"checkpoint {name}{m}: {c}"
        read_launches("mixed checkpoints", ("exact_count", "cascade",
                                            "compact_valrows", "verify",
                                            "stages", "words_view"), total)

    reset_launches()
    r = ts.scan(tdev, pats[8], device="cuda")
    read_launches("scan()", ("exact_count",), total)
    log(f"scan(): {r}")
    assert r["matches"] == anchors[8] and r["bytes"] == N_FULL, "scan()"
    log("mixed phase (host clock): " + ", ".join(
        f"{k} {v:.3f} s" for k, v in secs.items()))
    return eng


# ---------------------------------------------------------------------------
# distribution and the command line
# ---------------------------------------------------------------------------

def distributed_path(tdev, codes, gates, fpos, named, slot_pats, dense,
                     total):
    """World size 1 on NCCL (this process, cuda:0): make_distributed over
    bench.py's five tiers and the eleven engines of the engines phase, each
    count through the halo exchange and the all-reduce, equal to its
    anchor and to the single-device count of the same scanner (count,
    count_async, scan_many); the sharded ladder (dense32's text flags the
    overflow and counts exactly, step 1; an all-match text at cap 1024,
    step 2); DistributedPositions (fp m=32 over the corpus, the exact tier
    over the 4 MiB prefix); sigma = 256 on a 64 MiB byte text.  Each group
    is driven with the launch counters at 0, then checked; the
    single-device counts it is held to are taken before, so a group's
    counts are its distributed calls' alone, and each tier and engine must
    launch its own kernel.  Returns {tier name: its DistributedCounter}."""
    import numpy as np
    import torch
    from tpu_smatcher_torch import make_distributed, make_engine, make_fast
    from tpu_smatcher_torch.core import datagen
    from tpu_smatcher_torch.core.alphabet import Alphabet
    from tpu_smatcher_torch.core.patterns import PatternSet
    from tpu_smatcher_torch.ops import cuda_filter as cf
    from tpu_smatcher_torch.parallel import DistributedPositions, make_mesh
    from tpu_smatcher_torch.parallel.dist import DistributedCounter

    mesh = make_mesh(1, device="cuda")
    log(f"distributed world 1: {mesh}")
    assert mesh.backend == "nccl" and mesh.size == 1
    ab = Alphabet.dna()
    secs = {}
    t0 = time.perf_counter()
    tiers, single, got, own = {}, {}, {}, {}
    for name, m, p, anchor in TIERS:
        tiers[name] = make_distributed("fast", PatternSet(codes[name], ab),
                                       mesh)
        single[name] = tiers[name].fast.count(tdev)
    reset_launches()
    for name, m, p, anchor in TIERS:
        dc = tiers[name]
        got[name], own[name] = launched(lambda: (
            dc.count(tdev), dc.count_async(tdev).result(),
            dc.scan_many([tdev, tdev[:N_GATE]])))
    read_launches("distributed world 1 tiers", (
        "exact_count_guard", "cascade", "compact_valrows", "verify"), total)
    for name, m, p, anchor in TIERS:
        kern = "exact_count_guard" if name == "exact" else "cascade"
        assert own[name][kern] > 0, f"distributed {name}: no {kern} launch"
        (c, a, many), single_c = got[name], single[name]
        log(f"distributed tier {name} (m={m} p={p}): count {c}, count_async "
            f"{a}, scan_many (corpus, 4 MiB prefix) {many}; single-device "
            f"{single_c} (anchor {anchor}, gate {len(gates[name])}); "
            f"launches {own[name]}")
        assert c == a == single_c == anchor, \
            f"distributed {name}: {c} / {a}"
        assert many == [anchor, len(gates[name])], f"{name}: {many}"
    secs["tiers"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    pats = bench_pattern_sets(codes)
    anchors = {m: a for _, m, p, a in TIERS if p == 10_000}
    dcs = {(name, m): make_distributed(name, pats[m], mesh)
           for name, m in ENGINE_RUNS}
    single = {key: named[key].count(tdev) for key in dcs}
    reset_launches()
    got, own = {}, {}
    for key, dc in dcs.items():
        got[key], own[key] = launched(lambda: (
            dc.count(tdev), dc.count_async(tdev).result(),
            dc.scan_many([tdev, tdev])))
    read_launches("distributed world 1 engines", ("stages", "words_view"),
                  total)
    for (name, m), (c, a, many) in got.items():
        log(f"distributed engine {name} m={m}: count {c}, count_async {a}, "
            f"scan_many {many}, single-device {single[name, m]} (anchor "
            f"{anchors[m]}); stages launches {own[name, m]['stages']}")
        assert own[name, m]["stages"] > 0, f"distributed {name} m={m}: " \
            "the core launched no stage chain"
        assert c == a == single[name, m] == anchors[m], \
            f"distributed {name} m={m}"
        assert many == [c, c], f"distributed {name} m={m}: {many}"
    secs["engines"] = time.perf_counter() - t0

    # the sharded ladder: step 1 on dense32's text (over its SLOT_BITS
    # tables), step 2 on an all-match text (a filter_mask launch per dense
    # pass and per piece)
    t0 = time.perf_counter()
    _, t2, d_truth = dense
    reset_launches()
    ladder = slot_scanner(slot_pats, mesh.device)
    dc = DistributedCounter(ladder.core, mesh, m=slot_pats.m,
                            sigma=slot_pats.sigma, fast=ladder)
    raw = dc.count_with_overflow(t2)
    mask0 = cf.LAUNCHES["filter_mask"]
    d_count = dc.count(t2)
    d_passes = cf.LAUNCHES["filter_mask"] - mask0
    z = torch.zeros(ALL_MATCH_N, dtype=torch.uint8, device="cuda")
    dz = make_distributed("fast", PatternSet(np.zeros((1, 16), np.uint8), ab),
                          mesh, cap=ALL_MATCH_CAP)
    z_raw = dz.count_with_overflow(z)
    mask0 = cf.LAUNCHES["filter_mask"]
    z_count = dz.count(z)
    z_passes = cf.LAUNCHES["filter_mask"] - mask0
    read_launches("distributed ladder", ("filter_slots", "filter_mask",
                                         "words_view"), total)
    secs["ladder"] = time.perf_counter() - t0
    log(f"distributed ladder: dense32 raw {raw}, count {d_count} (truth "
        f"{d_truth}), {d_passes} dense passes; all-match ({ALL_MATCH_N} "
        f"bytes, cap {ALL_MATCH_CAP}) raw {z_raw}, count {z_count} (truth "
        f"{ALL_MATCH_N - 15}), {z_passes} dense passes (the dense shard "
        f"pass, then the pieces), {secs['ladder']:.1f} s")
    assert raw[1] and d_count == d_truth, "distributed ladder step 1"
    assert z_raw[1] and z_count == ALL_MATCH_N - 15, "ladder step 2"
    assert z_passes > 2, "the all-match text did not reach the pieces"

    t0 = time.perf_counter()
    reset_launches()
    dpos = DistributedPositions(tiers["fp"].fast, mesh).positions(tdev)
    epos = DistributedPositions(tiers["exact"].fast, mesh).positions(
        tdev[:N_GATE])
    read_launches("distributed positions", (
        "exact_mask", "filter_mask", "words_view"), total)
    secs["positions"] = time.perf_counter() - t0
    log(f"distributed positions: fp m=32 {len(dpos)} (FastScanner "
        f"{len(fpos)}), exact on the 4 MiB prefix {len(epos)} (gate "
        f"{len(gates['exact'])})")
    assert np.array_equal(dpos, fpos), "distributed fp positions"
    assert np.array_equal(epos, gates["exact"]), "distributed exact pos"

    # sigma = 256: test_sigma256_wrap_correction's and
    # _zero_pad_pattern_subtracted's cases at 64 MiB
    t0 = time.perf_counter()
    ab256 = Alphabet.byte()
    stext = datagen.generate_text(S256_N, ab256, seed=33)
    spats = datagen.generate_patterns(stext, 32, 8, ab256, frac_present=0.6,
                                      seed=34)
    stext = datagen.plant(stext, spats.codes[0], [S256_N - 8, S256_N - 11])
    zpats = PatternSet(np.zeros((1, 8), np.uint8), ab256)
    ztext = datagen.plant(stext, zpats.codes[0], [500, S256_N - 8])
    cases = {}
    for label, ps, host in (("wm", spats, stext), ("fast", spats, stext),
                            ("ac", spats, stext), ("wm zero", zpats, ztext)):
        name = label.split()[0]
        t = torch.from_numpy(host).cuda()
        one = make_fast(ps) if name == "fast" else make_engine(name, ps)
        cases[label] = (make_distributed(name, ps, mesh), t, host,
                        one.count(t))
    reset_launches()
    got = {}
    for label, (dc, t, host, one) in cases.items():
        (c, h), own = launched(lambda: (dc.count(t), dc.count(host)))
        got[label] = (c, h, one)
        if label != "fast":
            assert own["stages"] > 0, f"distributed sigma=256 {label}"
    read_launches("distributed sigma=256", ("stages", "words_view"), total)
    secs["sigma256"] = time.perf_counter() - t0
    log(f"distributed sigma=256 ({S256_N} bytes; device shard, host text, "
        f"single device): {got}")
    for label, (c, h, one) in got.items():
        assert c == h == one >= (2 if "zero" in label else 1), label
    log("distributed world 1 phases (host clock): " + ", ".join(
        f"{k} {v:.1f} s" for k, v in secs.items()))
    return tiers


def world2_path(text, tdev, codes, total):
    """World size 2 on gloo, both ranks on cuda:0 (NCCL refuses two ranks
    on one card): two spawned processes of this script (rank_main) read
    their halves of the corpus from a file (load_corpus_shards) and count
    the three anchors through make_distributed("fast") and one engine per
    stage kind, and the corpus with pattern 0 of the m=8 set planted across
    the rank boundary at each offset from -(m-1) to 0, against this
    process's single-device counts.  A failing rank fails the run.  Returns
    the ranks' results."""
    import tempfile
    import torch
    from tpu_smatcher_torch import make_fast

    t_start = time.perf_counter()
    pats = bench_pattern_sets(codes)
    anchors = {m: a for _, m, p, a in TIERS if p == 10_000}
    per = N_FULL // 2
    p0 = torch.from_numpy(pats[8].codes[0]).cuda()
    one = make_fast(pats[8])
    plants = {}
    for d in W2_OFFSETS:
        t = tdev.clone()
        t[per + d:per + d + 8] = p0
        plants[str(d)] = one.count(t)
        del t
    with tempfile.TemporaryDirectory() as tmp:
        text.tofile(os.path.join(tmp, "corpus.bin"))
        for m, ps in pats.items():
            ps.save(os.path.join(tmp, f"pats{m}.npz"))
        cmd = [sys.executable, os.path.abspath(__file__), "--rank"]
        procs = [subprocess.Popen(cmd + [str(r), "2", tmp],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            outs = [p.communicate(timeout=W2_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, out) in enumerate(zip(procs, outs)):
            for line in out.strip().splitlines():
                log(f"  [rank {r}] {line}")
            assert p.returncode == 0, f"world 2: rank {r} rc {p.returncode}"
        results = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                results.append(json.load(f))
    for r, res in enumerate(results):
        assert res["backend"] == "gloo" and res["device"] == "cuda:0", res
        for m, c in res["fast"].items():
            assert c == anchors[int(m)], f"world 2 rank {r} fast m={m}: {c}"
        for key, c in res["engines"].items():
            m = int(key.split("=")[1])
            assert c == anchors[m], f"world 2 rank {r} {key}: {c}"
        assert res["plants"] == plants, \
            f"world 2 rank {r} plants {res['plants']} != {plants}"
        for k, v in res["launches"].items():
            total[k] += v
        for k in ("exact_count_guard", "cascade", "compact_valrows",
                  "verify", "stages", "words_view"):
            assert res["launches"][k] > 0, f"world 2 rank {r}: {k}"
    log(f"world 2: boundary plants at offsets {list(W2_OFFSETS)}: counts "
        f"{plants} (single device) on both ranks; launches per rank "
        f"{[res['launches'] for res in results]}; phase "
        f"{time.perf_counter() - t_start:.1f} s")
    return results


def rank_main(argv):
    """One rank of world2_path: argv[2] is the rank, argv[3] the world
    size, argv[4] the directory with the corpus, the pattern sets and the
    group's FileStore.  Writes rank<r>.json there."""
    import torch
    import torch.distributed as dist
    from tpu_smatcher_torch import make_distributed
    from tpu_smatcher_torch.core.patterns import PatternSet
    from tpu_smatcher_torch.ops import cuda_filter as cf
    from tpu_smatcher_torch.parallel import (init_distributed,
                                             load_corpus_shards, make_mesh)
    rank, world, tmp = int(argv[2]), int(argv[3]), argv[4]
    t0 = time.perf_counter()
    init_distributed(num_processes=world, process_id=rank, device="cuda",
                     store=dist.FileStore(os.path.join(tmp, "store"), world))
    mesh = make_mesh(world, device="cuda")
    shard, n = load_corpus_shards(os.path.join(tmp, "corpus.bin"), mesh,
                                  sigma=4)
    pats = {m: PatternSet.load(os.path.join(tmp, f"pats{m}.npz"))
            for m in (8, 16, 32)}
    log(f"{mesh}: shard of {int(shard.shape[0])} bytes read in "
        f"{time.perf_counter() - t0:.1f} s")
    reset_launches()
    fast = {m: make_distributed("fast", ps, mesh) for m, ps in pats.items()}
    out = {"backend": mesh.backend, "device": str(mesh.device)}
    out["fast"] = {str(m): dc.count(shard, n=n) for m, dc in fast.items()}
    out["engines"] = {f"{name} m={m}": make_distributed(
        name, pats[m], mesh).count(shard, n=n) for name, m in W2_ENGINES}
    per = int(shard.shape[0])
    lo = rank * per
    p0 = torch.from_numpy(pats[8].codes[0]).cuda()
    out["plants"] = {}
    for d in W2_OFFSETS:
        g = per + d                       # the plant's global start
        a, b = max(g, lo), min(g + 8, lo + per)
        s = shard.clone()
        if a < b:
            s[a - lo:b - lo] = p0[a - g:b - g]
        out["plants"][str(d)] = fast[8].count(s, n=n)
        del s
    out["launches"] = counters()
    out["ms"] = {str(m): cuda_ms(lambda: dc.count_async(shard, n=n).result())
                 for m, dc in fast.items()}
    log(f"counts {out['fast']} {out['engines']}; ms/scan {out['ms']}; "
        f"{time.perf_counter() - t0:.1f} s")
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def cli_path(text, codes, gates, fpos, total):
    """The command line: --algo all --verify on the 4 MiB prefix and on the
    whole corpus with the m=8 p=10k set (in this process, launches counted;
    every engine agrees with the ground truth, the native library's count
    on the corpus), --stream --positions on the corpus with the
    m=32 set (5,000 positions, as FastScanner's), and `python -m
    tpu_smatcher_torch.cli ... --devices 2` (two gloo ranks on cuda:0, the
    same count)."""
    import io
    import tempfile
    import numpy as np
    from tpu_smatcher_torch import cli

    t0 = time.perf_counter()
    pats = bench_pattern_sets(codes)
    gate = len(gates["exact"])

    def run_cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                cli.main(argv)
            except SystemExit as e:
                raise AssertionError(f"cli {argv} exited {e.code}") from e
        return buf.getvalue()

    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "prefix.bin")
        corpus = os.path.join(tmp, "corpus.bin")
        text[:N_GATE].tofile(prefix)
        text.tofile(corpus)
        p8 = pats[8].save(os.path.join(tmp, "p8.npz"))
        p32 = pats[32].save(os.path.join(tmp, "p32.npz"))
        base = ["--text", prefix, "--patterns", p8, "--m", "8",
                "--alphabet", "4"]
        reset_launches()
        out = run_cli(base + ["--algo", "all", "--verify"])
        read_launches("cli --algo all", ("exact_count", "stages",
                                         "stages_flat"), total)
        res = json.loads(out.strip().splitlines()[-1])
        log("cli --algo all --verify (4 MiB): " + " | ".join(
            line for line in out.strip().splitlines()[:-1]))
        assert "ALL ENGINES AGREE" in out, "cli: engines disagree"
        assert [r["engine"] for r in res] == ["ac", "sh", "sbom", "wm",
                                              "fast", "sog8"]
        assert all(r["matches"] == r["ground_truth"] == gate for r in res)

        # the same on the whole corpus: the ground truth is the native
        # library's threaded count
        reset_launches()
        out, secs = timed(lambda: run_cli(
            ["--text", corpus] + base[2:] + ["--algo", "all", "--verify"]))
        read_launches("cli --algo all (256 MiB)", ("exact_count", "stages",
                                                   "stages_flat"), total)
        res = json.loads(out.strip().splitlines()[-1])
        log(f"cli --algo all --verify (256 MiB, {secs:.1f} s): " + " | ".join(
            line for line in out.strip().splitlines()[:-1]))
        assert "ALL ENGINES AGREE" in out, "cli 256 MiB: engines disagree"
        assert all(r["matches"] == r["ground_truth"] == TIERS[0][3]
                   for r in res), "cli 256 MiB --verify"

        reset_launches()
        pos_path = os.path.join(tmp, "pos.npy")
        out = run_cli(["--stream", "--text", corpus, "--patterns", p32,
                       "--m", "32", "--alphabet", "4", "--positions",
                       pos_path, "--json"])
        read_launches("cli --stream --positions", ("filter_mask",
                                                   "words_view"), total)
        pos = np.load(pos_path)
        res = json.loads(out.strip().splitlines()[-1])
        log(f"cli --stream --positions (m=32, 256 MiB): count "
            f"{res['matches']}, {len(pos)} positions")
        assert res["matches"] == len(pos) == len(fpos) == TIERS[2][3]
        assert np.array_equal(pos, fpos), "cli positions"

        # its own session, so that a timeout kills the ranks it spawns too
        p = subprocess.Popen(
            [sys.executable, "-m", "tpu_smatcher_torch.cli"] + base
            + ["--algo", "fast", "--devices", "2", "--json"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            start_new_session=True)
        try:
            out, err = p.communicate(timeout=W2_TIMEOUT_S)
        finally:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.communicate()
        log(f"cli --devices 2: rc {p.returncode}; stderr "
            f"{err.strip()[-400:]!r}; stdout {out.strip()[-300:]!r}")
        assert p.returncode == 0, "cli --devices 2 failed"
        assert "backend gloo" in err
        assert json.loads(out.strip().splitlines()[-1])[
            "matches"] == gate, "cli --devices 2 count"
    log(f"cli phase {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the native library on the card's host (tpu_smatcher_torch/native)
# ---------------------------------------------------------------------------

def native_path(text, tdev, engines, codes, total):
    """The port's native library, built from the checkout with the host's
    C++ compiler (main times the build): the five table builders at m=32 p=100k (bench.py's
    fp32_p100k set) natively and with numpy, timed, the tables equal; the
    full-corpus host truth (count_cpu_native) of the five tiers against
    make_fast's counts (driven here with the launch counters at 0) and the
    BENCH_r05.json anchors, and on the 1 MiB prefix against the numpy
    oracle, both timed; match_enum_native over the corpus against
    make_fast(m=32 p=10k).matches; load_fasta of the corpus written as
    FASTA with the native encoder and with numpy, the same bytes."""
    import dataclasses
    import tempfile
    import numpy as np
    from tpu_smatcher_torch import automata, native
    from tpu_smatcher_torch.core import corpus, datagen
    from tpu_smatcher_torch.core.alphabet import Alphabet

    t0 = time.perf_counter()
    path = native.build()            # built at start-up (main)
    assert native.load() is not None, "native library did not load"
    log(f"native: {os.path.basename(path)} loaded")

    p100k = codes["fp32_p100k"]
    for name, build, args in (("ac", automata.build_ac, ()),
                              ("sh", automata.build_sh, ()),
                              ("sbom", automata.build_sbom, ()),
                              ("wm", automata.build_wm, ()),
                              ("sog32", automata.build_sog, (32,))):
        nat, t_nat = timed(lambda: build(p100k, 4, *args, native=True))
        ref, t_np = timed(lambda: build(p100k, 4, *args, native=False))
        for f in dataclasses.fields(nat):
            x, y = getattr(nat, f.name), getattr(ref, f.name)
            assert (x.dtype == y.dtype and np.array_equal(x, y)
                    if isinstance(x, np.ndarray) else x == y), \
                f"native {name}: {f.name} differs"
        log(f"native: set-up {name} m=32 p=100k: native {t_nat:.4f} s, "
            f"numpy {t_np:.4f} s ({t_np / t_nat:.1f}x), tables equal")

    reset_launches()
    counts = {name: eng.count(tdev) for name, eng in engines}
    fp = dict(engines)["fp"]
    mpos, mids = fp.matches(tdev)
    read_launches("native (make_fast counts and matches)",
                  ("exact_count", "cascade", "compact_valrows", "verify",
                   "filter_mask", "words_view"),
                  total)
    for name, m, p, anchor in TIERS:
        got, t_full = timed(lambda: native.count_cpu_native(text,
                                                            codes[name]))
        log(f"native: host truth {name} (m={m} p={p}) {N_FULL // MiB} MiB: "
            f"{got} in {t_full:.4f} s ({N_FULL / MiB / t_full:.1f} MiB/s); "
            f"make_fast {counts[name]}, anchor {anchor}")
        assert got == counts[name] == anchor, f"native truth {name}"
        gate_nat, t_gn = timed(
            lambda: datagen.count_matches(text[:MiB], codes[name],
                                          prefer_native=True))
        gate_np, t_gp = timed(
            lambda: datagen.count_matches(text[:MiB], codes[name]))
        log(f"native: host truth {name} 1 MiB: native {gate_nat} in "
            f"{t_gn:.4f} s, numpy {gate_np} in {t_gp:.4f} s "
            f"({t_gp / t_gn:.0f}x)")
        assert gate_nat == gate_np, f"native 1 MiB truth {name}"

    (npos, nids), t_enum = timed(lambda: native.match_enum_native(
        text, codes["fp"]))
    order = np.argsort(mpos, kind="stable")
    log(f"native: match_enum fp (m=32 p=10k) {N_FULL // MiB} MiB: "
        f"{len(npos)} matches in {t_enum:.4f} s; make_fast matches "
        f"{len(mpos)}")
    assert np.array_equal(npos, mpos[order]), "native enum positions"
    assert np.array_equal(nids, mids[order]), "native enum ids"

    ab = Alphabet.dna()
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "corpus.fa")
        _, t_write = timed(lambda: write_corpus_fasta(fasta, text, ab))
        c_nat, t_nat = timed(lambda: corpus.load_fasta(fasta, ab))
        real = native.encode_fasta_native
        native.encode_fasta_native = lambda *a: None     # the numpy path
        try:
            c_np, t_np = timed(lambda: corpus.load_fasta(fasta, ab))
        finally:
            native.encode_fasta_native = real
        size = os.path.getsize(fasta)
    log(f"native: load_fasta ({size} bytes, written in {t_write:.2f} s): "
        f"native {t_nat:.4f} s, numpy {t_np:.4f} s ({t_np / t_nat:.1f}x)")
    assert np.array_equal(c_nat.codes, c_np.codes), "native FASTA bytes"
    assert np.array_equal(c_nat.codes, text), "load_fasta != the corpus"
    log(f"native phase {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the experiment and conformance tools (tpu_smatcher_torch/tools)
# ---------------------------------------------------------------------------

def conformance_path(total):
    """The cells of the reference's TPU smoke (scripts/tpu_smoke.py) that
    the phases above do not hold, at its sizes, each against datagen:
    protein m=32 p=400 over 4 MiB (count, positions, the five engines, a
    table checkpoint, count_file / positions_file, matches attribution,
    scan_many); m=256 and m=1024 through make_fast; the full fingerprint
    collision set at SLOT_BITS-bit stages (8 exact scans that retry, then
    fallback_scans no longer growing over 3 more) and at the default width
    (11 exact scans, no retry); the sigma=20 p=4000 match-dense set (2
    exact scans, no stage bumps once the dense pass is on)."""
    import tempfile
    import numpy as np
    import torch
    from tpu_smatcher_torch import make_engine, make_fast
    from tpu_smatcher_torch.core import datagen
    from tpu_smatcher_torch.core.alphabet import Alphabet
    from tpu_smatcher_torch.core.checkpoint import load_tables, save_tables
    from tpu_smatcher_torch.engines import (build_tables,
                                            make_engine_from_tables)
    from tpu_smatcher_torch.tools.find_fp_collision import collision_case

    t0 = time.perf_counter()
    checks = []

    def check(name, got, want):
        checks.append(name)
        assert got == want, f"conformance {name}: {got} != {want}"

    reset_launches()
    ab = Alphabet.protein()
    m, n = 32, 4 * MiB
    text = datagen.generate_text(n, ab, seed=11)
    pats = datagen.generate_patterns(text, 400, m, ab, frac_present=0.6,
                                     seed=12)
    truth = datagen.count_matches(text, pats)
    want_pos = np.nonzero(datagen.match_starts(text, pats))[0]
    tdev = torch.from_numpy(text).cuda()
    fast = make_fast(pats)
    check("fast count", fast.count(tdev), truth)
    check("fast positions", int(fast.positions(tdev).sum()),
          int(want_pos.sum()))
    for name in ("ac", "sh", "sbom", "wm", "sog32"):
        check(f"{name} count", make_engine(name, pats).count(tdev), truth)
    with tempfile.TemporaryDirectory() as td:
        tp = os.path.join(td, "t.npz")
        save_tables(tp, build_tables("fast", pats))
        eng = make_engine_from_tables("fast", load_tables(tp, device="cuda"),
                                      device="cuda")
        check("checkpoint round trip", eng.count(tdev), truth)
        cp = os.path.join(td, "c.bin")
        text.tofile(cp)
        check("count_file", fast.count_file(cp, chunk=MiB), truth)
        check("positions_file", int(fast.positions_file(cp, chunk=MiB)
                                    .sum()), int(want_pos.sum()))
    mpos, mids = fast.matches(tdev)
    win = text[np.asarray(mpos)[:, None] + np.arange(m)]
    check("matches attribution",
          bool((win == pats.codes[np.asarray(mids)]).all())
          and int(mpos.size), truth)
    check("scan_many", fast.scan_many([tdev, tdev[:2 * MiB], tdev]),
          [truth, datagen.count_matches(text[:2 * MiB], pats), truth])
    log(f"  protein m=32 p=400 (4 MiB): count {truth}, {len(want_pos)} "
        f"positions, five engines, checkpoint, files, matches, scan_many")

    text = datagen.generate_text(4 * MiB, ab, seed=13)
    tdev = torch.from_numpy(text).cuda()
    for m_long, p_long, seed in ((256, 50, 14), (1024, 20, 15)):
        lp = datagen.generate_patterns(text, p_long, m_long, ab,
                                       frac_present=0.6, seed=seed)
        c = make_fast(lp).count(tdev)
        check(f"fast count m={m_long}", c, datagen.count_matches(text, lp))
        log(f"  m={m_long} p={p_long} (4 MiB): {c}")

    # windows x and x + FP_COLLISION_D share the three base fingerprints,
    # so x passes every derived stage of pattern x + d: planted every 96
    # bytes they overflow SLOT_BITS tables' per-block slots until the
    # scanner adapts; at the default width the cascade's row slots hold them
    atext, apats = collision_case(2 * MiB)
    atruth = datagen.count_matches(atext, apats)
    afast = slot_scanner(apats)
    adev = torch.from_numpy(atext).cuda()
    check("fp collision, 8 scans", [afast.count(adev) for _ in range(8)],
          [atruth] * 8)
    mid = afast.fallback_scans
    check("fp collision retried", mid >= 1, True)
    for _ in range(3):
        afast.count(adev)
    check("fp collision converged", afast.fallback_scans, mid)
    log(f"  fp collision (2 MiB, {SLOT_BITS}-bit stages): {atruth} x 8, "
        f"fallback_scans {mid}, _k_extra {afast._k_extra}, _match_dense "
        f"{afast._match_dense}")
    bfast = make_fast(apats)
    check("fp collision at the default width, 11 scans",
          [bfast.count(adev) for _ in range(11)], [atruth] * 11)
    check("fp collision at the default width, no retry",
          bfast.fallback_scans, 0)
    log(f"  fp collision (2 MiB, {bfast.ft.stage_bits}-bit stages): "
        f"{atruth} x 11, fallback_scans 0")

    ab20 = Alphabet.of_size(20)
    dtext = datagen.generate_text(2 * MiB, ab20, seed=21)
    dpats = datagen.generate_patterns(dtext, 4000, 8, ab20,
                                      frac_present=0.9, seed=22)
    dtruth = datagen.count_matches(dtext, dpats)
    dfast = make_fast(dpats)
    ddev = torch.from_numpy(dtext).cuda()
    check("match-dense, 2 scans", (dfast.count(ddev), dfast.count(ddev)),
          (dtruth, dtruth))
    if dfast._match_dense:
        check("match-dense switch, no stage bumps", dfast._k_extra, 0)
    log(f"  match-dense sigma=20 p=4000 (2 MiB): {dtruth} x 2, "
        f"_match_dense {dfast._match_dense}, _k_extra {dfast._k_extra}")
    read_launches("conformance", CONFORMANCE_KERNELS, total)
    log(f"conformance phase: {len(checks)} checks held, "
        f"{time.perf_counter() - t0:.1f} s")


def soak_path(total):
    """tools.soak on the card: the 60 trials, their distributed ones in
    one group of four gloo ranks sharing cuda:0 (their launches added)."""
    from tpu_smatcher_torch.tools import soak
    reset_launches()
    res = soak.soak(device="cuda", log=lambda s: log(f"  {s}"))
    read_launches("soak", SOAK_KERNELS, total)
    assert not res["failures"], f"soak: {res['failures']}"
    assert len(res["ranks"]) == soak.DIST_WORLD and res["dist_trials"]
    for r, rank in enumerate(res["ranks"]):
        assert rank["backend"] == "gloo" and rank["device"] == "cuda:0", \
            f"soak rank {r}: {rank['backend']} {rank['device']}"
        assert not rank["imports_jax"], rank["imports_jax"]
        for k, v in rank["launches"].items():
            total[k] += v
    log(f"soak phase: {res['trials']}/{res['trials']} trials held, "
        f"{len(res['dist_trials'])} on {soak.DIST_WORLD} ranks (launches "
        f"per rank {[r['launches'] for r in res['ranks']]}), "
        f"{res['seconds']:.1f} s")


def sweep_path(total):
    """tools.sweep at the reference's full corpus sizes: 12 (corpus, p)
    shapes x six engines, counts equal across engines and to datagen on
    each 1 MiB prefix, every repeat's sum q x count below 2^31."""
    from tpu_smatcher_torch.tools import sweep
    reset_launches()
    res = sweep.sweep(device="cuda", window=SWEEP_WINDOW_S,
                      log=lambda s: log(f"  {s}"))
    read_launches("sweep", SWEEP_KERNELS, total)
    assert not res["failures"], f"sweep: {res['failures']}"
    lines = [r for r in res["records"] if "matches" in r]
    assert len(lines) == len(sweep.CORPORA) * len(sweep.P_SIZES) * len(
        sweep.DEFAULT_ENGINES), f"sweep: {len(lines)} lines"
    assert all(r["queue"] * r["matches"] <= sweep.INT32_MAX for r in lines)
    log(f"sweep phase: {len(lines)} lines, {res['seconds']:.1f} s")


def ladder_path(total):
    """tools.ladder at its defaults (64 MiB DNA, m=8, p=1000): every rung
    of the five engines and make_fast holds parity with datagen."""
    from tpu_smatcher_torch.tools import ladder
    t0 = time.perf_counter()
    reset_launches()
    rows = ladder.ladder(device="cuda", log=lambda s: log(f"  {s}"))
    read_launches("ladder", LADDER_KERNELS, total)
    assert all(r["parity"] for r in rows) and len(rows) == 5 * 5 + 1
    log(f"ladder phase: {len(rows)} rungs held, "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# timings
# ---------------------------------------------------------------------------

def path_times(card, label, eng, t, scan):
    """Main path ms/scan on the kernels and on the plain versions, and a
    torch.profiler breakdown of the kernel path."""
    n = int(t.shape[0])
    k_ms = cuda_ms(lambda: scan(eng, t))
    with plain_kernels():
        p_ms = cuda_ms(lambda: scan(eng, t))
    log(f"[{card}] {label}: main path {k_ms:.3f} ms/scan "
        f"({n / k_ms / 1e6:.2f} GB/s) on the kernels, {p_ms:.3f} ms/scan "
        f"({n / p_ms / 1e6:.2f} GB/s) on the plain versions")
    profile(card, label, lambda: scan(eng, t))
    return k_ms


#: the __global__ functions of tpu_smatcher_torch/csrc
KERNEL_SYMBOLS = ("exact_kernel", "cascade_kernel", "filter_kernel",
                  "words_kernel", "stages_kernel")
#: profiler sessions profile() tries for one with every port kernel's
#: record: torch.profiler drops kernel records now and then in a long run
PROFILE_TRIES = 5


def profile(card, label, fn, reps=3):
    """Per scan: wall time (host clock), device busy time (the sum of the
    device's kernel and copy events), the share of the wall the device
    idles, and the three device events that take most, each with the
    number of its events the profiler recorded over the reps.  Each
    session traces reps scans after a warm-up step of reps untraced ones
    (the profiler's schedule).  The port's kernel events are held against
    their launch counts: a session that lost a record is run again, up to
    PROFILE_TRIES sessions, and the line says LOST RECORDS if none kept
    them all (its busy time and idle share are then not measured)."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from tpu_smatcher_torch.ops import cuda_filter as cf
    fn()
    torch.cuda.synchronize()
    for session in range(1, PROFILE_TRIES + 1):
        with torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                                 repeat=1)) as prof:
            for step in (0, 1):
                before = dict(cf.LAUNCHES)
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / reps
                prof.step()
        launches = sum(v - before[k] for k, v in cf.LAUNCHES.items())
        dev, events = collections.Counter(), collections.Counter()
        for e in prof.events():
            # the schedule's step annotation spans the step on the device
            if e.device_type == DeviceType.CUDA and \
                    not e.name.startswith("ProfilerStep"):
                dev[e.name] += e.time_range.elapsed_us() / 1e3 / reps
                events[e.name] += 1
        ours = sum(n for name, n in events.items()
                   if any(f"::{k}" in name for k in KERNEL_SYMBOLS))
        if ours == launches:
            break
    busy = sum(dev.values())
    top = ", ".join(f"{name[:48]} {ms:.3f} ms ({events[name]} events)"
                    for name, ms in dev.most_common(3))
    lost = "" if ours == launches else "; LOST RECORDS"
    log(f"[{card}] {label} profile: wall {wall:.3f} ms/scan, device busy "
        f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}; port kernels "
        f"{ours} events of {launches} launches (session {session}){lost}; "
        f"top: {top}")


def host_breakdown(card, label, fn, reps=20, rows=10):
    """Where the host's time per call of fn goes: the wall per call (host
    clock, fn's result read back), the torch.profiler CPU-side self time
    of the ops it ran, summed and the `rows` largest by op, each with its
    calls per fn() call.  The wall less the ops' self time is Python and
    the wait for the device."""
    import torch
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(reps):
            fn()
    ops = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                 reverse=True)
    own = sum(e.self_cpu_time_total for e in ops) / reps / 1e3
    log(f"[{card}] {label} host breakdown: wall {wall:.3f} ms/call, ops' "
        f"self CPU {own:.3f} ms/call; " + ", ".join(
            f"{e.key} {e.self_cpu_time_total / reps:.1f} us "
            f"({e.count / reps:g}/call)" for e in ops[:rows]))


def kernel_time(card, ck, label, name, kern, plain, bnd, library=None):
    """Holds the kernel against its plain version on the main path's inputs
    (exactly), then times both and the library call."""
    ck.same(name, kern(), plain(), f"{label} (main-path inputs)")
    ms, p_ms = cuda_ms(kern), cuda_ms(plain)
    lib_ms = cuda_ms(library) if library is not None else None
    log(f"[{card}] {label}: {name} kernel {ms:.3f} ms vs plain {p_ms:.3f} ms"
        f", bound {bnd[0]:.4f} ms by {bnd[1]}"
        + (f", library call {lib_ms:.3f} ms" if library is not None else ""))
    return {"ms": ms, "plain_ms": p_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": lib_ms}


def compact_time(card, ck, label, slots, ovf, cap):
    """compact_rows held against its plain version on the cascade's slots
    (exactly), then both timed, the kernel one call at a time on a cold L2
    (cold_ms), as a count runs it; the bound reads the slots once and writes
    the outputs once."""
    from tpu_smatcher_torch.ops import cuda_filter as cf
    kern = functools.partial(cf.compact_rows, slots, ovf, cap=cap)
    plain = functools.partial(cf.compact_rows_plain, slots, ovf, cap=cap)
    ck.same("compact_valrows", kern(), plain(), f"{label} (main-path inputs)")
    ms, p_ms = cold_ms(kern, reps=4 * REPS), cuda_ms(plain)
    bnd = bound(slots.numel() * 4 + 4 + cap * 8 + 8 + 4, 0)
    log(f"[{card}] {label}: compact_valrows kernel {ms:.4f} ms, L2 cold "
        f"({int(slots.shape[0])} rows, cap {cap}) vs plain {p_ms:.3f} ms, "
        f"bound {bnd[0]:.4f} ms by {bnd[1]} ({bnd[0] / ms:.1%})")
    return {"ms": ms, "plain_ms": p_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": None}


def verify_time(card, ck, label, text, idxs, n_cand, ft):
    """verify_count_live held against its plain version on the cascade
    route's compacted candidates (exactly), then both timed, the kernel one
    call at a time on a cold L2 (cold_ms), as a count runs it; the bound
    reads each live candidate's start, its window's m bytes, its bucket's
    fp2 words and id and its pattern's words once, and writes the count."""
    from tpu_smatcher_torch.ops import cuda_filter as cf
    kern = functools.partial(cf.verify_count_live, text, idxs, n_cand, ft)
    plain = functools.partial(cf.verify_count_live_plain, text, idxs, n_cand,
                              ft)
    ck.same("verify", kern(), plain(), f"{label} (main-path inputs)")
    ms, p_ms = cold_ms(kern, reps=4 * REPS), cuda_ms(plain)
    live = min(int(n_cand), int(idxs.shape[0]))
    bnd = bound(live * (8 + ft.m + 4 * ft.lmax + 4 + 4 * ft.words) + 8 + 4,
                live * 3 * 2 * ft.m)
    log(f"[{card}] {label}: verify kernel {ms:.4f} ms, L2 cold ({live} "
        f"candidates, cap {int(idxs.shape[0])}, m={ft.m}) vs plain "
        f"{p_ms:.3f} ms, bound {bnd[0]:.4f} ms by {bnd[1]} "
        f"({bnd[0] / ms:.1%})")
    return {"ms": ms, "plain_ms": p_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": None}


def positions_timings(card, ck, tdev, ext, engines):
    """Profiles of the positions phase's paths, and exact_mask and the
    guarded exact_count on its inputs."""
    from tpu_smatcher_torch.ops import cuda_filter as cf
    eng, fp = dict(engines)["exact"], dict(engines)["fp"]
    profile(card, "exact positions", lambda: eng.positions(tdev), reps=1)
    profile(card, "exact count_per_pattern",
            lambda: eng.count_per_pattern(tdev))
    profile(card, "fp matches", lambda: fp.matches(tdev))
    rows = tdev.view(8, -1)
    for label, e in (("exact", eng), ("fp", fp)):
        # the rows summed on the device against scan_many's host sum
        st = cuda_ms(lambda: e.count_stack(rows))
        sm = cuda_ms(lambda: sum(e.scan_many(list(rows))))
        log(f"[{card}] {label} stack of 8 rows: count_stack {st:.3f} ms, "
            f"sum(scan_many) {sm:.3f} ms")
        profile(card, f"{label} count_stack", lambda: e.count_stack(rows))
        profile(card, f"{label} sum(scan_many)",
                lambda: sum(e.scan_many(list(rows))))
    ft = eng.ft
    n, bm = int(tdev.shape[0]), ft.bitmaps[0]
    args = dict(m=ft.m, sigma=ft.sigma)
    rows = -(-(n - ft.m + 1) // cf.ROW)
    per_kernel = {"exact_mask": kernel_time(
        card, ck, "exact positions", "exact_mask",
        lambda: cf.exact_mask(tdev, bm, **args),
        lambda: cf.exact_mask_plain(tdev, bm, **args),
        bound(n + bm.numel() * 4 + rows * cf.ROW,
              (n - ft.m + 1) * (EXACT_START_OPS + GUARD_START_OPS)))}
    # a piece of the size FastScanner._drive cuts after the first overflow
    # (cap/2 matches at the text's density), one byte past its second
    # piece: a view at an odd address
    chunk = max(eng.cap // 2,
                (eng.cap // 2) * (n - ft.m + 1) // TIERS[0][3])
    piece = tdev[chunk + 1:2 * chunk + ft.m]
    kernel_time(card, ck, f"exact positions piece ({chunk} starts at "
                f"offset {chunk + 1})", "exact_mask",
                lambda: cf.exact_mask(piece, bm, **args),
                lambda: cf.exact_mask_plain(piece, bm, **args),
                bound(chunk + ft.m - 1 + bm.numel() * 4
                      + -(-chunk // cf.ROW) * cf.ROW,
                      chunk * (EXACT_START_OPS + GUARD_START_OPS)))
    ne = int(ext.shape[0])
    per_kernel["exact_count_guard"] = kernel_time(
        card, ck, "core, padded text", "exact_count_guard",
        lambda: cf.exact_count(ext, bm, guard=True, **args),
        lambda: cf.exact_count_plain(ext, bm, guard=True, **args),
        bound(ne + bm.numel() * 4 + 4,
              (ne - ft.m + 1) * (EXACT_START_OPS + GUARD_START_OPS)))
    return per_kernel


def timings(card, ck, tdev, engines, slot_eng, dense, sat):
    import torch
    import torch.nn.functional as F
    from tpu_smatcher_torch.ops import cuda_filter as cf
    from tpu_smatcher_torch.ops.fast import stages_for, words_len

    def async_scan(eng, t):
        return eng.count_async(t).result()

    def sync_scan(eng, t):
        return eng.count(t)

    per_kernel, tier_ms = {}, {}
    n = int(tdev.shape[0])
    for name, eng in engines:
        ft = eng.ft
        tier_ms[name] = path_times(card, f"tier {name}", eng, tdev,
                                   async_scan)
        if ft.exact:
            per_kernel["exact_count"] = kernel_time(
                card, ck, f"tier {name}", "exact_count",
                lambda: cf.exact_count(tdev, ft.bitmaps[0], m=ft.m,
                                       sigma=ft.sigma),
                lambda: cf.exact_count_plain(tdev, ft.bitmaps[0], m=ft.m,
                                             sigma=ft.sigma),
                bound(n + ft.bitmaps[0].numel() * 4 + 4,
                      (n - ft.m + 1) * EXACT_START_OPS))
            continue
        _, k1, kt = route_of(eng, n)
        args = dict(m=ft.m, k1=k1, cd=ft.cd(kt))
        kern = functools.partial(cf.cascade, tdev, ft.bitmaps[:kt], **args)
        plain = functools.partial(cf.cascade_plain, tdev, ft.bitmaps[:kt],
                                  **args)
        rows = -(-(n - ft.m + 1) // cf.ROW)
        bnd = bound(n + stage_bytes(ft, kt) + rows * cf.ROW_SLOTS * 4 + 4,
                    fp_filter_ops(ft, n, k1))
        if name != "fp":            # every tier's shapes held, one timed
            ck.same("cascade", kern(), plain(),
                    f"tier {name} k1={k1} kt={kt} (main-path inputs)")
            log(f"tier {name}: cascade bound {bnd[0]:.4f} ms by {bnd[1]}")
            continue
        per_kernel["cascade"] = kernel_time(
            card, ck, f"tier {name}", "cascade", kern, plain, bnd)
        per_kernel["compact_valrows"] = compact_time(
            card, ck, f"tier {name}", *kern(), eng.cap)
        idxs, _, n_cand = cf.compact_rows(*kern(), cap=eng.cap)
        per_kernel["verify"] = verify_time(card, ck, f"tier {name}", tdev,
                                           idxs, n_cand, ft)

    ft = slot_eng.ft
    path_times(card, "slot32", slot_eng, tdev, async_scan)
    _, _, ks = route_of(slot_eng, n)
    args = dict(m=ft.m, cd=ft.cd(ks))
    n_sub = -(-(n - ft.m + 1) // cf.SUB_BLOCK)
    per_kernel["filter_slots"] = kernel_time(
        card, ck, "slot32", "filter_slots",
        lambda: cf.filter_slots(tdev, ft.bitmaps[:ks], **args),
        lambda: cf.filter_slots_plain(tdev, ft.bitmaps[:ks], **args),
        bound(n + stage_bytes(ft, ks) + n_sub * (cf.BLOCK_SLOTS + 1) * 4,
              fp_filter_ops(ft, n, ks)))
    nw = words_len(n, ft.words)
    per_kernel["words_view"] = kernel_time(
        card, ck, "slot32", "words_view",
        lambda: cf.words_view(tdev, nw),
        lambda: cf.words_view_plain(tdev, nw),
        bound(n + 4 * nw, 0),
        library=lambda: F.pad(tdev, (0, 4 * nw - n)).view(torch.int32))

    d_eng, t2, _ = dense
    path_times(card, "dense32 (dense pass)", d_eng, t2, async_scan)
    ft = d_eng.ft
    k = stages_for(ft, n, d_eng.cap)
    args = dict(m=ft.m, cd=ft.cd(k))
    rows = -(-(n - ft.m + 1) // cf.ROW)
    per_kernel["filter_mask"] = kernel_time(
        card, ck, "dense32", "filter_mask",
        lambda: cf.filter_mask(t2, ft.bitmaps[:k], **args),
        lambda: cf.filter_mask_plain(t2, ft.bitmaps[:k], **args),
        bound(n + stage_bytes(ft, k) + rows * cf.ROW, fp_filter_ops(ft, n, k)))

    s_eng, t3, _ = sat
    path_times(card, "saturated (count, with the sync ladder)", s_eng, t3,
               sync_scan)
    ft = s_eng.ft
    n3 = int(t3.shape[0])
    k = stages_for(ft, n3, s_eng.cap)
    args = dict(m=ft.m, cd=ft.cd(k))
    kernel_time(card, ck, f"saturated k={k}", "filter_mask",
                lambda: cf.filter_mask(t3, ft.bitmaps[:k], **args),
                lambda: cf.filter_mask_plain(t3, ft.bitmaps[:k], **args),
                bound(n3 + stage_bytes(ft, k) + -(-(n3 - ft.m + 1) // cf.ROW)
                      * cf.ROW, fp_filter_ops(ft, n3, k)))
    return per_kernel, tier_ms


def record_stages(fn):
    """The stages() calls fn makes, as (text, chain, tables, kwargs)."""
    from tpu_smatcher_torch.ops import cuda_engines as ce
    calls = []
    real = ce.stages

    def spy(text, chain, tables, **kw):
        calls.append((text, chain, tables, kw))
        return real(text, chain, tables, **kw)

    ce.stages = spy
    try:
        fn()
    finally:
        ce.stages = real
    return calls


def pass_fractions(text, chain, tables, kw):
    """The fraction of the starts of text that pass each set of the chain's
    stages (the hit is an AND, so a set has no order), counted by the
    kernel: {frozenset of stage indices: fraction}."""
    from tpu_smatcher_torch.ops import cuda_engines as ce
    n_st = int(text.shape[0]) - kw["m"] + 1
    out = {frozenset(): 1.0}
    for r in range(1, len(chain) + 1):
        for idx in itertools.combinations(range(len(chain)), r):
            c = ce.stages(text, [chain[i] for i in idx],
                          [tables[i] for i in idx], m=kw["m"],
                          sigma=kw["sigma"], mode="count")
            out[frozenset(idx)] = int(c) / n_st
    return out


def stages_bound(text, chain, tables, kw, ft, fractions):
    """(bound(), the cheapest order) of one stage-chain call: the text read
    once, the tables and the output; per start, the guard, the count's sum
    and the stages in the order that needs the fewest operations (the hit
    is an AND).  A stage costs its test at the starts that reach it (the
    fraction passing the stages before it, from pass_fractions) and either
    its rolling update at every start or its key computed for each start
    that reaches it (start_key_ops), whichever is less."""
    n, m = int(text.shape[0]), kw["m"]
    n_st = n - m + 1
    nbytes = n + sum(t.numel() * 4 for t in tables) + {
        "count": 4, "mask": -(-n_st // 128) * 128,
        "slots": -(-n_st // 16384) * 17 * 4}[kw["mode"]]

    def cost(kind, params, reach):
        if kind == "fpset":
            roll = ROLLING_FP_OPS
            test = STAGE_TEST_OPS * stage_tests(ft, params[0])
        else:
            roll, test = STAGE_OPS[kind]
        return reach * test + min(roll, reach * start_key_ops(kind, params,
                                                              m))

    orders = []
    for order in itertools.permutations(range(len(chain))):
        ops, before = 0.0, frozenset()
        for i in order:
            ops += cost(*chain[i], fractions[before])
            before |= {i}
        orders.append((ops, order))
    ops, order = min(orders)
    ops += GUARD_START_OPS * kw.get("guard", False) + (kw["mode"] == "count")
    return bound(nbytes, n_st * ops), [chain[i][0] for i in order]


def mixed_timings(card, tdev, mixed, tier_ms):
    """The mixed scan's ms/scan beside the sum of its groups' make_fast
    tiers' in this run, and its profile."""
    ms = cuda_ms(lambda: mixed.count_async(tdev).result())
    parts = [tier_ms[name] for name, m, p, _ in TIERS
             if p == 10_000 and m in MIXED_M]
    log(f"[{card}] mixed m={'+'.join(map(str, MIXED_M))}: {ms:.3f} ms/scan "
        f"({int(tdev.shape[0]) / ms / 1e6:.2f} GB/s); its groups' make_fast "
        f"tiers {' + '.join(f'{t:.3f}' for t in parts)} = {sum(parts):.3f} "
        f"ms/scan, ratio {ms / sum(parts):.3f}")
    profile(card, "mixed count", lambda: mixed.count_async(tdev).result())


def engines_timings(card, ck, tdev, engines, tier_ms):
    """Per-scan medians of the eleven engines beside make_fast's at the same
    m, a profile per stage kind, and the stage kernel on each engine's own
    main-path inputs, held against its plain version, then timed against
    it and its bound.  Returns the JSON line's stages / stages_flat entries
    and {chain_kind: (ms, bound ms) per 256 MiB} of every chain timed."""
    from tpu_smatcher_torch.ops import cuda_engines as ce
    n = int(tdev.shape[0])
    fast = {m: tier_ms[name] for name, m, p, _ in TIERS if p == 10_000}
    for (name, m), eng in engines.items():
        ms = cuda_ms(lambda: eng.count_async(tdev).result())
        log(f"[{card}] engine {name} m={m}: {ms:.3f} ms/scan "
            f"({n / ms / 1e6:.2f} GB/s); make_fast at m={m} "
            f"{fast[m]:.3f} ms/scan")
    for key in PROFILED:
        chain = [k for k, _ in engines[key].fast_path._stages(n)[0]]
        profile(card, f"engine {key[0]} m={key[1]} ({' + '.join(chain)})",
                lambda: engines[key].count_async(tdev).result())
    log("stages / stages_flat: no single PyTorch call computes a stage "
        "chain, so their library_ms is null")
    per_kernel, chain_times = {}, {}
    for key in PROFILED:
        eng = engines[key]
        # the async scan's chain; at m=32 also count()'s (mask mode), and
        # the exact tier's guarded mask of positions() on the 4 MiB prefix
        calls = record_stages(lambda: eng.count_async(tdev).result())
        if key[1] == 32:
            calls += record_stages(lambda: eng.count(tdev))
        if key == ("ac", 8):
            calls += record_stages(lambda: eng.positions(tdev[:N_GATE]))
        for text, chain, tables, kw in calls:
            kname = "stages_flat" if kw.get("flat") else "stages"
            label = (f"engine {key[0]} m={key[1]} {kw['mode']} "
                     f"{'+'.join(k for k, _ in chain)} n={int(text.shape[0])}")
            fractions = pass_fractions(text, chain, tables, kw)
            bnd, order = stages_bound(text, chain, tables, kw,
                                      eng.fast_path.ft, fractions)
            log(f"{label}: starts passing each set of stages: " + ", ".join(
                f"{'+'.join(chain[i][0] for i in sorted(st))} {f:.6f}"
                for st, f in fractions.items() if st)
                + f"; the bound's order: {' then '.join(order)}")
            res = kernel_time(
                card, ck, label, kname,
                lambda: ce.stages(text, chain, tables, **kw),
                lambda: ce.stages_plain(text, chain, tables, **kw), bnd)
            scale = N_FULL / int(text.shape[0])     # per 256 MiB
            chain_times.setdefault(chain_kind(chain, kw), (
                res["ms"] * scale, res["bound_ms"] * scale))
            if key == JSON_TIMED[kname] and kw["mode"] == "count":
                per_kernel[kname] = res
    return per_kernel, chain_times


def distributed_timings(card, tdev, tiers, tier_ms, w2):
    """World 1 (NCCL) ms/scan of each tier beside make_fast's in this run,
    and the ratio; the world-2 ranks' ms/scan (gloo, both ranks on one
    card, each rank timing its own count_async with the other running);
    profiles of the world-1 exact and fp m=32 tiers, and the host's time
    per world-1 exact count beside the single-device one's."""
    for name, m, p, _ in TIERS:
        dc = tiers[name]
        ms = cuda_ms(lambda: dc.count_async(tdev).result())
        log(f"[{card}] distributed world 1 (nccl) {name}: {ms:.3f} ms/scan; "
            f"make_fast {tier_ms[name]:.3f} ms/scan; ratio "
            f"{ms / tier_ms[name]:.3f}")
    for r, res in enumerate(w2):
        log(f"[{card}] distributed world 2 (gloo, one card) rank {r}: "
            + ", ".join(f"m={m} {ms:.3f} ms/scan"
                        for m, ms in res["ms"].items()))
    for name in ("exact", "fp"):
        profile(card, f"distributed world 1 {name}",
                lambda: tiers[name].count_async(tdev).result())
    host_breakdown(card, "distributed world 1 exact",
                   lambda: tiers["exact"].count_async(tdev).result())
    host_breakdown(card, "single-device exact (the ladder's FastScanner)",
                   lambda: tiers["exact"].fast.count_async(tdev).result())


def sweep_timings(card):
    """The sweep's twelve shapes through make_fast at full size: the
    pipelined per-scan time (CUDA events over SWEEP_PIPELINE scans
    enqueued back to back, count_repeat_async) beside one synchronous
    scan's, a profile of the pipelined scans, and where the host's time
    goes on the smallest fingerprint-tier shape, whose scans the host's
    enqueue bounds."""
    import torch
    from tpu_smatcher_torch import make_fast
    from tpu_smatcher_torch.core import datagen
    from tpu_smatcher_torch.core.alphabet import Alphabet
    from tpu_smatcher_torch.tools import sweep
    for name, n, sigma in sweep.CORPORA:
        ab = Alphabet.of_size(sigma)
        text = datagen.generate_text(n, ab, seed=1)
        tdev = torch.from_numpy(text).cuda()
        for p in sweep.P_SIZES:
            pats = datagen.generate_patterns(text, p, 8, ab,
                                             frac_present=0.5, seed=2)
            eng = make_fast(pats)
            q = min(SWEEP_PIPELINE, sweep.INT32_MAX // max(eng.count(tdev),
                                                          1))
            one = cuda_ms(lambda: eng.count_async(tdev).result())
            rep = cuda_ms(lambda: eng.count_repeat_async(tdev, q).result())
            label = f"sweep {name} p={p} fast ({sweep.route_of(eng, n)})"
            log(f"[{card}] {label}: {rep / q:.4f} ms/scan over {q} "
                f"pipelined scans, {one:.4f} ms for one scan read back")
            profile(card, f"{label}, one call = {q} pipelined scans",
                    lambda: eng.count_repeat_async(tdev, q).result(),
                    reps=1)
            if name == "world192":
                host_breakdown(card, label,
                               lambda: eng.count_async(tdev).result())
        del tdev


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = device_info()
    log(f"card: {card}")
    from tpu_smatcher_torch import _build
    from tpu_smatcher_torch.core import datagen
    from tpu_smatcher_torch.core.alphabet import Alphabet
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    from tpu_smatcher_torch import native
    t1 = time.perf_counter()
    native.build()
    log(f"native library built in {time.perf_counter() - t1:.3f} s")

    ck = kernel_checks()
    log(f"kernel checks done at {time.perf_counter() - t0:.1f} s")

    text = datagen.generate_text(N_FULL, Alphabet.dna(), seed=7)
    tdev = torch.from_numpy(text).cuda()
    log(f"corpus: {N_FULL} bytes DNA seed 7 "
        f"({time.perf_counter() - t0:.1f} s)")
    total = {k: 0 for k in KERNELS}
    with sized_launches() as (scanned, unaligned, chains):
        engines, codes, gates = tiers_path(text, tdev, total)
        pats, slot_eng, gate0, full0 = slot32_path(text, tdev, total)
        dense = dense32_path(text, tdev, pats, gate0, full0, total)
        sat = saturated_path(text, tdev, total)
        t1 = time.perf_counter()
        ext, fpos = positions_path(text, tdev, engines, codes, dense, sat,
                                   total)
        t2 = time.perf_counter()
        named = engines_path(text, tdev, codes, fpos, pats, total)
        t3 = time.perf_counter()
        mixed = mixed_path(text, tdev, codes, gates, total)
        t4 = time.perf_counter()
        tiers = distributed_path(tdev, codes, gates, fpos, named,
                                 pats, dense, total)
        t5 = time.perf_counter()
        w2 = world2_path(text, tdev, codes, total)
        t6 = time.perf_counter()
        cli_path(text, codes, gates, fpos, total)
        t7n = time.perf_counter()
        native_path(text, tdev, engines, codes, total)
        t7 = time.perf_counter()
        conformance_path(total)
        t8 = time.perf_counter()
        soak_path(total)
        t9 = time.perf_counter()
        sweep_path(total)
        t10 = time.perf_counter()
        ladder_path(total)
    log(f"main paths done at {time.perf_counter() - t0:.1f} s (positions "
        f"phase {t2 - t1:.1f} s, engines phase {t3 - t2:.1f} s, mixed "
        f"phase {t4 - t3:.1f} s, distributed world 1 {t5 - t4:.1f} s, "
        f"world 2 {t6 - t5:.1f} s, cli {t7n - t6:.1f} s, native "
        f"{t7 - t7n:.1f} s, conformance "
        f"{t8 - t7:.1f} s, soak {t9 - t8:.1f} s, sweep {t10 - t9:.1f} s, "
        f"ladder {time.perf_counter() - t10:.1f} s); launches {total}")
    per_kernel, tier_ms = timings(card, ck, tdev, engines, slot_eng, dense,
                                  sat)
    t1 = time.perf_counter()
    per_kernel.update(positions_timings(card, ck, tdev, ext, engines))
    t2 = time.perf_counter()
    engine_kernels, chain_times = engines_timings(card, ck, tdev, named,
                                                  tier_ms)
    per_kernel.update(engine_kernels)
    mixed_timings(card, tdev, mixed, tier_ms)
    distributed_timings(card, tdev, tiers, tier_ms, w2)
    t3 = time.perf_counter()
    sweep_timings(card)
    log(f"sweep timings {time.perf_counter() - t3:.1f} s")
    log(f"timings done at {time.perf_counter() - t0:.1f} s (positions "
        f"phase {t2 - t1:.1f} s, engines phase "
        f"{time.perf_counter() - t2:.1f} s)")

    size_weighted(total, scanned, per_kernel, chains, chain_times)
    log("launches on texts at addresses not 16-byte aligned: " + ", ".join(
        f"{k} {unaligned[k]} of {total[k]}" for k in total if total[k]))
    from tpu_smatcher_torch.ops import cuda_filter as cf
    log(f"exact kernel launches by path since the start: {cf.EXACT_PATHS}")

    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": total[k], "max_abs_err": ck.max_err[k],
                **per_kernel[k]} for k, (_, _, src, rep) in KERNELS.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv) if sys.argv[1:2] == ["--rank"] else main())
