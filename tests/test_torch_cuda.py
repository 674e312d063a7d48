"""PyTorch port on the card: each CUDA kernel equals its plain torch
version bit for bit, every route of the fast path and every named engine
counts exactly through the kernels, and the async paths do not wait for
the device.

These tests need a CUDA device and skip without one.  They import no JAX,
so they run where only the port is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from tpu_smatcher_torch import kernel_cases as kc
from tpu_smatcher_torch import make_engine, make_fast
from tpu_smatcher_torch.core import datagen
from tpu_smatcher_torch.ops import cuda_engines as ce
from tpu_smatcher_torch.ops import cuda_filter as cf
from tpu_smatcher_torch.ops import fast as tfast
from tpu_smatcher_torch.ops.common import bits_per_char

from torch_cases import (CASES, dense_case, edge_starts, make_case,
                         random_stages, wide_case)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("sigma,m,p", [(2, 8, 16), (2, 16, 16), (4, 8, 200),
                                       (4, 1, 2), (256, 2, 200)])
def test_exact_kernel_matches_plain(cuda, sigma, m, p):
    """The unguarded exact count equals its plain version and the ground
    truth on short, ragged and long texts, on start counts around a run
    and a tile, at m=1 and sigma=256, and on a text at an odd address
    (staged from the aligned address below it)."""
    text, pats = make_case(sigma, m, p, 300_007, seed=3 * sigma + m)
    bm = tfast.build_fast(pats.codes, sigma, device=cuda).bitmaps[0]
    ns = [m, 127, 300_007] + [m - 1 + s for s in kc.exact_edge_starts()]
    for n in ns:
        t = torch.from_numpy(text[:n].copy()).to(cuda)
        before = cf.LAUNCHES["exact_count"]
        got = cf.exact_count(t, bm, m=m, sigma=sigma)
        torch.cuda.synchronize()
        assert cf.LAUNCHES["exact_count"] == before + 1
        assert int(got) == int(cf.exact_count_plain(t, bm, m=m, sigma=sigma))
        assert int(got) == datagen.count_matches(text[:n], pats)
    t = torch.from_numpy(text).to(cuda)[1:]
    assert t.data_ptr() % 16
    assert int(cf.exact_count(t, bm, m=m, sigma=sigma)) == \
        int(cf.exact_count_plain(t, bm, m=m, sigma=sigma)) == \
        datagen.count_matches(text[1:], pats)


def _check_cascade(cuda, text, pats, stage_bits=None):
    tft = tfast.build_fast(pats.codes, pats.sigma, stage_bits=stage_bits,
                           device=cuda)
    eng = tfast.FastScanner(tft)
    n = len(text)
    _, k1, kt = eng._route_costs(n, tfast.stages_for(tft, n, eng.cap))[
        "cascade"]
    t = torch.from_numpy(text).to(cuda)
    before = cf.LAUNCHES["cascade"]
    slots, ovf = cf.cascade(t, tft.bitmaps[:kt], m=pats.m, k1=k1,
                            cd=tft.cd(kt))
    torch.cuda.synchronize()
    assert cf.LAUNCHES["cascade"] == before + 1
    ps, po = cf.cascade_plain(t, tft.bitmaps[:kt], m=pats.m, k1=k1,
                              cd=tft.cd(kt))
    assert torch.equal(slots, ps)
    assert int(ovf) == int(po)
    return int(ovf)


@pytest.mark.parametrize("m,sigma", [(8, 20), (16, 4), (32, 4), (129, 4),
                                     (513, 4), (16, 256)])
def test_cascade_kernel_matches_plain(cuda, m, sigma):
    """The cascade equals its plain version on a long text and on start
    counts around a run and a tile."""
    text, pats = make_case(sigma, m, 3000, 200_003, seed=m)
    assert _check_cascade(cuda, text, pats) == 0
    for s in kc.cascade_edge_starts():
        _check_cascade(cuda, text[:m - 1 + s].copy(), pats)


@pytest.mark.parametrize("m", [1, 32, 4097])
@pytest.mark.parametrize("k1", [6, 12, 14])
def test_cascade_kernel_on_wide_stages_matches_plain(cuda, m, k1):
    """131,072-bit stages, p=100k's width: phase 1's k1 stages in shared
    memory at k1=6 (96 KB) and k1=12 (192 KB), through the read-only cache
    at k1=14 (224 KB does not fit beside the text tiles); bytes up to 255;
    m=1 and m=4097.  Bits set with probability 0.8, so rows overflow at
    k1=6."""
    kt = k1 + 2
    bitmaps = torch.from_numpy(random_stages(kt, 131072, 0.8, seed=k1)).to(
        cuda)
    rng = np.random.default_rng(m)
    text = rng.integers(0, 256, m - 1 + 2 * kc.CASCADE_TILE + 77).astype(
        np.uint8)
    t = torch.from_numpy(text).to(cuda)
    args = dict(m=m, k1=k1, cd=tfast.STAGE_CD[:kt])
    before = cf.LAUNCHES["cascade"]
    slots, ovf = cf.cascade(t, bitmaps, **args)
    torch.cuda.synchronize()
    assert cf.LAUNCHES["cascade"] == before + 1
    ps, po = cf.cascade_plain(t, bitmaps, **args)
    assert torch.equal(slots, ps) and int(ovf) == int(po)
    assert k1 != 6 or int(ovf) == 1


#: bench.py's five tiers at 16 MiB: (m, p, the width the JAX package's
#: TPU-fitted rule gives them, which the port used before its own)
BENCH_TIERS = [(8, 10_000, None), (16, 10_000, 16384), (32, 10_000, 16384),
               (32, 30_000, 32768), (32, 100_000, 131072)]


@pytest.fixture(scope="module")
def bench_text():
    from tpu_smatcher_torch.core.alphabet import Alphabet
    return datagen.generate_text(1 << 24, Alphabet.dna(), seed=7)


@pytest.mark.parametrize("m,p,tpu_bits", BENCH_TIERS)
def test_default_width_counts_like_the_tpu_width(cuda, bench_text, m, p,
                                                 tpu_bits, tmp_path):
    """At the default stage width (ops/fast.h100_stage_bits) the cascade
    equals its plain version, the route is the cascade, and make_fast's
    count equals the count at the TPU-fitted width, with no retry; tables
    saved at that width load and count the same."""
    from tpu_smatcher_torch.core import checkpoint
    from tpu_smatcher_torch.core.alphabet import Alphabet
    from tpu_smatcher_torch.engines import make_engine_from_tables
    pats = datagen.generate_patterns(bench_text, p, m, Alphabet.dna(),
                                     frac_present=0.5,
                                     seed=8 if m == 8 else 8 + m)
    t = torch.from_numpy(bench_text).to(cuda)
    eng = make_fast(pats, device=cuda)
    count = eng.count(t)
    assert eng.fallback_scans == 0
    if tpu_bits is None:                  # the exact tier: no stages
        assert eng.ft.exact
        assert count == int(cf.exact_count_plain(t, eng.ft.bitmaps[0], m=m,
                                                 sigma=4))
        return
    n = len(bench_text)
    assert eng._pick_path(n, tfast.stages_for(eng.ft, n, eng.cap))[0] == \
        "cascade"
    assert _check_cascade(cuda, bench_text, pats) == 0
    old = tfast.build_fast(pats.codes, 4, stage_bits=tpu_bits, device=cuda)
    assert tfast.FastScanner(old).count(t) == count
    path = tmp_path / "tables.npz"
    checkpoint.save_tables(path, {"main": old})
    loaded = checkpoint.load_tables(path, device=cuda)
    assert loaded["main"].stage_bits == tpu_bits
    assert make_engine_from_tables("fast", loaded, device=cuda).count(t) \
        == count


def test_cascade_kernel_after_a_smaller_large_launch(cuda):
    """Three launches above the default 48 KB of shared memory: 192 KB of
    phase-1 stages, then 48 KB, then 192 KB again.  The second lowers the
    kernel's shared-memory limit, so the third must raise it again even
    though its grid size is known from the first."""
    rng = np.random.default_rng(3)
    t = torch.from_numpy(rng.integers(0, 4, 3 * kc.CASCADE_TILE).astype(
        np.uint8)).to(cuda)
    wide = torch.from_numpy(random_stages(14, 131072, 0.8, seed=1)).to(cuda)
    mid = torch.from_numpy(random_stages(13, 32768, 0.8, seed=2)).to(cuda)
    for bitmaps, k1 in ((wide, 12), (mid, 12), (wide, 12)):
        kt = int(bitmaps.shape[0])
        args = dict(m=32, k1=k1, cd=tfast.STAGE_CD[:kt])
        slots, ovf = cf.cascade(t, bitmaps, **args)
        torch.cuda.synchronize()
        ps, po = cf.cascade_plain(t, bitmaps, **args)
        assert torch.equal(slots, ps) and int(ovf) == int(po)


#: phase-1 stages (131,072 bits each) and their fill for each of the
#: cascade's shapes: a p=10k table's two (one thread a row), p=100k's six
#: (96 KB: two threads a row), fourteen (224 KB, past shared memory: read
#: through the read-only cache)
CASCADE_SHAPES = {"row": (2, 0.073), "half_row": (6, 0.53),
                  "past_shared": (14, 0.53)}


@pytest.mark.parametrize("m", [1, 15, 16, 17, 32, 33, 4097])
@pytest.mark.parametrize("shape", sorted(CASCADE_SHAPES))
def test_cascade_kernel_shapes_match_plain(cuda, shape, m):
    """At each shape, slots and ovf equal the plain version's bit for bit
    on start counts around the runs, rows and tiles, on a view at an odd
    address, and with rows of more than 16 phase-1 survivors: a run of zero
    bytes over a tile edge, whose windows all have the fingerprints 0, and
    bit 0 set in every stage, so that each of its starts passes."""
    k1, fill = CASCADE_SHAPES[shape]
    kt = k1 + 2
    stages = random_stages(kt, 131072, fill, seed=k1 + m)
    stages[:, 0] |= 1
    bitmaps = torch.from_numpy(stages).to(cuda)
    starts = kc.cascade_edge_starts()
    rng = np.random.default_rng(m)
    text = rng.integers(0, 4, m + 16 + max(starts)).astype(np.uint8)
    zeros = slice(kc.CASCADE_TILE - 300, kc.CASCADE_TILE + 300 + m)
    text[zeros] = 0
    full = torch.from_numpy(text).to(cuda)
    args = dict(m=m, k1=k1, cd=tfast.STAGE_CD[:kt])
    views = [full[:m - 1 + s] for s in starts] + [full[1:]]
    assert views[-1].data_ptr() % 2
    for t in views:
        before = cf.LAUNCHES["cascade"]
        slots, ovf = cf.cascade(t, bitmaps, **args)
        torch.cuda.synchronize()
        assert cf.LAUNCHES["cascade"] == before + 1
        ps, po = cf.cascade_plain(t, bitmaps, **args)
        assert torch.equal(slots, ps) and int(ovf) == int(po)
        if int(t.shape[0]) - m + 1 > zeros.start + 16:   # 17 zero windows
            assert int(ovf) == 1


def test_cascade_kernel_overflow_matches_plain(cuda):
    text, pats = dense_case()
    assert _check_cascade(cuda, text, pats, stage_bits=32768) == 1


def _check_compact(slots, ovf, cap):
    """compact_rows on the card against its plain version (compact_valrows,
    the overflow OR-ed with ovf), bit for bit: one call counted in
    EPILOGUE_LAUNCHES, none in LAUNCHES.  Returns (overflow, n_cand)."""
    before, launches = dict(cf.EPILOGUE_LAUNCHES), dict(cf.LAUNCHES)
    got = cf.compact_rows(slots, ovf, cap=cap)
    torch.cuda.synchronize()
    assert cf.EPILOGUE_LAUNCHES["compact_valrows"] == \
        before["compact_valrows"] + 1
    assert cf.LAUNCHES == launches
    want = cf.compact_rows_plain(slots, ovf, cap=cap)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    return int(got[1]), int(got[2])


@pytest.mark.parametrize("name", kc.COMPACT_EDGE_CASES)
def test_compact_kernel_at_edges_matches_plain(cuda, name):
    """No candidate, every slot live, n_cand == cap and cap + 1, a cap
    above the slot count, the cascade's row overflow with few
    candidates."""
    slots, ovf, cap = kc.compact_edge_case(name, cuda)
    o, n_cand = _check_compact(slots, ovf, cap)
    assert o == int(n_cand > cap or int(ovf))


@pytest.mark.parametrize("rows", [1, 127, 1023, 1024, 1025, 3 * 1024 + 77,
                                  1 << 21])
def test_compact_kernel_on_any_row_count_matches_plain(cuda, rows):
    """Row counts around the kernel's 1,024-row tile and the flagship's
    2^21, with a cap that holds every candidate (4 a row against ~0.16)
    and one that overflows (rows / 8), and a view starting a few rows
    in."""
    slots = torch.from_numpy(kc.sparse_slots(rows, 0.01, seed=rows)).to(cuda)
    zero = torch.zeros((), dtype=torch.int32, device=cuda)
    assert _check_compact(slots, zero, 4 * rows)[0] == 0
    _check_compact(slots, zero, max(1, rows // 8))
    if rows > 3:
        _check_compact(slots[3:], zero, 4 * rows)


def test_compact_kernel_on_the_flagship_cascade_output(cuda):
    """The cascade's slots over 256 MiB of DNA against an m=32 p=10k panel
    (the benchmark's flagship shapes, 2^21 rows), then over the same text
    with pattern 0 planted every 32 bytes across 8 MiB: 262,144 matches,
    past the cap."""
    text, pats = make_case(4, 32, 10_000, 1 << 28, seed=32)
    eng = make_fast(pats, device=cuda)
    n = len(text)
    path, k1, kt = eng._pick_path(n, tfast.stages_for(eng.ft, n, eng.cap))
    assert path == "cascade"
    t = torch.from_numpy(text).to(cuda)
    args = dict(m=32, k1=k1, cd=eng.ft.cd(kt))
    slots, ovf = cf.cascade(t, eng.ft.bitmaps[:kt], **args)
    assert slots.shape == ((n - 31 + 127) // 128, 16)
    o, n_cand = _check_compact(slots, ovf, eng.cap)
    assert o == 0 and n_cand > 0
    plant = torch.from_numpy(pats.codes[0].astype(np.uint8)).to(cuda)
    t[1 << 24:(1 << 24) + (1 << 23)].view(-1, 32)[:] = plant
    slots, ovf = cf.cascade(t, eng.ft.bitmaps[:kt], **args)
    o, n_cand = _check_compact(slots, ovf, eng.cap)
    assert o == 1 and n_cand >= 1 << 18


def _check_verify(text, idxs, n_cand, ft):
    """verify_count_live on the card against its plain version (verify_count
    over the word view), exactly: one call counted in EPILOGUE_LAUNCHES,
    none in LAUNCHES.  Returns the count."""
    before, launches = dict(cf.EPILOGUE_LAUNCHES), dict(cf.LAUNCHES)
    got = cf.verify_count_live(text, idxs, n_cand, ft)
    torch.cuda.synchronize()
    assert cf.EPILOGUE_LAUNCHES["verify"] == before["verify"] + 1
    assert cf.LAUNCHES == launches
    want = cf.verify_count_live_plain(text, idxs, n_cand, ft)
    assert got.dtype == want.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(want)
    return int(got)


@pytest.mark.parametrize("m,slot_ok,wide,kind", kc.VERIFY_EDGE_CASES)
def test_verify_kernel_at_edges_matches_plain(cuda, m, slot_ok, wide, kind):
    """A partial and a whole last word, eb = 0 and above, fp2's slot
    choice and every slot tried, n_cand 0, below cap with a -1 tail, equal
    to cap and above it, a match at the last window start; and the same on
    the text at odd addresses (views 1 to 3 bytes in, the candidates
    shifted with it)."""
    text, idxs, n_cand, ft, truth = kc.verify_edge_case(m, slot_ok, wide,
                                                        kind, cuda)
    assert _check_verify(text, idxs, n_cand, ft) == truth
    for off in (1, 2, 3):
        t = text[off:]
        assert t.data_ptr() % 4
        _check_verify(t, torch.where(idxs >= off, idxs - off, -1), n_cand,
                      ft)


def test_verify_kernel_on_the_flagship_candidates(cuda):
    """The benchmark's flagship shapes (256 MiB of DNA, m=32 p=10k): count()
    equals fast_count_core, the plain tiled scan; the kernel equals its
    plain version on the compacted candidates of the cascade, and again
    with pattern 0 planted every 32 bytes across 8 MiB, past the cap."""
    text, pats = make_case(4, 32, 10_000, 1 << 28, seed=32)
    eng = make_fast(pats, device=cuda)
    ft = eng.ft
    n = len(text)
    path, k1, kt = eng._pick_path(n, tfast.stages_for(ft, n, eng.cap))
    assert path == "cascade"
    t = torch.from_numpy(text).to(cuda)
    before = dict(cf.LAUNCHES)
    count = eng.count(t)
    assert cf.LAUNCHES["words_view"] == before["words_view"]
    c, o = tfast.fast_count_core(t, ft)
    assert count == int(c) and not int(o)
    args = dict(m=32, k1=k1, cd=ft.cd(kt))
    idxs, o, n_cand = cf.compact_rows(*cf.cascade(t, ft.bitmaps[:kt], **args),
                                      cap=eng.cap)
    assert 0 < int(n_cand) < eng.cap and int(o) == 0
    assert _check_verify(t, idxs, n_cand, ft) == count
    plant = torch.from_numpy(pats.codes[0].astype(np.uint8)).to(cuda)
    t[1 << 24:(1 << 24) + (1 << 23)].view(-1, 32)[:] = plant
    idxs, o, n_cand = cf.compact_rows(*cf.cascade(t, ft.bitmaps[:kt], **args),
                                      cap=eng.cap)
    assert int(n_cand) > eng.cap and int(o) == 1
    assert _check_verify(t, idxs, n_cand, ft) > 0


def test_cascade_route_takes_the_compaction_kernel(cuda):
    """Counts on the cascade route equal the plain path's (the CPU scanner)
    and the truth, each count one compaction and one verify kernel call
    counted apart from LAUNCHES (which sees the cascade only: no word
    view), and the tsm.compact spans say "cuda"."""
    from tpu_smatcher_torch.utils import profiling
    text, pats = wide_case(0.02)
    eng = tfast.FastScanner(tfast.build_fast(
        pats.codes, 4, stage_bits=32768, device=cuda), cap=1 << 14)
    n = len(text)
    assert eng._pick_path(n, tfast.stages_for(eng.ft, n, eng.cap))[0] == \
        "cascade"
    t = torch.from_numpy(text).to(cuda)
    plain = tfast.FastScanner(tfast.build_fast(
        pats.codes, 4, stage_bits=32768, device="cpu"), cap=1 << 14).count(
        torch.from_numpy(text))
    assert plain == datagen.count_matches(text, pats)
    assert eng.count(t) == plain               # warm
    before, launches = dict(cf.EPILOGUE_LAUNCHES), dict(cf.LAUNCHES)
    profiling.clear()
    profiling.enable()
    try:
        assert [eng.count(t) for _ in range(3)] == [plain] * 3
        spans = profiling.summary()
    finally:
        profiling.disable()
        profiling.clear()
    assert {k: v - before[k] for k, v in cf.EPILOGUE_LAUNCHES.items()} == \
        {"compact_valrows": 3, "verify": 3}
    assert {k: v - launches[k] for k, v in cf.LAUNCHES.items()
            if v != launches[k]} == {"cascade": 3}
    assert spans["tsm.compact"]["paths"] == {"cuda": 3}
    assert spans["tsm.verify"]["calls"] == 3


def _filter_case(sigma, m, stage_bits):
    text, pats = make_case(sigma, m, 3000, 200_003, seed=m + sigma)
    return text, tfast.build_fast(pats.codes, sigma, stage_bits=stage_bits,
                                  device="cuda")


@pytest.mark.parametrize("stage_bits", [4096, 131072])
@pytest.mark.parametrize("m,sigma", [(8, 20), (16, 4), (32, 4), (129, 4),
                                     (513, 4)])
def test_filter_kernels_match_plain(cuda, m, sigma, stage_bits):
    """filter_mask, filter_slots and words_view equal their plain versions
    bit for bit, on short, ragged and long texts, with k = 1 (sub-blocks
    over their 16 slots at 4096-bit stages) and k = 3."""
    text, ft = _filter_case(sigma, m, stage_bits)
    for n in sorted({m, max(m, 127), max(m, 1001), 200_003}):
        t = torch.from_numpy(text[:n].copy()).to(cuda)
        for k in (1, 3):
            args = dict(m=m, cd=ft.cd(k))
            before = dict(cf.LAUNCHES)
            mask = cf.filter_mask(t, ft.bitmaps[:k], **args)
            pos, counts = cf.filter_slots(t, ft.bitmaps[:k], **args)
            torch.cuda.synchronize()
            assert cf.LAUNCHES["filter_mask"] == before["filter_mask"] + 1
            assert cf.LAUNCHES["filter_slots"] == before["filter_slots"] + 1
            assert torch.equal(mask, cf.filter_mask_plain(
                t, ft.bitmaps[:k], **args))
            pp, pc = cf.filter_slots_plain(t, ft.bitmaps[:k], **args)
            assert torch.equal(pos, pp) and torch.equal(counts, pc)
            assert int(counts.sum()) == int(mask.sum())
        nw = tfast.words_len(n, ft.words)
        for off in (0, 1):                     # aligned and unaligned text
            tt = t[off:]
            got = cf.words_view(tt, nw)
            assert torch.equal(got, cf.words_view_plain(tt, nw))


@pytest.mark.parametrize("sigma,m,p_size,n", CASES)
def test_slice_on_the_card(cuda, sigma, m, p_size, n):
    """make_fast on the card counts exactly through the routed kernel; the
    slot and mask routes verify over the words_view kernel, the cascade
    route through the verify kernel, with no word view."""
    text, pats = make_case(sigma, m, p_size, n, seed=3 * sigma + m)
    eng = make_fast(pats, device=cuda)
    path = "exact" if eng.ft.exact else \
        eng._pick_path(n, tfast.stages_for(eng.ft, n, eng.cap))[0]
    if path == "exact":
        names = ["exact_count"]
    else:
        names = [ROUTE_KERNEL[path]] + \
            ([] if path == "cascade" else ["words_view"])
    before, epilogue = dict(cf.LAUNCHES), dict(cf.EPILOGUE_LAUNCHES)
    assert eng.count(torch.from_numpy(text).to(cuda)) == \
        datagen.count_matches(text, pats)
    for name in names:
        assert cf.LAUNCHES[name] == before[name] + 1, name
    assert cf.EPILOGUE_LAUNCHES["verify"] == \
        epilogue["verify"] + (path == "cascade")
    if path == "cascade":
        assert cf.LAUNCHES["words_view"] == before["words_view"]
    assert eng.fallback_scans == 0


#: filter.cu's run (starts per thread) and tile (starts per block
#: iteration, one sub-block)
FILTER_RUN, FILTER_TILE = 32, 16384


def _check_filters(t, bitmaps, m, cd):
    """filter_mask and filter_slots on t against their plain versions,
    exactly, each launched once; returns the sub-blocks' counts."""
    before = dict(cf.LAUNCHES)
    mask = cf.filter_mask(t, bitmaps, m=m, cd=cd)
    pos, counts = cf.filter_slots(t, bitmaps, m=m, cd=cd)
    torch.cuda.synchronize()
    assert cf.LAUNCHES["filter_mask"] == before["filter_mask"] + 1
    assert cf.LAUNCHES["filter_slots"] == before["filter_slots"] + 1
    assert torch.equal(mask, cf.filter_mask_plain(t, bitmaps, m=m, cd=cd))
    pp, pc = cf.filter_slots_plain(t, bitmaps, m=m, cd=cd)
    assert torch.equal(pos, pp) and torch.equal(counts, pc)
    assert int(counts.sum()) == int(mask.sum())
    return counts


@pytest.mark.parametrize("m", [1, 31, 4097])
@pytest.mark.parametrize("sigma", [4, 256])
def test_filter_kernels_at_edges_match_plain(cuda, sigma, m):
    """Both modes equal their plain versions on start counts around a run,
    a 128-start mask row and a tile, on texts at every address mod 16
    (views staged from the aligned address below them), with crowded
    sub-blocks (k=1 at half fill) and sparse ones (k=3)."""
    rng = np.random.default_rng(sigma + m)
    text = rng.integers(0, sigma, m - 1 + 2 * cf.SUB_BLOCK + 64).astype(
        np.uint8)
    full = torch.from_numpy(text).to(cuda)
    stages = [(torch.from_numpy(random_stages(k, bits, fill, seed=m)).to(
        cuda), tfast.STAGE_CD[:k]) for k, bits, fill in ((1, 4096, 0.5),
                                                           (3, 16384, 0.2))]
    starts = sorted(set(edge_starts(FILTER_RUN, FILTER_TILE))
                    | {127, 128, 129})
    crowded = 0
    for i, s in enumerate(starts):
        off = i % 16
        t = full[off:off + m - 1 + s]
        assert t.data_ptr() % 16 == off
        for bitmaps, cd in stages:
            crowded += int((_check_filters(t, bitmaps, m, cd)
                            > cf.BLOCK_SLOTS).sum())
    assert crowded


@pytest.mark.parametrize("k", [1, 32])
@pytest.mark.parametrize("stage_bits", [4096, 16384, 131072, 262144])
def test_filter_kernels_on_wide_stages_match_plain(cuda, stage_bits, k):
    """Stage bitmaps in shared memory (all k up to 112 KB per block beside
    the text buffers) and past it (32 stages of 131,072 or 262,144 bits:
    the first ones there, at least the three tested without a branch, the
    rest through the read-only cache), bits set with probability 0.8 so
    that deep stages run, bytes up to 255, m = 32 and 4097."""
    bitmaps = torch.from_numpy(random_stages(k, stage_bits, 0.8,
                                             seed=k + stage_bits)).to(cuda)
    rng = np.random.default_rng(k)
    for m in (32, 4097):
        text = rng.integers(0, 256, m - 1 + 3 * cf.SUB_BLOCK + 77).astype(
            np.uint8)
        t = torch.from_numpy(text).to(cuda)
        _check_filters(t, bitmaps, m, tfast.STAGE_CD[:k])
        _check_filters(t[3:], bitmaps, m, tfast.STAGE_CD[:k])


def test_filter_kernels_after_a_smaller_large_launch(cuda):
    """Three launches of each mode above the default 48 KB of shared
    memory: two 262,144-bit stages (64 KB), then thirteen 32,768-bit ones
    (52 KB), then the 64 KB again, which must raise the kernel's limit
    again after the smaller launch lowered it."""
    rng = np.random.default_rng(5)
    t = torch.from_numpy(rng.integers(0, 4, 3 * cf.SUB_BLOCK).astype(
        np.uint8)).to(cuda)
    wide = torch.from_numpy(random_stages(2, 262144, 0.5, seed=1)).to(cuda)
    mid = torch.from_numpy(random_stages(13, 32768, 0.8, seed=2)).to(cuda)
    for bitmaps in (wide, mid, wide):
        k = int(bitmaps.shape[0])
        _check_filters(t, bitmaps, 32, tfast.STAGE_CD[:k])


#: the filter kernel of each fingerprint route
ROUTE_KERNEL = {"slot": "filter_slots", "cascade": "cascade",
                "mask": "filter_mask"}


def test_slot_route_on_the_card(cuda):
    """A DNA m=32 p=1000 set at 4,096-bit stages takes the slot route
    (the default width gives it to the cascade): filter_slots and
    words_view launch, and the count is exact."""
    text, pats = make_case(4, 32, 1000, 1 << 20, seed=40)
    eng = tfast.FastScanner(tfast.build_fast(pats.codes, 4, stage_bits=4096,
                                             device=cuda))
    n = len(text)
    assert eng._pick_path(n, tfast.stages_for(eng.ft, n, eng.cap))[0] == \
        "slot"
    before = dict(cf.LAUNCHES)
    assert eng.count(torch.from_numpy(text).to(cuda)) == \
        datagen.count_matches(text, pats)
    assert cf.LAUNCHES["filter_slots"] > before["filter_slots"]
    assert cf.LAUNCHES["words_view"] > before["words_view"]


def test_wide_case_on_the_card(cuda):
    text, pats = wide_case(0.02)
    tft = tfast.build_fast(pats.codes, 4, stage_bits=32768, device=cuda)
    eng = tfast.FastScanner(tft, cap=1 << 14)
    assert eng.count(torch.from_numpy(text).to(cuda)) == \
        datagen.count_matches(text, pats)
    assert eng.fallback_scans == 0
    # the match run overflows the cascade's rows: the retry is exact and,
    # as in the JAX package, switches the scanner to the dense pass, which
    # then counts without retrying
    text, pats = dense_case()
    eng = tfast.FastScanner(tfast.build_fast(pats.codes, 4, stage_bits=32768,
                                             device=cuda))
    t = torch.from_numpy(text).to(cuda)
    truth = datagen.count_matches(text, pats)
    assert eng.count(t) == truth
    assert eng.fallback_scans == 1
    assert (eng._k_extra, eng._match_dense) == (0, True)
    assert eng.count_with_overflow(t) == (truth, False)
    assert eng.count(t) == truth and eng.fallback_scans == 1


def _sync_free_case(kind):
    """(scanner, text tensor, truth) whose count_async runs the given
    route or the dense pass."""
    if kind in ("exact", "slot"):
        sigma, m, p_size, n = CASES[2] if kind == "exact" else CASES[4]
        text, pats = make_case(sigma, m, p_size, n, seed=3 * sigma + m)
        eng = make_fast(pats, device="cuda")
    elif kind == "cascade":
        text, pats = wide_case(0.02)
        eng = tfast.FastScanner(tfast.build_fast(
            pats.codes, 4, stage_bits=32768, device="cuda"), cap=1 << 14)
    elif kind == "mask":
        text, pats = make_case(4, 32, 10_000, 1 << 15, seed=21)
        eng = tfast.FastScanner(tfast.build_fast(
            pats.codes, 4, stage_bits=4096, device="cuda"))
    else:                                      # the dense pass
        text, pats = dense_case()
        eng = tfast.FastScanner(tfast.build_fast(
            pats.codes, 4, stage_bits=32768, device="cuda"))
        eng._match_dense = True
    return eng, torch.from_numpy(text).cuda(), datagen.count_matches(text,
                                                                     pats)


@pytest.mark.parametrize("kind", ["exact", "slot", "cascade", "mask",
                                  "dense"])
def test_count_async_does_not_wait_for_the_device(cuda, kind):
    """count_async only enqueues: no torch op in it synchronises, on every
    route and on the dense pass."""
    eng, t, truth = _sync_free_case(kind)
    eng.count(t)                               # warm: lazy build and caches
    if kind not in ("exact", "dense"):
        eng._match_dense = False               # the warm scan may adapt
        n = int(t.shape[0])
        assert eng._pick_path(n, tfast.stages_for(eng.ft, n, eng.cap))[0] \
            == kind
    torch.cuda.set_sync_debug_mode("error")
    try:
        fut = eng.count_async(t)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fut.result() == truth


#: (sigma, m) of the exact-tier kernel checks: m*bits <= 16 at each sigma
EXACT_GUARD_CASES = [(2, 16), (4, 8), (20, 3), (256, 2)]


@pytest.mark.parametrize("sigma,m", EXACT_GUARD_CASES)
def test_exact_mask_and_guard_kernels_match_plain(cuda, sigma, m):
    """exact_mask and exact_count(guard=True) equal their plain versions
    bit for bit over ragged lengths, with bytes >= sigma planted where the
    alphabet leaves room for them (sigma = 256 has none)."""
    text, pats = make_case(sigma, m, 200, 300_007, seed=sigma + m)
    text = text.copy()
    if sigma < 256:
        at = np.random.default_rng(sigma).integers(0, len(text), 3000)
        text[at[::2]] = sigma                    # the pad symbol
        text[at[1::2]] = 255
    bm = tfast.build_fast(pats.codes, sigma, device=cuda).bitmaps[0]
    for n in (m, 127, 128 * 40 + 5, 300_007):
        t = torch.from_numpy(text[:n].copy()).to(cuda)
        before = dict(cf.LAUNCHES)
        mask = cf.exact_mask(t, bm, m=m, sigma=sigma)
        count = cf.exact_count(t, bm, m=m, sigma=sigma, guard=True)
        torch.cuda.synchronize()
        assert cf.LAUNCHES["exact_mask"] == before["exact_mask"] + 1
        assert cf.LAUNCHES["exact_count_guard"] == \
            before["exact_count_guard"] + 1
        assert cf.LAUNCHES["exact_count"] == before["exact_count"]
        assert torch.equal(mask, cf.exact_mask_plain(t, bm, m=m, sigma=sigma))
        assert int(count) == int(cf.exact_count_plain(t, bm, m=m, sigma=sigma,
                                                      guard=True))
        assert int(count) == int(mask.sum()) == \
            datagen.count_matches(text[:n], pats)
        # unguarded, kernel and plain are one function of any bytes
        assert int(cf.exact_count(t, bm, m=m, sigma=sigma)) == \
            int(cf.exact_count_plain(t, bm, m=m, sigma=sigma))


@pytest.mark.parametrize("sigma,m", kc.EXACT_EDGE_CASES)
def test_exact_kernels_at_edges_match_plain(cuda, sigma, m):
    """exact_mask and exact_count, guard on and off, equal their plain
    versions bit for bit on kernel_cases' exact edge cases: views at every
    address mod 16, start counts around a run, a mask row and a tile, a
    positions piece of about 2^18 starts at an odd address and n = m;
    bytes >= sigma planted (at sigma = 20 also bytes in [20, 32), which
    the guard drops and the rolling id takes as clean), a random bitmap.
    Each mask sums to the guarded count; the guard drops windows wherever
    sigma < 256.  Each launch counts once in EXACT_PATHS, on the path
    exact_pairs names (the pair table up to 18 bits of (m+1)-gram)."""
    views, bm = kc.exact_edge_case(sigma, m, cuda)
    path = "pairs" if cf.exact_pairs(m, bits_per_char(sigma),
                                     int(bm.shape[0])) else "bitmap"
    assert (path == "pairs") == ((sigma, m) not in [(20, 3), (256, 2)])
    dropped = 0
    for t in views:
        before, paths = dict(cf.LAUNCHES), dict(cf.EXACT_PATHS)
        mask = cf.exact_mask(t, bm, m=m, sigma=sigma)
        guarded = cf.exact_count(t, bm, m=m, sigma=sigma, guard=True)
        unguarded = cf.exact_count(t, bm, m=m, sigma=sigma)
        torch.cuda.synchronize()
        for name in ("exact_mask", "exact_count_guard", "exact_count"):
            assert cf.LAUNCHES[name] == before[name] + 1, name
        assert {k: v - paths[k] for k, v in cf.EXACT_PATHS.items()
                if v != paths[k]} == {path: 3}
        assert torch.equal(mask, cf.exact_mask_plain(t, bm, m=m, sigma=sigma))
        assert int(guarded) == int(mask.sum()) == int(cf.exact_count_plain(
            t, bm, m=m, sigma=sigma, guard=True))
        assert int(unguarded) == int(cf.exact_count_plain(t, bm, m=m,
                                                          sigma=sigma))
        dropped += int(unguarded) - int(guarded)
    assert (dropped > 0) == (sigma < 256)


#: (sigma, m, bitmap bits): the pair path at its widest grams (18 bits at
#: DNA m = 8, sigma 8 m = 5 and sigma 64 m = 2; 17 at sigma 2 m = 16; 16 at
#: sigma 256 m = 1), a bitmap smaller than the id space (the bitmap path,
#: every run a per-start one) and a gram of 20 bits (the bitmap path)
EXACT_PAIR_CASES = [(4, 8, 65536), (8, 5, 32768), (64, 2, 4096),
                    (2, 16, 65536), (256, 1, 4096), (4, 8, 4096),
                    (20, 3, 32768)]


@pytest.mark.parametrize("sigma,m,nbits", EXACT_PAIR_CASES)
def test_exact_pair_path_matches_plain(cuda, sigma, m, nbits):
    """The three exact modes equal their plain versions bit for bit over
    texts of one to three tiles a block of the persistent grid (start
    counts around a block's last tile, a tile and a run past a whole
    number of tiles a block), random bytes with the pad symbol and 255
    planted, and over one view at an odd address; each launch counts once
    in EXACT_PATHS on the path exact_pairs names."""
    bits = bits_per_char(sigma)
    bm = torch.from_numpy(random_stages(1, nbits, 0.4, seed=m)[0]).to(cuda)
    path = "pairs" if cf.exact_pairs(m, bits, nbits // 32) else "bitmap"
    assert (path == "pairs") == (nbits >= 1 << (m * bits) and sigma != 20)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    tile = kc.EXACT_PAIR_TILE if path == "pairs" else kc.EXACT_TILE
    rng = np.random.default_rng(sigma * m)
    for starts in (sms * tile - 1, 2 * sms * tile + 33,
                   3 * sms * tile + tile + 1):
        text = rng.integers(0, sigma, starts + m + 8).astype(np.uint8)
        if sigma < 256:
            at = rng.integers(0, len(text), len(text) // 512)
            text[at[::2]] = sigma
            text[at[1::2]] = 255
        full = torch.from_numpy(text).to(cuda)
        for t in (full[:starts + m - 1], full[3:starts + m - 1]):
            paths = dict(cf.EXACT_PATHS)
            mask = cf.exact_mask(t, bm, m=m, sigma=sigma)
            guarded = cf.exact_count(t, bm, m=m, sigma=sigma, guard=True)
            unguarded = cf.exact_count(t, bm, m=m, sigma=sigma)
            torch.cuda.synchronize()
            assert {k: v - paths[k] for k, v in cf.EXACT_PATHS.items()
                    if v != paths[k]} == {path: 3}
            assert torch.equal(mask, cf.exact_mask_plain(t, bm, m=m,
                                                         sigma=sigma))
            assert int(guarded) == int(mask.sum()) == int(
                cf.exact_count_plain(t, bm, m=m, sigma=sigma, guard=True))
            assert int(unguarded) == int(cf.exact_count_plain(
                t, bm, m=m, sigma=sigma))


@pytest.mark.parametrize("sigma,m,p_size,n", [CASES[2], CASES[3]])
def test_positions_on_the_card_equal_cpu(cuda, sigma, m, p_size, n):
    """positions, matches and count_per_pattern on the card equal the same
    calls on the CPU, through exact_mask (exact tier) or filter_mask and
    words_view (fingerprint tier); a small cap makes the pieces split."""
    text, pats = make_case(sigma, m, p_size, n, seed=3 * sigma + m)
    for cap in (None, 64):
        kw = {} if cap is None else {"cap": cap}
        eng = make_fast(pats, device=cuda, **kw)
        ref = make_fast(pats, device="cpu", **kw)
        t = torch.from_numpy(text).to(cuda)
        names = ["exact_mask"] if eng.ft.exact else ["filter_mask",
                                                     "words_view"]
        before = dict(cf.LAUNCHES)
        pos = eng.positions(t)
        for name in names:
            assert cf.LAUNCHES[name] > before[name], name
        pm, ids = eng.matches(t)
        rpm, rids = ref.matches(text)
        np.testing.assert_array_equal(pos, ref.positions(text))
        np.testing.assert_array_equal(pm, rpm)
        np.testing.assert_array_equal(ids, rids)
        np.testing.assert_array_equal(eng.count_per_pattern(t),
                                      ref.count_per_pattern(text))
        assert len(pos) == datagen.count_matches(text, pats)


def test_core_guards_the_pad_on_the_card(cuda):
    from tpu_smatcher_torch.core.alphabet import Alphabet
    from tpu_smatcher_torch.core.patterns import PatternSet
    pats = PatternSet(np.array([[0, 0, 0, 0, 0, 0, 1, 0]], np.uint8),
                      Alphabet.dna())
    eng = make_fast(pats, device=cuda)
    ext = torch.zeros(23, dtype=torch.uint8, device=cuda)
    ext[16:] = 4                                   # the shard's sigma pad
    before = cf.LAUNCHES["exact_count_guard"]
    c, o = eng.core(ext)
    assert (int(c), int(o)) == (0, 0)
    assert cf.LAUNCHES["exact_count_guard"] == before + 1
    assert int(cf.exact_count(ext, eng.ft.bitmaps[0], m=8, sigma=4)) == 1


@pytest.mark.parametrize("kind", ["exact", "slot"])
def test_repeat_and_stack_do_not_wait_for_the_device(cuda, kind):
    """count_repeat_async and count_stack_async only enqueue."""
    eng, t, truth = _sync_free_case(kind)
    eng.count(t)                               # warm: lazy build and caches
    n = int(t.shape[0]) // 4 * 4
    batch = t[:n].view(4, -1)
    want = sum(eng.scan_many(list(batch)))
    eng.count_stack(batch)
    torch.cuda.set_sync_debug_mode("error")
    try:
        rep = eng.count_repeat_async(t, 3)
        stack = eng.count_stack_async(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert rep.result() == 3 * truth
    assert stack.result() == want


#: (sigma, m) of the stage-chain kernel checks: with the engines below they
#: run every stage kind (prefix, suffix and exact wid, fpset, wm, sog), wm
#: and sog past their tables, both tiers
STAGE_SIGMAS = [2, 4, 20, 256]


def _engine_chains(sigma, m, n):
    """(name, chain, tables) of each engine's fast path at (sigma, m) on the
    card, and the text (bytes >= sigma planted where there is room)."""
    text, pats = make_case(sigma, m, 200, n, seed=sigma + m)
    text = text.copy()
    if sigma < 256:
        at = np.random.default_rng(m).integers(0, n, 400)
        text[at[::2]] = sigma
        text[at[1::2]] = 255
    names = ["ac", "sh", "wm"] + ([f"sog{m}"] if m in (8, 16, 32) else [])
    out = []
    for name in names:
        chain, tables, _ = make_engine(name, pats,
                                       device="cuda").fast_path._stages(n)
        out.append((name, chain, tables))
    return text, out


@pytest.mark.parametrize("m", [8, 32])
@pytest.mark.parametrize("sigma", STAGE_SIGMAS)
def test_stages_kernel_matches_plain(cuda, sigma, m):
    """The stage-chain kernel equals stages_plain bit for bit in count,
    mask and slots mode, guard on and off, on short, ragged and long
    texts; launches count as stages, or stages_flat for a flat call."""
    text, chains = _engine_chains(sigma, m, 300_007)
    for name, chain, tables in chains:
        flat_ok = all(k in ("wid", "fpset") for k, _ in chain)
        for n in (m, 127, 2 * 16384 + 77, 300_007):
            t = torch.from_numpy(text[:n].copy()).to(cuda)
            for mode in ("count", "mask", "slots"):
                for guard in (False, True):
                    flat = flat_ok and not guard and mode != "slots"
                    kw = dict(m=m, sigma=sigma, mode=mode, guard=guard)
                    key = "stages_flat" if flat else "stages"
                    before = cf.LAUNCHES[key]
                    got = ce.stages(t, chain, tables, flat=flat, **kw)
                    torch.cuda.synchronize()
                    assert cf.LAUNCHES[key] == before + 1
                    want = ce.stages_plain(t, chain, tables, **kw)
                    got = got if isinstance(got, tuple) else (got,)
                    want = want if isinstance(want, tuple) else (want,)
                    for g, w in zip(got, want, strict=True):
                        assert g.shape == w.shape and torch.equal(g, w), (
                            name, n, mode, guard)


def _check_stages(t, chain, tables, m, sigma):
    """stages() == stages_plain on t in every mode, guard on and off (the
    flat call where the chain allows it); returns the candidates."""
    flat_ok = all(k in ("wid", "fpset") for k, _ in chain)
    cands = 0
    for mode in ("count", "mask", "slots"):
        for guard in (False, True):
            kw = dict(m=m, sigma=sigma, mode=mode, guard=guard)
            got = ce.stages(t, chain, tables, flat=flat_ok and not guard,
                            **kw)
            torch.cuda.synchronize()
            want = ce.stages_plain(t, chain, tables, **kw)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want, strict=True):
                assert g.shape == w.shape and torch.equal(g, w), (
                    [k for k, _ in chain], int(t.shape[0]), mode, guard)
            if mode == "count":
                cands += int(want[0])
    return cands


@pytest.mark.parametrize("sigma,m,kind", kc.STAGE_EDGE_CASES)
def test_stages_kernel_at_edges_matches_plain(cuda, sigma, m, kind):
    """The stage-chain kernel equals stages_plain in every mode, guard on
    and off, on start counts around its run, a mask row and its tile, on
    views at every address mod 16 (staged from the aligned address below
    them), with bytes >= sigma planted (runs that take the wid stage's
    per-start path, lookups past the value tables, windows the guard
    drops)."""
    views, chain, tables = kc.stage_edge_case(sigma, m, kind, cuda)
    assert sum(_check_stages(v, chain, tables, m, sigma) for v in views)


@pytest.mark.parametrize("stage_bits", [131072, 262144])
def test_stages_kernel_on_wide_fp_stages_matches_plain(cuda, stage_bits):
    """32 fingerprint stages of 2^17 or 2^18 bits (past shared memory)
    alone and behind each stage 0 (prefix wid, wm, sog), at m = 32 and
    4097, aligned and at address 3 mod 16."""
    for t, chain, tables, m in kc.wide_fp_cases(stage_bits, cuda):
        _check_stages(t, chain, tables, m, 4)


@pytest.mark.parametrize("sigma,m", kc.GENERIC_CASES)
def test_stages_kernel_generic_chains_match_plain(cuda, sigma, m):
    """Chains outside EngineFastPath's (a value stage alone, two value
    stages, the fp stage first, a bitmap smaller than the id space, three
    wid stages) run in the kernel's generic instantiation and equal
    stages_plain, at an odd address."""
    t, chains = kc.generic_case(sigma, m, cuda)
    for chain, tables in chains:
        _check_stages(t, chain, tables, m, sigma)


def test_stages_kernel_after_a_smaller_large_launch(cuda):
    """Stage-chain launches above 48 KB of shared memory around smaller
    ones: each raises the kernel's limit again."""
    for t, chain, tables, m in kc.smaller_launch_cases(cuda):
        _check_stages(t, chain, tables, m, 4)


#: (sigma, m, engines) of the engine checks on the card: both tiers, every
#: stage 0
CARD_ENGINE_CASES = [
    (4, 8, ["ac", "sh", "sbom", "wm", "sog8"]),
    (4, 32, ["ac", "sh", "sbom", "wm", "sog32"]),
    (20, 16, ["ac", "wm", "sog16"]),
]


@pytest.mark.parametrize("sigma,m,engines", CARD_ENGINE_CASES)
def test_engines_on_the_card_equal_cpu(cuda, sigma, m, engines):
    """make_engine(device='cuda') equals device='cpu': count, count_async,
    the guarded core, positions and the portable scan."""
    text, pats = make_case(sigma, m, 300, 200_003, seed=3 * sigma + m)
    truth = datagen.count_matches(text, pats)
    t = torch.from_numpy(text).to(cuda)
    ext = torch.cat([t, torch.full((m - 1,), sigma % 256, dtype=torch.uint8,
                                   device=cuda)])
    for name in engines:
        eng = make_engine(name, pats, device=cuda)
        ref = make_engine(name, pats, device="cpu")
        before = cf.LAUNCHES["stages"] + cf.LAUNCHES["stages_flat"]
        got = (eng.count(t), eng.count_async(t).result(),
               [int(x) for x in eng.fast_path.core(ext)])
        assert cf.LAUNCHES["stages"] + cf.LAUNCHES["stages_flat"] > before
        want = (ref.count(text), ref.count_async(text).result(),
                [int(x) for x in ref.fast_path.core(ext.cpu())])
        assert got == want and got[0] == truth, name
        np.testing.assert_array_equal(eng.positions(t), ref.positions(text))
        portable = make_engine(name, pats, device=cuda, fastpath=False)
        assert portable.count(t) == truth, name


#: (engine, sigma, m, p, async mode): exact tier, and the fingerprint
#: tier's slot and mask modes (few true matches, so neither overflows)
SYNC_FREE_ENGINES = [("wm", 4, 8, 300, "count"), ("ac", 20, 32, 40, "slots"),
                     ("sog16", 4, 16, 40, "slots"),
                     ("wm", 4, 32, 30_000, "mask")]


@pytest.mark.parametrize("name,sigma,m,p,mode", SYNC_FREE_ENGINES)
def test_engine_count_async_does_not_wait_for_the_device(cuda, name, sigma,
                                                         m, p, mode):
    """An engine's count_async and count_repeat_async only enqueue."""
    from tpu_smatcher_torch.core.alphabet import Alphabet
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(200_003, ab, seed=5)
    pats = datagen.generate_patterns(text, p, m, ab, frac_present=0.01,
                                     seed=6)
    eng = make_engine(name, pats, device=cuda)
    t = torch.from_numpy(text).to(cuda)
    truth = datagen.count_matches(text, pats)
    modes = []
    real = ce.stages

    def spy(*a, **kw):
        modes.append(kw["mode"])
        return real(*a, **kw)

    ce.stages = spy
    try:
        assert eng.count_async(t).result() == truth      # warm
    finally:
        ce.stages = real
    assert modes == [mode] and not eng.fast_path._use_fallback_async
    torch.cuda.set_sync_debug_mode("error")
    try:
        fut = eng.count_async(t)
        rep = eng.fast_path.count_repeat_async(t, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fut.result() == truth and rep.result() == 2 * truth


# ---------------------------------------------------------------------------
# mixed lengths and table checkpoints
# ---------------------------------------------------------------------------

def _mixed_case(n=300_007):
    """DNA text and a mixed set of lengths 8 (exact tier), 16 and 32 (fp
    tier), patterns taken from the text and random ones."""
    from tpu_smatcher_torch.core.alphabet import Alphabet
    from tpu_smatcher_torch.core.patterns import MixedPatternSet
    ab = Alphabet.dna()
    text = datagen.generate_text(n, ab, seed=90)
    rows = [r for m in (8, 16, 32) for r in datagen.generate_patterns(
        text, 60, m, ab, frac_present=0.5, seed=91 + m).codes]
    order = np.random.default_rng(92).permutation(len(rows))
    return text, MixedPatternSet.from_rows([rows[i] for i in order], ab)


def test_mixed_on_the_card_equals_cpu(cuda):
    """make_mixed's count, count_async, positions, matches and
    count_per_pattern on the card equal the CPU's, the count the oracle's;
    count_async enqueues every group without waiting for the device."""
    from tpu_smatcher_torch import make_mixed
    text, mx = _mixed_case()
    eng, cpu = make_mixed(mx, device=cuda), make_mixed(mx, device="cpu")
    t = torch.from_numpy(text).to(cuda)
    truth = sum(datagen.count_matches(text, g) for g in mx.groups)
    assert eng.count(t) == cpu.count(text) == truth
    torch.cuda.set_sync_debug_mode("error")
    try:
        fut = eng.count_async(t)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fut.result() == truth
    for got, want in zip(eng.positions(t), cpu.positions(text)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(eng.matches(t), cpu.matches(text)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(eng.count_per_pattern(t),
                                  cpu.count_per_pattern(text))
    wm = make_mixed(mx, engine="wm", device=cuda)
    assert wm.count(t) == truth


def test_mixed_unaligned_piece_on_the_card(cuda, tmp_path):
    """count_file's pieces on the card, and one piece as a view at an odd
    address inside a larger device buffer, count as on the CPU."""
    from tpu_smatcher_torch import make_mixed
    text, mx = _mixed_case()
    eng, cpu = make_mixed(mx, device=cuda), make_mixed(mx, device="cpu")
    path = tmp_path / "corpus.bin"
    text.tofile(path)
    for chunk in (1 << 16, 99_991):
        assert eng.count_file(str(path), chunk=chunk) == \
            cpu.count_file(str(path), chunk=chunk) == cpu.count(text)
    t = torch.from_numpy(text).to(cuda)
    piece = t[99_991:2 * 99_991 + 31]
    assert piece.data_ptr() % 16
    assert eng.count(piece) == cpu.count(text[99_991:2 * 99_991 + 31])


@pytest.mark.parametrize("m", [8, 32])
def test_checkpoint_loaded_on_the_card_counts_like_cpu(cuda, tmp_path, m):
    """A fast table saved from the card loads on the card and on the CPU,
    and both count the oracle's count; an engine over tables of the other
    device raises instead of moving them."""
    from tpu_smatcher_torch.core import checkpoint
    from tpu_smatcher_torch.engines import (build_tables,
                                            make_engine_from_tables)
    text, pats = make_case(4, m, 300, 300_007, seed=93 + m)
    p = tmp_path / "fast.npz"
    checkpoint.save_tables(p, build_tables("fast", pats, device=cuda))
    on_card = checkpoint.load_tables(p, device=cuda)
    on_cpu = checkpoint.load_tables(p, device="cpu")
    assert on_card["main"].device.type == "cuda"
    truth = datagen.count_matches(text, pats)
    eng = make_engine_from_tables("fast", on_card, device=cuda, cap=1 << 17)
    assert eng.cap == 1 << 17
    assert eng.count(torch.from_numpy(text).to(cuda)) == truth
    assert make_engine_from_tables("fast", on_cpu, device="cpu").count(
        text) == truth
    with pytest.raises(ValueError, match="fast tables on"):
        make_engine_from_tables("fast", on_cpu, device=cuda)
    with pytest.raises(ValueError, match="fast tables on"):
        make_engine_from_tables("fast", on_card, device="cpu")


@pytest.fixture
def nccl_mesh(cuda):
    """This process as a one-rank NCCL group on the card."""
    from tpu_smatcher_torch.parallel import make_mesh
    mesh = make_mesh(1, device="cuda")
    assert mesh.backend == "nccl" and mesh.device.type == "cuda"
    return mesh


@pytest.mark.parametrize("name,m", [("fast", 8), ("fast", 32), ("wm", 8),
                                    ("ac", 32)])
def test_distributed_world1_counts_like_one_device(nccl_mesh, name, m):
    """make_distributed on a one-rank NCCL group: the halo exchange and
    the all-reduce run, and count, count_async and scan_many equal the
    single-device scanner's count and the oracle's."""
    from tpu_smatcher_torch import make_distributed
    text, pats = make_case(4, m, 300, 1 << 20, seed=101 + m)
    t = torch.from_numpy(text).cuda()
    single = make_fast(pats) if name == "fast" else make_engine(name, pats)
    want = single.count(t)
    assert want == datagen.count_matches(text, pats)
    dc = make_distributed(name, pats, nccl_mesh)
    assert dc.count(t) == dc.count_async(t).result() == want
    assert dc.scan_many([t, t[:1 << 19]]) == [
        want, datagen.count_matches(text[:1 << 19], pats)]
    assert dc.count(text) == want                 # a host text, sharded


@pytest.mark.parametrize("m", [8, 32])
def test_distributed_positions_on_the_card(nccl_mesh, m):
    from tpu_smatcher_torch.parallel import DistributedPositions
    text, pats = make_case(4, m, 300, 1 << 20, seed=111 + m)
    eng = make_fast(pats, cap=1 << 12)
    t = torch.from_numpy(text).cuda()
    got = DistributedPositions(eng, nccl_mesh).positions(t)
    np.testing.assert_array_equal(got, eng.positions(t))
    np.testing.assert_array_equal(
        got, np.flatnonzero(datagen.match_starts(text, pats)))


def test_cli_on_the_card(cuda, capsys):
    """python -m tpu_smatcher_torch.cli runs on the card by default: every
    engine agrees with the ground truth, exit code 0."""
    import json
    from tpu_smatcher_torch import cli
    cli.main(["--synthetic", "--n", "300000", "--m", "8", "--p-size", "200",
              "--alphabet", "4", "--algo", "all", "--verify"])
    out = capsys.readouterr().out
    assert "ALL ENGINES AGREE" in out
    res = json.loads(out.strip().splitlines()[-1])
    assert len(res) == 6
    assert all(r["matches"] == r["ground_truth"] for r in res)


# ---------------------------------------------------------------------------
# the tools (tpu_smatcher_torch/tools) on the card, at small sizes
# ---------------------------------------------------------------------------

def test_soak_first_7_trials_on_the_card(cuda):
    """The soak's first 7 trials (the long-pattern trial 6 among them)
    through the kernels and the plain versions, and trials 0 and 5 on four
    gloo ranks sharing the card."""
    from tpu_smatcher_torch.tools import soak
    res = soak.soak(7, device="cuda", log=lambda s: None)
    assert res["failures"] == []
    assert res["dist_trials"] == [0, 5]
    assert [(r["backend"], r["device"]) for r in res["ranks"]] == \
        [("gloo", "cuda:0")] * 4


def test_sweep_small_on_the_card(cuda, tmp_path):
    """The six corpus shapes cut to 1 MiB at p = 1000: every engine agrees
    with datagen, lines timed by CUDA events, below the int32 wrap."""
    from tpu_smatcher_torch.tools import sweep
    corpora = [(name, min(n, 1 << 20), sigma)
               for name, n, sigma in sweep.CORPORA]
    res = sweep.sweep(corpora, [1000], device="cuda", reps=1, window=0.02,
                      out=str(tmp_path / "s.jsonl"), log=lambda s: None)
    assert res["failures"] == []
    lines = [r for r in res["records"] if "matches" in r]
    assert len(lines) == len(sweep.CORPORA) * len(sweep.DEFAULT_ENGINES)
    for r in lines:
        assert r["backend"] == "cuda" and r["method"] == "cuda_events"
        assert r["card"] and r["matches"] == r["gate"]
        assert r["queue"] * r["matches"] < 2 ** 31


def test_fp_collision_cell_on_the_card(cuda):
    """The full fingerprint collision.  At the slot route's 4,096-bit
    stages, whose per-block slots it crowds: 8 exact scans, then no
    further retries over 3 more (the scanner converged).  At the default
    width the cascade's row slots hold it: 11 exact scans, no retry."""
    from tpu_smatcher_torch.tools.find_fp_collision import collision_case
    text, pats = collision_case()
    truth = datagen.count_matches(text, pats)
    eng = tfast.FastScanner(tfast.build_fast(pats.codes, 4, stage_bits=4096,
                                             device=cuda))
    t = torch.from_numpy(text).cuda()
    assert [eng.count(t) for _ in range(8)] == [truth] * 8
    mid = eng.fallback_scans
    assert mid >= 1
    for _ in range(3):
        assert eng.count(t) == truth
    assert eng.fallback_scans == mid
    eng = make_fast(pats)
    assert [eng.count(t) for _ in range(11)] == [truth] * 11
    assert eng.fallback_scans == 0
