"""PyTorch port: the fingerprint tier's router, compactions and overflow
ladder equal the JAX package's (Pallas kernels in interpret mode) on the
same inputs, and every route and ladder step counts exactly.  All integer:
tolerance 0.  Inputs stay at or under 2^17 starts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_smatcher.ops import fast as jfast
from tpu_smatcher.ops import pallas_filter as pf

from tpu_smatcher_torch.core import datagen
from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.core.patterns import PatternSet
from tpu_smatcher_torch.ops import cuda_filter as cf
from tpu_smatcher_torch.ops import fast as tfast

from test_adversarial import _planted
from torch_cases import port_pats, wide_case

N = 1 << 17
N_FULL = 1 << 28          # bench.py's corpus: the router needs no text

#: name -> (sigma, m, p, stage_bits): the router's table cases
ROUTE_TABLES = {
    "dna32_p1000": (4, 32, 1000, None),
    "dna16_p1000": (4, 16, 1000, None),
    "prot16_p2000": (20, 16, 2000, None),
    "dna32_p10k_4096": (4, 32, 10_000, 4096),
    "wide": None,
    "dna32_p10k": (4, 32, 10_000, None),
}


def _case(name, frac=0.5):
    if name == "wide":
        text, pats = wide_case(0.02)
        return text, pats, 32768
    sigma, m, p, sb = ROUTE_TABLES[name]
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(N, ab, seed=21)
    pats = datagen.generate_patterns(text, p, m, ab, frac_present=frac,
                                     seed=22)
    return text, pats, sb


def _scanners(pats, stage_bits, **kw):
    """(JAX FastScanner on the Pallas backend in interpret mode, the port's
    FastScanner on the CPU), over tables built from the same codes at one
    stage width (the JAX package's where stage_bits is None: the port's
    own default is the H100's)."""
    jft = jfast.build_fast(pats.codes, pats.sigma, stage_bits=stage_bits)
    jeng = jfast.FastScanner(jft, backend="pallas", interpret=True, **kw)
    eng = tfast.FastScanner(
        tfast.build_fast(pats.codes, pats.sigma, stage_bits=jft.stage_bits,
                         device="cpu"), **kw)
    return jeng, eng


def _state(eng):
    return eng.fallback_scans, eng._k_extra, eng._match_dense


def _jstate(jeng):
    return jeng._retries, jeng._k_extra, jeng._match_dense


@pytest.mark.parametrize("name", list(ROUTE_TABLES))
def test_pick_path_matches_jax(name):
    """The router is arithmetic on the tables: equal routes at bench.py's
    n = 2^28 and at the test's n, for every _k_extra the adaptation can
    reach, and it never raises for fingerprint tables."""
    text, pats, sb = _case(name)
    jeng, eng = _scanners(pats, sb)
    for n in (N_FULL, len(text)):
        k = tfast.stages_for(eng.ft, n, eng.cap)
        assert k == jfast.stages_for(jeng.ft, n, jeng.cap)
        for ke in range(5):
            jeng._k_extra = eng._k_extra = ke
            assert eng._pick_path(n, k) == jeng._pick_path(n, k), (n, ke)
    jeng._k_extra = eng._k_extra = 0
    want = {"dna32_p1000": "slot", "dna16_p1000": "slot",
            "prot16_p2000": "slot", "dna32_p10k_4096": "mask",
            "wide": "cascade", "dna32_p10k": "cascade"}[name]
    k = tfast.stages_for(eng.ft, N_FULL, eng.cap)
    assert eng._pick_path(N_FULL, k)[0] == want


@pytest.mark.parametrize("name,frac,n,retries", [
    ("dna32_p1000", 0.02, 1 << 15, 0),      # slot route
    ("dna32_p1000", 0.5, 1 << 15, 1),       # slots crowded by matches
    ("dna32_p10k_4096", 0.02, 1 << 15, 1),  # mask route, rows over 8
    ("wide", None, 1 << 16, 0),             # cascade
])
def test_route_counts_match_jax(name, frac, n, retries):
    """count_async on each route (slot, mask, cascade): the count equals
    the JAX package's and the ground truth, and the retry counter, _k_extra
    and _match_dense end equal.  Where the scan overflows, the retry
    switches both packages to the dense pass; the port's second scan runs
    it, exactly and without another retry.  (The JAX package's own tests
    hold its dense pass; compiling it here in interpret mode would double
    the test's time.)"""
    text, pats, sb = _case(name, frac)
    text = text[:n]
    jeng, eng = _scanners(pats, sb)
    truth = datagen.count_matches(text, pats)
    t = torch.from_numpy(text)
    assert eng.count_async(t).result() == jeng.count_async(text).result() \
        == truth
    assert _state(eng) == _jstate(jeng)
    assert eng.count_async(t).result() == truth
    assert eng.fallback_scans == retries
    assert eng._match_dense == bool(retries)


def _slot_input(rng, n_sub, *, overflow):
    counts = rng.integers(0, 6, n_sub)
    if overflow:
        counts[n_sub // 2] = 40
    pos = np.full((n_sub, 16), -1, np.int32)
    for b in range(n_sub):
        c = min(int(counts[b]), 16)
        pos[b, :c] = np.sort(rng.choice(16384, c, replace=False)) + 16384 * b
    slotmat = np.full((n_sub, 128), -1, np.int32)
    slotmat[:, :16] = pos
    slotmat[:, 16] = counts
    return pos, counts.astype(np.int32), slotmat


@pytest.mark.parametrize("overflow,cap", [(False, 1024), (True, 1024),
                                          (False, 64)])
def test_compact_slots_matches_jax(overflow, cap):
    """Equal idxs, overflow (a sub-block over its 16 slots, or more than
    cap candidates) and n_cand (the true total)."""
    pos, counts, slotmat = _slot_input(np.random.default_rng(4), 40,
                                       overflow=overflow)
    want = jfast.compact_slots(jnp.asarray(slotmat), slots=16, cap=cap)
    got = tfast.compact_slots(torch.from_numpy(pos), torch.from_numpy(counts),
                              slots=16, cap=cap)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert bool(got[1]) == bool(int(want[1])) == (overflow or cap == 64)
    assert int(got[2]) == int(want[2]) == int(counts.sum())


def _mask_input(rng, R=300):
    mask = (rng.random((R, 128)) < 0.01).astype(np.int8)
    mask[rng.random(R) < 0.5] = 0
    mask[7, :20] = 1                        # one match-dense row
    return mask


@pytest.mark.parametrize("caprows,cap,row_slots,want_ovf", [
    (1024, 4096, 128, False),
    (1024, 4096, 8, True),                  # row 7 holds 20 > 8
    (16, 4096, 128, True),                  # more live rows than caprows
    (1024, 64, 128, True),                  # more candidates than cap
])
def test_compact_mask_matches_jax(caprows, cap, row_slots, want_ovf):
    mask = _mask_input(np.random.default_rng(5))
    want = jfast.compact_mask(jnp.asarray(mask), caprows=caprows, cap=cap,
                              row_slots=row_slots)
    got = tfast.compact_mask(torch.from_numpy(mask), caprows=caprows,
                             cap=cap, row_slots=row_slots)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert bool(got[1]) == bool(int(want[1])) == want_ovf
    assert int(got[2]) == int(want[2])


@pytest.mark.parametrize("cap,row_slots", [
    (1 << 16, 128),             # the half-cap trial fits
    (8192, 128),                # half-cap overflows, the full cap fits
    (8192, 8),                  # rows hold > 8: only the 128-slot trial fits
    (4096, 128),                # every trial overflows
])
def test_compact_verify_retry_matches_jax(cap, row_slots):
    """The sync ladder's trials over one mask (one stage at 4096 bits:
    ~7,000 candidates, ~22 per 128-start row, a run of 185 matches):
    equal (count, overflowed), exact when a trial fits."""
    ab = Alphabet.of_size(4)
    text = datagen.generate_text(40_000, ab, seed=31)
    codes = datagen.generate_patterns(text, 700, 16, ab, frac_present=0.8,
                                      seed=32).codes.copy()
    codes[0] = 0
    text = text.copy()
    text[5000:5200] = 0
    pats = PatternSet(codes, ab)
    jft = jfast.build_fast(codes, 4, stage_bits=4096)
    tft = tfast.build_fast(codes, 4, stage_bits=4096, device="cpu")
    n, m, k = len(text), pats.m, 1
    t = torch.from_numpy(text)
    mask = cf.filter_mask(t, tft.bitmaps[:k], m=m, cd=tft.cd(k))
    tw = cf.words_view(t, tfast.words_len(n, tft.words))
    # caprows above the mask's 313 rows: the trials' row bound never binds
    kw = dict(cap=cap, caprows=1024, row_slots=row_slots,
              n_starts=n - m + 1)
    got = tfast.compact_verify_retry(mask, tw, tft, **kw)
    want = jfast.compact_verify_retry(jnp.asarray(mask.numpy()),
                                      jnp.asarray(tw.numpy()), jft, **kw)
    assert got == want
    assert got[1] == (cap == 4096)
    if not got[1]:
        assert got[0] == datagen.count_matches(text, pats)


def test_slot_kernel_matches_mask_path():
    """filter_slots + compact_slots yields exactly the filter_mask +
    compact_mask candidates when no sub-block overflows, a subset when one
    does, and the true per-sub-block counts either way
    (test_fast.py::test_slot_kernel_matches_mask_path)."""
    text, pats, _ = _case("dna16_p1000", 0.02)
    eng = tfast.FastScanner(tfast.build_fast(pats.codes, 4, device="cpu"))
    ft = eng.ft
    t = torch.from_numpy(text)
    seen = set()
    for k in (tfast.stages_for_block(ft, tfast.SLOT_BLOCK), 1):
        k = min(k, len(ft.bitmaps))
        args = dict(m=ft.m, cd=ft.cd(k))
        pos, counts = cf.filter_slots(t, ft.bitmaps[:k], **args)
        idxs_s, o_s, n_cand = tfast.compact_slots(pos, counts, cap=eng.cap)
        mask2d = cf.filter_mask(t, ft.bitmaps[:k], **args)
        idxs_m, o_m, _ = tfast.compact_mask(mask2d, caprows=eng.cap,
                                            cap=eng.cap, row_slots=128)
        a = np.sort(idxs_s.numpy()[idxs_s.numpy() >= 0])
        b = np.sort(idxs_m.numpy()[idxs_m.numpy() >= 0])
        assert not bool(o_m)
        if not bool(o_s):
            assert np.array_equal(a, b) and int(n_cand) == len(a)
        else:
            assert set(a.tolist()) < set(b.tolist())
        assert int(counts.sum()) == int(mask2d.sum()) == int(n_cand)
        seen.add(bool(o_s))
    assert seen == {False, True}


def test_slot_overflow_falls_back_exact():
    """Every window matches: the slot route overflows, and the future's
    retry counts exactly (test_fast.py::test_slot_overflow_falls_back_exact)."""
    pats = PatternSet(np.zeros((1, 8), np.uint8), Alphabet.protein())
    text = np.zeros(50_000, np.uint8)
    eng = tfast.FastScanner(tfast.build_fast(pats.codes, 20, device="cpu"),
                            cap=1 << 12)
    n = len(text)
    assert eng._pick_path(n, tfast.stages_for(eng.ft, n, eng.cap))[0] == \
        "slot"
    assert eng.count_async(torch.from_numpy(text)).result() == 50_000 - 7
    assert eng.fallback_scans == 1 and eng._match_dense


def test_overflow_flag():
    """An all-match corpus overflows every cap trial of the sync path,
    equal to the JAX package's flag and count; count() still counts
    exactly (test_fast.py::test_overflow_flag)."""
    pats = PatternSet(np.zeros((1, 16), np.uint8), Alphabet.dna())
    text = np.zeros(40_000, np.uint8)
    jeng, eng = _scanners(pats, None, cap=1 << 8)
    got = eng.count_with_overflow(text)
    assert got == jeng.count_with_overflow(text) and got[1]
    assert eng.count(text) == 40_000 - 15


@pytest.fixture(scope="module")
def dense_text():
    """test_dense_matches.py's case: every window of a zero text hits."""
    pats = PatternSet(np.zeros((1, 32), np.uint8), Alphabet.of_size(20))
    return np.zeros(40_000, np.uint8), pats, 40_000 - 31


def test_fast_dense(dense_text):
    text, pats, truth = dense_text
    eng = tfast.FastScanner(tfast.build_fast(pats.codes, 20, device="cpu"),
                            cap=1024)
    assert eng.count(text) == truth
    assert eng.fallback_scans == 1 and eng._match_dense
    assert eng.count_with_overflow(text)[1]     # the cap cannot hold them


def test_mixed_density(dense_text):
    text, pats, _ = dense_text
    text2 = np.concatenate([np.zeros(20_000, np.uint8),
                            datagen.generate_text(20_000, Alphabet.of_size(20),
                                                  seed=3)])
    truth = datagen.count_matches(text2, pats)
    eng = tfast.FastScanner(tfast.build_fast(pats.codes, 20, device="cpu"),
                            cap=1024)
    assert eng.count(text2) == truth


def test_adversarial_adaptation_converges():
    """Planted fingerprint collisions pass every stage: the adaptation
    ladder (_k_extra bumps, then the terminal dense switch) must converge,
    exact on every scan (test_adversarial.py)."""
    text, jpats = _planted()
    pats = port_pats(jpats.codes, 4)
    truth = datagen.count_matches(text, pats)
    eng = tfast.FastScanner(tfast.build_fast(pats.codes, 4, device="cpu"))
    t = torch.from_numpy(text)
    assert [eng.count(t) for _ in range(7)] == [truth] * 7
    mid = eng.fallback_scans
    assert 1 <= mid <= 6
    assert [eng.count(t) for _ in range(2)] == [truth] * 2
    assert eng.fallback_scans == mid and eng._match_dense


def test_async_retry_adds_filter_stages():
    """A false-candidate-driven retry is exact and bumps _k_extra up to 4;
    the next one is terminal and switches to the dense pass — after each
    call the same state as the JAX package's (test_async.py)."""
    ab = Alphabet.of_size(20)
    text = datagen.generate_text(N, ab, seed=15)
    pats = datagen.generate_patterns(text, 80, 12, ab, frac_present=0.2,
                                     seed=16)
    truth = datagen.count_matches(text, pats)
    assert truth * 16384 / (len(text) - 11) <= 4     # match-sparse
    jeng, eng = _scanners(pats, None)
    t = torch.from_numpy(text)
    for want in ((1, False), (2, False), (3, False), (4, False), (4, True)):
        assert eng._async_retry(t) == jeng._async_retry(text) == truth
        assert (eng._k_extra, eng._match_dense) == \
            (jeng._k_extra, jeng._match_dense) == want
        if want == (1, False):
            assert eng.count_async(t).result() == truth
    k = tfast.stages_for(eng.ft, N_FULL, eng.cap)
    assert eng._pick_path(N_FULL, k) == jeng._pick_path(N_FULL, k)
    assert eng.count_async(t).result() == truth       # the dense pass


def test_async_retry_match_dense_switch():
    """A match-driven retry switches to the dense pass and leaves _k_extra,
    as the JAX package's does; the dense pass then counts exactly with no
    retry (test_async.py)."""
    ab = Alphabet.of_size(20)
    text = datagen.generate_text(60_000, ab, seed=5)
    pats = datagen.generate_patterns(text, 80, 12, ab, frac_present=0.5,
                                     seed=6)
    truth = datagen.count_matches(text, pats)
    assert truth * 16384 / (len(text) - pats.m + 1) > 8
    jeng, eng = _scanners(pats, None)
    t = torch.from_numpy(text)
    assert eng._async_retry(t) == jeng._async_retry(text) == truth
    assert (eng._k_extra, eng._match_dense) == \
        (jeng._k_extra, jeng._match_dense) == (0, True)
    for _ in range(2):
        assert eng.count_async(t).result() == truth
    assert eng.fallback_scans == 1


def test_saturated_tables_scan_in_budget_pieces():
    """At 4096-bit stages p=10k fills every stage (0.9): all 32 stages
    still miss a small cap's budget, so the sync path scans budget-sized
    pieces on the dense pass.  Equal to the JAX package and exact."""
    text, pats, sb = _case("dna32_p10k_4096", 0.02)
    text = text[:1 << 15]
    jeng, eng = _scanners(pats, sb, cap=4096)
    ft, n = eng.ft, len(text)
    k = tfast.stages_for(ft, n, eng.cap)
    assert k >= len(ft.bitmaps) and n * ft.density ** k > eng.cap / 4
    truth = datagen.count_matches(text, pats)
    assert eng.count_with_overflow(text) == \
        jeng.count_with_overflow(text) == (truth, False)
    assert eng._count_retry(torch.from_numpy(text)) == truth
