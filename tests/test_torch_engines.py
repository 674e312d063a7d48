"""PyTorch port of the named engines against the JAX package, on the CPU.

The table builders equal the JAX package's (native=False) field for field;
the fast path's stage choice and chains equal JAX's EngineFastPath; the
plain stage chain (cuda_engines.stages_plain) equals the Pallas stage
kernels in interpret mode, mask and slots; and every engine's count,
through the fast path and through the portable scan, equals JAX's portable
count and datagen.count_matches.  All integer: tolerance 0.  The CUDA
kernel itself is held against stages_plain on the card in
tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_smatcher import automata as jauto
from tpu_smatcher.engines import make_engine as jmake_engine
from tpu_smatcher.ops import pallas_engines as pe

from tpu_smatcher_torch import automata as tauto
from tpu_smatcher_torch import make_engine, make_fast
from tpu_smatcher_torch.core import datagen
from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.core.patterns import PatternSet
from tpu_smatcher_torch.ops import cuda_engines as ce
from tpu_smatcher_torch.ops import cuda_filter as cf

from torch_cases import jax_pats, make_case

TILE = 1 << 12

#: test_pallas_engines.py's CASES: sigma, m, engines (sog width == m)
ENGINE_CASES = [
    (4, 8, ["ac", "sh", "sbom", "wm", "sog8"]),       # exact tier
    (4, 16, ["ac", "sh", "sbom", "wm", "sog16"]),     # fp tier, suffix-8
    (20, 32, ["ac", "sh", "sbom", "wm", "sog32"]),    # fp tier, protein
    (2, 16, ["ac", "sh", "wm", "sog16"]),             # exact tier, binary
]


def _assert_dataclass_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, (f.name, x, y)


@pytest.mark.parametrize("sigma", [2, 4, 20, 256])
def test_builders_match_jax(sigma):
    """Every table builder, field for field, against the JAX package's
    pure-numpy branch."""
    text, pats = make_case(sigma, 8, 40, 5000, seed=sigma)
    codes = pats.codes
    for jb, tb in ((jauto.build_ac, tauto.build_ac),
                   (jauto.build_sh, tauto.build_sh),
                   (jauto.build_sbom, tauto.build_sbom),
                   (jauto.build_wm, tauto.build_wm)):
        _assert_dataclass_equal(jb(codes, sigma, native=False),
                                tb(codes, sigma))
    _assert_dataclass_equal(jauto.build_sog(codes, sigma, 8, native=False),
                            tauto.build_sog(codes, sigma, 8))
    _assert_dataclass_equal(jauto.build_verify(codes, sigma),
                            tauto.build_verify(codes, sigma))
    jac = jauto.build_ac(codes, sigma, native=False)
    tac = tauto.build_ac(codes, sigma)
    assert np.array_equal(jac.delta_packed, tac.delta_packed)
    from tpu_smatcher.automata.ac import multi_step_tables
    for q in ((2, 4) if sigma <= 4 else (2,) if sigma < 256 else ()):
        jt, jb = multi_step_tables(jac, q)
        tt, tb = tauto.multi_step_tables(tac, q)
        assert jb == tb and jt.dtype == tt.dtype and np.array_equal(jt, tt)


#: (sigma, m) of the stage-choice cases: every stage-0 branch (value stage,
#: prefix / suffix bitmap, none; the value-table threshold at sigma = 20 for
#: SOG and sigma = 256 for WM), both tiers
STAGE_CASES = [(2, 8), (4, 8), (4, 16), (4, 32), (20, 8), (20, 32),
               (128, 8), (256, 16)]


def _engine_names(m):
    return ["ac", "sh", "sbom", "wm"] + ([f"sog{m}"] if m in (8, 16, 32)
                                         else [])


@pytest.mark.parametrize("sigma,m", STAGE_CASES)
def test_stage_choice_matches_jax(sigma, m):
    """stage0, its table, _flat_ok and the _stages chains equal JAX's
    EngineFastPath (the JAX tables hold TPU weights besides; the stage
    tables are compared)."""
    text, pats = make_case(sigma, m, 40, 5000, seed=sigma + m)
    for name in _engine_names(m):
        jfp = jmake_engine(name, jax_pats(pats), interpret=True).fast_path
        tfp = make_engine(name, pats, device="cpu").fast_path
        assert tfp.stage0 == jfp.stage0, name
        assert tfp._flat_ok() == jfp._flat_ok(), name
        for jt, tt in zip(jfp.tables0, tfp.tables0, strict=True):
            want = np.asarray(jt).reshape(-1)
            got = tt.numpy()
            assert np.array_equal(want[:len(got)], got), name
            assert not want[len(got):].any(), name
        for n, k_min in ((5000, 1), (1 << 28, 1), (5000, 3)):
            jst, _, jex = jfp._stages(n, k_min=k_min)
            tst, ttab, tex = tfp._stages(n, k_min=k_min)
            assert tex == jex and tst == jst, (name, n, k_min)
            assert len(ttab) == len(tst)


def _oob(text, sigma, seed):
    """text with some bytes >= sigma: the pad sigma and 255."""
    text = text.copy()
    at = np.random.default_rng(seed).integers(0, len(text), 60)
    text[at[::2]] = sigma
    text[at[1::2]] = 255
    return text


#: stage-chain parity cases: (engine, sigma, m, guard, out-of-alphabet
#: bytes, flat layout).  Together they run every stage kind (prefix and
#: suffix wid, the exact tier's wid, fpset, wm, sog), the guard on
#: out-of-alphabet text, wm and sog lookups past their tables (unguarded,
#: where the port and the TPU agree on any bytes), both JAX layouts
MASK_CASES = [
    ("ac", 4, 16, False, False, True),      # prefix wid + fpset, flat
    ("sh", 4, 16, False, False, False),     # suffix wid + fpset, tiled
    ("wm", 4, 8, True, True, False),        # wm + exact wid, guarded
    ("sog16", 4, 16, False, True, False),   # sog + fpset, past the table
    ("wm", 20, 32, False, True, False),     # wm past the table + fpset
    ("sog8", 2, 8, True, True, False),      # sog + exact wid, guarded
    ("ac", 4, 8, True, True, False),        # exact wid alone, guarded
]


@pytest.mark.parametrize("name,sigma,m,guard,oob,flat", MASK_CASES)
def test_stages_plain_mask_matches_pallas(name, sigma, m, guard, oob, flat):
    """stages_plain (mask mode) == _run_stages / _run_stages_flat in
    interpret mode, bit for bit, on the engine's own chain; a CPU tensor
    through stages() runs the plain version and launches nothing."""
    n = 20_011                            # two 16,384-start blocks, ragged
    text, pats = make_case(sigma, m, 40, n, seed=7 * sigma + m)
    if oob:
        text = _oob(text, sigma, n)
    jfp = jmake_engine(name, jax_pats(pats), interpret=True).fast_path
    tfp = make_engine(name, pats, device="cpu").fast_path
    jst, jtab, _ = jfp._stages(n, flat=flat)
    tst, ttab, _ = tfp._stages(n)
    assert tst == jst
    jt = jnp.asarray(text)
    if flat:
        want = pe._run_stages_flat(jt, jst, jtab, m=m, n=n, mode="mask",
                                   interpret=True)
    else:
        want = pe._run_stages(jt, jst, jtab, m=m, sigma=sigma, n=n,
                              mode="mask", guard=guard, interpret=True)
    want = np.asarray(want).reshape(-1)
    t = torch.from_numpy(text)
    got = ce.stages_plain(t, tst, ttab, m=m, sigma=sigma, mode="mask",
                          guard=guard)
    n_starts = n - m + 1
    assert got.dtype == torch.int8 and got.shape == (-(-n_starts // 128), 128)
    got = got.numpy().reshape(-1)
    assert np.array_equal(got[:n_starts], want[:n_starts])
    assert not got[n_starts:].any() and not want[n_starts:].any()
    assert got.sum() > 0                  # the case has candidates
    before = dict(cf.LAUNCHES)
    again = ce.stages(t, tst, ttab, m=m, sigma=sigma, mode="mask",
                      guard=guard, flat=flat)
    count = ce.stages(t, tst, ttab, m=m, sigma=sigma, mode="count",
                      guard=guard, flat=flat)
    assert np.array_equal(again.numpy().reshape(-1), got)
    assert int(count) == int(got.sum())
    assert cf.LAUNCHES == before


def _dense_slots_case():
    """DNA m=16 with a run of 400 zero bytes and the all-zero pattern: the
    run's sub-block holds far more than 16 candidates."""
    text, pats = make_case(4, 16, 40, 36_011, seed=5)
    text = text.copy()
    text[20_000:20_400] = 0
    codes = pats.codes.copy()
    codes[0] = 0
    return text, PatternSet(codes, pats.alphabet)


@pytest.mark.parametrize("name,flat", [("ac", True), ("sog16", False)])
def test_stages_plain_slots_matches_pallas(name, flat):
    """stages_plain (slots mode) == the slot rows of _run_stages(_flat)
    (mode='slots') per 16,384-start sub-block: the first 16 positions and
    the true count, a crowded sub-block included."""
    text, pats = _dense_slots_case()
    n, m = len(text), pats.m
    jfp = jmake_engine(name, jax_pats(pats), interpret=True).fast_path
    tfp = make_engine(name, pats, device="cpu").fast_path
    jst, jtab, _ = jfp._stages(n, flat=flat)
    tst, ttab, _ = tfp._stages(n)
    jt = jnp.asarray(text)
    if flat:
        slotmat, _ = pe._run_stages_flat(jt, jst, jtab, m=m, n=n,
                                         mode="slots", interpret=True)
    else:
        slotmat, _ = pe._run_stages(jt, jst, jtab, m=m, sigma=4, n=n,
                                    mode="slots", interpret=True)
    slotmat = np.asarray(slotmat)
    pos, counts = ce.stages_plain(torch.from_numpy(text), tst, ttab, m=m,
                                  sigma=4, mode="slots")
    n_sub = -(-(n - m + 1) // cf.SUB_BLOCK)
    assert pos.dtype == counts.dtype == torch.int32
    assert pos.shape == (n_sub, 16) and counts.shape == (n_sub,)
    assert np.array_equal(pos.numpy(), slotmat[:n_sub, :16])
    assert np.array_equal(counts.numpy(), slotmat[:n_sub, 16])
    assert int(counts.max()) > 16


def test_stages_rejects_bad_chains():
    text, pats = make_case(4, 8, 20, 3000, seed=1)
    fp = make_engine("wm", pats, device="cpu").fast_path
    chain, tables, _ = fp._stages(3000)
    t = torch.from_numpy(text)
    with pytest.raises(ValueError):                # wm on the flat layout
        ce.stages(t, chain, tables, m=8, sigma=4, mode="mask", flat=True)
    with pytest.raises(ValueError):
        ce.stages(t, chain, tables, m=8, sigma=4, mode="dense")
    with pytest.raises(ValueError):                # n < m
        ce.stages(t[:7], chain, tables, m=8, sigma=4, mode="count")
    with pytest.raises(TypeError):
        ce.stages(t, chain, [tables[0].long(), tables[1]], m=8, sigma=4,
                  mode="count")


# ---------------------------------------------------------------------------
# engine counts: the fast path and the portable scan against JAX's portable
# scan and the ground truth (test_pallas_engines.py, test_ops_jnp.py)
# ---------------------------------------------------------------------------

def _engine_case(sigma, m, n=50_000):
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(n, ab, seed=61)
    pats = datagen.generate_patterns(text, 50, m, ab, frac_present=0.6,
                                     seed=62)
    return text, pats


@pytest.mark.parametrize("sigma,m,engines", ENGINE_CASES)
def test_engine_counts_match_jax(sigma, m, engines):
    """Each engine's count through the fast path (device='cpu': the plain
    stage chain), its async count, and its portable scan equal JAX's
    portable count and datagen.count_matches."""
    text, pats = _engine_case(sigma, m)
    truth = datagen.count_matches(text, pats)
    for name in engines:
        want = jmake_engine(name, jax_pats(pats), fastpath=False, tile=TILE,
                            lanes=64).count(text)
        eng = make_engine(name, pats, device="cpu", tile=TILE)
        assert eng.fast_path is not None
        portable = make_engine(name, pats, device="cpu", fastpath=False,
                               tile=TILE, lanes=64)
        assert portable.fast_path is None
        got = (eng.count(text), eng.count_async(text).result(),
               portable.count(text))
        assert got == (want, want, want) and want == truth, name


def _jnp_case(sigma, m, p, n, seed):
    text, pats = make_case(sigma, m, p, n, seed)
    return text, pats, datagen.count_matches(text, pats)


#: test_ops_jnp.py's CASES: (sigma, m, p, n)
JNP_CASES = [(2, 8, 16, 40_000), (4, 16, 32, 50_000), (4, 32, 16, 40_000),
             (20, 16, 24, 40_000), (128, 8, 16, 40_000)]


@pytest.mark.parametrize("sigma,m,p,n", JNP_CASES)
def test_portable_scans_match_truth(sigma, m, p, n):
    """fastpath=False: every engine family's portable scan (tiled, small
    tile; AC with 64 lanes) equals the ground truth."""
    text, pats, truth = _jnp_case(sigma, m, p, n, seed=7 * sigma + m)
    names = ["ac", "sh", "sbom", "wm"] + ([f"sog{m}"] if m in (8, 16, 32)
                                          else [])
    for name in names:
        eng = make_engine(name, pats, device="cpu", fastpath=False,
                          lanes=64, tile=TILE)
        assert eng.count(text) == truth, name


@pytest.mark.parametrize("q", [2, 4])
def test_ac_multistep(q):
    text, pats, truth = _jnp_case(4, 8, 64, 50_000, seed=77)
    eng = make_engine("ac", pats, device="cpu", fastpath=False, lanes=64, q=q)
    assert eng.count(text) == truth
    jeng = jmake_engine("ac", jax_pats(pats), fastpath=False, lanes=64, q=q)
    assert jeng.count(text) == truth


@pytest.mark.parametrize("lanes", [1, 8, 1024])
def test_ac_lane_invariance(lanes):
    text, pats, truth = _jnp_case(4, 16, 32, 30_000 if lanes > 1 else 6_000,
                                  seed=5)
    eng = make_engine("ac", pats, device="cpu", fastpath=False, lanes=lanes)
    assert eng.count(text) == truth


def test_ac_match_ends_positions():
    text, pats = make_case(4, 8, 32, 20_000, seed=13)
    starts = datagen.match_starts(text, pats)
    eng = make_engine("ac", pats, device="cpu", fastpath=False, lanes=32)
    ends = eng.match_ends(text)
    want = jmake_engine("ac", jax_pats(pats), fastpath=False,
                        lanes=32).match_ends(text)
    assert ends.shape == (len(text),) and np.array_equal(ends, want)
    got = np.zeros_like(starts)
    got[np.nonzero(ends)[0] - (pats.m - 1)] = True
    assert np.array_equal(got, starts)


def test_tile_boundary_exactness():
    """Matches straddling tile boundaries count once, on both paths."""
    ab = Alphabet.dna()
    m = 8
    pat = ab.encode(b"ACGTACGT")
    text = datagen.generate_text(4 * TILE, ab, seed=3)
    for s in (0, TILE - 7, TILE - 1, TILE, 2 * TILE - 4, 4 * TILE - m):
        text = datagen.plant(text, pat, [s])
    pats = PatternSet(pat[None, :], ab)
    expected = datagen.count_matches(text, pats)
    for name in ("wm", "sog8", "sh", "sbom", "ac"):
        for fastpath in (False, True):
            eng = make_engine(name, pats, device="cpu", tile=TILE, lanes=64,
                              fastpath=fastpath)
            assert eng.count(text) == expected, (name, fastpath)


def test_empty_and_short_text():
    ab = Alphabet.dna()
    pats = PatternSet(np.zeros((2, 8), np.uint8), ab)
    for name in ("ac", "sh", "sbom", "wm", "sog8"):
        for fastpath in (False, True):
            eng = make_engine(name, pats, device="cpu", tile=TILE,
                              fastpath=fastpath)
            for n in (0, 5):
                t = np.zeros(n, np.uint8)
                assert eng.count(t) == 0, (name, fastpath, n)
                assert eng.count_async(t).result() == 0
            if fastpath:
                assert eng.positions(np.zeros(5, np.uint8)).size == 0


# ---------------------------------------------------------------------------
# the fast path's other entry points (test_pallas_engines.py,
# test_pad_guard.py, test_async.py)
# ---------------------------------------------------------------------------

def test_fastpath_core_guarded():
    """core() on a text padded with sigma (a distribution shard): the
    guarded chain counts the real windows only, with no overflow."""
    ab = Alphabet.dna()
    text = datagen.generate_text(20_000, ab, seed=63)
    pats = datagen.generate_patterns(text, 30, 8, ab, seed=64)
    truth = datagen.count_matches(text, pats)
    eng = make_engine("wm", pats, device="cpu")
    ext = np.concatenate([text, np.full(7, 4, np.uint8)])
    c, o = eng.fast_path.core(ext)
    assert (int(c), int(o)) == (truth, 0)
    c, o = make_engine("ac", pats, device="cpu").fast_path.core(ext)
    assert (int(c), int(o)) == (truth, 0)


def _aliasing_case():
    """test_pad_guard.py's case: 16 zero bytes; the pattern's window id
    aliases the pad window [0]*7 + [4] under 2-bit packing."""
    pats = PatternSet(np.array([[0, 0, 0, 0, 0, 0, 1, 0]], np.uint8),
                      Alphabet.dna())
    return np.zeros(16, np.uint8), pats


def test_engine_core_no_pad_alias():
    text, pats = _aliasing_case()
    ext = np.concatenate([text, np.full(7, 4, np.uint8)])
    c, o = make_engine("ac", pats, device="cpu").fast_path.core(ext)
    assert (int(c), int(o)) == (0, 0)


def test_engine_positions_guard_out_of_alphabet_text():
    """Exact-tier positions on text holding an out-of-alphabet byte: the
    aliased window is not reported, as in FastScanner.positions."""
    text, pats = _aliasing_case()
    text[15] = 4
    fast = make_fast(pats, device="cpu")
    eng = make_engine("ac", pats, device="cpu")
    np.testing.assert_array_equal(fast.positions(text), eng.positions(text))
    assert eng.positions(text).size == 0


def test_fastpath_overflow_total_count():
    """Engine counts are total: candidates past the fast path's cap still
    count exactly (the sync ladder, then budget pieces)."""
    pats = PatternSet(np.zeros((1, 32), np.uint8), Alphabet.protein())
    eng = make_engine("wm", pats, device="cpu")
    eng.fast_path.cap = 256
    eng.fast_path.caprows = 256
    text = np.zeros(8_192, np.uint8)
    assert eng.count(text) == 8_192 - 32 + 1
    assert eng.scan_many([text]) == [8_192 - 32 + 1]


def test_engine_fastpath_count_total_on_dense_matches():
    pats = PatternSet(np.zeros((1, 12), np.uint8), Alphabet.of_size(20))
    text = np.zeros(2_600, np.uint8)       # every start matches
    fp = make_engine("wm", pats, device="cpu").fast_path
    fp.cap = 1024                          # far below the 2,589 matches
    assert fp.count(text) == 2_589
    assert fp.scan_many([text]) == [2_589]
    assert len(fp.positions(text)) == 2_589


def test_byte_alphabet_and_long_patterns():
    """sigma=256 and m=64 through the fast paths."""
    ab = Alphabet.of_size(256)
    text = datagen.generate_text(40_000, ab, seed=71)
    pats = datagen.generate_patterns(text, 40, 16, ab, frac_present=0.6,
                                     seed=72)
    truth = datagen.count_matches(text, pats)
    for name in ("wm", "ac", "sog16"):
        eng = make_engine(name, pats, device="cpu", tile=TILE)
        assert eng.count(text) == truth, name
    ab2 = Alphabet.protein()
    text2 = datagen.generate_text(40_000, ab2, seed=73)
    pats2 = datagen.generate_patterns(text2, 30, 64, ab2, frac_present=0.6,
                                      seed=74)
    truth2 = datagen.count_matches(text2, pats2)
    eng = make_engine("sh", pats2, device="cpu", tile=TILE)
    assert eng.count(text2) == truth2
    assert len(eng.positions(text2)) == truth2


def test_engine_async_fp_tier_slots():
    """The async path of the fp tier runs the slot mode and counts
    exactly; positions, matches and per-pattern counts agree with it."""
    ab = Alphabet.protein()
    text = datagen.generate_text(60_000, ab, seed=81)
    pats = datagen.generate_patterns(text, 40, 32, ab, frac_present=0.6,
                                     seed=82)
    truth = datagen.count_matches(text, pats)
    starts = np.flatnonzero(datagen.match_starts(text, pats))
    for name in ("wm", "ac"):
        eng = make_engine(name, pats, device="cpu")
        calls = []
        real = ce.stages

        def spy(*a, **kw):
            calls.append(kw["mode"])
            return real(*a, **kw)

        ce.stages = spy
        try:
            assert eng.scan_many([text]) == [truth], name
        finally:
            ce.stages = real
        assert calls == ["slots"], calls
        assert np.array_equal(eng.positions(text), starts)
        pos, ids = eng.matches(text)
        assert np.array_equal(pos, starts)
        assert np.array_equal(ids, datagen.match_ids(text, pos, pats.codes))
        assert eng.count_per_pattern(text).sum() == truth
        rep = eng.fast_path.count_repeat_async(text, 3).result()
        assert rep == 3 * truth


def test_engine_async_match_dense_adapts():
    """A match-dense corpus: the first async scan overflows and retries
    exactly, then async scans are pinned to the fallback FastScanner."""
    ab = Alphabet.dna()
    text = datagen.generate_text(120_000, ab, seed=61)
    pats = datagen.generate_patterns(text, 32, 12, ab, frac_present=0.5,
                                     seed=62)
    text = datagen.plant(text, pats.codes[0], list(range(0, 119_000, 150)))
    truth = datagen.count_matches(text, pats)
    eng = make_engine("wm", pats, device="cpu")
    fp = eng.fast_path
    fp.cap = 1024                      # force the fused path to overflow
    fp._fallback = None                # rebuild the fallback at this cap
    assert eng.count_async(text).result() == truth      # retries
    assert fp._use_fallback_async
    assert eng.count_async(text).result() == truth      # the fallback
    assert fp.count_repeat_async(text, 2).result() == 2 * truth


def test_engine_streams_and_without_fastpath(tmp_path):
    """count_file / positions_file through the engines; without a fast path
    positions raises, as in the JAX package, and attribution runs on a
    FastScanner over the engine's pattern codes (tests/test_torch_faults.py
    holds it against the JAX package)."""
    text, pats = make_case(4, 8, 30, 30_000, seed=9)
    truth = datagen.count_matches(text, pats)
    path = tmp_path / "corpus.bin"
    text.tofile(path)
    eng = make_engine("sog8", pats, device="cpu", tile=TILE)
    assert eng.count_file(str(path), chunk=7_000) == truth
    assert len(eng.positions_file(str(path), chunk=7_000)) == truth
    bare = make_engine("sh", pats, device="cpu", fastpath=False, tile=TILE)
    assert bare.count_file(str(path), chunk=7_000) == truth
    assert bare.scan_many([text, text[:100]]) == [
        truth, datagen.count_matches(text[:100], pats)]
    with pytest.raises(NotImplementedError):
        bare.positions(text)
    pos, ids = bare.matches(text)
    want = np.flatnonzero(datagen.match_starts(text, pats))
    np.testing.assert_array_equal(pos, want)
    np.testing.assert_array_equal(ids, datagen.match_ids(text, want, pats))
    assert bare.count_per_pattern(text).sum() == truth


def test_make_engine_needs_cuda_by_default():
    """device='cuda' is the default and raises without CUDA; an unknown
    name raises."""
    _, pats = make_case(4, 8, 10, 1000, seed=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_engine("wm", pats)
    with pytest.raises(ValueError):
        make_engine("kmp", pats, device="cpu")
