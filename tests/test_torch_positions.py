"""PyTorch port: positions, pattern attribution and the batch and stream
API around count equal the JAX package (Pallas kernels in interpret mode,
or its xla backend) and the numpy ground truth on the same inputs, and the
pad-guarded exact-tier plain versions equal their TPU kernels.  All
integer: tolerance 0.  The CUDA kernels are held against these plain
versions on the card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_smatcher.engines import make_fast as jax_make_fast
from tpu_smatcher.ops import fast as jfast
from tpu_smatcher.ops import keys as jkeys
from tpu_smatcher.ops import pallas_filter as pf

from tpu_smatcher_torch import make_fast
from tpu_smatcher_torch.core import datagen
from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.core.patterns import PatternSet
from tpu_smatcher_torch.ops import cuda_filter as cf
from tpu_smatcher_torch.ops import fast as tfast
from tpu_smatcher_torch.ops import keys as tkeys
from tpu_smatcher_torch.ops import verify as tverify

from torch_cases import CASES, jax_pats, make_case, wide_case


def _oracle(text, pats):
    return np.flatnonzero(datagen.match_starts(text, pats)).astype(np.int64)


def _aliasing_case():
    """tests/test_pad_guard.py's case: 16 zero bytes and one DNA pattern
    whose 2-bit packed id equals that of the pad window [0]*7 + [4]."""
    pats = PatternSet(np.array([[0, 0, 0, 0, 0, 0, 1, 0]], np.uint8),
                      Alphabet.dna())
    return np.zeros(16, np.uint8), pats


def _padded_dna():
    """DNA m=8 over ~20k bytes with out-of-alphabet bytes planted: the pad
    symbol 4 and 200, some inside matches."""
    text, pats = make_case(4, 8, 200, 20_011, seed=13)
    text = text.copy()
    starts = _oracle(text, pats)
    text[starts[::7] + 3] = 4
    text[[5, 999, 12_345, 20_010]] = 200
    text[[77, 4096, 19_000]] = 4
    return text, pats


#: the two inputs of the exact-tier kernel parity tests
EXACT_INPUTS = {"padded_dna": _padded_dna, "aliasing": _aliasing_case}


@pytest.fixture(scope="module")
def jax_exact_guarded():
    """{name: (exact_mask_pallas (R, 128), guarded count)} in interpret
    mode, on the JAX package's tables of the same codes."""
    out = {}
    for name, make in EXACT_INPUTS.items():
        text, pats = make()
        jft = jfast.build_fast(pats.codes, 4)
        n = len(text)
        mask = pf.exact_mask_pallas(jnp.asarray(text), jft.bitmaps[0], m=8,
                                    sigma=4, n=n, interpret=True)
        count = pf.exact_count_pallas(jnp.asarray(text), jft.bitmaps[0], m=8,
                                      sigma=4, n=n, guard=True,
                                      interpret=True)
        out[name] = (np.asarray(mask), int(count))
    return out


@pytest.mark.parametrize("name", list(EXACT_INPUTS))
def test_exact_mask_plain_matches_pallas(jax_exact_guarded, name):
    text, pats = EXACT_INPUTS[name]()
    tft = tfast.build_fast(pats.codes, 4, device="cpu")
    t = torch.from_numpy(text)
    got = cf.exact_mask_plain(t, tft.bitmaps[0], m=8, sigma=4)
    want = jax_exact_guarded[name][0]
    rows = -(-(len(text) - 7) // 128)
    assert got.dtype == torch.int8 and got.shape == (rows, 128)
    assert np.array_equal(got.numpy(), want[:rows])
    assert not want[rows:].any()
    # no window over a byte >= sigma is reported, every match is
    assert np.array_equal(np.flatnonzero(got.numpy().reshape(-1)),
                          _oracle(text, pats))
    before = dict(cf.LAUNCHES)      # a CPU tensor runs the plain version
    assert torch.equal(cf.exact_mask(t, tft.bitmaps[0], m=8, sigma=4), got)
    assert cf.LAUNCHES == before


@pytest.mark.parametrize("name", list(EXACT_INPUTS))
def test_exact_count_guard_plain_matches_pallas(jax_exact_guarded, name):
    text, pats = EXACT_INPUTS[name]()
    tft = tfast.build_fast(pats.codes, 4, device="cpu")
    t = torch.from_numpy(text)
    got = cf.exact_count_plain(t, tft.bitmaps[0], m=8, sigma=4, guard=True)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == jax_exact_guarded[name][1]
    assert int(got) == int(jax_exact_guarded[name][0].sum())
    before = dict(cf.LAUNCHES)
    assert int(cf.exact_count(t, tft.bitmaps[0], m=8, sigma=4,
                              guard=True)) == int(got)
    assert cf.LAUNCHES == before
    if name == "aliasing":          # the unguarded count takes the alias
        assert int(got) == 0
        ext = torch.from_numpy(np.concatenate([text, np.full(7, 4,
                                                             np.uint8)]))
        assert int(cf.exact_count_plain(ext, tft.bitmaps[0], m=8,
                                        sigma=4)) == 1


def test_max_keys_matches_jax():
    rng = np.random.default_rng(3)
    t = rng.integers(0, 256, size=(2, 300)).astype(np.int32)
    for m in (1, 5, 8, 16, 33):
        want = np.asarray(jkeys.max_keys(jnp.asarray(t), m))
        got = tkeys.max_keys(torch.from_numpy(t), m)
        assert np.array_equal(got.numpy(), want), m


@pytest.mark.parametrize("slot_ok", [True, False])
def test_verify_attr_matches_jax(slot_ok):
    """_verify_matched(return_pid=True) == verify_attr_at: the slot_ok
    branch (fp2 selects the slot) and the bucket loop (first hit)."""
    text, pats = wide_case(0.02)
    jft = jfast.build_fast(pats.codes, 4, stage_bits=32768)
    tft = tfast.build_fast(pats.codes, 4, stage_bits=32768, device="cpu")
    assert tft.slot_ok and tft.lmax > 1     # both branches exact; slots > 1
    n, m = len(text), pats.m
    n_starts = n - m + 1
    rng = np.random.default_rng(19)
    idxs = np.concatenate([_oracle(text, pats), rng.integers(0, n_starts, 2000),
                           [-1, 0, n_starts - 1, n_starts]]).astype(np.int32)
    rng.shuffle(idxs)
    tw = cf.words_view(torch.from_numpy(text), tfast.words_len(n, tft.words))
    kw = dict(m=m, words=jft.words, lmax=jft.lmax, eb=jft.eb,
              n_starts=n_starts, slot_ok=slot_ok)
    want_r, want_p = jfast.verify_attr_at(
        jnp.asarray(tw.numpy()), jnp.asarray(idxs), jft.bucket_ids,
        jft.packed, jft.bucket_fp2, **kw)
    got_r, got_p = tverify._verify_matched(
        tw, torch.from_numpy(idxs.astype(np.int64)), tft.bucket_ids,
        tft.packed, tft.bucket_fp2, return_pid=True, **kw)
    assert np.array_equal(got_r.numpy(), np.asarray(want_r))
    assert np.array_equal(got_p.numpy(), np.asarray(want_p))
    assert int(got_r.sum()) == np.isin(idxs, _oracle(text, pats)).sum()
    # the same through verify_attr (the tables' own slot_ok), in pieces
    r2, p2 = tfast.verify_attr(tw, torch.from_numpy(idxs.astype(np.int64)),
                               tft, n_starts=n_starts)
    assert torch.equal(r2, got_r) and torch.equal(p2, got_p)


def test_mask_verify_matched_matches_jax():
    """The fp piece: _mask_verify(matched=True) returns JAX's (idxs,
    match mask, internal pid, overflow) on the same tables (at the JAX
    package's width) and text."""
    text, pats = make_case(4, 16, 64, 30_011, seed=23)
    cap = 1 << 12
    jft = jfast.build_fast(pats.codes, 4)
    jeng = jfast.FastScanner(jft, cap=cap, backend="pallas", interpret=True)
    eng = tfast.FastScanner(tfast.build_fast(pats.codes, 4,
                                             stage_bits=jft.stage_bits,
                                             device="cpu"), cap=cap)
    n = len(text)
    k = tfast.stages_for(eng.ft, n, cap)
    assert k == jfast.stages_for(jeng.ft, n, cap)
    want = jeng._mask_verify(jnp.asarray(text), k, caprows=cap,
                             row_slots=128, matched=True)
    got = eng._mask_verify(torch.from_numpy(text), k, caprows=cap,
                           row_slots=128, matched=True)
    for g, w in zip(got[:3], want[:3], strict=True):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert not bool(got[3]) and not int(want[3])
    matched = got[1].numpy()
    assert np.array_equal(got[0].numpy()[matched], _oracle(text, pats))


def test_exact_hist_matches_jax():
    text, pats = make_case(4, 8, 200, 50_000, seed=29)
    codes = pats.codes.copy()
    codes[37] = codes[11]                   # duplicate: credit id 11
    jft = jfast.build_fast(codes, 4)
    tft = tfast.build_fast(codes, 4, device="cpu")
    want = np.asarray(jfast._exact_hist(jnp.asarray(text), jft.wid_pids, m=8,
                                        sigma=4, n_orig=200))
    got = tfast._exact_hist(torch.from_numpy(text), tft.wid_pids, m=8,
                            sigma=4, n_orig=200)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert want[37] == 0 and want.sum() == datagen.count_matches(text, codes)


#: CASES of both tiers for the slice as a whole: DNA m=8 and binary m=16
#: (exact), DNA m=16 and a protein-sized alphabet at m=8 (fingerprint)
SLICE_CASES = [CASES[2], CASES[1], CASES[3], CASES[5]]


@pytest.mark.parametrize("sigma,m,p_size,n", SLICE_CASES)
def test_slice_matches_jax(sigma, m, p_size, n):
    """positions, matches and count_per_pattern equal the JAX package's
    (xla backend) and the ground truth, and agree with count."""
    text, pats = make_case(sigma, m, p_size, n, seed=3 * sigma + m)
    jeng = jax_make_fast(jax_pats(pats), backend="xla")
    eng = make_fast(pats, device="cpu")
    assert eng.ft.exact == jeng.ft.exact == (m * (sigma - 1).bit_length()
                                            <= 16)
    pos = eng.positions(text)
    pm, ids = eng.matches(text)
    per = eng.count_per_pattern(text)
    jpm, jids = jeng.matches(text)
    np.testing.assert_array_equal(pos, jeng.positions(text))
    np.testing.assert_array_equal(pm, jpm)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(per, jeng.count_per_pattern(text))
    assert pos.dtype == ids.dtype == per.dtype == np.int64
    np.testing.assert_array_equal(pos, _oracle(text, pats))
    np.testing.assert_array_equal(pm, pos)
    np.testing.assert_array_equal(ids, datagen.match_ids(text, pos, pats))
    assert per.shape == (p_size,) and per.sum() == eng.count(text) == len(pos)


# ---------------------------------------------------------------------------
# counterparts of tests/test_positions.py on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sigma,m", [(4, 8), (2, 12), (4, 16), (20, 32)])
def test_positions_both_tiers(sigma, m):
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(60_000, ab, seed=31)
    pats = datagen.generate_patterns(text, 40, m, ab, frac_present=0.6,
                                     seed=32)
    eng = make_fast(pats, device="cpu")
    assert eng.ft.exact == (m * (sigma - 1).bit_length() <= 16)
    got = eng.positions(torch.from_numpy(text))
    np.testing.assert_array_equal(got, _oracle(text, pats))


def test_positions_short_text():
    ab = Alphabet.dna()
    pats = datagen.generate_patterns(datagen.generate_text(100, ab, seed=1),
                                     4, 8, ab, seed=2)
    eng = make_fast(pats, device="cpu")
    assert eng.positions(np.zeros(3, np.uint8)).size == 0
    pos, ids = eng.matches(np.zeros(3, np.uint8))
    assert pos.size == ids.size == 0
    np.testing.assert_array_equal(eng.count_per_pattern(np.zeros(3, np.uint8)),
                                  np.zeros(4, np.int64))


@pytest.mark.parametrize("sigma,m", [(4, 8), (20, 32)])
def test_positions_unbounded_dense(sigma, m):
    """Every start matches, far past the cap: pieces split until they fit,
    and every position streams out (both tiers)."""
    pats = PatternSet(np.zeros((1, m), np.uint8), Alphabet.of_size(sigma))
    eng = make_fast(pats, device="cpu", cap=256)
    n = 6_000
    got = eng.positions(np.zeros(n, np.uint8))
    np.testing.assert_array_equal(got, np.arange(n - m + 1, dtype=np.int64))
    pos, ids = eng.matches(np.zeros(n, np.uint8))
    np.testing.assert_array_equal(pos, got)
    assert not ids.any()


def test_positions_chunked_dense():
    """chunk= presizes the pieces (test_positions_xla_dense_chunked)."""
    pats = PatternSet(np.zeros((1, 12), np.uint8), Alphabet.of_size(2))
    eng = make_fast(pats, device="cpu", cap=512)
    got = eng.positions(np.zeros(20_000, np.uint8), chunk=700)
    np.testing.assert_array_equal(got, np.arange(20_000 - 11, dtype=np.int64))


def test_piece_overflow_below_the_guarantee_raises(monkeypatch):
    """A piece of <= cap/2 starts that overflows is a bug, not a split."""
    text, pats = make_case(4, 8, 200, 5_000, seed=3)
    eng = make_fast(pats, device="cpu", cap=8192)

    def always_over(piece):
        idxs, _ = tfast.FastScanner._positions_piece(eng, piece)
        return idxs, torch.ones((), dtype=torch.bool)

    monkeypatch.setattr(eng, "_positions_piece", always_over)
    with pytest.raises(AssertionError, match="guaranteed size"):
        eng.positions(text)


def _weights(kind):
    """Per-start match weights of the piece pipeline's fake scans."""
    if kind == "uniform":
        return np.ones(1025, np.int64)
    rng = np.random.default_rng(7)
    w = rng.integers(0, 3, 3001)
    w[1200:1700] = 9                      # a dense stretch
    return w


#: (weights, presize, limit, min_chunk): a fake scan overflows when its
#: piece's weight exceeds limit
PIPELINE_CASES = {
    "odd_uniform": ("uniform", None, 256, 64),
    "dense_stretch": ("dense", None, 300, 32),
    "presized": ("dense", 700, 300, 32),
    "min_chunk_floor": ("dense", 1001, 300, 16),
    "below_the_guarantee": ("uniform", None, 256, 300),
}


@pytest.mark.parametrize("case", list(PIPELINE_CASES))
def test_split_pieces(case):
    """common.split_pieces on a fake scan: an overflowing piece splits in
    two at max(min_chunk, ceil(owned / 2)); every start is owned by one
    yielded piece; the values sum to the truth; at depth 1 the pieces come
    in text order, and the pieces do not depend on the depth; a piece of
    <= min_chunk starts that overflows raises."""
    from tpu_smatcher_torch.ops.common import cut_pieces, split_pieces
    kind, presize, limit, min_chunk = PIPELINE_CASES[case]
    w = _weights(kind)
    total = len(w)
    work = cut_pieces(0, total, presize or total)

    def run(depth):
        launched = []

        def launch(start, owned):
            launched.append((start, owned))
            return int(w[start:start + owned].sum())

        out = list(split_pieces(work, launch, lambda v: (v > limit, v),
                                min_chunk=min_chunk, depth=depth))
        return out, launched

    if case == "below_the_guarantee":
        with pytest.raises(AssertionError, match="guaranteed size"):
            run(4)
        return
    out, launched = run(1)
    starts = [s for s, _, _ in out]
    assert starts == sorted(starts)
    owned = np.zeros(total, np.int64)
    for s, o, v in out:
        owned[s:s + o] += 1
        assert v == w[s:s + o].sum() <= limit
    assert (owned == 1).all()
    assert sum(v for _, _, v in out) == w.sum()
    for s, o in launched:
        if w[s:s + o].sum() > limit:
            half = max(min_chunk, -(-o // 2))
            assert (s, half) in launched and (s + half, o - half) in launched
    assert len(launched) == len(work) + 2 * (len(launched) - len(out))
    for depth in (2, 4):
        out_d, launched_d = run(depth)
        assert sorted(out_d) == out and sorted(launched_d) == \
            sorted(launched)


def test_count_chunked_splits_odd_pieces_in_two(monkeypatch):
    """_count_chunked on an all-matching text of 1,025 starts at cap=256:
    every overflowing dense-core scan splits into two pieces (a split at
    owned // 2 would make three), and the count is exact."""
    pats = PatternSet(np.zeros((1, 16), np.uint8), Alphabet.dna())
    eng = make_fast(pats, device="cpu", cap=256)
    assert not eng.ft.exact
    scans = []
    dense = eng._dense_core()

    def spy(piece):
        c, o = dense(piece)
        scans.append(bool(o))
        return c, o

    monkeypatch.setattr(eng, "_dense_core", lambda: spy)
    n_starts = 1025
    assert eng._count_chunked(torch.zeros(n_starts + 15,
                                          dtype=torch.uint8)) == n_starts
    split = sum(scans)
    assert split > 0 and len(scans) == 1 + 2 * split


def test_matches_attribution():
    """Smallest id on duplicate patterns; every id's pattern equals the
    window at its position; a non-match raises in datagen.match_ids."""
    ab = Alphabet.dna()
    text = datagen.generate_text(40_000, ab, seed=71)
    pats = datagen.generate_patterns(text, 30, 8, ab, frac_present=0.7,
                                     seed=72)
    codes = np.vstack([pats.codes, pats.codes[3:4]])
    pats = PatternSet(codes, ab)
    text = datagen.plant(text, codes[3], [123])
    eng = make_fast(pats, device="cpu")
    pos, ids = eng.matches(text)
    np.testing.assert_array_equal(pos, _oracle(text, pats))
    np.testing.assert_array_equal(text[pos[:, None] + np.arange(8)],
                                  codes[ids])
    assert ids.max() < 30
    assert 123 in pos and ids[list(pos).index(123)] == 3
    non_match = next(i for i in range(1000) if i not in set(pos.tolist()))
    with pytest.raises(ValueError):
        datagen.match_ids(text, np.array([non_match]), pats)


def test_matches_attribution_fp_tier_duplicates():
    """The fingerprint tier dedups the patterns: ids are original ids, the
    smallest of a duplicate pair."""
    ab = Alphabet.of_size(20)
    text = datagen.generate_text(40_000, ab, seed=73)
    pats = datagen.generate_patterns(text, 30, 16, ab, frac_present=0.7,
                                     seed=74)
    codes = np.vstack([pats.codes[5:6], pats.codes])   # id 0 == id 6
    pats = PatternSet(codes, ab)
    eng = make_fast(pats, device="cpu")
    pos, ids = eng.matches(text)
    np.testing.assert_array_equal(pos, _oracle(text, pats))
    np.testing.assert_array_equal(ids, datagen.match_ids(text, pos, pats))
    assert 0 in ids and 6 not in ids


def test_count_per_pattern():
    ab = Alphabet.dna()
    text = datagen.generate_text(40_000, ab, seed=81)
    pats = datagen.generate_patterns(text, 25, 8, ab, frac_present=0.7,
                                     seed=82)
    eng = make_fast(pats, device="cpu")
    per = eng.count_per_pattern(text)
    assert per.shape == (25,) and per.sum() == eng.count(text)
    win = datagen.sliding_windows(text, 8)
    for i, pat in enumerate(pats.codes):
        assert per[i] == int((win == pat).all(axis=1).sum())


_EXACT_HIST = tfast._exact_hist


def test_count_per_pattern_dense_wid_histogram(monkeypatch):
    """A match-dense exact-tier text takes the window-id histogram
    (_exact_hist); it equals the piece path and the host oracle, with the
    duplicate credited to the smallest id."""
    ab = Alphabet.dna()
    text = datagen.generate_text(100_000, ab, seed=91)
    pats = datagen.generate_patterns(text, 400, 8, ab, frac_present=0.9,
                                     seed=92)
    codes = np.array(pats.codes)
    codes[37] = codes[11]
    pats = PatternSet(codes, ab)
    truth = datagen.count_matches(text, pats)
    dense = make_fast(pats, device="cpu", cap=256)
    assert truth > dense.cap // 2
    calls = []
    monkeypatch.setattr(tfast, "_exact_hist",
                        lambda *a, **k: calls.append(1)
                        or _EXACT_HIST(*a, **k))
    per = dense.count_per_pattern(text)
    assert calls == [1]
    assert int(per.sum()) == truth and per[37] == 0
    sparse = make_fast(pats, device="cpu")
    np.testing.assert_array_equal(sparse.count_per_pattern(text), per)
    assert calls == [1]
    want = np.bincount(datagen.match_ids(text, _oracle(text, pats), pats),
                       minlength=400)
    np.testing.assert_array_equal(per, want)


def test_attribution_without_tables_raises():
    """Tables without attribution (n_orig 0) raise in matches and
    count_per_pattern: attribution never moves to the host; positions
    needs no attribution and still runs."""
    import dataclasses
    text, pats = make_case(20, 8, 64, 30_000, seed=5)
    eng = make_fast(pats, device="cpu")
    want = eng.positions(text)
    eng.ft = dataclasses.replace(eng.ft, n_orig=0, orig_ids=None)
    np.testing.assert_array_equal(eng.positions(text), want)
    with pytest.raises(ValueError, match="attribution"):
        eng.matches(text)
    with pytest.raises(ValueError, match="attribution"):
        eng.count_per_pattern(text)


def test_long_patterns_positions_run_the_plain_piece():
    """m > MAX_KERNEL_M: positions, matches and core take plain torch (a
    small cap keeps the verify of 4100-byte windows small)."""
    ab = Alphabet.dna()
    text = datagen.generate_text(12_000, ab, seed=43)
    pats = datagen.generate_patterns(text, 4, 4100, ab, frac_present=0.5,
                                     seed=44)
    eng = make_fast(pats, device="cpu", cap=64)
    assert not eng._kernels()
    want = _oracle(text, pats)
    assert want.size >= 1
    np.testing.assert_array_equal(eng.positions(text), want)
    pos, ids = eng.matches(text)
    np.testing.assert_array_equal(ids, datagen.match_ids(text, want, pats))
    c, o = eng.core(text)
    assert (int(c), int(o)) == (want.size, 0)


def test_positions_file_streaming(tmp_path):
    """positions_file = positions of the whole file, in (m-1)-halo pieces,
    with matches straddling the piece boundaries."""
    ab = Alphabet.dna()
    text = datagen.generate_text(50_000, ab, seed=61)
    pats = datagen.generate_patterns(text, 40, 8, ab, frac_present=0.6,
                                     seed=62)
    text = datagen.plant(text, pats.codes[0], [12_997, 25_999])
    path = tmp_path / "c.bin"
    text.tofile(path)
    eng = make_fast(pats, device="cpu")
    np.testing.assert_array_equal(eng.positions_file(str(path), chunk=13_000),
                                  _oracle(text, pats))


# ---------------------------------------------------------------------------
# the pad guard (tests/test_pad_guard.py) and the distribution core
# ---------------------------------------------------------------------------

def test_count_and_positions_no_pad_alias():
    text, pats = _aliasing_case()
    eng = make_fast(pats, device="cpu")
    assert eng.count(text) == 0
    assert eng.positions(text).size == 0
    text = text.copy()
    text[15] = 4                    # window [8:16] = [0]*7 + [4] aliases
    assert eng.positions(text).size == 0
    assert eng.matches(text)[0].size == 0


def test_core_guards_the_pad():
    """core() on a shard padded with sigma: the pad windows alias the
    pattern and must not count; a real text counts in full."""
    text, pats = _aliasing_case()
    eng = make_fast(pats, device="cpu")
    ext = np.concatenate([text, np.full(7, 4, np.uint8)])
    c, o = eng.core(ext)
    assert (c.dtype, int(c), int(o)) == (torch.int32, 0, 0)
    c, o = tfast.fast_count_core(torch.from_numpy(ext), eng.ft, guard=True)
    assert int(c) == 0
    c, _ = tfast.fast_count_core(torch.from_numpy(ext), eng.ft)
    assert int(c) == 1              # the alias the guard removes
    for sigma, m, p, n in (CASES[2], CASES[4]):
        text, pats = make_case(sigma, m, p, 30_000, seed=sigma + m)
        eng = make_fast(pats, device="cpu")
        c, o = eng.core(torch.from_numpy(text))
        assert (int(c), int(o)) == (datagen.count_matches(text, pats), 0)


# ---------------------------------------------------------------------------
# batches, repeats and streaming (tests/test_fast.py, tests/test_async.py)
# ---------------------------------------------------------------------------

def test_count_stack_parity():
    """count_stack == the sum of per-text counts on both tiers, a planted
    straddler across a shard boundary does not count, and a stack of
    shards shorter than m counts 0."""
    ab = Alphabet.of_size(4)
    nsh = 30_000
    texts = [datagen.generate_text(nsh, ab, seed=s) for s in (1, 2, 3)]
    batch = np.stack(texts)
    for m, p in ((8, 100), (16, 64)):
        pats = datagen.generate_patterns(np.concatenate(texts), p, m, ab,
                                         frac_present=0.3, seed=9 + m)
        truth = sum(datagen.count_matches(t, pats) for t in texts)
        eng = make_fast(pats, device="cpu")
        assert eng.count_stack(batch) == truth
        assert eng.count_stack(torch.from_numpy(batch)) == truth
    pats = datagen.generate_patterns(np.concatenate(texts), 64, 16, ab,
                                     frac_present=0.3, seed=77)
    t2 = batch.copy()
    t2[0, -8:] = pats.codes[0][:8]
    t2[1, :8] = pats.codes[0][8:]
    truth = sum(datagen.count_matches(t2[i], pats) for i in range(3))
    flat = datagen.count_matches(t2.reshape(-1), pats)
    assert flat == truth + 1        # the straddler no shard holds
    eng = make_fast(pats, device="cpu")
    assert eng.count_stack(t2) == truth
    assert eng.count_stack_async(t2).result() == truth
    short = t2[:, :10]              # nsh < m: no window
    assert eng.count_stack(short) == 0


def test_count_repeat_async():
    """reps scans summed in one future, on both tiers; the fp case's warm
    count adapts the scanner (its slot route overflows on matches), and
    the repeats then run the dense pass, as count_async would."""
    for sigma, m, p in ((4, 8, 64), (4, 16, 64)):
        text, pats = make_case(sigma, m, p, 50_000, seed=31)
        truth = datagen.count_matches(text, pats)
        eng = make_fast(pats, device="cpu")
        t = torch.from_numpy(text)
        assert eng.count(t) == truth
        assert eng._match_dense == (m == 16)
        assert eng.count_repeat_async(t, 1).result() == truth
        assert eng.count_repeat_async(t, 3).result() == 3 * truth


def test_count_file_streaming(tmp_path):
    ab = Alphabet.dna()
    text = datagen.generate_text(100_003, ab, seed=41)
    pats = datagen.generate_patterns(text, 60, 8, ab, frac_present=0.6,
                                     seed=42)
    path = tmp_path / "c.bin"
    text.tofile(path)
    eng = make_fast(pats, device="cpu")
    want = datagen.count_matches(text, pats)
    assert eng.count_file(str(path), chunk=1 << 14) == want
    assert eng.count_file(str(path), chunk=1 << 14, depth=1) == want
    assert eng.count_file(str(path), chunk=1 << 20) == want   # one piece


@pytest.mark.parametrize("sigma,m,p_size,n", [CASES[2], CASES[4]])
def test_scan_many_both_tiers(sigma, m, p_size, n):
    text, pats = make_case(sigma, m, p_size, n, seed=3 * sigma + m)
    eng = make_fast(pats, device="cpu")
    got = eng.scan_many([text, text[:30_000], torch.from_numpy(text[:5])])
    assert got == [datagen.count_matches(text, pats),
                   datagen.count_matches(text[:30_000], pats), 0]


def test_build_fast_needs_a_device():
    with pytest.raises(TypeError):
        tfast.build_fast(np.zeros((2, 8), np.uint8), 4)
