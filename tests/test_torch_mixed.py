"""Mixed-length pattern sets of the PyTorch port (MixedPatternSet,
make_mixed) against the JAX package's, on the CPU, tolerance 0: the same
seeded texts and pattern rows go through both (the JAX package on its xla
backend), and through the per-length datagen oracle.  Mirrors
tests/test_mixed.py but for its CLI cases."""

import numpy as np
import pytest

from tpu_smatcher.core.alphabet import Alphabet as JAlphabet
from tpu_smatcher.core.patterns import MixedPatternSet as JMixedPatternSet
from tpu_smatcher.engines import make_mixed as jmake_mixed

from tpu_smatcher_torch import make_mixed
from tpu_smatcher_torch.core import datagen
from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.core.patterns import MixedPatternSet, PatternSet


def _mixed_rows(text, lengths, per_len, ab, seed=0):
    """Rows sampled from text windows (sure hits) and random rows, over
    several lengths, shuffled (test_mixed.py's _mixed_set)."""
    rng = np.random.default_rng(seed)
    rows = []
    for m in lengths:
        for _ in range(per_len):
            if rng.random() < 0.6:
                s = rng.integers(0, len(text) - m + 1)
                rows.append(np.asarray(text[s:s + m], np.uint8))
            else:
                rows.append(rng.integers(0, ab.size, size=m, dtype=np.uint8))
    return [rows[i] for i in rng.permutation(len(rows))]


def _both(rows, ab):
    """The port's and the JAX package's MixedPatternSet of the same rows."""
    jab = JAlphabet(ab.size, ab.chars, ab.name)
    return (MixedPatternSet.from_rows(rows, ab),
            JMixedPatternSet.from_rows(rows, jab))


def _oracle_count(text, mixed):
    return sum(int(datagen.count_matches(text, g)) for g in mixed.groups)


@pytest.fixture(scope="module")
def case():
    """DNA, lengths 6 / 9 / 16 (exact tier, exact tier, fp tier)."""
    ab = Alphabet.dna()
    text = datagen.generate_text(30_000, ab, seed=21)
    rows = _mixed_rows(text, (6, 9, 16), 15, ab, seed=22)
    mx, jmx = _both(rows, ab)
    return (text, rows, mx, make_mixed(mx, device="cpu"),
            jmake_mixed(jmx, backend="xla"))


def test_grouping_and_global_ids():
    ab = Alphabet.dna()
    rows = [np.zeros(8, np.uint8), np.ones(4, np.uint8),
            np.full(8, 2, np.uint8), np.full(4, 3, np.uint8)]
    mx, jmx = _both(rows, ab)
    assert mx.lengths == jmx.lengths == (4, 8)
    assert mx.p_size == jmx.p_size == 4
    assert mx.sigma == 4
    for g, gids, jg, jgids in zip(mx.groups, mx.ids, jmx.groups, jmx.ids):
        np.testing.assert_array_equal(g.codes, jg.codes)
        np.testing.assert_array_equal(gids, jgids)
        for row, gid in zip(g.codes, gids):
            np.testing.assert_array_equal(row, rows[gid])


def test_count_matches_jax_and_the_per_length_oracle(case):
    text, _, mx, eng, jeng = case
    got = eng.count(text)
    assert got == jeng.count(text) == _oracle_count(text, mx)
    assert eng.count_async(text).result() == got


def test_positions_matches_and_count_per_pattern(case):
    text, rows, mx, eng, jeng = case
    starts, lens = eng.positions(text)
    jstarts, jlens = jeng.positions(text)
    np.testing.assert_array_equal(starts, jstarts)
    np.testing.assert_array_equal(lens, jlens)
    exp = sorted((int(p), g.m) for g in mx.groups
                 for p in np.flatnonzero(datagen.match_starts(text, g)))
    assert list(zip(starts.tolist(), lens.tolist())) == exp

    mstarts, mids = eng.matches(text)
    jms, jmids = jeng.matches(text)
    np.testing.assert_array_equal(mstarts, jms)
    np.testing.assert_array_equal(mids, jmids)
    for s, i in zip(mstarts.tolist(), mids.tolist()):
        np.testing.assert_array_equal(text[s:s + len(rows[i])], rows[i])

    per = eng.count_per_pattern(text)
    np.testing.assert_array_equal(per, jeng.count_per_pattern(text))
    assert per.dtype == np.int64 and per.shape == (mx.p_size,)
    assert int(per.sum()) == eng.count(text)


def test_scan_many():
    ab = Alphabet.of_size(8)
    texts = [datagen.generate_text(20_000, ab, seed=s) for s in (31, 32, 33)]
    mx, jmx = _both(_mixed_rows(texts[0], (4, 7), 12, ab, seed=34), ab)
    got = make_mixed(mx, device="cpu").scan_many(texts)
    assert got == jmake_mixed(jmx, backend="xla").scan_many(texts)
    assert got == [_oracle_count(t, mx) for t in texts]


@pytest.mark.parametrize("chunk", [4096, 4999])
def test_count_file_short_groups_tail(tmp_path, chunk):
    """The file's pieces follow the shortest length's grid, so the tail
    starts that only the short group owns are counted; at a chunk that is
    a multiple of nothing too."""
    ab = Alphabet.dna()
    text = datagen.generate_text(20_000, ab, seed=41)
    mx, jmx = _both(_mixed_rows(text, (4, 64), 10, ab, seed=42), ab)
    path = tmp_path / "corpus.bin"
    text.tofile(path)
    eng = make_mixed(mx, device="cpu")
    got = eng.count_file(str(path), chunk=chunk)
    assert got == _oracle_count(text, mx) == eng.count(text)
    # the JAX package's count_file equals the oracle (test_mixed.py); its
    # positions_file is held here, and gives the count too
    starts, lens = eng.positions_file(str(path), chunk=chunk)
    jstarts, jlens = jmake_mixed(jmx, backend="xla").positions_file(
        str(path), chunk=chunk)
    np.testing.assert_array_equal(starts, jstarts)
    np.testing.assert_array_equal(lens, jlens)
    assert len(starts) == got


@pytest.mark.parametrize("engine", ["ac", "wm"])
def test_engine_family(engine):
    """The mixed wrapper over the named engines, one per length, on their
    fast paths and on the portable scans."""
    ab = Alphabet.of_size(20)
    text = datagen.generate_text(20_000, ab, seed=51)
    mx, jmx = _both(_mixed_rows(text, (5, 10), 10, ab, seed=52), ab)
    want = jmake_mixed(jmx, engine=engine, fastpath=False).count(text)
    assert want == _oracle_count(text, mx)
    for fastpath in (True, False):
        eng = make_mixed(mx, engine=engine, device="cpu", fastpath=fastpath)
        assert eng.count(text) == want


def test_rejects_uniform_set():
    pats = PatternSet(np.zeros((2, 8), np.uint8), Alphabet.dna())
    with pytest.raises(TypeError):
        make_mixed(pats, device="cpu")


def test_ids_group_count_mismatch():
    ab = Alphabet.dna()
    g5 = PatternSet(np.zeros((2, 5), np.uint8), ab)
    g8 = PatternSet(np.zeros((3, 8), np.uint8), ab)
    with pytest.raises(ValueError, match="one entry per group"):
        MixedPatternSet((g5, g8), (np.arange(2),), ab)
    with pytest.raises(ValueError, match="align"):
        MixedPatternSet((g5,), (np.arange(3),), ab)


def test_groups_alphabet_char_map_checked():
    g = PatternSet(np.zeros((2, 5), np.uint8), Alphabet.dna())
    with pytest.raises(ValueError, match="alphabet"):
        MixedPatternSet((g,), (np.arange(2),), Alphabet(4))


def test_sog_over_two_lengths_raises():
    """sog8 takes m = 8 only, in both packages: over lengths {8, 16} it
    raises rather than scan a subset."""
    rows = [np.zeros(8, np.uint8), np.ones(16, np.uint8)]
    mx, jmx = _both(rows, Alphabet.dna())
    with pytest.raises(ValueError, match="SOG"):
        jmake_mixed(jmx, engine="sog8", fastpath=False)
    with pytest.raises(ValueError, match="SOG"):
        make_mixed(mx, engine="sog8", device="cpu")
