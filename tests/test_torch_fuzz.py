"""Randomized conformance fuzz of the port (the counterpart of
tests/test_fuzz.py, same seeds and draws), against datagen only, with no
JAX call: make_fast's count and positions and every engine's count over
random (sigma, m, p, n, planted-fraction) configurations; and
tests/test_automata.py's shared-suffix set through the five engines'
count and positions, with and without their fast path.  Tolerance 0."""

import numpy as np
import pytest

from tpu_smatcher_torch import make_engine, make_fast
from tpu_smatcher_torch.core import datagen
from tpu_smatcher_torch.core.alphabet import Alphabet
import torch_cases  # noqa: F401  (one torch thread per test process)

SIGMAS = [2, 4, 8, 20, 128]
MS = [4, 8, 12, 16, 24, 32, 48]


def _config(rng):
    sigma = int(rng.choice(SIGMAS))
    m = int(rng.choice(MS))
    p = int(rng.integers(1, 120))
    n = int(rng.integers(m, 30_000))
    frac = float(rng.uniform(0, 1))
    return sigma, m, p, n, frac


def _case(base, seed):
    rng = np.random.default_rng(base + seed)
    sigma, m, p, n, frac = _config(rng)
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(n, ab, seed=seed)
    pats = datagen.generate_patterns(text, p, m, ab, frac_present=frac,
                                     seed=seed + 1)
    return (sigma, m, p, n), text, pats


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_fast(seed):
    cfg, text, pats = _case(1000, seed)
    truth = datagen.count_matches(text, pats)
    for tile in (1 << 12, None):
        opts = {} if tile is None else {"tile": tile}
        assert make_fast(pats, device="cpu", **opts).count(text) == truth, \
            cfg
    want = np.nonzero(datagen.match_starts(text, pats))[0]
    np.testing.assert_array_equal(
        make_fast(pats, device="cpu").positions(text), want)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_engines(seed):
    cfg, text, pats = _case(2000, seed)
    sigma, m = cfg[0], cfg[1]
    truth = datagen.count_matches(text, pats)
    names = ["wm", "sh", "sbom"] + (["ac"] if sigma < 256 else [])
    if m in (8, 16, 32):
        names.append(f"sog{m}")
    for name in names:
        eng = make_engine(name, pats, device="cpu", tile=1 << 12)
        assert eng.count(text) == truth, (name, cfg)


def _shared_suffix():
    ab = Alphabet.dna()
    rng = np.random.default_rng(3)
    base = rng.integers(0, 4, size=(40, 8)).astype(np.uint8)
    base[:, 5:] = ab.encode(b"ACG")          # all share the last 3-gram
    text = datagen.generate_text(6000, ab, seed=4)
    text = datagen.plant(text, base[7], [100, 200, 300])
    from tpu_smatcher_torch.core.patterns import PatternSet
    return text, PatternSet(base, ab)


@pytest.mark.parametrize("fastpath", [True, False])
def test_shared_suffix_through_the_engines(fastpath):
    """40 patterns sharing their last 3-gram (verify buckets padded to
    lmax >= 30) through ac, sh, sbom, wm and sog8: count and positions."""
    text, pats = _shared_suffix()
    truth = datagen.count_matches(text, pats)
    want = np.nonzero(datagen.match_starts(text, pats))[0]
    assert truth >= 3
    for name in ("ac", "sh", "sbom", "wm", "sog8"):
        eng = make_engine(name, pats, device="cpu", fastpath=fastpath)
        assert eng.count(text) == truth, name
        if fastpath:
            np.testing.assert_array_equal(eng.positions(text), want)
        else:
            # without a fast path positions are not offered (as in the
            # JAX package); matches attribute through a FastScanner
            pos, _ = eng.matches(text)
            np.testing.assert_array_equal(np.sort(pos), want)
