"""Long patterns on the port's fast path (the counterpart of
tests/test_long_patterns.py), against datagen only, with no JAX call:
m up to 2048 through make_fast (count and positions), wm at m = 200, and
sigma = 256 texts of the two highest bytes at m = 257 and 513 — the
reference's f32 fingerprint-accumulation regression, which the port's
integer keys must not repeat.  Tolerance 0 (integer counts, exact
positions)."""

import numpy as np
import pytest

from tpu_smatcher_torch import make_engine, make_fast
from tpu_smatcher_torch.core import datagen
from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.core.patterns import PatternSet
import torch_cases  # noqa: F401  (one torch thread per test process)


@pytest.mark.parametrize("m", [150, 512, 1024, 2048])
def test_long_pattern_fast_path_parity(m):
    ab = Alphabet.of_size(20)
    text = datagen.generate_text(30_000, ab, seed=11)
    pats = datagen.generate_patterns(text, 20, m, ab, frac_present=0.5,
                                     seed=m)
    truth = datagen.count_matches(text, pats)
    assert truth >= 1
    eng = make_fast(pats, device="cpu")
    assert eng.count(text) == truth
    want = np.nonzero(datagen.match_starts(text, pats))[0]
    np.testing.assert_array_equal(eng.positions(text), want)


def test_long_pattern_engine_fast_path():
    ab = Alphabet.of_size(20)
    text = datagen.generate_text(20_000, ab, seed=12)
    pats = datagen.generate_patterns(text, 15, 200, ab, frac_present=0.5,
                                     seed=13)
    truth = datagen.count_matches(text, pats)
    eng = make_engine("wm", pats, device="cpu")
    assert eng.fast_path is not None
    assert eng.count(text) == truth >= 1


@pytest.mark.parametrize("m", [257, 513])
def test_long_pattern_max_byte_fp_accumulation(m):
    """Three or more 128-byte views of bytes 254/255: sums that rounded in
    the reference's f32 accumulation; every planted window must match."""
    ab = Alphabet(256)
    rng = np.random.default_rng(5)
    n = 1 << 14
    text = rng.choice(np.array([254, 255], np.uint8), n)
    starts = rng.integers(0, n - m, 64)
    pats = PatternSet(np.stack([text[s:s + m] for s in starts]), ab)
    truth = datagen.count_matches(text, pats)
    assert truth >= 64
    eng = make_fast(pats, device="cpu")
    assert eng.count(text) == truth
    np.testing.assert_array_equal(
        eng.positions(text), np.nonzero(datagen.match_starts(text, pats))[0])
