"""Wide filter stages (stage_bits > 2^16) on the port (the counterpart of
tests/test_wide_stages.py), against datagen only, with no JAX call:
build_fast(stage_bits=) forces 2^17- and 2^18-bit stages on a small
pattern set, whose count and positions must equal the ground truth and the
16-bit tables' positions.  (The count at 2^17 with attribution is held
through checkpoints in tests/test_torch_io.py.)  Tolerance 0."""

import numpy as np
import pytest

from tpu_smatcher_torch.core import datagen
from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.ops import fast as F
import torch_cases  # noqa: F401  (one torch thread per test process)


@pytest.fixture(scope="module")
def corpus():
    ab = Alphabet.dna()
    text = datagen.generate_text(1 << 17, ab, seed=11)
    pats = datagen.generate_patterns(text, 400, 16, ab, frac_present=0.5,
                                     seed=12)
    want = np.nonzero(datagen.match_starts(text, pats))[0]
    return text, pats, want


@pytest.mark.parametrize("sb", [131072, 262144])
def test_wide_build_shape(corpus, sb):
    _, pats, _ = corpus
    ft = F.build_fast(pats.codes, 4, stage_bits=sb, device="cpu")
    assert ft.stage_bits == sb
    assert tuple(ft.bitmaps.shape[1:]) == (sb // 32,)
    assert all(c >= sb >> 16 for c, _ in ft.stage_cd)
    assert F.STAGE_CD[0] not in ft.stage_cd
    assert all(f < 0.01 for f in ft.stage_fills)


@pytest.mark.parametrize("sb", [131072, 262144])
def test_wide_positions(corpus, sb):
    text, pats, want = corpus
    s = F.FastScanner(F.build_fast(pats.codes, 4, stage_bits=sb,
                                   device="cpu"))
    np.testing.assert_array_equal(s.positions(text), want)
    ref = F.FastScanner(F.build_fast(pats.codes, 4, device="cpu"))
    np.testing.assert_array_equal(s.positions(text), ref.positions(text))


def test_wide_count_2_18(corpus):
    text, pats, want = corpus
    s = F.FastScanner(F.build_fast(pats.codes, 4, stage_bits=262144,
                                   device="cpu"))
    assert s.count(text) == len(want)
    assert s.count_async(text).result() == len(want)
