"""Very large pattern sets on the port's fingerprint tier (the counterpart
of tests/test_huge_patternsets.py), against datagen only, with no JAX
call: when every built stage together misses the candidate budget, the
sync path scans in budget-sized pieces and counts exactly; a saturated
filter terminates on count and count_async; p = 100k at m = 8 DNA stays
on the exact tier.  Tolerance 0."""

import dataclasses

import torch

from tpu_smatcher_torch import make_fast
from tpu_smatcher_torch.core import datagen
from tpu_smatcher_torch.core.alphabet import Alphabet
import torch_cases  # noqa: F401  (one torch thread per test process)


def test_budget_shortfall_chunks_and_counts_exactly():
    ab = Alphabet.of_size(20)
    text = datagen.generate_text(60_000, ab, seed=21)
    pats = datagen.generate_patterns(text, 300, 16, ab, frac_present=0.5,
                                     seed=22)
    truth = datagen.count_matches(text, pats)
    eng = make_fast(pats, device="cpu", cap=8192)
    # stage saturation, simulated by keeping two of the built stages
    eng.ft = dataclasses.replace(eng.ft, bitmaps=eng.ft.bitmaps[:2])
    assert eng._count_pallas(torch.from_numpy(text)) == (truth, False)
    assert eng.count(text) == truth


def test_saturated_filter_terminates():
    """density ** k > 0.5: budget pieces pin at cap // 2 and each still
    overflows; the piece path finishes through the dense pass and
    _count_chunked instead of re-entering itself."""
    ab = Alphabet.of_size(4)
    text = datagen.generate_text(20_000, ab, seed=25)
    pats = datagen.generate_patterns(text, 3_000, 12, ab, frac_present=0.3,
                                     seed=26)
    truth = datagen.count_matches(text, pats)
    eng = make_fast(pats, device="cpu", cap=4096)
    eng.ft = dataclasses.replace(eng.ft, bitmaps=eng.ft.bitmaps[:1],
                                 density=0.95)
    assert eng.count(text) == truth
    assert eng.count_async(torch.from_numpy(text)).result() == truth


def test_p100k_exact_tier():
    ab = Alphabet.dna()
    text = datagen.generate_text(200_000, ab, seed=23)
    pats = datagen.generate_patterns(text, 100_000, 8, ab, frac_present=0.3,
                                     seed=24)
    truth = datagen.count_matches(text, pats)
    eng = make_fast(pats, device="cpu")
    assert eng.ft.exact
    assert eng.count(text) == truth
