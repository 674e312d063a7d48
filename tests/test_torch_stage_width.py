"""The port's stage-width rule (ops/fast.h100_stage_bits, build_fast's
default): the width, phase-1 depth k1 and total depth kt it gives on the
bench's pattern sets, the shared-memory budget of phase 1, and counts and
positions at its width equal to those at the JAX package's (TPU-fitted)
width.  All integer: tolerance 0."""

import numpy as np
import pytest

from tpu_smatcher.ops import fast as jfast

from tpu_smatcher_torch.core import datagen
from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.ops import fast as tfast
import torch_cases  # noqa: F401  (one torch thread per test process)

N_BENCH = 1 << 28         # the bench corpus: the rule needs no text

#: name -> (sigma, m, p, stage_bits, k1, kt at N_BENCH, route there)
RULE_CASES = {
    "dna16_p10k": (4, 16, 10_000, 131072, 2, 4, "cascade"),
    "dna32_p10k": (4, 32, 10_000, 131072, 2, 4, "cascade"),
    "dna32_p30k": (4, 32, 30_000, 262144, 2, 5, "cascade"),
    "dna32_p100k": (4, 32, 100_000, 131072, 6, 13, "cascade"),
    "prot8_p8k": (20, 8, 8_000, 131072, 2, 4, "cascade"),
    "dna32_p5": (4, 32, 5, 4096, 1, 2, "slot"),
}


def _patterns(sigma, m, p, n=1 << 22):
    ab = Alphabet.dna() if sigma == 4 else Alphabet.of_size(sigma)
    text = datagen.generate_text(n, ab, seed=7)
    return text, datagen.generate_patterns(text, p, m, ab, frac_present=0.5,
                                           seed=8 + m)


@pytest.mark.parametrize("name", list(RULE_CASES))
def test_rule_widths(name):
    """The width, k1 and kt on each set; phase 1's bitmaps within the
    shared-memory budget; the route at the bench's n."""
    sigma, m, p, bits, k1, kt, route = RULE_CASES[name]
    _, pats = _patterns(sigma, m, p)
    ft = tfast.build_fast(pats.codes, sigma, device="cpu")
    eng = tfast.FastScanner(ft)
    assert ft.stage_bits == bits
    assert tfast.k1_for(ft) == k1
    assert k1 * bits // 8 <= tfast.PHASE1_SMEM_BYTES
    k = tfast.stages_for(ft, N_BENCH, eng.cap)
    assert k == kt
    path, path_k1, path_kt = eng._pick_path(N_BENCH, k)
    assert path == route and path_kt == kt
    assert path_k1 == (k1 if route == "cascade" else None)


@pytest.mark.parametrize("fill0,want", [
    # fewest phase-1 stages: 2 at 2^17 and at 2^18, the narrower wins
    ({16384: 0.457, 65536: 0.141, 131072: 0.0735, 262144: 0.0374}, 131072),
    # one stage at 4,096 bits
    ({4096: 0.001, 8192: 0.0005}, 4096),
    # 2^18 needs 4 stages (128 KB) and 2^17 six (96 KB): 2^17
    ({65536: 0.78, 131072: 0.534, 262144: 0.317}, 131072),
    # nothing fits the budget: the widest width
    ({131072: 0.9, 262144: 0.68}, 262144),
])
def test_rule_on_fills(fill0, want):
    assert tfast.h100_stage_bits(fill0) == want


def test_rule_falls_back_to_the_widest_width():
    """Where no width's phase 1 fits the budget (p=200k), build_fast takes
    the widest width; at p=10k the JAX package's rule keeps 16,384 bits."""
    codes = np.random.default_rng(5).integers(0, 4, (200_000, 32), np.uint8)
    assert tfast.build_fast(codes, 4, device="cpu").stage_bits == 262144
    _, pats = _patterns(4, 32, 10_000)
    assert jfast.build_fast(pats.codes, 4).stage_bits == 16384


@pytest.mark.parametrize("sigma,m,p", [(4, 16, 10_000), (4, 32, 10_000),
                                       (4, 32, 30_000), (20, 8, 8_000)])
def test_counts_and_positions_equal_the_tpu_width(sigma, m, p):
    """On a 128 KB corpus, the count and positions at the default width
    equal those at the JAX package's width and the ground truth."""
    text, pats = _patterns(sigma, m, p, n=1 << 17)
    old = jfast.build_fast(pats.codes, sigma).stage_bits
    new = tfast.FastScanner(tfast.build_fast(pats.codes, sigma,
                                             device="cpu"))
    ref = tfast.FastScanner(tfast.build_fast(pats.codes, sigma,
                                             stage_bits=old, device="cpu"))
    assert new.ft.stage_bits != old
    want = np.flatnonzero(datagen.match_starts(text, pats))
    assert new.count(text) == ref.count(text) == len(want)
    np.testing.assert_array_equal(new.positions(text), ref.positions(text))
    np.testing.assert_array_equal(new.positions(text), want)
