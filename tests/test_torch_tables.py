"""PyTorch port: tables, keys and the stage budgets equal the JAX
package's (tpu_smatcher.ops.fast / ops.keys) on the same inputs.  All
integer: tolerance 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_smatcher.ops import fast as jfast
from tpu_smatcher.ops import keys as jkeys
from tpu_smatcher.ops.lookup import pack_bitmap as j_pack_bitmap
from tpu_smatcher.automata.verify import pack_rows as j_pack_rows

from tpu_smatcher_torch.ops import fast as tfast
from tpu_smatcher_torch.ops import keys as tkeys
from tpu_smatcher_torch.ops.lookup import bitmap_test, pack_bitmap, pack_rows

from torch_cases import (CASES, assert_tables_equal, jax_fields, make_case,
                         wide_case)


TABLE_CASES = [pytest.param(c, id=f"s{c[0]}m{c[1]}p{c[2]}") for c in CASES]
TABLE_CASES.append(pytest.param("wide", id="wide32768"))


def _tables(case):
    """(JAX tables, port tables) of one case: test_fast.py's CASES, or the
    cascade's 32768-bit wide case; the port's at the JAX package's width
    (its own default is the H100's)."""
    if case == "wide":
        _, pats = wide_case(0.02)
        codes, sigma, stage_bits = pats.codes, 4, 32768
    else:
        sigma, m, p, _ = case
        _, pats = make_case(sigma, m, p, 20_000, seed=3 * sigma + m)
        codes, stage_bits = pats.codes, None
    jft = jfast.build_fast(codes, sigma, stage_bits=stage_bits)
    return jft, tfast.build_fast(codes, sigma, stage_bits=jft.stage_bits,
                                 device="cpu")


@pytest.mark.parametrize("case", TABLE_CASES)
def test_build_fast_matches_jax(case):
    jft, tft = _tables(case)
    assert_tables_equal(jft, tft)
    # carried across from the JAX package: the same tables again
    assert_tables_equal(jft, tfast.FastTables.from_numpy(jax_fields(jft),
                                                         "cpu"))


@pytest.mark.parametrize("case", TABLE_CASES)
def test_stage_budgets_match_jax(case):
    """fp_rate, cap_for, stages_for, stages_for_block and k1_for are the
    same functions of the same tables."""
    jft, tft = _tables(case)
    assert tfast.cap_for(tft) == jfast.cap_for(jft)
    assert tfast.k1_for(tft) == jfast.k1_for(jft)
    for k in (1, 3, 8):
        assert tfast.fp_rate(tft, k) == jfast.fp_rate(jft, k)
    for n in (1 << 16, 1 << 28):
        assert (tfast.stages_for(tft, n, tfast.cap_for(tft))
                == jfast.stages_for(jft, n, jfast.cap_for(jft)))
    assert (tfast.stages_for_block(tft, 128 * 128)
            == jfast.stages_for_block(jft, 128 * 128))


def test_packers_and_bitmap_test():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 16384, 500)
    bm = pack_bitmap(keys, 16384)
    assert np.array_equal(bm, j_pack_bitmap(keys, 16384))
    rows = rng.integers(0, 256, (40, 13)).astype(np.uint8)
    assert np.array_equal(pack_rows(rows), j_pack_rows(rows))
    probe = torch.from_numpy(rng.integers(0, 16384, 2000))
    got = bitmap_test(torch.from_numpy(bm.reshape(-1)), probe).numpy()
    want = np.isin(probe.numpy(), keys).astype(np.int64)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("m,bits", [(1, 2), (5, 2), (8, 2), (16, 1), (3, 7)])
def test_wid_keys_match_jax(m, bits):
    rng = np.random.default_rng(m)
    t = rng.integers(0, 1 << bits, (3, 300)).astype(np.int32)
    want = np.asarray(jkeys.wid_keys(jnp.asarray(t), m, bits))
    got = tkeys.wid_keys(torch.from_numpy(t), m, bits).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("m", [1, 2, 7, 32, 129, 513])
def test_fp_keys_match_jax(m):
    rng = np.random.default_rng(m)
    t = rng.integers(0, 256, (2, 1200)).astype(np.int32)
    for mult in tfast.FP_MULTS[:3]:
        want = np.asarray(jkeys.fp_keys(jnp.asarray(t), m, mult))
        got = tkeys.fp_keys(torch.from_numpy(t), m, mult).numpy()
        assert np.array_equal(got, want)
