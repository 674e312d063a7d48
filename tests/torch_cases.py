"""Shared inputs of the tests/test_torch_*.py parity tests: the same cases
go through the JAX package and its PyTorch port, made with numpy from a
seed.  Cases are built with the port's own data generator (which makes the
same bytes as the JAX package's) and hold the port's PatternSet; jax_pats
gives the JAX package's PatternSet of the same codes.  This module imports
nothing of the JAX package at import time, so the card-only tests can use
it where JAX is not installed."""

import dataclasses

import numpy as np
import torch

from tpu_smatcher_torch.core import datagen
from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.core.patterns import PatternSet
# the kernel checks' inputs, shared with chip_smoke.py
from tpu_smatcher_torch.kernel_cases import (  # noqa: F401
    edge_starts, engine_chain, generic_chains, make_case, plant_oob,
    random_stages, sog_table)

# The parity tests run many small torch CPU ops while the other test
# processes compile JAX programs: one intra-op thread per process keeps them
# from oversubscribing the cores.
torch.set_num_threads(1)

#: tests/test_fast.py's CASES: (sigma, m, p_size, n)
CASES = [
    (2, 8, 16, 120_000),     # exact tier (2^8 ids)
    (2, 16, 16, 120_000),    # exact tier (2^16 ids)
    (4, 8, 200, 120_000),    # exact tier (4^8 ids)
    (4, 16, 64, 120_000),    # fp tier
    (4, 32, 32, 120_000),    # fp tier
    (20, 8, 64, 120_000),    # fp tier
    (128, 8, 32, 120_000),   # fp tier
]


def wide_case(frac_present, n=1 << 16, p=3000, m=32, seed=5):
    """tests/test_fast.py's _wide_case inputs: a pattern set dense enough
    against a forced 32768-bit stage space that the router picks the
    cascade.  Build the tables with stage_bits=32768."""
    ab = Alphabet.of_size(4)
    text = datagen.generate_text(n, ab, seed=seed)
    pats = datagen.generate_patterns(text, p, m, ab,
                                     frac_present=frac_present, seed=seed + 1)
    return text, pats


def dense_case():
    """wide_case(0.02) with a run of 2000 zero bytes planted and the
    all-zero pattern added: every start in the run matches, so its
    128-start rows hold more than 16 cascade survivors (phase-1 overflow)."""
    text, pats = wide_case(0.02)
    text = text.copy()
    text[20_000:22_000] = 0
    codes = pats.codes.copy()
    codes[0] = 0
    return text, PatternSet(codes, pats.alphabet)


def jax_pats(pats):
    """The JAX package's PatternSet of the same numpy codes and alphabet."""
    from tpu_smatcher.core.alphabet import Alphabet as JAlphabet
    from tpu_smatcher.core.patterns import PatternSet as JPatternSet
    ab = pats.alphabet
    return JPatternSet(pats.codes, JAlphabet(ab.size, ab.chars, ab.name))


def port_pats(codes, sigma) -> PatternSet:
    """The port's PatternSet of numpy codes over the alphabet of size
    sigma."""
    return PatternSet(np.asarray(codes, np.uint8), Alphabet.of_size(sigma))


def jax_fields(jft) -> dict:
    """The JAX FastTables' fields as numpy arrays, scalars as they are —
    the input of tpu_smatcher_torch's FastTables.from_numpy."""
    out = {}
    for f in dataclasses.fields(jft):
        v = getattr(jft, f.name)
        if f.name == "bitmaps":
            v = tuple(np.asarray(b) for b in v)
        elif hasattr(v, "shape"):
            v = np.asarray(v)
        out[f.name] = v
    return out


def assert_tables_equal(jft, tft):
    """Field for field: a JAX FastTables and a port FastTables."""
    for f in dataclasses.fields(jft):
        a, b = getattr(jft, f.name), getattr(tft, f.name)
        if f.name == "bitmaps":
            want = np.stack([np.asarray(x).reshape(-1) for x in a])
            assert np.array_equal(want, b.cpu().numpy()), f.name
        elif a is None:
            assert b is None, f.name
        elif hasattr(a, "shape"):
            assert np.array_equal(np.asarray(a), b.cpu().numpy()), f.name
        else:
            assert a == b, (f.name, a, b)
