"""Faults of the PyTorch port against the JAX package, each pinned on the
CPU on the same inputs (tolerance 0):

  - an engine's matches() and count_per_pattern() answer without an active
    fast path (fastpath=False, or patterns longer than the kernels take),
    as the JAX package's do;
  - the unguarded exact count on text holding bytes >= sigma (text that is
    not encoded in the pattern set's alphabet) ORs the shifted bytes into
    the window id, as the JAX package's xla path does; its Pallas kernel
    sums them, and only encoded text is specified;
  - make_engine_from_tables("fast", ...) passes the scanner's options
    (cap) through, as the JAX package's does, and takes tables only on the
    device it was asked for."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_smatcher import native
from tpu_smatcher.core import datagen as jdatagen
from tpu_smatcher.engines import make_engine as jmake_engine
from tpu_smatcher.engines import make_fast as jmake_fast
from tpu_smatcher.ops import fast as jfast
from tpu_smatcher.ops import pallas_filter as pf

from tpu_smatcher_torch import ENGINE_NAMES, make_engine, make_fast
from tpu_smatcher_torch.engines import build_tables, make_engine_from_tables
from tpu_smatcher_torch.core import datagen
from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.ops import cuda_filter as cf
from tpu_smatcher_torch.ops.common import active_fastpath

from torch_cases import jax_pats, make_case, port_pats


def _reference_attribution(name, pats, text):
    """The JAX package's (positions, ids, per-pattern counts) of the engine
    without a fast path: its native enumerator.  Where the native library
    did not load in this process (it is built at first use, and processes
    that build it at once can race), the JAX package's portable
    enumeration: datagen.match_starts and datagen.match_ids."""
    jeng = jmake_engine(name, jax_pats(pats), fastpath=False)
    if native.load() is not None:
        pos, ids = jeng.matches(text)
        return pos, ids, jeng.count_per_pattern(text)
    codes = pats.codes
    pos = np.flatnonzero(jdatagen.match_starts(text, codes)).astype(np.int64)
    ids = jdatagen.match_ids(text, pos, codes).astype(np.int64)
    return pos, ids, np.bincount(ids, minlength=len(codes)).astype(np.int64)


def _check_attribution(eng, name, pats, text, count=True):
    assert active_fastpath(eng) is None
    pos, ids = eng.matches(text)
    per = eng.count_per_pattern(text)
    want_pos, want_ids, want_per = _reference_attribution(name, pats, text)
    np.testing.assert_array_equal(pos, want_pos)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(per, want_per)
    assert per.sum() == len(pos) >= 1
    # the portable scans walk m bytes per window: count only at small m
    assert not count or eng.count(text) == len(pos)


#: the engines that take any m (SOG runs at m == its width only)
ANY_M = [n for n in ENGINE_NAMES if not n.startswith("sog")]


@pytest.mark.parametrize("name", ANY_M)
def test_engine_attribution_past_the_kernels(name):
    """m = 4100 > MAX_KERNEL_M: the fast path is attached but inactive, and
    matches / count_per_pattern attribute through its fallback FastScanner
    on plain pieces (a small cap keeps the verify of 4100-byte windows
    small), equal to the JAX package's."""
    ab = Alphabet.dna()
    text = datagen.generate_text(12_000, ab, seed=43)
    pats = datagen.generate_patterns(text, 4, 4100, ab, frac_present=0.5,
                                     seed=44)
    eng = make_engine(name, pats, device="cpu")
    assert eng.fast_path.m > cf.MAX_KERNEL_M
    eng.fast_path.cap = 64
    _check_attribution(eng, name, pats, text, count=False)


#: (engine, m): the eleven engine runs of the port's smoke run
ENGINE_RUNS = [("ac", 8), ("sh", 8), ("sbom", 8), ("wm", 8), ("sog8", 8),
               ("sog16", 16), ("ac", 32), ("sh", 32), ("sbom", 32),
               ("wm", 32), ("sog32", 32)]


@pytest.mark.parametrize("name,m", ENGINE_RUNS)
def test_engine_attribution_without_fastpath(name, m):
    """fastpath=False: matches / count_per_pattern attribute through a
    FastScanner over build_fast of the engine's pattern codes (exact tier
    at m=8, fingerprint tier above), equal to the JAX package's, with
    duplicate patterns credited to the smallest id."""
    text, pats = make_case(4, m, 40, 40_000, seed=m)
    codes = pats.codes.copy()
    codes[-1] = codes[0]                       # a duplicate pattern
    pats = port_pats(codes, 4)
    eng = make_engine(name, pats, device="cpu", fastpath=False)
    assert eng.fast_path is None
    _check_attribution(eng, name, pats, text)


def _dirty_text(sigma, m, seed):
    """An encoded text with bytes >= sigma planted: sigma itself (the pad
    of distributed shards), 255, and random bytes of [sigma, 256)."""
    text, pats = make_case(sigma, m, 64, 20_000, seed=seed)
    rng = np.random.default_rng(seed)
    at = rng.integers(0, len(text), 600)
    text[at[:200]] = sigma
    text[at[200:400]] = 255
    text[at[400:]] = rng.integers(sigma, 256, 200)
    return text, pats


@pytest.mark.parametrize("sigma,m", [(2, 8), (2, 16), (4, 8), (20, 3)])
def test_exact_count_on_bytes_outside_the_alphabet(sigma, m):
    """The exact tier's count on text holding bytes >= sigma: the port's
    main path (make_fast(...).count, the unguarded exact count) and its
    plain count equal the JAX package's xla path (FastScanner on the CPU),
    which ORs the shifted bytes into the window id as the port does.  The
    count is defined on encoded text only; here it need not equal the
    number of matching windows."""
    text, pats = _dirty_text(sigma, m, seed=sigma + m)
    eng = make_fast(pats, device="cpu")
    assert eng.ft.exact
    jeng = jmake_fast(jax_pats(pats))
    assert jeng.backend == "xla"
    got = eng.count(text)
    assert got == jeng.count(text)
    assert got == int(cf.exact_count_plain(torch.from_numpy(text),
                                           eng.ft.bitmaps[0], m=m,
                                           sigma=sigma))
    # the guarded count drops every window holding such a byte
    clean = datagen.count_matches(text, pats)
    assert int(cf.exact_count(torch.from_numpy(text), eng.ft.bitmaps[0], m=m,
                              sigma=sigma, guard=True)) == clean


def test_exact_count_sums_on_the_tpu_and_ors_here():
    """A window whose bytes >= sigma carry into a neighbour's bits: DNA
    m=8, one pattern 0000 0010 (id 4), and a window 0000 0014.  ORed, its
    id is 4 | 4 = 4, a hit; summed, as the JAX package's Pallas kernel does
    on the MXU, it is 4 + 4 = 8, no hit; no window of the text equals the
    pattern.  The port counts 1, as the JAX package's xla path does."""
    pats = port_pats(np.array([[0, 0, 0, 0, 0, 0, 1, 0]], np.uint8), 4)
    text = np.zeros(64, np.uint8)
    text[30:32] = [1, 4]
    got = make_fast(pats, device="cpu").count(text)
    assert got == jmake_fast(jax_pats(pats)).count(text) == 1
    jft = jfast.build_fast(pats.codes, 4)
    assert int(pf.exact_count_pallas(jnp.asarray(text), jft.bitmaps[0], m=8,
                                     sigma=4, n=len(text),
                                     interpret=True)) == 0
    assert datagen.count_matches(text, pats) == 0


@pytest.mark.parametrize("m", [8, 16])
def test_fast_engine_from_tables_takes_the_cap(m):
    """A cap passed to make_engine_from_tables("fast", ...) reaches the
    scanner, on the exact tier and the fingerprint tier, and the scanner
    counts as the JAX package's built the same way."""
    text, pats = make_case(4, m, 40, 30_000, seed=60 + m)
    tables = build_tables("fast", pats, device="cpu")
    eng = make_engine_from_tables("fast", tables, device="cpu", cap=1 << 17,
                                  tile=1 << 12)
    assert eng.cap == 1 << 17 and eng.tile == 1 << 12
    jeng = jmake_fast(jax_pats(pats), cap=1 << 17, backend="xla")
    assert jeng.cap == eng.cap
    assert eng.count(text) == jeng.count(text) == \
        datagen.count_matches(text, pats)
    with pytest.raises(TypeError, match="'fast' only"):
        make_engine_from_tables("ac", build_tables("ac", pats), device="cpu",
                                cap=1 << 17)
