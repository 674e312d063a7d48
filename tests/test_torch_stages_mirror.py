"""A numpy mirror of the stage-chain kernel's decomposition
(tpu_smatcher_torch/csrc/stages.cu), step for step: text tiles of 16,384
starts staged from the 16-byte aligned address at or below the text (junk
before the view), runs of 32 consecutive starts per thread, each stage
rolling over the run to a 32-bit hit mask from funnel-shifted 16-byte
loads (the rolling window id with its per-start path for dirty runs, the
SOG shift-or register with its m-3 grams of warm-up, the fingerprint
stages of filter.cu's runs, the guard's smeared mask of entering bytes >=
sigma), the value stages (wm; sog behind fp stages) per live start, the
chain as the AND of the masks, the two 16-byte mask stores of a run and the
slots mode's block-wide prefix.

The mirror is held against the plain torch version (stages_plain) on the
chains EngineFastPath builds (wid, wm + wid, sog + wid, wid + fpset, wm +
fpset, sog + fpset) and on other chains the kernel runs in its generic
instantiation, at sigma in {2, 4, 20, 256}, m in {3, 8, 32, 34, 4097},
texts at every offset mod 16, start counts that are not a multiple of 32,
guard on and off and bytes outside the alphabet; and against the JAX
package's Pallas stage kernels in interpret mode.  All integer: tolerance
0.  The CUDA kernel itself is held against stages_plain on the card in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_smatcher.engines import make_engine as jmake_engine
from tpu_smatcher.ops import pallas_engines as pe

from tpu_smatcher_torch import make_engine
from tpu_smatcher_torch.ops import cuda_engines as ce

from test_torch_filter_mirror import (M32, RUN, TILE, _byte_of, _tile_buffers,
                                      _words_at, mask_stores, run_hits,
                                      slot_ranks)
from torch_cases import (engine_chain, generic_chains, jax_pats, make_case,
                         plant_oob, random_stages)

U1 = np.uint64(1)


def _entering(bufs, t, p, s, x):
    """(runs, 8) words: the 32 bytes at p + x of each run's tile buffer."""
    return _words_at(bufs, t, p + x, (s + x) & 15, 8)


def _lookup0(tab, idx):
    """tab[idx] as uint32 in uint64, 0 past the table."""
    vals = tab.view(np.uint32).astype(np.uint64)
    inside = idx < len(vals)
    return np.where(inside, vals[np.where(inside, idx, 0).astype(np.int64)],
                    0).astype(np.uint64)


def wid_run(bufs, t, p, s, params, tab):
    """wid(off, d, bits): the rolling id over runs of clean bytes with a
    bitmap of at least 2^(d*bits) bits; the OR key per start elsewhere."""
    off, d, bits = params
    nbits = len(tab) * 32
    radix, kmask = np.uint64(1 << bits), np.uint64((1 << d * bits) - 1)
    dirty_bytes = np.uint64(0x01010101 * (0xFF & ~((1 << bits) - 1)))
    bm = tab.view(np.uint32).astype(np.uint64)
    inw = _entering(bufs, t, p, s, off + d - 1)
    dirty = np.full(len(p), nbits <= int(kmask))
    dirty |= ((inw & dirty_bytes) != 0).any(axis=1)
    key = np.zeros(len(p), np.uint64)
    for j in range(d - 1):
        c = bufs[t, p + off + j].astype(np.uint64)
        dirty |= (c >> np.uint64(bits)) != 0
        key = (key * radix + c) & M32
    rolled = np.zeros(len(p), np.uint64)
    for j in range(RUN):
        key = (key * radix + _byte_of(inw, j)) & M32
        k = np.minimum(key & kmask, np.uint64(nbits - 1))
        rolled |= ((bm[(k >> np.uint64(5)).astype(np.int64)]
                    >> (k & np.uint64(31))) & U1) << np.uint64(j)
    per_start = np.zeros(len(p), np.uint64)
    for j in range(RUN):
        k = np.zeros(len(p), np.uint64)
        for i in range(d):
            k = (k << np.uint64(bits)) | bufs[t, p + off + j + i]
        inside = k < nbits
        k = np.where(inside, k, 0)
        bit = (bm[(k >> np.uint64(5)).astype(np.int64)]
               >> (k & np.uint64(31))) & U1
        per_start |= np.where(inside, bit, 0).astype(np.uint64) \
            << np.uint64(j)
    return np.where(dirty, per_start, rolled)


def sog_run(bufs, t, p, s, m, sigma, tab):
    """sog: E = (E << 1) | T[g] over the run's grams from E = 0, m-3 grams
    of warm-up, then start j hits iff bit m-3 of E is 0."""
    sg, sg2 = np.uint64(sigma), np.uint64(sigma * sigma)
    x = bufs[t, p].astype(np.uint64)
    y = bufs[t, p + 1].astype(np.uint64)
    e = np.zeros(len(p), np.uint64)
    for j in range(m - 3):
        z = bufs[t, p + j + 2].astype(np.uint64)
        e = ((e << U1) | _lookup0(tab, x + y * sg + z * sg2)) & M32
        x, y = y, z
    inw = _entering(bufs, t, p, s, m - 1)
    hits = np.zeros(len(p), np.uint64)
    for j in range(RUN):
        z = _byte_of(inw, j)
        e = ((e << U1) | _lookup0(tab, x + y * sg + z * sg2)) & M32
        hits |= ((~e >> np.uint64(m - 3)) & U1) << np.uint64(j)
        x, y = y, z
    return hits


def value_starts(bufs, t, p, m, kind, params, tab, live):
    """A value stage per start, for the starts in live only (the kernel's
    loop over live's bits; here every start is tested and live kept): wm's
    SHIFT[(x*4 + y)*4 + z] == 0 on the window's last three bytes, sog's
    AND over i of bit i of T[g(s+i)] == 0."""
    hits = np.zeros(len(p), np.uint64)
    for j in range(RUN):
        w = [bufs[t, p + j + i].astype(np.uint64) for i in range(m)]
        if kind == "wm":
            ok = _lookup0(tab, (w[m - 3] * 4 + w[m - 2]) * 4 + w[m - 1]) == 0
        else:
            sg = np.uint64(params[1])
            ok = np.ones(len(p), bool)
            for i in range(m - 2):
                g = w[i] + w[i + 1] * sg + w[i + 2] * sg * sg
                ok &= ((_lookup0(tab, g) >> np.uint64(i)) & U1) == 0
        hits |= ok.astype(np.uint64) << np.uint64(j)
    return hits & live


def guard_run(bufs, t, p, s, m, thr):
    """The guard: the entering bytes >= thr as a 32-bit mask (the
    __vcmpgeu4 compare), each bit smeared over the m starts whose window
    holds it by shift-ors, and the starts up to the first window's last
    such byte."""
    last = np.full(len(p), -1)
    for j in range(m - 1):
        last = np.where(bufs[t, p + j] >= thr, j, last)
    inw = _entering(bufs, t, p, s, m - 1)
    enter = np.zeros(len(p), np.uint64)
    for j in range(RUN):
        enter |= (_byte_of(inw, j) >= thr).astype(np.uint64) << np.uint64(j)
    r, c = enter, 1
    while c < m and c < 32:
        step = min(c, m - c)
        r = (r | (r << np.uint64(step))) & M32
        c += step
    low = np.where(last >= 31, M32,
                   (np.uint64(2) << np.minimum(last, 31).astype(np.uint64))
                   - U1)
    low = np.where(last < 0, 0, low).astype(np.uint64)
    return ~(r | low) & M32


def chain_hits(text, chain, tables, m, sigma, guard, shift, n_runs):
    """(n_runs,) uint64 hit masks of runs 0 .. n_runs-1 of the text at an
    address with `shift` = address % 16, in the kernel's three steps: the
    guard, the wid stages and (without an fp stage) sog's register; the fp
    stages; per live start, wm and (with an fp stage) sog.  Then the valid
    starts of the last run."""
    n_starts = len(text) - m + 1
    bufs = _tile_buffers(text, shift, m)
    starts = np.arange(n_runs) * RUN
    live = starts < n_starts
    i0 = starts[live]
    t, p = i0 // TILE, shift + i0 % TILE
    hits = np.full(len(i0), M32)
    fp = any(kind == "fpset" for kind, _ in chain)
    stages = [(kind, params, tab.numpy()) for (kind, params), tab
              in zip(chain, tables)]
    if guard and sigma < 256:
        hits &= guard_run(bufs, t, p, shift, m, max(sigma, 0))
    for kind, params, tab in stages:
        if kind == "wid":
            hits &= wid_run(bufs, t, p, shift, params, tab)
        elif kind == "sog" and not fp:
            hits &= sog_run(bufs, t, p, shift, m, params[1], tab)
    for kind, params, tab in stages:
        if kind == "fpset":
            hits &= run_hits(text, tab, m, params[1][:params[0]], shift, i0)
    for kind, params, tab in stages:
        if kind == "wm" or (kind == "sog" and fp):
            hits = value_starts(bufs, t, p, m, kind, params, tab, hits)
    valid = n_starts - i0
    short = valid < RUN
    hits[short] &= (U1 << valid[short].astype(np.uint64)) - U1
    out = np.zeros(n_runs, np.uint64)
    out[live] = hits
    return out


def mirror(text, chain, tables, *, m, sigma, guard, shift):
    """stages.cu's outputs in the three modes for the text at an address
    with `shift` = address % 16, from the hit masks of every tile's runs
    (a run past the last start has none): count mode sums the runs'
    __popc, mask mode stores the runs below R*128, slots mode ranks each
    tile."""
    n_starts = len(text) - m + 1
    hits = chain_hits(text, chain, tables, m, sigma, guard, shift,
                      -(-n_starts // TILE) * TILE // RUN)
    rows = -(-n_starts // 128)
    return {"count": int(np.bitwise_count(hits).sum()),
            "mask": mask_stores(hits[:rows * 128 // RUN]),
            "slots": slot_ranks(hits)}


def _assert_mirror_equals_plain(text, chain, tables, m, sigma, guard,
                                shift):
    t = torch.from_numpy(text.copy())
    kw = dict(m=m, sigma=sigma, guard=guard)
    got = mirror(text, chain, tables, shift=shift, **kw)
    want = ce.stages_plain(t, chain, tables, mode="mask", **kw).numpy()
    assert np.array_equal(got["mask"], want)
    assert got["count"] == int(ce.stages_plain(t, chain, tables,
                                               mode="count", **kw))
    pos, counts = got["slots"]
    wp, wc = ce.stages_plain(t, chain, tables, mode="slots", **kw)
    assert np.array_equal(pos, wp.numpy())
    assert np.array_equal(counts, wc.numpy())
    assert counts.sum() == want.sum()
    return int(want.sum())


#: (sigma, m, engine): each a chain EngineFastPath builds — wid (exact
#: tier), wm + wid, sog + wid, wid + fpset (prefix and suffix), wm + fpset,
#: sog + fpset — at sigma in {2, 4, 20, 256}, m in {3, 8, 32, 34, 4097}
ENGINE_CASES = [
    (4, 8, "ac"), (4, 8, "wm"), (4, 8, "sog"), (2, 8, "sog"),
    (4, 3, "wm"), (4, 3, "sog"), (2, 16, "sh"),
    (4, 32, "ac"), (4, 32, "wm"), (4, 32, "sog"), (4, 34, "sog"),
    (20, 8, "wm"), (20, 32, "ac"), (256, 8, "ac"), (256, 32, "wm"),
    (4, 4097, "ac"), (4, 4097, "sh"),
]


@pytest.mark.parametrize("sigma,m,kind", ENGINE_CASES)
def test_stages_mirror_matches_plain(sigma, m, kind):
    """The mirror of count, mask and slots equals stages_plain on the
    engine's chain: start counts around a run, a mask row and a tile (not
    a multiple of 32), texts at addresses 0, 1, 7 and 15 mod 16, guard on
    and off, bytes >= sigma planted."""
    n = m - 1 + 2 * TILE + 45
    text, chain, tables = engine_chain(sigma, m, kind, n, seed=sigma + m)
    kinds = [k for k, _ in chain]
    if kind == "sog" or (kind == "wm" and sigma < 256):
        assert kinds[0] == kind
    # at m = 4097 the plants stay in the first 3000 bytes, so that windows
    # of the patterns present are left further on
    text = plant_oob(text, sigma, seed=m, span=3000 if m == 4097 else None)
    starts = [33, 129, TILE + 1, 2 * TILE + 45] if m < 4097 else \
        [33, 2 * TILE + 45]
    cands = 0
    for i, n_st in enumerate(starts):
        for guard in (False, True):
            cands += _assert_mirror_equals_plain(
                text[:m - 1 + n_st], chain, tables, m, sigma, guard,
                shift=(0, 1, 7, 15)[(i + guard) % 4])
    assert cands


@pytest.mark.parametrize("sigma,m", [(4, 8), (20, 16), (2, 32)])
def test_stages_mirror_generic_chains(sigma, m):
    """The mirror equals stages_plain on chains outside EngineFastPath's
    (the kernel's generic instantiation), guard on and off, bytes >=
    sigma planted, the text at an odd address."""
    text, pats = make_case(sigma, m, 30, m - 1 + TILE + 77, seed=m)
    text = plant_oob(text, sigma, seed=m + 1)
    fp_tables = torch.from_numpy(random_stages(2, 4096, 0.4, seed=m))
    for chain, tables in generic_chains(sigma, m, pats.codes, fp_tables):
        for guard in (False, True):
            _assert_mirror_equals_plain(text, chain, tables, m, sigma,
                                        guard, shift=9)


def test_guard_smear_drops_the_windows_of_each_byte():
    """The guard's smear drops exactly the windows holding a byte >= sigma,
    for a pad byte in the first window, one entering at every run offset,
    and m up to 4097 (past the 32-bit mask)."""
    for m in (1, 2, 5, 31, 32, 33, 4097):
        n = m - 1 + 3 * RUN
        for at in (range(0, n, 5) if m < 64 else
                   (0, 1, m - 2, m - 1, m, m + 17, m + 31, n - 1)):
            text = np.zeros(n, np.uint8)
            text[at] = 4
            got = mirror(text, [("wid", (0, 1, 2))],
                         [torch.full((128,), -1, dtype=torch.int32)], m=m,
                         sigma=4, guard=True, shift=3)["mask"].reshape(-1)
            want = np.ones(len(text) - m + 1, np.int8)
            want[max(0, at - m + 1):at + 1] = 0
            assert np.array_equal(got[:len(want)], want), (m, at)
            assert not got[len(want):].any()


#: test_torch_engines.py's MASK_CASES shapes (n = 20,011) run through the
#: Pallas kernels in interpret mode: (engine, sigma, m, guard, flat, mode)
#: and out-of-alphabet bytes where the two packages agree on them (not
#: under an unguarded wid stage: the TPU sums the shifted bytes, the port
#: ORs them)
PALLAS_CASES = [
    ("ac", 4, 16, False, True, "mask", False),    # prefix wid + fpset, flat
    ("wm", 4, 8, True, False, "mask", True),      # wm + exact wid, guarded
    ("sog16", 4, 16, False, False, "slots", True),  # sog + fpset
]


@pytest.mark.parametrize("name,sigma,m,guard,flat,mode,oob", PALLAS_CASES)
def test_stages_mirror_matches_pallas(name, sigma, m, guard, flat, mode,
                                      oob):
    """The mirror equals _run_stages / _run_stages_flat in interpret mode on
    the engine's own chain, the text at address 5 mod 16."""
    n = 20_011
    text, pats = make_case(sigma, m, 40, n, seed=7 * sigma + m)
    if oob:
        text = plant_oob(text, sigma, seed=n)
    jfp = jmake_engine(name, jax_pats(pats), interpret=True).fast_path
    tfp = make_engine(name, pats, device="cpu").fast_path
    jst, jtab, _ = jfp._stages(n, flat=flat)
    tst, ttab, _ = tfp._stages(n)
    assert tst == jst
    jt = jnp.asarray(text)
    kw = dict(m=m, n=n, mode=mode, interpret=True)
    if flat:
        want = pe._run_stages_flat(jt, jst, jtab, **kw)
    else:
        want = pe._run_stages(jt, jst, jtab, sigma=sigma, guard=guard, **kw)
    got = mirror(text, tst, ttab, m=m, sigma=sigma, guard=guard,
                 shift=5)[mode]
    n_starts = n - m + 1
    if mode == "mask":
        want = np.asarray(want).reshape(-1)
        got = got.reshape(-1)
        assert np.array_equal(got[:n_starts], want[:n_starts])
        assert not got[n_starts:].any() and got.sum() > 0
    else:
        rows = np.asarray(want[0])
        pos, counts = got
        assert np.array_equal(pos, rows[:len(pos), :16])
        assert np.array_equal(counts, rows[:len(pos), 16])
        assert counts.sum() > 0
