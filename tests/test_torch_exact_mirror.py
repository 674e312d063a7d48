"""A numpy mirror of the exact-tier kernels' decomposition
(tpu_smatcher_torch/csrc/exact_count.cu: the unguarded count, the guarded
count and the mask), step for step: text tiles of 8,192 starts staged from
the 16-byte aligned address at or below the text (junk before the view),
runs of 32 consecutive starts per thread, the rolling window id with its
per-start path for dirty runs (a byte >= 2^bits, or a bitmap smaller than
the id space), the guard's mask of entering bytes >= sigma smeared over m
starts (bytes in [sigma, 2^bits) dropped by the guard, clean for the id),
the last partial run, the counts as the runs' popcounts and the mask as
two 16-byte stores per run over all rows*128 entries (0 past n-m+1).  The
run code is the stage-chain kernel's (csrc/wid_run.cuh), so the mirror
runs test_torch_stages_mirror's wid_run and guard_run.

The mirror is held against the plain torch versions (exact_mask_plain,
exact_count_plain with the guard on and off) on kernel_cases' exact edge
cases (views at every offset mod 16, start counts around a run, a mask row
and a tile, a positions piece of about 2^18 starts, n = m) at sigma in {2,
4, 20, 256} and m in {1, 2, 3, 8, 16}, with a random bitmap and one
smaller than the id space; and against the JAX package's exact_mask_pallas
/ exact_count_pallas(guard=True) in interpret mode on
test_torch_positions.py's exact inputs (the same shapes).  All integer:
tolerance 0.  The CUDA kernels themselves are held against the plain
versions on the card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_smatcher.ops import fast as jfast
from tpu_smatcher.ops import pallas_filter as pf

from tpu_smatcher_torch import kernel_cases as kc
from tpu_smatcher_torch.ops import cuda_filter as cf
from tpu_smatcher_torch.ops import fast as tfast
from tpu_smatcher_torch.ops.common import bits_per_char

from test_torch_exact_pairs import build_pairs
from test_torch_filter_mirror import (BEFORE, M32, _byte_of, _tile_buffers,
                                      _words_at, mask_stores)
from test_torch_positions import EXACT_INPUTS
from test_torch_stages_mirror import guard_run, wid_run

RUN = kc.EXACT_RUN
U1 = np.uint64(1)
#: the pair run's window bytes before the run's first entering byte
LEAD = 16


def pair_run(bufs, t, p, s, m, bits, bitmap, thr):
    """exact_count.cu's pair_run: a window of 48 bytes from the run's byte
    m-1-LEAD (12 words from four aligned 16-byte loads; bytes before the
    buffer are shared memory the kernel does not own, junk here); a run with
    a byte >= 2^bits at or past its byte 0 takes wid_run; else the id rolls
    over the window's bytes 8..15 (0..15 for m > 9) and then two bytes a
    pair, and one lookup in the kernel's pair table for starts j and j+1,
    the word rotated right by 2*key - j so that the entry's two bits land
    at bits j, j+1 of the hit mask.  thr >= 0: the guard from
    the same window, the window's bytes >= thr as 48 bits, shifted to the
    run's byte 0 and smeared over the m starts whose window holds each."""
    radix = np.uint64(1 << bits)
    tab = build_pairs(bitmap, m, bits)
    twm = np.uint64(len(tab) - 1)
    junk = np.full((bufs.shape[0], LEAD), BEFORE, np.uint8)
    padded = np.concatenate([junk, bufs], axis=1)
    x = p + m - 1 - LEAD
    w = _words_at(padded, t, x + LEAD, (s + m - 1 - LEAD) & 15, 12)
    dirty = np.zeros(len(p), bool)
    for j in range(LEAD + 1 - m, LEAD + RUN):
        dirty |= (_byte_of(w, j) >> np.uint64(bits)) != 0
    key = np.zeros(len(p), np.uint64)
    for j in range(0 if m > LEAD // 2 + 1 else LEAD // 2, LEAD):
        key = (key * radix + _byte_of(w, j)) & M32
    hits = np.zeros(len(p), np.uint64)
    for j in range(0, RUN, 2):
        for i in (j, j + 1):
            key = (key * radix + _byte_of(w, LEAD + i)) & M32
        e = tab[((key >> np.uint64(4)) & twm).astype(np.int64)]
        r = (np.uint64(2) * key + np.uint64(32 - j)) & np.uint64(31)
        rot = ((e >> r) | (e << ((np.uint64(32) - r) & np.uint64(31)))) & M32
        hits |= rot & np.uint64(3 << j)
    if dirty.any():
        hits[dirty] = wid_run(bufs, t[dirty], p[dirty], s, (0, m, bits),
                              bitmap.numpy())
    if thr >= 0:
        r = np.zeros(len(p), np.uint64)
        for j in range(48):
            r |= (_byte_of(w, j) >= np.uint64(thr)).astype(np.uint64) \
                << np.uint64(j)
        r >>= np.uint64(LEAD + 1 - m)
        c = 1
        while c < m:
            step = min(c, m - c)
            r |= r >> np.uint64(step)
            c += step
        hits &= ~r & M32
    return hits


def run_hits(text, bitmap, m, sigma, guard, shift):
    """(runs,) uint64 hit masks of every run of every tile of the text at
    an address with `shift` = address % 16 (0 for a run past the last
    start): the rolling id's mask, ANDed with the guard's where sigma <
    256, the last run cut to its valid starts."""
    n_starts = len(text) - m + 1
    bits = bits_per_char(sigma)
    pairs = cf.exact_pairs(m, bits, len(bitmap))
    tile = kc.EXACT_PAIR_TILE if pairs else kc.EXACT_TILE
    bufs = _tile_buffers(text, shift, m, tile=tile)
    starts = np.arange(len(bufs) * tile // RUN) * RUN
    live = starts < n_starts
    i0 = starts[live]
    t, p = i0 // tile, shift + i0 % tile
    thr = max(sigma, 0) if guard and sigma < 256 else -1
    if pairs:
        hits = pair_run(bufs, t, p, shift, m, bits, bitmap, thr)
    else:
        hits = wid_run(bufs, t, p, shift, (0, m, bits), bitmap.numpy())
        if thr >= 0:
            hits &= guard_run(bufs, t, p, shift, m, thr)
    valid = n_starts - i0
    short = valid < RUN
    hits[short] &= (U1 << valid[short].astype(np.uint64)) - U1
    out = np.zeros(len(starts), np.uint64)
    out[live] = hits
    return out


def mirror(text, bitmap, *, m, sigma, shift):
    """exact_count.cu's three outputs: the unguarded and the guarded count
    (the runs' popcounts) and the mask (the runs below R*128 stored)."""
    guarded = run_hits(text, bitmap, m, sigma, True, shift)
    rows = -(-(len(text) - m + 1) // 128)
    return {"count": int(np.bitwise_count(
                run_hits(text, bitmap, m, sigma, False, shift)).sum()),
            "guarded": int(np.bitwise_count(guarded).sum()),
            "mask": mask_stores(guarded[:rows * 128 // RUN])}


def _assert_mirror_equals_plain(text, bitmap, m, sigma, shift):
    t = torch.from_numpy(np.ascontiguousarray(text))
    kw = dict(m=m, sigma=sigma)
    got = mirror(text, bitmap, shift=shift, **kw)
    want = cf.exact_mask_plain(t, bitmap, **kw).numpy()
    assert np.array_equal(got["mask"], want), shift
    assert got["guarded"] == int(cf.exact_count_plain(t, bitmap, guard=True,
                                                      **kw)) == want.sum()
    assert got["count"] == int(cf.exact_count_plain(t, bitmap, **kw))
    return got["count"] - got["guarded"]


#: (sigma, m): m*bits up to 16 at sigma 2, 4, 8, 20 and 256; the pair path
#: at every shape but (20, 3) and (256, 2)
MIRROR_CASES = [(2, 16), (2, 1), (4, 8), (4, 2), (8, 5), (20, 3), (20, 2),
                (256, 2), (256, 1)]


@pytest.mark.parametrize("sigma,m", MIRROR_CASES)
def test_exact_mirror_matches_plain(sigma, m):
    """The mirror's counts and mask equal the plain versions on the views
    of an exact edge case: every offset mod 16 (two tiles and a ragged
    run), start counts around a run, a mask row and a tile, a positions
    piece, n = m; bytes >= sigma planted (at sigma = 20 also bytes in [20,
    32)); the guard drops windows wherever sigma < 256."""
    views, bitmap = kc.exact_edge_case(sigma, m, "cpu")
    dropped = 0
    for i, v in enumerate(views):
        dropped += _assert_mirror_equals_plain(v.numpy(), bitmap, m, sigma,
                                               shift=i % 16)
    assert (dropped > 0) == (sigma < 256)


def test_exact_mirror_small_bitmap():
    """A bitmap smaller than 2^(m*bits) bits: every run takes the
    per-start path and ids past the bitmap miss."""
    views, bitmap = kc.exact_edge_case(4, 8, "cpu")
    small = bitmap[:128].clone()
    for i in (0, 5, 16 + 7, len(views) - 2):
        _assert_mirror_equals_plain(views[i].numpy(), small, 8, 4,
                                    shift=i % 16)


def test_exact_mirror_guard_on_bytes_between_sigma_and_radix():
    """sigma = 20 (bits = 5): a byte in [20, 32) keeps the run clean for
    the rolling id but drops the m windows that hold it."""
    m, sigma = 3, 20
    bitmap = torch.full((1024,), -1, dtype=torch.int32)     # every id hits
    text = np.zeros(m - 1 + 3 * RUN, np.uint8)
    for at in (0, 1, m - 1, 40, len(text) - 1):
        txt = text.copy()
        txt[at] = 27
        got = mirror(txt, bitmap, m=m, sigma=sigma, shift=9)
        want = np.ones(len(txt) - m + 1, np.int8)
        want[max(0, at - m + 1):at + 1] = 0
        assert np.array_equal(got["mask"].reshape(-1)[:len(want)], want)
        assert not got["mask"].reshape(-1)[len(want):].any()
        assert got["count"] == len(want) and got["guarded"] == want.sum()


@pytest.fixture(scope="module")
def pallas_exact():
    """{name: (exact_mask_pallas (R, 128), guarded count)} in interpret
    mode on test_torch_positions.py's exact inputs."""
    out = {}
    for name, make in EXACT_INPUTS.items():
        text, pats = make()
        jft = jfast.build_fast(pats.codes, 4)
        n = len(text)
        kw = dict(m=8, sigma=4, n=n, interpret=True)
        mask = pf.exact_mask_pallas(jnp.asarray(text), jft.bitmaps[0], **kw)
        count = pf.exact_count_pallas(jnp.asarray(text), jft.bitmaps[0],
                                      guard=True, **kw)
        out[name] = (np.asarray(mask), int(count))
    return out


@pytest.mark.parametrize("name", list(EXACT_INPUTS))
def test_exact_mirror_matches_pallas(pallas_exact, name):
    """The mirror's mask and guarded count equal the TPU kernels' on DNA
    m=8 with the pad symbol and 200 planted (some inside matches), and on
    the pad window whose packed id aliases a pattern's, at address 13 mod
    16."""
    text, pats = EXACT_INPUTS[name]()
    bitmap = tfast.build_fast(pats.codes, 4, device="cpu").bitmaps[0]
    got = mirror(text, bitmap, m=8, sigma=4, shift=13)
    want_mask, want_count = pallas_exact[name]
    rows = got["mask"].shape[0]
    assert np.array_equal(got["mask"], want_mask[:rows])
    assert not want_mask[rows:].any()
    assert got["guarded"] == want_count
