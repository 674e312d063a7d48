"""A numpy mirror of the k-stage filter kernel's decomposition
(tpu_smatcher_torch/csrc/filter.cu), step for step: text tiles of 16,384
starts staged from the 16-byte aligned address at or below the text, runs
of 32 consecutive starts per thread with Horner's rule once and rolling
fingerprints after it, the bytes leaving and entering each window
funnel-shifted out of 16-byte loads, a 32-bit hit mask per run, the two
16-byte mask stores of a run, and the slots mode's block-wide prefix of
the runs' counts in position order.

The mirror is held against the plain torch versions (filter_mask_plain,
filter_slots_plain) and against the JAX package's Pallas kernels in
interpret mode, at run, pass and sub-block edges, start counts that are
not a multiple of 32, m in {1, 31, 4097}, sigma in {4, 256}, texts at
every offset mod 16, and crowded sub-blocks.  All integer: tolerance 0.
The CUDA kernel itself is held against the plain versions on the card in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_smatcher.ops import pallas_filter as pf

from tpu_smatcher_torch.ops import cuda_filter as cf
from tpu_smatcher_torch.ops.fast import STAGE_CD
from tpu_smatcher_torch.ops.keys import FP_MULTS

from torch_cases import random_stages

#: the kernel's shape: starts per run (thread), threads per block, starts
#: per tile (one sub-block), slots per sub-block, the stages tested without
#: a branch (always in shared memory) and the shared memory a block keeps to
RUN, THREADS, SLOTS = 32, 512, cf.BLOCK_SLOTS
TILE = RUN * THREADS
BRANCH_FREE = 3
SMEM_TARGET = 112 * 1024
M32 = np.uint64(0xFFFFFFFF)
#: junk that the aligned staging copies from before the text
BEFORE = 0xEE
#: (k, stage_bits, fill) of the random stages: every sub-block crowded, a
#: mix around 16 candidates per sub-block, and sparse sub-blocks
STAGES = [(1, 4096, 0.5), (3, 4096, 0.1), (7, 16384, 0.3)]


def _buf_bytes(m, tile=TILE):
    return (tile + m + 30) // 16 * 16 + 16


def shared_stages(k, stage_bits, m):
    """The stages filter.cu keeps in shared memory (as the host decides):
    as many as keep a block within SMEM_TARGET, the branch-free ones in
    any case."""
    room = SMEM_TARGET - 2 * _buf_bytes(m)
    return min(k, max(BRANCH_FREE, room // (stage_bits // 8)))


def _tile_buffers(text, shift, m, tile=TILE):
    """(tiles, blen) uint8: each tile's text buffer, copied from the aligned
    address `shift` bytes below the text: buffer byte x of tile t is memory
    byte t*tile + x, memory being `shift` bytes before the text, the text,
    and zeros past it (the copies' zero fill)."""
    n = len(text)
    tiles = -(-(n - m + 1) // tile)
    blen = _buf_bytes(m, tile)
    mem = np.zeros(tiles * tile + blen, np.uint8)
    mem[:shift] = BEFORE
    mem[shift:shift + n] = text
    idx = np.arange(tiles)[:, None] * tile + np.arange(blen)[None, :]
    return mem[idx]


def _words_at(bufs, t, p, s, nw=4):
    """(runs, nw) uint64 words: the 4*nw bytes at buffer offset p of tile t,
    from nw/4 + 1 aligned 16-byte loads funnel-shifted by s = p % 16
    (filter.cu's words_at, tile_pipeline.cuh's shifted_words)."""
    q16 = (p >> 4) * 16
    raw = bufs[t[:, None], q16[:, None] + np.arange(4 * nw + 16)[None, :]]
    w = raw.view("<u4").astype(np.uint64)
    q, r = s >> 2, np.uint64((s & 3) * 8)
    out = np.empty((len(p), nw), np.uint64)
    for k in range(nw):
        out[:, k] = (((w[:, k + q + 1] << np.uint64(32)) | w[:, k + q])
                     >> r) & M32
    return out


def _byte_of(words, j):
    return (words[:, j >> 2] >> np.uint64(8 * (j & 3))) & np.uint64(0xFF)


def _horner(bufs, t, p, s, m):
    """The three uint32 fingerprints of the m bytes at offset p of each
    run's tile buffer: Horner's rule from the last byte (filter.cu's
    horner_at: byte by byte past the last whole 16, then 16 per load)."""
    whole = m & ~15

    def steps():
        for j in range(m - 1, whole - 1, -1):
            yield bufs[t, p + j].astype(np.uint64)
        for c in range(whole - 16, -1, -16):
            x = _words_at(bufs, t, p + c, s)
            for j in range(15, -1, -1):
                yield _byte_of(x, j)

    f = [np.zeros(len(p), np.uint64) for _ in range(3)]
    for byte in steps():
        for i in range(3):
            f[i] = (f[i] * np.uint64(FP_MULTS[i]) + byte) & M32
    return f


def run_hits(text, bitmaps, m, cd, shift, run_starts):
    """(runs,) uint32 hit masks of the runs whose first starts are
    run_starts (multiples of 32), as the kernel's threads compute them on
    the text at an address with `shift` = address % 16."""
    k, words = bitmaps.shape
    smask = words * 32 - 1
    n_starts = len(text) - m + 1
    bufs = _tile_buffers(text, shift, m)
    live = run_starts < n_starts
    i0 = run_starts[live]
    t, p = i0 // TILE, shift + i0 % TILE
    f = _horner(bufs, t, p, shift, m)
    outw = _words_at(bufs, t, p, shift, RUN // 4)
    inw = _words_at(bufs, t, p + m, (shift + m) & 15, RUN // 4)
    inv = [np.uint64(pow(x, -1, 1 << 32)) for x in FP_MULTS[:3]]
    top = [np.uint64(pow(x, m - 1, 1 << 32)) for x in FP_MULTS[:3]]
    bits = bitmaps.view(np.uint32).astype(np.uint64)
    hits = np.zeros(len(i0), np.uint64)
    for j in range(RUN):
        a = [x & np.uint64(0xFFFF) for x in f]
        ok = np.ones(len(i0), bool)
        # stages 0-2 for every start, the rest until the first miss: the
        # same AND
        for s in range(k):
            C, D = (np.uint64(v) for v in cd[s])
            key = (a[0] + C * a[1] + D * a[2]) & M32 & np.uint64(smask)
            ok &= ((bits[s][(key >> np.uint64(5)).astype(np.int64)]
                    >> (key & np.uint64(31))) & np.uint64(1)) == 1
        hits |= ok.astype(np.uint64) << np.uint64(j)
        out, inb = _byte_of(outw, j), _byte_of(inw, j)
        f = [(f[i] * inv[i] + (inb * top[i] - out * inv[i])) & M32
             for i in range(3)]
    valid = n_starts - i0
    short = valid < RUN
    hits[short] &= (np.uint64(1) << valid[short].astype(np.uint64)) - 1
    full = np.zeros(len(run_starts), np.uint64)
    full[live] = hits
    return full


def _spread4(bits):
    return ((bits & np.uint64(0xF)) * np.uint64(0x00204081)) \
        & np.uint64(0x01010101)


def mask_stores(hits):
    """(runs * 32 / 128, 128) int8: each run's 32 results stored as eight
    words of 0/1 bytes (two 16-byte stores), the runs in order."""
    words = np.stack([_spread4(hits >> np.uint64(4 * w))
                      for w in range(RUN // 4)], axis=1).astype("<u4")
    return words.view(np.int8).reshape(-1, 128)


def mirror_mask(text, bitmaps, m, cd, shift):
    """filter.cu's mask mode: every run below R*128 stores its 32 results
    as eight words of 0/1 bytes (two 16-byte stores)."""
    n_out = -(-(len(text) - m + 1) // 128) * 128
    return mask_stores(run_hits(text, bitmaps, m, cd, shift,
                                np.arange(0, n_out, RUN)))


def slot_ranks(hits):
    """(pos, counts) of sub-blocks of 512 runs each (hits: their 32-bit
    masks, in order): a run's rank is the candidates of the warps before it
    and of the lanes before it in its warp; a run whose rank is below 16
    writes its candidates until rank 16 (tile_pipeline.cuh's
    rank_run_slots)."""
    n_sub = len(hits) // THREADS
    starts = np.arange(n_sub * TILE, step=RUN)
    cnt = np.bitwise_count(hits).astype(np.int64).reshape(n_sub, 16, 32)
    incl = np.cumsum(cnt, axis=2)                  # the warp's shuffle scan
    wsum = incl[..., -1]                           # (n_sub, 16)
    before = np.cumsum(wsum, axis=1) - wsum        # warps before
    rank0 = (before[..., None] + incl - cnt).reshape(-1)
    pos = np.full((n_sub, SLOTS), -1, np.int32)
    for r in np.flatnonzero((rank0 < SLOTS) & (hits != 0)):
        rank, h = int(rank0[r]), int(hits[r])
        while h and rank < SLOTS:
            low = h & -h
            pos[r * RUN // TILE, rank] = starts[r] + low.bit_length() - 1
            h ^= low
            rank += 1
    return pos, wsum.sum(axis=1).astype(np.int32)


def mirror_slots(text, bitmaps, m, cd, shift):
    """filter.cu's slots mode: a sub-block is one tile of 512 runs, ranked
    by slot_ranks."""
    n_sub = -(-(len(text) - m + 1) // TILE)
    return slot_ranks(run_hits(text, bitmaps, m, cd, shift,
                               np.arange(0, n_sub * TILE, RUN)))


def _text(sigma, m, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, sigma, m - 1 + 2 * TILE + 17).astype(np.uint8)


#: start counts around a run, a 128-start mask row and a tile (the ragged
#: ones not a multiple of 32)
STARTS = [1, 31, 32, 33, 129, TILE - 1, TILE + 1, 2 * TILE + 17]


@pytest.mark.parametrize("m", [1, 31, 4097])
@pytest.mark.parametrize("sigma", [4, 256])
def test_filter_mirror_matches_plain(sigma, m):
    """The mirror of both modes equals filter_mask_plain and
    filter_slots_plain at every start count of STARTS (some at 4097, whose
    Horner steps dominate), every stage set of STAGES and texts at
    addresses 0, 1, 5 and 15 mod 16."""
    text = _text(sigma, m, seed=sigma + m)
    starts = STARTS if m < 4097 else STARTS[3:4] + STARTS[-2:]
    crowded = 0
    for i, n_st in enumerate(starts):
        x = text[:m - 1 + n_st]
        t = torch.from_numpy(x.copy())
        for j, (k, stage_bits, fill) in enumerate(STAGES):
            bm = random_stages(k, stage_bits, fill, seed=10 * k + m)
            cd = STAGE_CD[:k]
            shift = (0, 1, 5, 15)[(i + j) % 4]
            b = torch.from_numpy(bm)
            want = cf.filter_mask_plain(t, b, m=m, cd=cd).numpy()
            assert np.array_equal(mirror_mask(x, bm, m, cd, shift), want), \
                (n_st, k, shift)
            pos, counts = mirror_slots(x, bm, m, cd, shift)
            wp, wc = cf.filter_slots_plain(t, b, m=m, cd=cd)
            assert np.array_equal(pos, wp.numpy()), (n_st, k, shift)
            assert np.array_equal(counts, wc.numpy()), (n_st, k, shift)
            assert counts.sum() == want.sum()
            crowded += int((counts > SLOTS).sum())
    assert crowded


@pytest.mark.parametrize("m", [1, 31, 4097])
@pytest.mark.parametrize("sigma", [4, 256])
def test_filter_mirror_matches_pallas(sigma, m):
    """The mirror of both modes equals the Pallas kernels in interpret mode
    (filter_mask_pallas, filter_slots_pallas) on two full sub-blocks and a
    ragged third, at 4096-bit stages filled so that the first sub-blocks
    are crowded, the text at an odd address.  At m=4097 only the mask
    kernel runs (the slot kernel takes some 20 s there in interpret mode;
    the plain case above covers the slots)."""
    text = _text(sigma, m, seed=sigma + m + 1)
    n = len(text)
    k = 2
    bm = random_stages(k, 4096, 0.35, seed=m)
    cd = STAGE_CD[:k]
    jt, jb = jnp.asarray(text), tuple(jnp.asarray(b.reshape(-1, 128))
                                      for b in bm)
    kw = dict(m=m, n=n, n_stages=k, cd=cd, interpret=True)
    n_starts = n - m + 1
    want = np.asarray(pf.filter_mask_pallas(jt, jb, **kw)).reshape(-1)
    got = mirror_mask(text, bm, m, cd, shift=7).reshape(-1)
    assert np.array_equal(got[:n_starts], want[:n_starts])
    assert not got[n_starts:].any()
    if m == 4097:
        return
    rows, _ = pf.filter_slots_pallas(jt, jb, **kw)
    rows = np.asarray(rows)
    pos, counts = mirror_slots(text, bm, m, cd, shift=7)
    assert np.array_equal(pos, rows[:len(pos), :SLOTS])
    assert np.array_equal(counts, rows[:len(pos), SLOTS])
    assert (counts[:2] > SLOTS).all() and counts.sum() == got.sum()


@pytest.mark.parametrize("stage_bits", [4096, 16384, 131072, 262144])
def test_shared_stages_fit_the_card(stage_bits):
    """filter.cu keeps every stage of the 7 x 4096-bit, 32 x 4096-bit and
    13 x 16384-bit sets of the slot32, saturated and fp m=32 cells in
    shared memory, two blocks per SM; the three stages it tests without a
    branch are there at every width the tables build, within the 227 KB a
    block may opt in to (one block per SM at 2^18 bits only)."""
    for m in (1, 31, 32, 129, 4097):
        for k, bits in ((7, 4096), (32, 4096), (13, 16384)):
            assert shared_stages(k, bits, m) == k
        ks = shared_stages(32, stage_bits, m)
        smem = -(-ks * stage_bits // 8 // 16) * 16 + 2 * _buf_bytes(m)
        assert ks >= BRANCH_FREE and smem <= 232448
        assert smem <= SMEM_TARGET or stage_bits == 262144
