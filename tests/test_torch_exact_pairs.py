"""The exact tier's pair table (tpu_smatcher_torch/csrc/exact_count.cu's
pair path): its definition, ops/cuda_filter.exact_pair_table_plain, and a
numpy mirror of the kernel's block-wide build (build_pairs: a table word
from two bitmap words, entry by entry below 8 bits of gram).

Held here: the plain count read through the table (one entry for two
starts) equals exact_count_plain, guard on and off, on random texts at
sigma in {4, 8, 20} and every m the pair rule admits; and the mirror of the
kernel's build equals the plain table at every (bits, m) the rule admits.
All integer: tolerance 0.  tests/test_torch_exact_mirror.py runs the
kernel's pair runs on these tables; the CUDA kernel is held against the
plain versions on the card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from tpu_smatcher_torch.ops import cuda_filter as cf
from tpu_smatcher_torch.ops.common import bits_per_char


def _admitted(bits):
    """Every m of the exact tier (m*bits <= 16) whose (m+1)-gram ids fit
    the pair table, with the tier's bitmap of max(4096, 2^(m*bits)) bits."""
    return [m for m in range(1, 17) if m * bits <= 16 and cf.exact_pairs(
        m, bits, max(4096, 1 << (m * bits)) // 32)]


#: (sigma, m) of the count checks: every m the rule admits at sigma 4, 8, 20
COUNT_CASES = [(sigma, m) for sigma in (4, 8, 20)
               for m in _admitted(bits_per_char(sigma))]
#: (bits, m) of the build checks: every shape the rule admits
BUILD_CASES = [(bits, m) for bits in range(1, 9) for m in _admitted(bits)]


def _bitmap(m, bits, seed):
    nbits = max(4096, 1 << (m * bits))
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2**31, 2**31, nbits // 32,
                                         dtype=np.int64).astype(np.int32))


def build_pairs(bitmap, m, bits):
    """(words,) uint64: csrc/exact_count.cu's build_pairs over a bitmap
    ((nwords,) int32), step for step: below 8 bits of gram entry by entry
    (g taken mod 2^gb); else each word from the 16 bitmap bits of its low
    ids, spread to the odd bits, and the c = max(1, 16 >> bits) bits of its
    ids g >> bits, each repeated over 16/c entries at the even bits."""
    bm = bitmap.numpy().view(np.uint32).astype(np.uint64)
    gb, kb = bits * (m + 1), bits * m
    words = 1 << (gb - 4) if gb > 4 else 1
    kmask = np.uint64((1 << kb) - 1)
    w = np.arange(words, dtype=np.uint64)
    b5, b31 = np.uint64(5), np.uint64(31)

    def bit(k):
        return (bm[(k >> b5).astype(np.int64)] >> (k & b31)) & np.uint64(1)
    if gb < 8:
        out = np.zeros(words, np.uint64)
        for e in range(16):
            g = (w * np.uint64(16) + np.uint64(e)) & np.uint64((1 << gb) - 1)
            out |= (bit(g >> np.uint64(bits))
                    | bit(g & kmask) << np.uint64(1)) << np.uint64(2 * e)
        return out
    lo0 = (w << np.uint64(4)) & kmask
    z = (bm[(lo0 >> b5).astype(np.int64)] >> (lo0 & np.uint64(16))) \
        & np.uint64(0xFFFF)
    for sh, mk in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333),
                   (1, 0x55555555)):
        z = (z | z << np.uint64(sh)) & np.uint64(mk)
    hi0 = (w << np.uint64(4)) >> np.uint64(bits)
    if bits >= 4:
        h = bit(hi0) * np.uint64(0xFFFFFFFF)
    else:
        c = 16 >> bits
        x = (bm[(hi0 >> b5).astype(np.int64)] >> (hi0 & b31)) \
            & np.uint64((1 << c) - 1)
        if bits == 3:
            h = ((x & np.uint64(1)) | (x & np.uint64(2)) << np.uint64(15)) \
                * np.uint64(0xFFFF)
        elif bits == 2:
            h = ((x * np.uint64(0x00204081)) & np.uint64(0x01010101)) \
                * np.uint64(0xFF)
        else:
            y = (x | x << np.uint64(12)) & np.uint64(0x000F000F)
            y = (y | y << np.uint64(6)) & np.uint64(0x03030303)
            h = ((y | y << np.uint64(3)) & np.uint64(0x11111111)) \
                * np.uint64(0xF)
    return ((h & np.uint64(0x55555555)) | z << np.uint64(1)) \
        & np.uint64(0xFFFFFFFF)


@pytest.mark.parametrize("guard", [False, True])
@pytest.mark.parametrize("sigma,m", COUNT_CASES)
def test_pair_count_matches_exact_count(sigma, m, guard):
    """The count read through the plain pair table, one entry for starts
    2k and 2k+1, equals exact_count_plain on random texts of every parity
    of start count, n = m included; with the guard, over text holding the
    pad symbol wherever sigma < 2^bits."""
    bits = bits_per_char(sigma)
    bitmap = _bitmap(m, bits, seed=sigma * 31 + m)
    table = cf.exact_pair_table_plain(bitmap, m, bits)
    assert table.dtype == torch.int32
    assert table.shape[0] == max(1, 1 << (bits * (m + 1) - 4))
    rng = np.random.default_rng(sigma + m)
    top = sigma + 1 if guard and sigma < 1 << bits else sigma
    for n in (m, m + 1, m + 2, 777, 3000):
        t = torch.from_numpy(rng.integers(0, top, n).astype(np.uint8))
        kw = dict(m=m, sigma=sigma, guard=guard)
        assert int(cf.exact_pair_count_plain(t, table, **kw)) == \
            int(cf.exact_count_plain(t, bitmap, **kw))


@pytest.mark.parametrize("bits,m", BUILD_CASES)
def test_kernel_build_matches_plain_table(bits, m):
    """The mirror of the kernel's word-at-a-time build equals the plain
    table on a random bitmap, and on one with every bit set or none."""
    bitmap = _bitmap(m, bits, seed=bits * 17 + m)
    want = cf.exact_pair_table_plain(bitmap, m, bits)
    assert np.array_equal(build_pairs(bitmap, m, bits).astype(np.uint32),
                          want.numpy().view(np.uint32))
    ones = torch.full_like(bitmap, -1)
    assert (build_pairs(ones, m, bits) == 0xFFFFFFFF).all()
    assert not build_pairs(torch.zeros_like(bitmap), m, bits).any()
