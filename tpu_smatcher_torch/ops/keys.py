"""Window keys by binary segment doubling, in torch (port of
tpu_smatcher/ops/keys.py).

All functions work on the LAST axis of an int64 tensor of character codes
over W0 columns; a length-L segment result is valid over columns
[0, W0 - (L - 1)).  O(log m) tensor ops instead of O(m):

  window id      V_{a+b}[j] = (V_a[j] << b*bits) | V_b[j+a]
  fingerprint    F_{a+b}[j] = F_a[j] + mult^a * F_b[j+a]   (mod 2^16)
  window max     M_{a+b}[j] = max(M_a[j], M_b[j+a])

int64 throughout: a 16-bit fingerprint times a 16-bit power stays below
2^32, and every step masks back to 16 bits, so nothing relies on overflow.
"""

from __future__ import annotations

import torch

#: fingerprint multipliers per stage (odd => invertible mod 2^16); the
#: scan uses the first three as its base fingerprints
FP_MULTS = (0x9E37, 0x6A09, 0xB2D1, 0x85EB, 0xC2B3,
            0x2545, 0x9B61, 0x6C89, 0x5BD1, 0xA511)


def _doubling(t: torch.Tensor, m: int, combine) -> torch.Tensor:
    W0 = t.shape[-1]
    cache = {1: t}

    def seg(L):                      # width of seg(L) is W0 - (L - 1)
        if L not in cache:
            a = L // 2
            b = L - a
            va, vb = seg(a), seg(b)
            w = W0 - (L - 1)
            cache[L] = combine(va[..., :w], vb[..., a:a + w], a, b)
        return cache[L]

    return seg(m)


def wid_keys(t: torch.Tensor, m: int, bits: int) -> torch.Tensor:
    """Packed window ids of the m chars starting at each column."""
    return _doubling(t.to(torch.int64), m,
                     lambda va, vb, a, b: (va << (b * bits)) | vb)


def fp_keys(t: torch.Tensor, m: int, mult: int) -> torch.Tensor:
    """16-bit polynomial fingerprints: sum c[j+i] * mult^i mod 2^16."""
    def comb(fa, fb, a, b):
        return (fa + pow(mult, a, 1 << 16) * fb) & 0xFFFF
    return _doubling(t.to(torch.int64), m, comb)


def max_keys(t: torch.Tensor, m: int) -> torch.Tensor:
    """Max char code over each m-window: the pad guard.  A window is real
    text iff its max is < sigma (distribution pads shards and halos with
    the out-of-alphabet symbol sigma, and for a power-of-two sigma a pad
    window's packed id can alias a real pattern's, so exact-tier scans
    that may see pads mask by this)."""
    return _doubling(t.to(torch.int64), m,
                     lambda va, vb, a, b: torch.maximum(va, vb))
