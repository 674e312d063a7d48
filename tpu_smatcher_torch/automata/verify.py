"""Exact-verification tables of the filter engines WM, SOG and SBOM (port of
tpu_smatcher/automata/verify.py).

The reference verifies candidates three ways (WM prefix lists + memcmp,
wu/wu.c:184-201; SOG Rabin-Karp binary search, sog/sog8.c:51-95; SBOM
state lists, sbom/sbom.c:176-190), all deciding "does the window equal a
pattern?".  Here one structure does: patterns bucketed by their last
3-gram in a collision-free base-sigma key, buckets padded to lmax, pattern
bytes packed into little-endian int32 words (ops/lookup.pack_rows).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_smatcher_torch.ops.lookup import pack_rows


@dataclasses.dataclass
class VerifyTables:
    packed: np.ndarray        # (p, W) int32 — LE-packed pattern bytes, 0-padded
    bucket_ids: np.ndarray    # (H, Lmax) int32 — pattern ids, -1 padded
    bucket_size: np.ndarray   # (H,) int32
    lmax: int
    words: int                # W = ceil(m / 4)
    sigma: int
    m: int


def gram_key(c0, c1, c2, sigma: int):
    """Collision-free base-sigma 3-gram key (vectorized)."""
    return (np.asarray(c0, np.int64)
            + np.asarray(c1, np.int64) * sigma
            + np.asarray(c2, np.int64) * sigma * sigma)


def build_verify(patterns: np.ndarray, sigma: int) -> VerifyTables:
    patterns = np.asarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    if m < 3:
        raise ValueError("verification keys need m >= 3")
    H = sigma ** 3
    keys = gram_key(patterns[:, m - 3], patterns[:, m - 2],
                    patterns[:, m - 1], sigma)
    size = np.bincount(keys, minlength=H).astype(np.int32)
    lmax = max(1, int(size.max(initial=0)))
    bucket_ids = np.full((H, lmax), -1, dtype=np.int32)
    slot = np.zeros(H, dtype=np.int64)
    for j in range(p):
        h = int(keys[j])
        bucket_ids[h, slot[h]] = j
        slot[h] += 1
    return VerifyTables(pack_rows(patterns), bucket_ids, size, lmax,
                        -(-m // 4), sigma, m)
