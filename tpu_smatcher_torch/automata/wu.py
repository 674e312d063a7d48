"""Wu-Manber table builder (port of tpu_smatcher/automata/wu.py).

B=3 block hashing with 2-bit shifts in the reference's hash space
(wu/wu.c:64-67, sizes from wu_determine_shiftsize:18-47): for each pattern
position q in [B, m], SHIFT[hash] = min(SHIFT[hash], m - q), initialized to
m - B + 1 (main.c:444-449).  The PREFIX lists (patterns whose last 3-gram
hashes to h, with their 2-char prefix hash) are padded (H, Lmax) matrices.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_smatcher_torch import native as nat

#: bits shifted per character in the block hash (main.c:431)
WM_BITS_IN_SHIFT = 2
#: block (q-gram) size: the scan hashes the window's last 3 chars
WM_B = 3


def wm_shiftsize(sigma: int) -> int:
    """Hash-space size 21*(sigma-1)+1, reproducing wu_determine_shiftsize's
    table for all its supported alphabet sizes (wu/wu.c:18-47)."""
    if sigma not in (2, 4, 8, 20, 128, 256, 512, 1024):
        raise ValueError(f"alphabet size {sigma} unsupported by Wu-Manber")
    return 21 * (sigma - 1) + 1


@dataclasses.dataclass
class WMTables:
    shift: np.ndarray          # (H,) int32
    prefix_value: np.ndarray   # (H, Lmax) int32, -1 padded
    prefix_index: np.ndarray   # (H, Lmax) int32, -1 padded
    prefix_size: np.ndarray    # (H,) int32
    shiftsize: int
    lmax: int
    sigma: int
    m: int


def hash3_np(c0, c1, c2):
    """The reference's block hash ((c0<<2)+c1<<2)+c2 (wu/wu.c:163-169):
    multiply-add with base 4 for every sigma, so for sigma > 4 the fields
    overlap."""
    return ((c0.astype(np.int32) << WM_BITS_IN_SHIFT) + c1.astype(np.int32)
            << WM_BITS_IN_SHIFT) + c2.astype(np.int32)


def build_wm(patterns: np.ndarray, sigma: int,
             native: bool | str = "auto") -> WMTables:
    """native: as automata.ac.build_ac's."""
    patterns = np.asarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    if m < WM_B:
        raise ValueError(f"Wu-Manber requires m >= {WM_B}")
    H = wm_shiftsize(sigma)
    if native:
        r = nat.build_wm_native(patterns, sigma, H)
        if r is not None:
            shift, prefix_value, prefix_index, prefix_size, lmax = r
            return WMTables(shift, prefix_value, prefix_index, prefix_size,
                            H, lmax, sigma, m)
        if native is True:
            raise RuntimeError("native builder requested but unavailable")
    shift = np.full(H, m - WM_B + 1, dtype=np.int32)

    # every (pattern, q) gram hash: q in [B, m], gram chars at q-3, q-2,
    # q-1 (0-based), shiftlen = m - q
    qs = np.arange(WM_B, m + 1)
    h_all = hash3_np(patterns[:, qs - 3], patterns[:, qs - 2],
                     patterns[:, qs - 1])                       # (p, len(qs))
    shiftlen = (m - qs).astype(np.int32)
    np.minimum.at(shift, h_all.reshape(-1),
                  np.broadcast_to(shiftlen, h_all.shape).reshape(-1))

    # PREFIX lists for shiftlen == 0 (q == m): last-gram hash per pattern
    h_last = h_all[:, -1]
    prefix_hash = ((patterns[:, 0].astype(np.int32) << WM_BITS_IN_SHIFT)
                   + patterns[:, 1].astype(np.int32))
    prefix_size = np.bincount(h_last, minlength=H).astype(np.int32)
    lmax = max(1, int(prefix_size.max(initial=0)))
    prefix_value = np.full((H, lmax), -1, dtype=np.int32)
    prefix_index = np.full((H, lmax), -1, dtype=np.int32)
    slot = np.zeros(H, dtype=np.int64)
    for j in range(p):                   # keeps the reference's insertion order
        h = int(h_last[j])
        prefix_value[h, slot[h]] = int(prefix_hash[j])
        prefix_index[h, slot[h]] = j
        slot[h] += 1
    return WMTables(shift, prefix_value, prefix_index, prefix_size, H, lmax,
                    sigma, m)
