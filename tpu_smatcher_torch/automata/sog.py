"""SOG (shift-or with q-grams) table builder (port of
tpu_smatcher/automata/sog.py).

The reference's T8/T16/T32 tables are 2^24-entry arrays indexed by a
byte-packed 3-gram (sog/sog8.c:140-147); since text bytes are code points
< sigma, the gram index is remapped to base sigma (g = c0 + c1*sigma +
c2*sigma^2), an injective relabelling that shrinks the table to sigma^3
entries.  Bit i of T[g] is cleared iff some pattern holds gram g at offset
i.  Start s is a candidate iff bit i of T[gram(s+i)] is 0 for every i in
0..m-B, the reference's E-register test after warm-up.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_smatcher_torch import native as nat

SOG_B = 3


@dataclasses.dataclass
class SOGTables:
    T: np.ndarray          # (sigma^3,) uint32 — bit i set = gram NOT at offset i
    width: int             # state register width: 8, 16, or 32 (m == width)
    checkbit: int          # m - B
    sigma: int
    m: int


def build_sog(patterns: np.ndarray, sigma: int, width: int | None = None,
              native: bool | str = "auto") -> SOGTables:
    """native: as automata.ac.build_ac's."""
    patterns = np.asarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    if width is None:
        width = m
    if width not in (8, 16, 32) or m != width:
        raise ValueError("SOG requires m == width in {8, 16, 32}")
    if native:
        T = nat.build_sog_native(patterns, sigma, width)
        if T is not None:
            return SOGTables(T, width, m - SOG_B, sigma, m)
        if native is True:
            raise RuntimeError("native builder requested but unavailable")
    full = np.uint32((1 << width) - 1)
    T = np.full(sigma ** 3, full, dtype=np.uint32)
    # grams at offsets i in [0, m-B]: g = c_i + c_{i+1}*sigma + c_{i+2}*sigma^2
    offs = np.arange(m - SOG_B + 1)
    g = (patterns[:, offs].astype(np.int64)
         + patterns[:, offs + 1].astype(np.int64) * sigma
         + patterns[:, offs + 2].astype(np.int64) * sigma * sigma)
    bits = np.uint32(1) << offs.astype(np.uint32)
    clear = np.broadcast_to(bits, g.shape)
    np.bitwise_and.at(T, g.reshape(-1), (full ^ clear).reshape(-1))
    return SOGTables(T, width, m - SOG_B, sigma, m)
