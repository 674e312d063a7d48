"""Multi-pattern Horspool bad-character table (port of
tpu_smatcher/automata/bm.py, the reference's preBmBc, bm/bm.c:19-29):

    bmBc[c] = min over patterns j and positions i < m-1 of (m - 1 - i)
              where pattern[j][i] == c, else m.

The dense SH scan evaluates every window end instead of skipping by bmBc
(skipped ends cannot match, so counts are identical); the table stays part
of the SH engine's tables.
"""

from __future__ import annotations

import numpy as np


def pre_bm_bc(patterns: np.ndarray, sigma: int) -> np.ndarray:
    """patterns: (p, m) uint8 codes in [0, sigma). Returns (sigma,) int32."""
    patterns = np.asarray(patterns, np.uint8)
    _, m = patterns.shape
    bmBc = np.full(sigma, m, dtype=np.int32)
    if m > 1:
        shifts = (m - 1 - np.arange(m - 1)).astype(np.int32)
        for pat in patterns:
            np.minimum.at(bmBc, pat[: m - 1], shifts)
    return bmBc
