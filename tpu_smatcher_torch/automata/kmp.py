"""Knuth-Morris-Pratt preprocessing and a single-pattern count, on the
host in numpy (the port's copy of tpu_smatcher/automata/kmp.py).

The reference ships only KMP's table builder as live code (kmp/kmp.c:
140-158, the optimized next table); kmp_count scans with it so the table's
semantics are testable.  KMP is single-pattern and sequential, so no
kernel runs it.
"""

from __future__ import annotations

import numpy as np


def pre_kmp(pattern: np.ndarray) -> np.ndarray:
    """Optimized KMP next table of one (m,) uint8 pattern: (m+1,) int32,
    next[0] = -1; entry i is the resume position after a mismatch at
    pattern position i, chained through positions holding the same
    character; next[m] is the border length of the whole pattern."""
    p = np.asarray(pattern, np.uint8)
    m = len(p)
    nxt = np.empty(m + 1, np.int32)
    nxt[0] = -1
    j = -1
    for i in range(m):
        while j >= 0 and p[i] != p[j]:
            j = nxt[j]
        j += 1
        if i + 1 < m and p[i + 1] == p[j]:
            nxt[i + 1] = nxt[j]
        else:
            nxt[i + 1] = j
    return nxt


def kmp_count(pattern: np.ndarray, text: np.ndarray) -> int:
    """Occurrences of `pattern` in `text` (overlapping ones too) through
    the pre_kmp table: one count per end position whose suffix equals the
    pattern."""
    p = np.asarray(pattern, np.uint8)
    t = np.asarray(text, np.uint8)
    m, n = len(p), len(t)
    if m == 0 or n < m:
        return 0
    nxt = pre_kmp(p)
    count = 0
    j = 0
    for i in range(n):
        while j >= 0 and t[i] != p[j]:
            j = nxt[j]
        j += 1
        if j == m:
            count += 1
            j = nxt[j]
            if j < 0:
                j = 0
    return count
