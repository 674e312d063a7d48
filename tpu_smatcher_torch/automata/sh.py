"""Set Horspool table builder (port of tpu_smatcher/automata/sh.py).

Reversed-pattern trie (insertion from the last char down, sh/sh.c:81-149)
plus the multi-pattern Horspool bad-character table (bm/bm.c:19-29).
Every missing transition is -1, so the dense scan's "walk died" test is one
comparison.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_smatcher_torch import native as nat
from tpu_smatcher_torch.automata.bm import pre_bm_bc


@dataclasses.dataclass
class SHTables:
    transition: np.ndarray   # (S, sigma) int32, -1 = missing
    final: np.ndarray        # (S,) uint8
    bmBc: np.ndarray         # (sigma,) int32 bad-character shifts
    n_states: int
    sigma: int
    m: int


def build_sh(patterns: np.ndarray, sigma: int,
             native: bool | str = "auto") -> SHTables:
    """native: as automata.ac.build_ac's."""
    patterns = np.asarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    if native:
        r = nat.build_sh_native(patterns, sigma)
        if r is not None:
            transition, final, bmBc, n = r
            return SHTables(transition, final, bmBc, n, sigma, m)
        if native is True:
            raise RuntimeError("native builder requested but unavailable")
    goto = [dict()]
    final = [False]
    for pat in patterns:
        s = 0
        for c in pat[::-1]:
            c = int(c)
            nxt = goto[s].get(c)
            if nxt is None:
                goto.append(dict())
                final.append(False)
                nxt = len(goto) - 1
                goto[s][c] = nxt
            s = nxt
        final[s] = True
    S = len(goto)
    transition = np.full((S, sigma), -1, dtype=np.int32)
    for s, edges in enumerate(goto):
        for c, t in edges.items():
            transition[s, c] = t
    bmBc = pre_bm_bc(patterns, sigma)
    return SHTables(transition, np.asarray(final, np.uint8), bmBc, S, sigma, m)
