"""SBOM (Set Backward Oracle Matching) table builder (port of
tpu_smatcher/automata/sbom.py).

Factor oracle of the reversed patterns: when a new state is created,
external transitions into it are patched along the supply chain
(sbom/sbom.c:99-116), so the transition table accepts at least every
factor of every pattern.  Terminal states carry their pattern ids as a
(S, Fmax) padded id matrix plus per-state counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_smatcher_torch import native as nat


@dataclasses.dataclass
class SBOMTables:
    transition: np.ndarray    # (S, sigma) int32, -1 = missing
    final_count: np.ndarray   # (S,) int32 — number of pattern ids at state
    final_ids: np.ndarray     # (S, Fmax) int32 — pattern ids, -1 padded
    n_states: int
    sigma: int
    m: int


def _finalize(transition, F, n, sigma, m) -> SBOMTables:
    final_count = np.zeros(n, dtype=np.int32)
    for s, ids in F.items():
        final_count[s] = len(ids)
    fmax = max(1, int(final_count.max(initial=0)))
    final_ids = np.full((n, fmax), -1, dtype=np.int32)
    for s, ids in F.items():
        final_ids[s, :len(ids)] = ids
    return SBOMTables(transition, final_count, final_ids, n, sigma, m)


def build_sbom(patterns: np.ndarray, sigma: int,
               native: bool | str = "auto") -> SBOMTables:
    """native: as automata.ac.build_ac's."""
    patterns = np.asarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    if native:
        r = nat.build_sbom_native(patterns, sigma)
        if r is not None:
            transition, F, n = r
            return _finalize(transition, F, n, sigma, m)
        if native is True:
            raise RuntimeError("native builder requested but unavailable")
    goto = [dict()]
    supply = [None]
    F = [[]]
    for pid, pat in enumerate(patterns):
        s = 0
        j = m - 1
        done = False
        while not done:
            nxt = goto[s].get(int(pat[j]))
            if nxt is None:
                break
            s = nxt
            if j <= 0:
                done = True
            j -= 1
        if not done:
            while j >= 0:
                c = int(pat[j])
                new = len(goto)
                goto.append(dict())
                supply.append(None)
                F.append([])
                goto[s][c] = new
                k = supply[s]
                while k is not None and c not in goto[k]:
                    goto[k][c] = new
                    k = supply[k]
                supply[new] = goto[k][c] if k is not None else 0
                s = new
                j -= 1
        F[s].append(pid)

    S = len(goto)
    transition = np.full((S, sigma), -1, dtype=np.int32)
    for s, edges in enumerate(goto):
        for c, t in edges.items():
            transition[s, c] = t
    return _finalize(transition, {s: f for s, f in enumerate(F) if f},
                     S, sigma, m)
