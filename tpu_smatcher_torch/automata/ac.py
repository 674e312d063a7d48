"""Aho-Corasick table builder (port of tpu_smatcher/automata/ac.py).

The reference's flat tables — ``transition`` (-1 = missing, root row
defaults 0), ``supply`` (failure links), ``final`` (ac/ac.c:127-196) —
plus what the scan needs instead of walking failure links per byte:

  - ``delta``: the completed DFA (failure chains resolved at build time),
    one gather per byte;
  - ``delta_packed = delta * 2 + final[delta]``: next state and terminal
    flag from one gather;
  - ``multi_step_tables``: q bytes per gather, packing (next state,
    terminal visits over the q steps), exact counts.

A pad column ``sigma`` resets to the root (never terminal), so a scan can
right-pad its text with the out-of-alphabet symbol.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_smatcher_torch import native as nat


@dataclasses.dataclass
class ACTables:
    transition: np.ndarray   # (S, sigma) int32, -1 missing (root row: 0)
    supply: np.ndarray       # (S,) int32 failure links
    final: np.ndarray        # (S,) uint8 terminal flags
    delta: np.ndarray        # (S, sigma + 1) int32 completed DFA (+pad col -> 0)
    depth: np.ndarray        # (S,) int32 trie depth of each state
    n_states: int
    sigma: int
    m: int

    @property
    def delta_packed(self) -> np.ndarray:
        """(S, sigma+1) int32: next*2 | final[next]."""
        nxt = self.delta
        return (nxt.astype(np.int32) << 1) | self.final[nxt].astype(np.int32)


def _build_trie(patterns: np.ndarray):
    """Forward trie over the pattern rows: (children dicts, final, depth)."""
    goto = [dict()]
    final = [False]
    depth = [0]
    for pat in patterns:
        s = 0
        for c in pat:
            c = int(c)
            nxt = goto[s].get(c)
            if nxt is None:
                goto.append(dict())
                final.append(False)
                depth.append(depth[s] + 1)
                nxt = len(goto) - 1
                goto[s][c] = nxt
            s = nxt
        final[s] = True
    return goto, final, depth


def build_ac(patterns: np.ndarray, sigma: int,
             native: bool | str = "auto") -> ACTables:
    """The tables of `patterns` over an alphabet of `sigma` codes.  native:
    "auto" builds with the native library where it loads, else with numpy;
    True requires the library (RuntimeError without it); False is numpy
    only.  The two paths give equal tables."""
    patterns = np.asarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    if native:
        r = nat.build_ac_native(patterns, sigma)
        if r is not None:
            transition, supply, final, delta, depth, n = r
            return ACTables(transition, supply, final, delta, depth, n,
                            sigma, m)
        if native is True:
            raise RuntimeError("native builder requested but unavailable")
    goto, final_l, depth_l = _build_trie(patterns)
    S = len(goto)

    transition = np.full((S, sigma), -1, dtype=np.int32)
    transition[0, :] = 0                      # root row defaults (ac_init)
    for s, edges in enumerate(goto):
        for c, t in edges.items():
            transition[s, c] = t

    final = np.asarray(final_l, dtype=np.uint8)
    depth = np.asarray(depth_l, dtype=np.int32)

    # failure links level by level; delta[0] = transition row 0 (complete)
    supply = np.zeros(S, dtype=np.int32)
    delta = np.zeros((S, sigma + 1), dtype=np.int32)
    delta[0, :sigma] = transition[0]
    order = np.argsort(depth, kind="stable")
    max_depth = int(depth.max(initial=0))
    by_depth = [order[depth[order] == d] for d in range(max_depth + 1)]
    # a state's failure link resolves with its parent's level:
    # fail(t) = delta[fail(s), c]
    for d in range(1, max_depth + 1):
        states = by_depth[d]
        if states.size == 0:
            continue
        rows = transition[states]                       # (k, sigma)
        fallback = delta[supply[states]][:, :sigma]     # complete (< d)
        delta[states, :sigma] = np.where(rows >= 0, rows, fallback)
        for s in states.tolist():
            fs = supply[s]
            for c, t in goto[s].items():
                supply[t] = delta[fs, c]
    delta[:, sigma] = 0           # pad column: out-of-alphabet resets to root
    return ACTables(transition, supply, final, delta, depth, S, sigma, m)


def multi_step_tables(ac: ACTables, q: int) -> tuple[np.ndarray, int]:
    """The DFA composed over q steps: (table, count_bits), where
    ``table[s, g]`` for the q-gram g = sum_j c_j * (sigma+1)^(q-1-j) (chars
    consumed in order j = 0..q-1) packs ``next_state << count_bits |
    terminal_visits``; terminal_visits counts the terminal states visited
    over the q transitions, so per-position counts are preserved.  int64
    when the packed value does not fit int32."""
    if q < 1:
        raise ValueError("q >= 1")
    sig_p = ac.sigma + 1
    count_bits = max(1, q.bit_length())
    nxt1 = ac.delta.astype(np.int64)                     # (S, sig_p)
    cnt1 = ac.final[ac.delta].astype(np.int64)
    nxt, cnt = nxt1, cnt1
    for _ in range(q - 1):
        # one more char: gram g' = g * sig_p + c
        S, G = nxt.shape
        nxt_new = nxt1[nxt.reshape(-1)].reshape(S, G * sig_p)
        cnt_new = (cnt.reshape(S, G, 1)
                   + cnt1[nxt.reshape(-1)].reshape(S, G, sig_p)
                   ).reshape(S, G * sig_p)
        nxt, cnt = nxt_new, cnt_new
    table = (nxt << count_bits) | cnt
    if int(nxt.max()) << count_bits > np.iinfo(np.int32).max:
        return table.astype(np.int64), count_bits
    return table.astype(np.int32), count_bits
