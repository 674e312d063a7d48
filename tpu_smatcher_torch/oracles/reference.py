"""Exact-semantics conformance oracles (the port's copy of
tpu_smatcher/oracles/reference.py).

Pure-Python re-implementations of the reference's five CPU search cores,
preserving every counting quirk (<=1 match per position, AC without
fail-output joining, SOG's filter/verify offsets).  They are written from
the algorithm semantics, independently of the engines' tables and scans,
so they are a second truth beside datagen's window set membership.

Reference behaviors mirrored (citations into the reference CUDA matcher):
  - AC:   extended trie + BFS failure links, count terminal-state visits,
          no output-set joining (ac/ac.c:79-124, 198-222; the note at :118).
  - SH:   trie over reversed patterns, backward window walk, Horspool
          bad-character shift (sh/sh.c:81-178, bm/bm.c:19-29).
  - SBOM: factor oracle of reversed patterns with external transitions
          patched during insertion, terminal pattern-id lists, memcmp verify,
          shift max(m-j, 1) (sbom/sbom.c:51-196).
  - WM:   B=3 block hash with 2-bit shifts, SHIFT/PREFIX tables, <=1 match
          per window end (wu/wu.c:18-47, 151-251; init main.c:429-449).
  - SOG:  shift-or over 3-grams with an 8/16/32-bit state register, window
          verification at column-m+B; the reference's Rabin-Karp+bitmap
          verification covers the full m-byte window (sog/sog8.c:51-115,
          sog/sog16.c:59-146, sog/sog32.c:61,133-139), so it is equivalent
          to exact membership, which is what is implemented.

All functions take (text: uint8[n] codes, patterns: (p, m) uint8 codes,
sigma: alphabet size) and return the total match count.  Wu-Manber's hash
space (wm_shiftsize, WM_B, WM_BITS_IN_SHIFT) and SOG's gram length (SOG_B)
are the port's automata constants: one copy in the port.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from tpu_smatcher_torch.automata.sog import SOG_B
from tpu_smatcher_torch.automata.wu import (WM_B, WM_BITS_IN_SHIFT,
                                            wm_shiftsize)


def _as_arrays(text, patterns):
    text = np.asarray(text, dtype=np.uint8)
    patterns = np.asarray(patterns, dtype=np.uint8)
    if patterns.ndim != 2:
        raise ValueError("patterns must be (p, m)")
    return text, patterns


# ---------------------------------------------------------------------------
# Aho-Corasick (ac/ac.c)
# ---------------------------------------------------------------------------

def _build_ac_trie(patterns):
    """Forward trie + BFS failure links. Returns (goto: list[dict], fail, final)."""
    goto = [dict()]
    final = [False]
    for pat in patterns:
        s = 0
        for c in pat:
            c = int(c)
            nxt = goto[s].get(c)
            if nxt is None:
                goto.append(dict())
                final.append(False)
                nxt = len(goto) - 1
                goto[s][c] = nxt
            s = nxt
        final[s] = True
    fail = [0] * len(goto)
    q = deque()
    for s in goto[0].values():       # depth-1 states fail to root (ac/ac.c:91)
        fail[s] = 0
        q.append(s)
    while q:
        r = q.popleft()
        for c, s in goto[r].items():
            q.append(s)
            f = fail[r]
            while c not in goto[f] and f != 0:
                f = fail[f]
            t = goto[f].get(c, 0)
            fail[s] = t if t != s else 0
            # NOTE: no output-set joining across failure links (ac/ac.c:118)
    return goto, fail, final


def oracle_ac(text, patterns, sigma=None):
    """search_ac semantics (ac/ac.c:198-222): run the goto/failure automaton
    over the text, +1 per position whose state is terminal (<=1 per position)."""
    text, patterns = _as_arrays(text, patterns)
    goto, fail, final = _build_ac_trie(patterns)
    matches = 0
    r = 0
    for c in text:
        c = int(c)
        while c not in goto[r] and r != 0:
            r = fail[r]
        r = goto[r].get(c, 0)       # root self-loops on missing (ac/ac.c:86-88)
        if final[r]:
            matches += 1
    return matches


# ---------------------------------------------------------------------------
# Set Horspool (sh/sh.c + bm/bm.c)
# ---------------------------------------------------------------------------

def _build_reversed_trie(patterns):
    """Trie over reversed patterns (insertion from j=m-1 down, sh/sh.c:86-131)."""
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
    return goto, final


def bad_char_table(patterns, sigma):
    """Multi-pattern Horspool bad-character shifts (bm/bm.c:19-29):
    bmBc[c] = min over patterns j and positions i<m-1 of (m-1-i) where
    pattern_j[i] == c, else m."""
    patterns = np.asarray(patterns, np.uint8)
    p, m = patterns.shape
    bmBc = np.full(sigma, m, dtype=np.int64)
    for pat in patterns:
        for i in range(m - 1):
            c = int(pat[i])
            bmBc[c] = min(bmBc[c], m - 1 - i)
    return bmBc


def oracle_sh(text, patterns, sigma):
    """search_sh semantics (sh/sh.c:151-178): at each visited window end,
    walk the reversed trie backwards; count if the reached node is terminal;
    advance by bmBc[text[column]]."""
    text, patterns = _as_arrays(text, patterns)
    m = patterns.shape[1]
    n = len(text)
    goto, final = _build_reversed_trie(patterns)
    bmBc = bad_char_table(patterns, sigma)
    matches = 0
    column = m - 1
    while column < n:
        r = 0
        j = 0
        while j < m:
            nxt = goto[r].get(int(text[column - j]))
            if nxt is None:
                break
            r = nxt
            j += 1
        if final[r]:
            matches += 1
        column += int(bmBc[int(text[column])])
    return matches


# ---------------------------------------------------------------------------
# SBOM (sbom/sbom.c)
# ---------------------------------------------------------------------------

def _build_factor_oracle(patterns):
    """Factor oracle of reversed patterns (sbom_addstring, sbom/sbom.c:51-150).

    During creation of each new state, external transitions into it are added
    along the supply chain.  Terminal states accumulate pattern-id lists F.
    Returns (goto: list[dict], F: list[list[int]])."""
    goto = [dict()]
    supply = [None]            # supply(root) = None (sbom/sbom.c:36)
    F = [[]]
    for pid, pat in enumerate(patterns):
        m = len(pat)
        s = 0
        j = m - 1
        done = False
        while not done:        # follow existing transitions (sbom/sbom.c:60-68)
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
                    goto[k][c] = new          # external transition (sbom/sbom.c:103)
                    k = supply[k]
                supply[new] = goto[k][c] if k is not None else 0
                s = new
                j -= 1
        F[s].append(pid)        # always appended, even duplicates (sbom/sbom.c:139)
    return goto, F


def oracle_sbom(text, patterns, sigma=None):
    """search_sbom semantics (sbom/sbom.c:152-196): backward oracle walk; on a
    full-window walk (j==m) verify each listed pattern with memcmp, count <=1
    and advance 1; otherwise shift by max(m-j, 1)."""
    text, patterns = _as_arrays(text, patterns)
    m = patterns.shape[1]
    n = len(text)
    goto, F = _build_factor_oracle(patterns)
    matches = 0
    column = m - 1
    while column < n:
        r = 0
        j = 0
        while j < m:
            nxt = goto[r].get(int(text[column - j]))
            if nxt is None:
                break
            r = nxt
            j += 1
        if F[r] and j == m:
            window = text[column - m + 1:column + 1]
            for pid in F[r]:
                if np.array_equal(patterns[pid], window):
                    matches += 1
                    break
            column += 1
        else:
            column += max(m - j, 1)
    return matches


# ---------------------------------------------------------------------------
# Wu-Manber (wu/wu.c)
# ---------------------------------------------------------------------------

def _wm_hash3(c0, c1, c2):
    return ((int(c0) << WM_BITS_IN_SHIFT) + int(c1) << WM_BITS_IN_SHIFT) + int(c2)


def _build_wm_tables(patterns, sigma):
    """SHIFT + PREFIX tables (preproc_wu2, wu/wu.c:211-251; init main.c:444-449)."""
    p, m = patterns.shape
    H = wm_shiftsize(sigma)
    SHIFT = np.full(H, m - WM_B + 1, dtype=np.int64)
    PREFIX = [[] for _ in range(H)]     # (prefix_hash, pattern_index) per hash
    for j in range(p):
        pat = patterns[j]
        for q in range(m, WM_B - 1, -1):
            h = _wm_hash3(pat[q - 3], pat[q - 2], pat[q - 1])
            shiftlen = m - q
            if shiftlen < SHIFT[h]:
                SHIFT[h] = shiftlen
            if shiftlen == 0:
                prefix_hash = (int(pat[0]) << WM_BITS_IN_SHIFT) + int(pat[1])
                PREFIX[h].append((prefix_hash, j))
    return SHIFT, PREFIX


def oracle_wm(text, patterns, sigma):
    """search_wu2 semantics (wu/wu.c:151-209): hash the last 3 chars of the
    window, skip by SHIFT; on SHIFT==0 compare prefix hashes then memcmp,
    count <=1 per window end, advance 1."""
    text, patterns = _as_arrays(text, patterns)
    if patterns.shape[1] < 3:
        raise ValueError("Wu-Manber needs m >= B = 3 (wu/wu.c block size)")
    p, m = patterns.shape
    n = len(text)
    SHIFT, PREFIX = _build_wm_tables(patterns, sigma)
    matches = 0
    column = m - 1
    while column < n:
        h = _wm_hash3(text[column - 2], text[column - 1], text[column])
        shift = int(SHIFT[h])
        if shift == 0:
            hash2 = (int(text[column - m + 1]) << WM_BITS_IN_SHIFT) + int(text[column - m + 2])
            window = text[column - m + 1:column + 1]
            for prefix_hash, j in PREFIX[h]:
                if hash2 == prefix_hash and np.array_equal(patterns[j], window):
                    matches += 1
                    break
            column += 1
        else:
            column += shift
    return matches


# ---------------------------------------------------------------------------
# SOG (sog/sog8.c, sog16.c, sog32.c)
# ---------------------------------------------------------------------------

def _sog_gram(c0, c1, c2):
    """Little-endian byte-packed 3-gram (GET3GRAM, smatcher.h:80)."""
    return int(c0) + (int(c1) << 8) + (int(c2) << 16)


def oracle_sog(text, patterns, sigma=None, width=None):
    """search_sog{8,16,32} semantics: E = (E<<1) | T[gram]; when bit (m-B) of
    E clears, verify the window starting at column-m+B exactly.

    width defaults to m and must be one of 8/16/32 with m == width
    (the reference registers are uint8/uint16/uint32; sog/sog8.c:99,
    sog16.c:119, sog32.c — candidate bits 0x20 / 0x2000 / 0x20000000).
    Gram offsets run 0..m-B per pattern (sog8's `limit = &pattern[6]`,
    sog/sog8.c:119-120; sog16/32's `limit` off-by-one is a dead-code bug we
    do not reproduce)."""
    text, patterns = _as_arrays(text, patterns)
    p, m = patterns.shape
    if width is None:
        width = m
    if width not in (8, 16, 32) or m != width:
        raise ValueError("SOG requires m == width in {8, 16, 32}")
    n = len(text)
    full = (1 << width) - 1
    T = np.full(1 << 24, full, dtype=np.uint32)
    for pat in patterns:
        for i in range(m - SOG_B + 1):
            g = _sog_gram(pat[i], pat[i + 1], pat[i + 2])
            T[g] &= full ^ (1 << i)
    # exact verification set (reference RK hash + bitmap + binary search +
    # memcmp covers the whole window => equivalent to set membership)
    pat_keys = {bytes(pat.tobytes()) for pat in patterns}
    checkbit = 1 << (m - SOG_B)
    E = full
    matches = 0
    for column in range(n - 2):
        g = _sog_gram(text[column], text[column + 1], text[column + 2])
        E = ((E << 1) | int(T[g])) & full
        if E & checkbit:
            continue
        s = column - m + SOG_B
        assert s >= 0, "filter cannot fire before warmup"
        if bytes(text[s:s + m].tobytes()) in pat_keys:
            matches += 1
    return matches


def oracle_sog8(text, patterns, sigma=None):
    return oracle_sog(text, patterns, sigma, width=8)


def oracle_sog16(text, patterns, sigma=None):
    return oracle_sog(text, patterns, sigma, width=16)


def oracle_sog32(text, patterns, sigma=None):
    return oracle_sog(text, patterns, sigma, width=32)


ORACLES = {
    "ac": oracle_ac,
    "sh": oracle_sh,
    "sbom": oracle_sbom,
    "wm": oracle_wm,
    "sog8": oracle_sog8,
    "sog16": oracle_sog16,
    "sog32": oracle_sog32,
}
