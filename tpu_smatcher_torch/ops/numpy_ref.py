"""Dense, branchless scan references in numpy (the port's copy of
tpu_smatcher/ops/numpy_ref.py, over the port's automata tables).

These are the *mathematical blueprints* of the scan kernels: every engine is
re-expressed as masked full-stride evaluation over all window positions —
no data-dependent skips (WM/SH/SBOM) and no per-byte failure-link loops (AC).
Count preservation vs the reference's skip loops is argued in SURVEY.md §7
and enforced by tests against both the oracles and ground truth.

Conventions:
  - text: (n,) uint8 code points < sigma
  - counts are over window starts [0, n-m]; equal to the reference's counts
    over visited window ends (see oracles.reference module docstring).
"""

from __future__ import annotations

import numpy as np

from tpu_smatcher_torch.automata.ac import ACTables
from tpu_smatcher_torch.automata.sbom import SBOMTables
from tpu_smatcher_torch.automata.sh import SHTables
from tpu_smatcher_torch.automata.sog import SOG_B, SOGTables
from tpu_smatcher_torch.automata.verify import VerifyTables, gram_key
from tpu_smatcher_torch.automata.wu import WMTables, hash3_np
from tpu_smatcher_torch.core.datagen import sliding_windows
from tpu_smatcher_torch.ops.lookup import pack_rows


# ---------------------------------------------------------------------------
# Aho-Corasick: lane-parallel completed-DFA scan
# ---------------------------------------------------------------------------

def segment_text(text: np.ndarray, lanes: int, m: int, pad_value: int) -> np.ndarray:
    """Split text into `lanes` segments with (m-1)-byte halos.

    Lane i covers chars [i*seg, i*seg + seg + m - 1); right-padded with
    pad_value (the out-of-alphabet reset symbol).  This is the reference's
    per-thread decomposition (cuda/cuda_ac.cu:34-46) at lane granularity.
    Returns (lanes, seg + m - 1) uint8."""
    n = len(text)
    seg = -(-n // lanes)
    padded = np.full(lanes * seg + m - 1, pad_value, dtype=np.uint8)
    padded[:n] = text
    idx = np.arange(seg + m - 1)[None, :] + (np.arange(lanes) * seg)[None, :].T
    return padded[idx]


def scan_ac_np(text: np.ndarray, ac: ACTables, lanes: int = 64) -> int:
    """Lane-parallel DFA scan: each lane runs the completed automaton over
    its segment from a fresh root state.  A depth-m terminal cannot fire
    within a lane's first m-1 chars, so per-lane counts partition exactly
    (no warmup masking needed — same argument as the reference's
    per-thread halo, SURVEY.md §2.2)."""
    n = len(text)
    if n < ac.m:
        return 0
    tiles = segment_text(text, lanes, ac.m, ac.sigma)
    dp = ac.delta_packed.reshape(-1)          # (S * (sigma+1),)
    sig_p = ac.sigma + 1
    state = np.zeros(lanes, dtype=np.int64)
    count = 0
    for t in range(tiles.shape[1]):
        v = dp[state * sig_p + tiles[:, t]]
        state = v >> 1
        count += int((v & 1).sum())
    return count


def scan_ac_flat_np(text: np.ndarray, ac: ACTables) -> int:
    """Runtime failure-chain traversal over the *flat ABI tables*
    (transition/supply/final) exactly like the reference GPU hot loop
    (cuda/cuda_ac.cu:586-590) — used to validate the table ABI itself."""
    trans, supply, final = ac.transition, ac.supply, ac.final
    s = 0
    count = 0
    for c in text:
        c = int(c)
        t = trans[s, c]
        while t == -1:
            s = supply[s]
            t = trans[s, c]
        s = int(t)
        count += int(final[s])
    return count


# ---------------------------------------------------------------------------
# Shared verification (WM / SOG / SBOM)
# ---------------------------------------------------------------------------

def _verify_candidates(text: np.ndarray, vt: VerifyTables, cand: np.ndarray) -> np.ndarray:
    """cand: bool over starts [0, n-m]. Returns bool 'matched' per start:
    window equals >= 1 pattern (checked only where cand)."""
    n = len(text)
    m = vt.m
    starts = np.arange(n - m + 1)
    win_words = pack_rows(sliding_windows(text, m))          # (n-m+1, W)
    key = gram_key(text[starts + m - 3], text[starts + m - 2],
                   text[starts + m - 1], vt.sigma)           # (n-m+1,)
    matched = np.zeros(n - m + 1, dtype=bool)
    for l in range(vt.lmax):
        pid = vt.bucket_ids[key, l]                          # (n-m+1,)
        live = cand & (pid >= 0) & ~matched
        eq = (win_words == vt.packed[np.maximum(pid, 0)]).all(axis=1)
        matched |= live & eq
    return matched


# ---------------------------------------------------------------------------
# Wu-Manber: dense SHIFT filter + bucket verification
# ---------------------------------------------------------------------------

def scan_wm_np(text: np.ndarray, wm: WMTables, vt: VerifyTables) -> int:
    n = len(text)
    m = wm.m
    if n < m:
        return 0
    ends = np.arange(m - 1, n)
    h = hash3_np(text[ends - 2], text[ends - 1], text[ends])
    cand = wm.shift[h] == 0
    return int(_verify_candidates(text, vt, cand).sum())


# ---------------------------------------------------------------------------
# SOG: branchless shift-or filter + bucket verification
# ---------------------------------------------------------------------------

def sog_candidates_np(text: np.ndarray, sog: SOGTables) -> np.ndarray:
    """Candidate mask over starts [0, n-m]: all of bits i of T[gram(s+i)]
    clear, i in [0, m-B] — the warmed-up E-register condition."""
    n = len(text)
    m = sog.m
    s2 = np.int64(sog.sigma) * sog.sigma
    g = (text[:n - 2].astype(np.int64)
         + text[1:n - 1].astype(np.int64) * sog.sigma
         + text[2:].astype(np.int64) * s2)
    V = sog.T[g]                                             # (n-2,) uint32
    n_starts = n - m + 1
    acc = np.zeros(n_starts, dtype=np.uint32)
    for i in range(m - SOG_B + 1):
        acc |= (V[i:i + n_starts] >> np.uint32(i)) & np.uint32(1)
    return acc == 0


def scan_sog_np(text: np.ndarray, sog: SOGTables, vt: VerifyTables) -> int:
    if len(text) < sog.m:
        return 0
    cand = sog_candidates_np(text, sog)
    return int(_verify_candidates(text, vt, cand).sum())


# ---------------------------------------------------------------------------
# Set Horspool: dense backward trie walk
# ---------------------------------------------------------------------------

def scan_sh_np(text: np.ndarray, sh: SHTables) -> int:
    """Evaluate the backward reversed-trie walk at EVERY window end (skipped
    positions can't match — Horspool shift safety), m fixed gather steps."""
    n = len(text)
    m = sh.m
    if n < m:
        return 0
    ends = np.arange(m - 1, n)
    state = np.zeros(len(ends), dtype=np.int64)
    alive = np.ones(len(ends), dtype=bool)
    for i in range(m):
        c = text[ends - i]
        nxt = sh.transition[state, c]
        step = alive & (nxt >= 0)
        state = np.where(step, nxt, state)
        alive = step
    return int(sh.final[state].sum())


# ---------------------------------------------------------------------------
# SBOM: dense backward oracle walk + bucket verification
# ---------------------------------------------------------------------------

def scan_sbom_np(text: np.ndarray, sb: SBOMTables, vt: VerifyTables) -> int:
    """Full-window oracle walks (j == m) gate exact verification; the factor
    oracle guarantees every true match survives the walk."""
    n = len(text)
    m = sb.m
    if n < m:
        return 0
    ends = np.arange(m - 1, n)
    state = np.zeros(len(ends), dtype=np.int64)
    alive = np.ones(len(ends), dtype=bool)
    for i in range(m):
        c = text[ends - i]
        nxt = sb.transition[state, c]
        step = alive & (nxt >= 0)
        state = np.where(step, nxt, state)
        alive = step
    cand_ends = alive & (sb.final_count[state] > 0)
    # ends -> starts index space
    return int(_verify_candidates(text, vt, cand_ends).sum())
