"""The filter engines' portable scans in torch: Wu-Manber, SOG, SH, SBOM
(port of tpu_smatcher/ops/filters.py, its XLA path).

Each is a dense masked evaluation over every window start, the rewrite of
the reference's skip loops (counts preserved):

  WM   (cuda/cuda_wm.cu:136-176): last-3-gram hash -> SHIFT == 0 filter,
       then exact bucket verification (common.verify_starts).
  SOG  (cuda/cuda_sog.cu:204-213): per-start AND of shifted T-table bit
       streams in place of the sequential E register, then verification.
  SH   (cuda/cuda_sh.cu:93-101): m-step backward reversed-trie walk at
       every window end; terminal == match.
  SBOM (cuda/cuda_sbom.cu:93-117): m-step backward factor-oracle walk;
       full walks gate exact verification.

They run on the scanner's device in tiles of `tile` starts
(common.tiled_count), a Python loop over torch ops where JAX has
lax.fori_loop.  These are what make_engine(..., fastpath=False) runs, and
what count falls back to without a fast path; the fast path
(ops/cuda_engines.py) is the production scan.  Out-of-alphabet text
indexes tables as a JAX gather does (clamped).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_smatcher_torch.automata.sbom import SBOMTables
from tpu_smatcher_torch.automata.sh import SHTables
from tpu_smatcher_torch.automata.sog import SOG_B, SOGTables
from tpu_smatcher_torch.automata.verify import VerifyTables
from tpu_smatcher_torch.automata.wu import WM_B, WMTables, hash3_np
from tpu_smatcher_torch.ops.common import (M32, EngineScanner,
                                           gather_clamped, pad_col,
                                           tiled_count, verify_starts)

DEFAULT_TILE = 1 << 20


def _zero(text: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=text.device)


def wm_count_core(text, shift_ext, packed, bucket_ids, *, sigma, m, lmax,
                  tile):
    """0-d int32 count.  shift_ext: SHIFT extended to the (sigma+1)-char
    hash space, so pad windows hash to non-candidate (init-value) slots."""
    if int(text.shape[0]) < m:
        return _zero(text)

    def per_tile(chunk, valid):
        t = chunk.to(torch.int64)
        w = valid.shape[0]
        h = (t[m - 3:m - 3 + w] * 4 + t[m - 2:m - 2 + w]) * 4 + t[m - 1:m - 1 + w]
        cand = (gather_clamped(shift_ext, h) == 0) & valid
        return verify_starts(chunk, cand, packed=packed, bucket_ids=bucket_ids,
                             lmax=lmax, sigma=sigma, m=m).sum()

    return tiled_count(per_tile, text, tile=tile, m=m, sigma=sigma)


def sog_count_core(text, t_table, packed, bucket_ids, *, sigma, m, lmax,
                   tile):
    """0-d int32 count.  t_table: (sigma^3,) uint32 bits in int32; pad
    grams clamp into the table, and any false candidate they make is
    killed by verification."""
    if int(text.shape[0]) < m:
        return _zero(text)

    def per_tile(chunk, valid):
        t = chunk.to(torch.int64)
        w = valid.shape[0]
        ng = t.shape[0] - 2
        g = t[:ng] + t[1:ng + 1] * sigma + t[2:ng + 2] * (sigma * sigma)
        v = gather_clamped(t_table, g).to(torch.int64) & M32
        acc = torch.zeros(w, dtype=torch.int64, device=chunk.device)
        for i in range(m - SOG_B + 1):
            acc |= (v[i:i + w] >> i) & 1
        cand = (acc == 0) & valid
        return verify_starts(chunk, cand, packed=packed, bucket_ids=bucket_ids,
                             lmax=lmax, sigma=sigma, m=m).sum()

    return tiled_count(per_tile, text, tile=tile, m=m, sigma=sigma)


def _backward_walk(chunk, trans, sig_p, m, w):
    """The m-step backward walk from every window end of the tile: (final
    state, whether all m steps succeeded); a dead walk keeps its last live
    state."""
    t = chunk.to(torch.int64)
    state = torch.zeros(w, dtype=torch.int64, device=chunk.device)
    alive = torch.ones(w, dtype=torch.bool, device=chunk.device)
    for i in range(m):                   # step i reads char end - i
        nxt = gather_clamped(trans, state * sig_p + t[m - 1 - i:m - 1 - i + w])
        step = alive & (nxt >= 0)
        state = torch.where(step, nxt.to(torch.int64), state)
        alive = step
    return state, alive


def sh_count_core(text, trans, final, *, sigma, m, tile):
    """0-d int32 count.  trans: (S*(sigma+1),) reversed-trie transitions,
    -1 missing and a -1 pad column; terminal states are full-pattern walks,
    so nothing is verified."""
    if int(text.shape[0]) < m:
        return _zero(text)

    def per_tile(chunk, valid):
        state, _ = _backward_walk(chunk, trans, sigma + 1, m, valid.shape[0])
        return (final[state] * valid).sum()

    return tiled_count(per_tile, text, tile=tile, m=m, sigma=sigma)


def sbom_count_core(text, trans, final_count, packed, bucket_ids, *, sigma,
                    m, lmax, tile):
    """0-d int32 count: full oracle walks ending in a terminal state are
    verified exactly."""
    if int(text.shape[0]) < m:
        return _zero(text)

    def per_tile(chunk, valid):
        state, alive = _backward_walk(chunk, trans, sigma + 1, m,
                                      valid.shape[0])
        cand = alive & (final_count[state] > 0) & valid
        return verify_starts(chunk, cand, packed=packed, bucket_ids=bucket_ids,
                             lmax=lmax, sigma=sigma, m=m).sum()

    return tiled_count(per_tile, text, tile=tile, m=m, sigma=sigma)


# ---------------------------------------------------------------------------
# the engines' scanners
# ---------------------------------------------------------------------------

def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class _VerifyingScanner(EngineScanner):
    """An engine whose candidates are verified against VerifyTables."""

    def _verify_tables(self, vt: VerifyTables):
        self.lmax = vt.lmax
        self.packed = _tensor(vt.packed, self.device)
        self.bucket_ids = _tensor(vt.bucket_ids.reshape(-1), self.device)


class WMScanner(_VerifyingScanner):
    def __init__(self, wm: WMTables, vt: VerifyTables, *,
                 tile: int = DEFAULT_TILE, device):
        self.m, self.sigma, self.tile = wm.m, wm.sigma, tile
        self.device = torch.device(device)
        # SHIFT extended over hashes holding the pad char (value sigma)
        s = np.int32(wm.sigma)
        shift_ext = np.full(int(hash3_np(s, s, s)) + 1, wm.m - WM_B + 1,
                            np.int32)
        shift_ext[:wm.shiftsize] = wm.shift
        self.shift_ext = _tensor(shift_ext, self.device)
        self._verify_tables(vt)

    def _count_core(self, text):
        return wm_count_core(text, self.shift_ext, self.packed,
                             self.bucket_ids, sigma=self.sigma, m=self.m,
                             lmax=self.lmax, tile=self.tile)


class SOGScanner(_VerifyingScanner):
    def __init__(self, sog: SOGTables, vt: VerifyTables, *,
                 tile: int = DEFAULT_TILE, device):
        self.m, self.sigma, self.tile = sog.m, sog.sigma, tile
        self.device = torch.device(device)
        self.t_table = _tensor(sog.T.view(np.int32), self.device)
        self._verify_tables(vt)

    def _count_core(self, text):
        return sog_count_core(text, self.t_table, self.packed,
                              self.bucket_ids, sigma=self.sigma, m=self.m,
                              lmax=self.lmax, tile=self.tile)


class SHScanner(EngineScanner):
    def __init__(self, sh: SHTables, *, tile: int = DEFAULT_TILE, device):
        self.m, self.sigma, self.tile = sh.m, sh.sigma, tile
        self.device = torch.device(device)
        self.trans = _tensor(pad_col(sh.transition, -1).reshape(-1),
                             self.device)
        self.final = _tensor(sh.final.astype(np.int32), self.device)

    def _count_core(self, text):
        return sh_count_core(text, self.trans, self.final, sigma=self.sigma,
                             m=self.m, tile=self.tile)


class SBOMScanner(_VerifyingScanner):
    def __init__(self, sb: SBOMTables, vt: VerifyTables, *,
                 tile: int = DEFAULT_TILE, device):
        self.m, self.sigma, self.tile = sb.m, sb.sigma, tile
        self.device = torch.device(device)
        self.trans = _tensor(pad_col(sb.transition, -1).reshape(-1),
                             self.device)
        self.final_count = _tensor(sb.final_count, self.device)
        self._verify_tables(vt)

    def _count_core(self, text):
        return sbom_count_core(text, self.trans, self.final_count,
                               self.packed, self.bucket_ids,
                               sigma=self.sigma, m=self.m, lmax=self.lmax,
                               tile=self.tile)
