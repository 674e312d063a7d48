"""Aho-Corasick portable scan in torch (port of tpu_smatcher/ops/ac.py, its
XLA path).

The failure-link loop per byte of the reference (cuda/cuda_ac.cu:90-94) is
resolved at build time into a completed DFA, one gather per byte.  The
text is cut into `lanes` segments with (m-1)-byte halos (the reference's
per-thread decomposition, cuda_ac.cu:34-46); every lane steps its DFA in
lockstep, a Python loop over (lanes,)-wide gathers where JAX has lax.scan.
A depth-m terminal cannot fire within a lane's first m-1 steps, so the
lanes' counts partition exactly.  q-char stepping uses the composed tables
of automata.ac.multi_step_tables: q bytes per gather, exact counts.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_smatcher_torch.automata.ac import ACTables, multi_step_tables
from tpu_smatcher_torch.ops.common import EngineScanner, cdiv, gather_clamped


def segment(text: torch.Tensor, n: int, *, lanes: int, m: int,
            sigma: int) -> torch.Tensor:
    """(lanes, seg + m - 1) uint8 overlapped segments, right-padded with
    min(sigma, 255).  For the byte alphabet 255 is a real char, so the
    scans mask pad positions by global position; pads are a suffix of a
    lane's stream, so a terminal at a real position never consumed one."""
    seg = max(1, cdiv(n, lanes))
    dev = text.device
    padded = torch.full((lanes * seg + m - 1,), min(sigma, 255),
                        dtype=torch.uint8, device=dev)
    padded[:n] = text[:n]
    main = padded[:lanes * seg].view(lanes, seg)
    halo_idx = ((torch.arange(lanes, device=dev) * seg)[:, None] + seg
                + torch.arange(m - 1, device=dev)[None, :])
    halo = padded[halo_idx.reshape(-1)].view(lanes, m - 1)
    return torch.cat([main, halo], dim=1)


def ac_count_core(text: torch.Tensor, dp: torch.Tensor, *, sig_p: int, m: int,
                  lanes: int) -> torch.Tensor:
    """0-d int32 count.  dp: (S * sig_p,) int32 packed next*2 | final.
    Terminals are masked by global position (< n), exact for every sigma
    including 256."""
    n = int(text.shape[0])
    dev = text.device
    if n < m:
        return torch.zeros((), dtype=torch.int32, device=dev)
    tiles = segment(text, n, lanes=lanes, m=m, sigma=sig_p - 1).to(
        torch.int64).T.contiguous()                        # (T, lanes)
    seg = max(1, cdiv(n, lanes))
    lane_base = torch.arange(lanes, device=dev) * seg
    state = torch.zeros(lanes, dtype=torch.int64, device=dev)
    acc = torch.zeros(lanes, dtype=torch.int64, device=dev)
    for t in range(tiles.shape[0]):
        v = gather_clamped(dp, state * sig_p + tiles[t]).to(torch.int64)
        acc += (v & 1) * (lane_base + t < n)
        state = v >> 1
    return acc.sum().to(torch.int32)


def ac_count_q(text: torch.Tensor, tq: torch.Tensor, *, sig_p: int, m: int,
               lanes: int, q: int, cbits: int) -> torch.Tensor:
    """0-d int32 count, q chars per step.  tq: (S * sig_p**q,) packing
    next_state << cbits | terminal visits; partial grams are padded with
    the out-of-alphabet symbol sig_p - 1, which resets to the root."""
    n = int(text.shape[0])
    dev = text.device
    if n < m:
        return torch.zeros((), dtype=torch.int32, device=dev)
    tiles = segment(text, n, lanes=lanes, m=m, sigma=sig_p - 1)  # (lanes, T)
    T = tiles.shape[1]
    steps = cdiv(T, q)
    if steps * q > T:
        tiles = torch.cat([tiles, torch.full(
            (lanes, steps * q - T), sig_p - 1, dtype=torch.uint8,
            device=dev)], dim=1)
    digits = tiles.view(lanes, steps, q).to(torch.int64)
    grams = torch.zeros((lanes, steps), dtype=torch.int64, device=dev)
    for j in range(q):                  # gram = c0*sig_p^(q-1) + ... + c_(q-1)
        grams = grams * sig_p + digits[:, :, j]
    grams = grams.T.contiguous()                           # (steps, lanes)
    G = sig_p ** q
    cmask = (1 << cbits) - 1
    state = torch.zeros(lanes, dtype=torch.int64, device=dev)
    acc = torch.zeros(lanes, dtype=torch.int64, device=dev)
    for s in range(steps):
        v = gather_clamped(tq, state * G + grams[s]).to(torch.int64)
        acc += v & cmask
        state = v >> cbits
    return acc.sum().to(torch.int32)


def ac_match_ends(text: torch.Tensor, dp: torch.Tensor, *, sig_p: int, m: int,
                  lanes: int) -> torch.Tensor:
    """(n,) uint8: 1 where a window ENDS with a match (the reference
    computes these but only counts them)."""
    n = int(text.shape[0])
    dev = text.device
    if n < m:
        return torch.zeros(n, dtype=torch.uint8, device=dev)
    tiles = segment(text, n, lanes=lanes, m=m, sigma=sig_p - 1).to(
        torch.int64).T.contiguous()                        # (T, lanes)
    lanes_n = tiles.shape[1]
    state = torch.zeros(lanes_n, dtype=torch.int64, device=dev)
    bits = []
    for t in range(tiles.shape[0]):
        v = gather_clamped(dp, state * sig_p + tiles[t]).to(torch.int64)
        bits.append((v & 1).to(torch.uint8))
        state = v >> 1
    bits = torch.stack(bits, dim=1)                        # (lanes, T)
    seg = max(1, cdiv(n, lanes_n))
    # lane i owns local steps [m-1, seg+m-1): global ends i*seg + t
    owned = bits[:, m - 1:]                                # (lanes, seg)
    flat = torch.zeros(lanes_n * seg, dtype=torch.uint8, device=dev)
    flat[m - 1:] = owned.reshape(-1)[:lanes_n * seg - (m - 1)]
    return flat[:n]


class ACScanner(EngineScanner):
    """The AC engine: tables on `device`, count and match ends."""

    def __init__(self, ac: ACTables, *, lanes: int = 8192, q: int = 1,
                 device):
        self.m = ac.m
        self.sig_p = ac.sigma + 1
        self.lanes = lanes
        self.q = q
        self.device = torch.device(device)
        self.dp = torch.from_numpy(np.ascontiguousarray(
            ac.delta_packed.reshape(-1))).to(self.device)
        self.tq, self.cbits = None, 0
        if q > 1:
            tq, self.cbits = multi_step_tables(ac, q)
            self.tq = torch.from_numpy(tq.reshape(-1)).to(self.device)

    def _count_core(self, text):
        if self.q == 1:
            return ac_count_core(text, self.dp, sig_p=self.sig_p, m=self.m,
                                 lanes=self.lanes)
        if self.sig_p > 256:
            raise ValueError(
                "the q-step composed AC scan pads partial grams with the "
                "out-of-alphabet symbol sigma, which does not fit uint8 for "
                "sigma=256; use q=1 (positionally masked) or the fast path")
        return ac_count_q(text, self.tq, sig_p=self.sig_p, m=self.m,
                          lanes=self.lanes, q=self.q, cbits=self.cbits)

    def match_ends(self, text) -> np.ndarray:
        return ac_match_ends(self._as_text(text), self.dp, sig_p=self.sig_p,
                             m=self.m, lanes=self.lanes).cpu().numpy()
