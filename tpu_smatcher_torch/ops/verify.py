"""Exact verification of fingerprint candidates with torch ops, no host
sync: the plain version of the cascade route's verify kernel
(cuda_filter.verify_count_live), and the verify of the slot and mask
routes, the sync ladder and the positions paths, over the text's int32
word view (cuda_filter.words_view).  Port of verify_chunked,
verify_attr_at and _verify_matched of tpu_smatcher/ops/fast.py."""

from __future__ import annotations

import functools
from typing import TYPE_CHECKING

import numpy as np
import torch

from tpu_smatcher_torch.ops.keys import FP_MULTS

if TYPE_CHECKING:
    from tpu_smatcher_torch.ops.fast import FastTables


def words_len(n: int, words: int) -> int:
    """Length of the int32 word view of an n-byte text plus the gather
    margin (_verify_matched reads words+1 consecutive words per start)."""
    return -(-n // 4) + words + 1


#: candidates per verification piece: bounds the (piece, words) temporaries
VERIFY_PIECE_ELEMS = 1 << 25


@functools.lru_cache(maxsize=64)
def _powers(mult: int, m: int, device: torch.device) -> torch.Tensor:
    """(m,) int64 mult^i mod 2^16 on `device`, made once: a copy from
    pageable host memory would wait for the device on every scan."""
    rp = np.ones((m,), np.int64)
    for i in range(1, m):
        rp[i] = (rp[i - 1] * mult) & 0xFFFF
    return torch.from_numpy(rp).to(device)


def _fp_from_bytes(bytes2d: torch.Tensor, mult: int) -> torch.Tensor:
    """sum_i bytes2d[:, i] * mult^i mod 2^16 (int64)."""
    rp = _powers(mult, bytes2d.shape[1], bytes2d.device)
    return ((bytes2d * rp).sum(1)) & 0xFFFF


def _verify_matched(text_words, idxs, bucket_ids, packed, bucket_fp2, *, m,
                    words, lmax, eb, n_starts, slot_ok=False,
                    return_pid=False):
    """(cap,) bool: exact verification at candidate starts (idxs, -1 pad).
    return_pid=True also returns each candidate's matching INTERNAL
    (deduped) pattern id, int64, -1 where unmatched: the one fp2 selects
    when slot_ok, else the first bucket slot that matches (a window
    matches at most one deduped pattern, so either is the id).

    Gathers words+1 int32 words per candidate from the word view,
    shift-combines them into the window's packed words, recomputes the
    bucket-key fingerprints from those, and compares with the bucketed
    patterns (one compare when slot_ok: fp2 selects the bucket slot).
    uint32 semantics in int64 with explicit masks."""
    M32 = 0xFFFFFFFF
    dev = idxs.device
    live = (idxs >= 0) & (idxs < n_starts)
    idxs = idxs.clamp(0, max(n_starts - 1, 0))
    q = idxs >> 2
    r8 = (idxs & 3) << 3
    cols = torch.arange(words + 1, device=dev)
    W = text_words[q[:, None] + cols[None, :]].to(torch.int64) & M32
    lo = W[:, :-1] >> r8[:, None]
    hi = (W[:, 1:] << (32 - r8[:, None])) & M32     # 0 where r8 == 0
    vals = lo | hi                                  # (cap, words) uint32
    nb_last = m - 4 * (words - 1)
    if nb_last < 4:
        vals[:, -1] &= (1 << (8 * nb_last)) - 1
    shifts = torch.arange(4, device=dev) * 8
    bytes2d = ((vals[:, :, None] >> shifts) & 0xFF).reshape(
        vals.shape[0], -1)[:, :m]
    key = _fp_from_bytes(bytes2d, FP_MULTS[0])
    if eb:
        key = key | ((_fp_from_bytes(bytes2d, FP_MULTS[1])
                      & ((1 << eb) - 1)) << 16)
    packed64 = packed.to(torch.int64) & M32

    def full_eq(pid):
        return (packed64[pid.clamp(min=0)] == vals).all(1)

    if slot_ok:
        fp2 = _fp_from_bytes(bytes2d, FP_MULTS[2])
        slot = torch.zeros_like(key)
        found = torch.zeros_like(live)
        for l in range(lmax):
            hit = bucket_fp2[key * lmax + l] == fp2      # unique per bucket
            slot = torch.where(hit, l, slot)
            found |= hit
        pid = bucket_ids[key * lmax + slot].to(torch.int64)
        matched = live & found & (pid >= 0) & full_eq(pid)
        if return_pid:
            return matched, torch.where(matched, pid, -1)
        return matched
    matched = torch.zeros_like(live)
    sel_pid = torch.full_like(key, -1)
    for l in range(lmax):
        pid = bucket_ids[key * lmax + l].to(torch.int64)
        hit = live & (pid >= 0) & ~matched & full_eq(pid)
        matched |= hit
        if return_pid:
            sel_pid = torch.where(hit, pid, sel_pid)
    if return_pid:
        return matched, sel_pid
    return matched


def _verify_pieces(tw, idxs, ft: FastTables, *, n_starts: int,
                   return_pid: bool):
    """_verify_matched over idxs in pieces bounding the temporaries."""
    piece = max(1, VERIFY_PIECE_ELEMS // (4 * ft.words + 8))
    for s in range(0, int(idxs.shape[0]), piece):
        yield _verify_matched(
            tw, idxs[s:s + piece], ft.bucket_ids, ft.packed, ft.bucket_fp2,
            m=ft.m, words=ft.words, lmax=ft.lmax, eb=ft.eb,
            n_starts=n_starts, slot_ok=ft.slot_ok, return_pid=return_pid)


def verify_count(tw, idxs, ft: FastTables, *, n_starts: int) -> torch.Tensor:
    """Exact matches among candidate starts idxs (-1 padded) over the word
    view tw, 0-d int64.

    Verifies the whole cap (the -1 slots are masked), in pieces bounding
    the temporaries, and never waits for the device: the JAX package
    gates chunks on the true candidate count with lax.cond, which torch
    cannot do without a host sync.  The slot and mask routes, the sync
    ladder and the plain scan run it on every device; the cascade route
    runs it only as the plain version of cuda_filter.verify_count_live,
    whose kernel reads the count on the device and needs no word view."""
    total = torch.zeros((), dtype=torch.int64, device=idxs.device)
    for matched in _verify_pieces(tw, idxs, ft, n_starts=n_starts,
                                  return_pid=False):
        total += matched.sum()
    return total


def verify_attr(tw, idxs, ft: FastTables, *, n_starts: int):
    """(matched (cap,) bool, internal pattern id (cap,) int64, -1 where
    unmatched) at candidate starts idxs (-1 padded), no host sync: the JAX
    package's verify_attr_at."""
    out = list(_verify_pieces(tw, idxs, ft, n_starts=n_starts,
                              return_pid=True))
    return (torch.cat([mt for mt, _ in out]), torch.cat([p for _, p in out]))
