"""Compaction of candidate positions with torch ops, no host sync: the
helpers of ops/fast.py's compactions, and compact_valrows, the plain
version of the cascade's compaction kernel (cuda_filter.compact_rows).
Port of the compaction helpers of tpu_smatcher/ops/fast.py."""

from __future__ import annotations

import torch


def nonzero_scatter(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Indices of set elements, densely packed, then `fill`: (size,) int64.

    cumsum + scatter, so no host sync (torch.nonzero waits for the device).
    torch has no drop mode: unset elements, and set ones beyond `size`,
    scatter into a trash tail [size, size + n) at distinct indices (one
    shared trash index would serialise millions of writes), sliced off."""
    n = mask.shape[0]
    iota = torch.arange(n, device=mask.device)
    rank = torch.cumsum(mask, 0) - 1
    dst = torch.where(mask & (rank < size), rank, size + iota)
    out = torch.full((size + n,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, dst, iota)
    return out[:size]


def _take(vals: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """vals[sel] where sel < len(vals), else -1 (torch gathers do not
    clamp; sel comes from nonzero_scatter with fill len(vals))."""
    return torch.cat([vals, vals.new_full((1,), -1)])[sel]


def _pack(vals2d: torch.Tensor, cap: int) -> torch.Tensor:
    """The positions of a position-valued matrix (-1 = empty) in row-major
    order, densely packed into (cap,) int64, then -1."""
    flat = vals2d.reshape(-1).to(torch.int64)
    return _take(flat, nonzero_scatter(flat >= 0, cap, flat.shape[0]))


def compact_valrows(vals2d: torch.Tensor, *, cap: int):
    """Compaction of a position-valued matrix (-1 = empty), e.g. the
    cascade's (R, 16) slots.  Returns (idxs (cap,) int64 positions densely
    packed in row-major order then -1, overflow (n_cand > cap) 0-d bool,
    n_cand 0-d int64 — the true candidate total).

    The JAX version also flags a packed row holding more than its row
    budget, an artefact of the TPU's 8:1 lane repack; here the per-row
    budget is the cascade's own ovf flag."""
    n_cand = (vals2d >= 0).sum()
    return _pack(vals2d, cap), n_cand > cap, n_cand
