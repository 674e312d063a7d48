"""Small shared helpers and the file streams (port of
tpu_smatcher/ops/common.py:125-202)."""

from __future__ import annotations

import os

import numpy as np


def check_count32(n: int) -> None:
    """Counts are int32 end-to-end (kernel accumulators, the count tensor);
    a single scan over >= 2^31 window starts could wrap.  Callers split
    such corpora into pieces."""
    if n >= (1 << 31):
        raise ValueError(
            f"text length {n} >= 2^31: counts are int32 — scan in pieces")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bits_per_char(sigma: int) -> int:
    """Bits of one character code in a packed window id."""
    return max(1, (sigma - 1).bit_length())


def _halo_pieces(path: str, m: int, chunk: int):
    """(start, piece) over a pre-encoded corpus file, memory-mapped: piece
    i covers [i*chunk, (i+1)*chunk + m - 1), so every window start belongs
    to exactly one piece (the (m-1)-halo partition)."""
    size = os.path.getsize(path)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    for start in range(0, max(size - m + 1, 1), chunk):
        yield start, np.asarray(mm[start:min(size, start + chunk + m - 1)])


def stream_count_file(count_async, m: int, path: str, *,
                      chunk: int = 1 << 28, depth: int = 3) -> int:
    """Count of a pre-encoded corpus file through `count_async`, without
    loading it whole: its (m-1)-halo pieces, up to `depth` in flight so
    disk reads, host-to-device copies and scans overlap."""
    total = 0
    inflight = []
    for _, piece in _halo_pieces(path, m, chunk):
        inflight.append(count_async(piece))
        if len(inflight) >= depth:
            total += inflight.pop(0).result()
    for f in inflight:
        total += f.result()
    return total


def stream_positions_file(positions_fn, m: int, path: str, *,
                          chunk: int = 1 << 28) -> np.ndarray:
    """Sorted int64 match starts of a pre-encoded corpus file, without
    loading it whole: its (m-1)-halo pieces, each enumerated by
    `positions_fn` (itself pipelined and unbounded); offsets accumulate in
    int64, so files >= 2^31 bytes stream too."""
    out = []
    for start, piece in _halo_pieces(path, m, chunk):
        pos = positions_fn(piece)
        if pos.size:
            out.append(pos.astype(np.int64) + start)
    if not out:
        return np.empty((0,), np.int64)
    return np.concatenate(out)
