"""Small shared helpers, the file streams, and the named engines' shared
glue and portable-scan helpers (port of tpu_smatcher/ops/common.py).

Padding convention of the portable scans: they right-pad text with the
out-of-alphabet symbol min(sigma, 255) and mask windows past the text by
position, so sigma = 256 (no pad symbol) is exact too.  Their tables are
extended so the pad is safe (resets AC to the root, kills SH/SBOM walks,
hashes WM to non-candidates); filter-engine candidates on pad windows are
killed by exact verification.
"""

from __future__ import annotations

import collections
import functools
import os

import numpy as np
import torch


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


def cut_pieces(start: int, owned: int, size: int) -> list:
    """Starts [start, start + owned) as (start, owned) pieces of `size`
    starts, the last one shorter."""
    return [(s, min(size, start + owned - s))
            for s in range(start, start + owned, size)]


def split_pieces(work, launch, finish, *, min_chunk: int, depth: int = 4):
    """The split-on-overflow piece pipeline of the exact ladders and the
    positions.  `work`: (start, owned) pieces of window starts, taken in
    text order, `depth` in flight.  launch(start, owned) enqueues one
    piece's scan with no host sync and returns its handle; finish(handle)
    reads it back as (overflowed, value).  A piece that overflowed is
    split in two at max(min_chunk, ceil(owned / 2)) starts, scanned
    before the pieces still waiting; the caller's scan cannot overflow on
    <= min_chunk starts, so such a piece raises AssertionError.  Yields
    (start, owned, value) of every piece that did not overflow.  Its
    choices depend on the flags alone: where they are all-reduced, every
    rank splits the same pieces."""
    work = collections.deque(work)
    inflight = collections.deque()
    while work or inflight:
        while work and len(inflight) < depth:
            start, owned = work.popleft()
            inflight.append((start, owned, launch(start, owned)))
        start, owned, handle = inflight.popleft()
        overflowed, value = finish(handle)
        if not overflowed:
            yield start, owned, value
            continue
        if owned <= min_chunk:
            raise AssertionError(
                f"a piece of {owned} starts overflowed below the "
                f"guaranteed size of {min_chunk} — this is a bug")
        half = max(min_chunk, -(-owned // 2))
        work.extendleft(reversed(cut_pieces(start, owned, half)))


def finish_pair(co: torch.Tensor) -> tuple[bool, int]:
    """split_pieces' finish of a (count, overflow) device pair."""
    c, o = co.tolist()
    return bool(o), int(c)


# ---------------------------------------------------------------------------
# the named engines: fast-path dispatch and the shared scanner surface
# ---------------------------------------------------------------------------

def active_fastpath(scanner):
    """The engine's attached fast path (engines.attach_fastpath), or None.
    It runs on the scanner's device, kernels on the card and their plain
    versions on the CPU; patterns longer than the kernels take
    (cuda_filter.MAX_KERNEL_M) fall back to the portable scan."""
    from tpu_smatcher_torch.ops.cuda_filter import MAX_KERNEL_M
    fp = scanner.fast_path
    if fp is not None and fp.m <= MAX_KERNEL_M:
        return fp
    return None


def fastpath_positions(scanner, text) -> np.ndarray:
    """Match start positions through the engine's fast path."""
    fp = active_fastpath(scanner)
    if fp is None:
        raise NotImplementedError(
            "positions() requires the engine's fast path (make_engine with "
            "fastpath=True and m <= MAX_KERNEL_M)")
    return fp.positions(text)


def attr_scanner(scanner, what: str):
    """The FastScanner that attributes the engine's matches on its device:
    the fast path's fallback (the same tables, any m), else one over
    build_fast of the engine's pattern codes (make_engine keeps them),
    built at first use.  Patterns longer than the kernels take run its
    plain pieces (fast._positions_piece_plain), where the JAX package
    enumerates on the host."""
    fp = scanner.fast_path
    if fp is not None:
        return fp._fallback_scanner()
    fs = getattr(scanner, "_attr_fast", None)
    if fs is None:
        from tpu_smatcher_torch.ops.fast import FastScanner, build_fast
        codes = getattr(scanner, "pattern_codes", None)
        if codes is None:
            raise ValueError(
                f"{what}() needs the engine's pattern codes: build it with "
                "make_engine, or set scanner.pattern_codes and "
                "scanner.pattern_sigma")
        fs = scanner._attr_fast = FastScanner(build_fast(
            codes, scanner.pattern_sigma, device=scanner.device))
    return fs


def scanner_matches(scanner, text):
    """(positions, pattern_ids): every match start and the ORIGINAL id of
    its pattern (smallest id on duplicates), attributed on the device by
    attr_scanner (same match set as the engine's count)."""
    return attr_scanner(scanner, "matches").matches(text)


def scanner_count_per_pattern(scanner, text) -> np.ndarray:
    """(p,) int64 match-start counts per original pattern id, summed on the
    device by attr_scanner; they sum to count(text)."""
    return attr_scanner(scanner, "count_per_pattern").count_per_pattern(
        text)


def fastpath_count_async(scanner, text):
    """count_async through the engine's fast path (its overflow retry is
    the scanner's own count); without one, a resolved future around the
    synchronous count."""
    from tpu_smatcher_torch.ops.fast import ScanFuture
    fp = active_fastpath(scanner)
    if fp is not None:
        return fp.count_async(text,
                              retry=functools.partial(scanner.count, text))
    zero = torch.zeros((), dtype=torch.int32)
    return ScanFuture(zero + scanner.count(text), zero)


def fastpath_scan_many(scanner, texts) -> list[int]:
    """Counts of a batch of texts, every scan enqueued before any is read."""
    return [f.result()
            for f in [fastpath_count_async(scanner, t) for t in texts]]


def fastpath_count_file(scanner, path: str, *, chunk: int = 1 << 28,
                        depth: int = 3) -> int:
    """stream_count_file through the engine's count_async."""
    return stream_count_file(
        functools.partial(fastpath_count_async, scanner), scanner.m, path,
        chunk=chunk, depth=depth)


def fastpath_positions_file(scanner, path: str, *,
                            chunk: int = 1 << 28) -> np.ndarray:
    """stream_positions_file through the engine's fast path."""
    return stream_positions_file(
        functools.partial(fastpath_positions, scanner), scanner.m, path,
        chunk=chunk)


class EngineScanner:
    """The surface every named engine shares (JAX: _FilterScanner and
    ACScanner): count through the attached fast path, else the capless
    portable scan (_count_core); the rest through the fast path.
    Subclasses set m, device and _count_core(text) -> 0-d int32."""

    fast_path = None

    def _as_text(self, text) -> torch.Tensor:
        from tpu_smatcher_torch.ops.fast import device_text
        return device_text(text, self.device)

    def count(self, text) -> int:
        """Through the fast path, which is total (an overflow retries
        exactly, never raises), else the capless portable scan."""
        fp = active_fastpath(self)
        if fp is not None:
            return fp.count(text)
        return int(self._count_core(self._as_text(text)))

    def positions(self, text) -> np.ndarray:
        return fastpath_positions(self, text)

    def core(self, ext) -> torch.Tensor:
        """Per-shard 0-d int32 count of ext's windows by the portable scan,
        no host sync: what distribution sums over shards when no fast path
        runs.  The shards' pad byte sigma indexes the tables' pad column
        (pad_col), which never matches."""
        return self._count_core(self._as_text(ext))

    def count_async(self, text):
        return fastpath_count_async(self, text)

    def scan_many(self, texts) -> list[int]:
        return fastpath_scan_many(self, texts)

    def count_file(self, path: str, *, chunk: int = 1 << 28,
                   depth: int = 3) -> int:
        return fastpath_count_file(self, path, chunk=chunk, depth=depth)

    def positions_file(self, path: str, *,
                       chunk: int = 1 << 28) -> np.ndarray:
        return fastpath_positions_file(self, path, chunk=chunk)

    def matches(self, text):
        return scanner_matches(self, text)

    def count_per_pattern(self, text) -> np.ndarray:
        return scanner_count_per_pattern(self, text)


# ---------------------------------------------------------------------------
# the portable scans' helpers
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF


def pad_col(table: np.ndarray, value: int) -> np.ndarray:
    """Append one column (the pad symbol's) with a constant value."""
    S = table.shape[0]
    return np.concatenate([table, np.full((S, 1), value, table.dtype)], axis=1)


def gather_clamped(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] with idx clamped into the table, as a JAX gather clamps
    (only out-of-alphabet text indexes past a table)."""
    return table[idx.clamp(0, table.shape[0] - 1)]


def word_streams(chunk: torch.Tensor, m: int, n_starts: int) -> torch.Tensor:
    """(n_starts, W) int64: the little-endian packed words of each window
    of chunk, as uint32 values (word w packs bytes 4w .. 4w+nb, nb =
    min(4, m - 4w), zero padded, bit-identical to lookup.pack_rows)."""
    t = chunk.to(torch.int64)
    streams = []
    for w in range(cdiv(m, 4)):
        acc = torch.zeros(n_starts, dtype=torch.int64, device=chunk.device)
        for k in range(min(4, m - 4 * w)):
            off = 4 * w + k
            acc |= t[off:off + n_starts] << (8 * k)
        streams.append(acc)
    return torch.stack(streams, dim=1)


def verify_starts(chunk: torch.Tensor, cand: torch.Tensor, *,
                  packed: torch.Tensor, bucket_ids: torch.Tensor, lmax: int,
                  sigma: int, m: int) -> torch.Tensor:
    """(n_starts,) bool: candidate starts (cand, over starts [0, n_starts)
    of chunk) whose window equals at least one pattern.  The window's last
    3-gram keys a bucket of verify.VerifyTables (bucket_ids flat, lmax per
    bucket); each bucket slot is compared word for word."""
    n_starts = cand.shape[0]
    win = word_streams(chunk, m, n_starts)
    t = chunk.to(torch.int64)
    key = (t[m - 3:m - 3 + n_starts] + t[m - 2:m - 2 + n_starts] * sigma
           + t[m - 1:m - 1 + n_starts] * (sigma * sigma))
    key = key.clamp(max=bucket_ids.shape[0] // lmax - 1)
    packed64 = packed.to(torch.int64) & M32
    matched = torch.zeros_like(cand)
    for slot in range(lmax):
        pid = bucket_ids[key * lmax + slot].to(torch.int64)
        live = cand & (pid >= 0) & ~matched
        eq = (packed64[pid.clamp(min=0)] == win).all(1)
        matched |= live & eq
    return matched


def tiled_count(per_tile, text: torch.Tensor, *, tile: int, m: int,
                sigma: int) -> torch.Tensor:
    """Sum of per_tile(chunk, valid) over tiles of `tile` owned starts, as
    a 0-d int32 tensor on text's device (no host sync).  chunk is (tile +
    m - 1,) uint8 of the text right-padded with min(sigma, 255); valid is
    (tile,) bool, False at starts past the text's last window (positional
    masking, so sigma = 256, whose pad 255 is a real byte, is exact)."""
    n = int(text.shape[0])
    dev = text.device
    n_valid = max(n - m + 1, 0)
    num_tiles = max(1, cdiv(n_valid, tile))
    padded = torch.full((num_tiles * tile + m - 1,), min(sigma, 255),
                        dtype=torch.uint8, device=dev)
    padded[:n] = text
    iota = torch.arange(tile, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(num_tiles):
        chunk = padded[i * tile:(i + 1) * tile + m - 1]
        total += per_tile(chunk, iota < n_valid - i * tile)
    return total.to(torch.int32)
