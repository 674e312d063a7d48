"""Distributed scans on torch.distributed: halo exchange, per-shard core,
all-reduced count (port of tpu_smatcher/parallel/dist.py).

The reference's distribution is four MPI collectives (SURVEY.md §2.2):
Scatterv of the text with an (m-1)-byte halo per rank (main.c:467-489),
Bcast of the patterns (main.c:492), and two Reduces (count and timings,
main.c:654-661).  Here, one process per rank:

  - each rank holds its shard of the text (mesh.shard_text, or
    multihost.load_corpus_shards from a file);
  - each rank takes its right neighbour's first m-1 bytes through one
    all-reduce of a (k, m-1) buffer in which every rank fills its own row
    (_halo); the last rank's halo is the out-of-alphabet pad;
  - tables are built on every rank (the reference's per-rank preproc);
  - every rank scans its shard + halo with any engine's core, and the
    (count, overflow) pair is one all-reduce.  Every scan (the count,
    the ladder, the positions) reads the shard and the seam (its last m-1
    bytes + the halo) apart: core calls over the shard in place and one
    over 2(m-1) bytes, where appending the halo would copy the whole
    shard (eager torch fuses nothing).

Every collective is an all-reduce, so one code path serves NCCL between
cards and gloo on the CPU or on one shared card (gloo takes CUDA tensors
for all_reduce and broadcast only).  An NCCL all-reduce is enqueued on the
current stream and count_async stays free of host syncs; a gloo all-reduce
of CUDA tensors waits on the host.

Exactness: rank i owns window starts [i*per, (i+1)*per); a window starting
in shard i ends within shard i + its halo, and every start belongs to
exactly one shard, the partition argument of the reference's rank
decomposition.

Byte alphabet (sigma = 256): no out-of-alphabet byte exists, so the pad of
the last shards is 0, which could match.  Every rank is its own process
with shapes of its own, so each scans only its valid starts, those below
n - m + 1: its shard + halo is cut to them before the core runs.  The JAX
package's shards share one static shape and it subtracts the overcount of
the invalid starts instead; the counts are the same.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tpu_smatcher_torch.ops.common import (check_count32, cut_pieces,
                                           finish_pair, split_pieces)
from tpu_smatcher_torch.parallel.mesh import Mesh, shard_text
from tpu_smatcher_torch.utils.profiling import span


#: the cap of the seam scans (DistributedCounter._seam_fn)
SEAM_CAP = 1024


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    """t summed over every rank, in place (the one collective used)."""
    dist.all_reduce(t)
    return t


def _add_pair(co: torch.Tensor, res) -> None:
    """Adds a core's count, or (count, overflow), into the (2,) int64
    pair co, in place."""
    c, o = res if isinstance(res, tuple) else (res, None)
    co[0].add_(c)
    if o is not None:
        co[1].add_(o)


class _DistFuture:
    """In-flight distributed scan: the all-reduced (count, overflow) pair
    stays on the device until result().  On overflow, result() runs the
    exact distributed retry ladder when one is attached (counts are TOTAL,
    as on one device: the reference's MPI_Reduce sums unconditionally,
    main.c:656); without one it raises.  Every rank reads the same pair, so
    every rank takes the same branch.  `request`: the traced request of
    the scan, which result()'s spans join."""

    __slots__ = ("_co", "_retry", "_request")

    def __init__(self, co_dev, retry=None, request=None):
        self._co = co_dev
        self._retry = retry
        self._request = request

    def result_with_overflow(self) -> tuple[int, bool]:
        """The RAW (count, overflow) of the single scan, no retry; an
        overflowed count is a truncation lower bound."""
        c, o = self._co.tolist()
        return int(c), bool(o)

    def result(self) -> int:
        with span("tsm.readback", request=self._request):
            c, o = self._co.tolist()
        if o:
            if self._retry is None:
                raise OverflowError(
                    "candidate cap exceeded on some shard; raise "
                    "cap=/row_slots=")
            with span("tsm.ladder", request=self._request):
                return self._retry()
        return int(c)


def _halo(local: torch.Tensor, mesh: Mesh, *, halo: int,
          sigma: int) -> torch.Tensor:
    """The right neighbour's first `halo` bytes: one all-reduce of a
    (k, halo) uint8 buffer in which each rank fills its own row (the sum
    of one nonzero row cannot wrap); rank i takes row (i+1) mod k.  The
    last rank's becomes the out-of-alphabet pad sigma; for sigma = 256 it
    keeps the cyclic row (shard 0's head), which its valid starts never
    read."""
    k, r = mesh.size, mesh.rank
    buf = torch.zeros((k, halo), dtype=torch.uint8, device=local.device)
    buf[r] = local[:halo]
    recv = _all_reduce(buf)[(r + 1) % k]
    if sigma < 256 and r == k - 1:
        recv.fill_(sigma)
    return recv


def exchange_halo(local: torch.Tensor, mesh: Mesh, *, halo: int,
                  sigma: int) -> torch.Tensor:
    """This shard with its right neighbour's first `halo` bytes appended
    (_halo's all-reduce), as one tensor: the JAX package's exchange_halo.
    The scans never build it (_Sharded reads the shard in place)."""
    if halo <= 0:
        return local
    return torch.cat([local, _halo(local, mesh, halo=halo, sigma=sigma)])


class _Sharded:
    """A scan's input on this rank: the shard, its halo, the shard length,
    the shard's global offset and `stop`, the length of shard + halo that
    holds the windows to count (cut to the valid starts for sigma =
    256).

    Shard + halo is never one tensor: a piece of starts that ends before
    the seam (the last m-1 starts, whose windows reach the halo) is a view
    of the shard, and a piece of the seam joins its shard bytes and the
    halo, a copy of at most 2(m-1) bytes.  spans() splits the starts
    there, and the ladder and the positions split pieces only within a
    span."""

    __slots__ = ("shard", "recv", "per", "base", "stop")

    def __init__(self, shard, recv, per, base, stop):
        self.shard, self.recv = shard, recv
        self.per, self.base, self.stop = per, base, stop

    @property
    def halo(self) -> int:
        return int(self.recv.shape[0])

    def spans(self) -> list:
        """The starts [0, per) as (offset, starts) pieces: the shard's own
        windows, then the seam."""
        cut = self.per - self.halo
        return [(o, c) for o, c in ((0, cut), (cut, self.halo)) if c > 0]

    def piece(self, off: int, owned: int) -> torch.Tensor:
        """The bytes of starts [off, off + owned), cut at `stop`."""
        hi = min(off + owned + self.halo, self.stop)
        if hi <= self.per:
            return self.shard[off:hi]
        return torch.cat([self.shard[off:], self.recv[:hi - self.per]])

    def count(self, fn, off: int, owned: int, co=None) -> torch.Tensor:
        """fn's (count, overflow) over starts [off, off + owned) added
        into co (by default a new (2,) int64 pair at zero); returns co."""
        if co is None:
            co = torch.zeros(2, dtype=torch.int64, device=self.shard.device)
        piece = self.piece(off, owned)
        if int(piece.shape[0]) > self.halo:            # holds a start
            _add_pair(co, fn(piece))
        return co

    def scan(self, core_fn, seam_fn=None) -> torch.Tensor:
        """(count, overflow) over every start, as a (2,) int64 tensor:
        core_fn over the shard's own windows, seam_fn (core_fn unless
        given) over the seam's."""
        co = None
        for off, owned in self.spans():
            own = off < self.per - self.halo
            with span("tsm.dist.scan" if own else "tsm.dist.seam"):
                co = self.count(core_fn if own else (seam_fn or core_fn),
                                off, owned, co)
        return co


def _shard_ext(text, mesh: Mesh, *, m: int, sigma: int, n):
    """The _Sharded input of a scan.  A numpy array is the whole text,
    which every rank holds (mesh.shard_text cuts this rank's shard); a
    tensor is this rank's shard already (shard_text, load_corpus_shards).
    `n`, the corpus length, defaults to the whole text's; it matters for
    sigma = 256 only, where the 0-pad is in the alphabet."""
    from tpu_smatcher_torch.ops.fast import device_text
    k = mesh.size
    if isinstance(text, np.ndarray):
        shard, n_text = shard_text(text, mesh, sigma=sigma)
        # an explicit n= wins: the array may itself carry host-side
        # padding (a pre-padded byte-alphabet corpus)
        n = n_text if n is None else int(n)
    else:
        shard = device_text(text, mesh.device)
    per = int(shard.shape[0])
    n = per * k if n is None else int(n)
    check_count32(per * k)
    if per < m - 1:
        raise ValueError(
            f"shard size {per} < m-1 = {m - 1}: the one-hop halo exchange "
            "cannot cover a window; use fewer devices or a longer text")
    with span("tsm.dist.halo"):
        recv = _halo(shard, mesh, halo=m - 1, sigma=sigma) if m > 1 else \
            shard[:0]
    base = mesh.rank * per
    stop = per + m - 1
    if sigma >= 256:
        stop = min(max(n - m + 1 - base, 0), per) + m - 1
    return _Sharded(shard, recv, per, base, stop)


class DistributedCounter:
    """A single-device count core made distributed over the ranks.

    core_fn(ext) -> 0-d count over starts [0, len - m + 1) of its argument,
    or (count, overflow): the overflow flag (candidate-cap truncation of
    the sparse-verify paths) rides the all-reduce; on overflow count()
    runs the exact retry ladder (fast=), so distributed counts are TOTAL.
    Every rank must make the same calls in the same order (SPMD)."""

    def __init__(self, core_fn, mesh: Mesh, *, m: int, sigma: int,
                 fast=None):
        """fast: optional FastScanner over the same pattern set: the exact
        distributed OVERFLOW LADDER (a dense per-shard pass, then
        budget-sized pieces; every engine counts the same windows, so the
        fast tables are a valid fallback for any core).  Without it a shard
        overflow raises (the portable cores never overflow)."""
        self.mesh = mesh
        self._core_fn = core_fn
        self.m = m
        self.sigma = sigma
        self.fast = fast
        #: the seam's 2(m-1) bytes go through a FastScanner over the
        #: ladder's tables with a small cap: the fingerprint tier's
        #: epilogue costs in proportion to the cap, not the text
        self._seam_fn = None
        if fast is not None:
            from tpu_smatcher_torch.ops.fast import FastScanner
            self._seam_fn = FastScanner(fast.ft,
                                        cap=max(SEAM_CAP, m - 1)).core

    def count(self, text, *, n: int | None = None) -> int:
        """text: the whole text as a numpy array (every rank holds it), or
        this rank's shard as a tensor on its device.  `n`: the corpus
        length of padded shards (load_corpus_shards), consulted for sigma
        = 256 only; sigma <= 255 shards are sigma-padded, which
        self-masks."""
        with span("tsm.count"):
            return self.count_async(text, n=n).result()

    def count_async(self, text, *, n: int | None = None) -> _DistFuture:
        """Scan this rank's shard and enqueue the all-reduce; the summed
        (count, overflow) pair stays on the device until result()."""
        with span("tsm.enqueue") as sp:
            sh = _shard_ext(text, self.mesh, m=self.m, sigma=self.sigma,
                            n=n)
            co = sh.scan(self._core_fn, self._seam_fn)
            with span("tsm.dist.all_reduce"):
                _all_reduce(co)
            retry = (None if self.fast is None
                     else lambda: self._retry_total(sh))
            return _DistFuture(co, retry, request=sp.request)

    def scan_many(self, texts) -> list[int]:
        """Pipelined batch counts: every scan is enqueued before any
        result is read."""
        return [f.result() for f in [self.count_async(t) for t in texts]]

    def count_with_overflow(self, text, *, n: int | None = None
                            ) -> tuple[int, bool]:
        """The RAW single-scan (count, overflow flag), no retry ladder."""
        return self.count_async(text, n=n).result_with_overflow()

    def _retry_total(self, sh: _Sharded) -> int:
        """Exact distributed count after a shard overflow, the distributed
        lift of FastScanner's retry ladder.  Step 1: the DENSE per-shard
        pass (FastScanner._dense_core) over the same shard + halo.  Step 2
        (pathological density): the shards in budget-sized pieces, SPMD,
        splitting any piece that overflows on some rank; pieces of <= cap/4
        starts cannot (FastScanner._count_chunked's argument)."""
        c, o = _all_reduce(sh.scan(self.fast._dense_core())).tolist()
        if not o:
            return int(c)
        return self._count_pieces(sh)

    def _count_pieces(self, sh: _Sharded) -> int:
        """Ladder step 2: every rank scans its shard in (owned + halo)
        pieces at the same offsets (common.split_pieces); each piece's
        (count, overflow) is all-reduced, so every rank splits the same
        pieces."""
        dense = self.fast._dense_core()

        def launch(off, owned):
            return _all_reduce(sh.count(dense, off, owned))

        return sum(c for _, _, c in split_pieces(
            sh.spans(), launch, finish_pair,
            min_chunk=max(self.fast.cap // 4, 1)))


class DistributedPositions:
    """Distributed match positions over the fast path, UNBOUNDED like
    FastScanner.positions.

    Each rank scans its shard in pieces, every rank at the same piece
    offsets (SPMD): exact_mask (exact tier) or filter_mask + words_view +
    verify (fingerprint tier) on each piece (FastScanner._positions_piece),
    local starts made global (rank i owns starts [i*per, (i+1)*per)).  One
    all-reduce per piece sums a (k, cap + 1) buffer in which each rank
    fills its row with its positions + 1 and its overflow flag: every rank
    learns every position, and every rank splits a piece that overflowed on
    some rank (pieces of <= cap/2 starts cannot).  Every rank returns the
    same sorted int64 array."""

    def __init__(self, fast, mesh: Mesh):
        self.fast = fast
        self.mesh = mesh
        self.m = fast.m
        self.sigma = fast.sigma
        self.k = mesh.size

    def _piece(self, sh: _Sharded, off: int, owned: int) -> torch.Tensor:
        """The all-reduced (k, cap + 1) int64 buffer of the piece of
        starts [off, off + owned)."""
        fast, cap = self.fast, self.fast.cap
        buf = torch.zeros((self.k, cap + 1), dtype=torch.int64,
                          device=sh.shard.device)
        piece = sh.piece(off, owned)
        if int(piece.shape[0]) >= self.m:
            idxs, o = fast._positions_piece(piece)
            buf[self.mesh.rank, :cap] = torch.where(
                idxs >= 0, idxs + (sh.base + off + 1), 0)
            buf[self.mesh.rank, cap] = o.to(torch.int64)
        return _all_reduce(buf)

    def positions(self, text, *, chunk: int | None = None,
                  depth: int = 4, n: int | None = None) -> np.ndarray:
        """text as DistributedCounter.count takes it; chunk= presizes the
        pieces (in starts of each shard) where the density is known."""
        sh = _shard_ext(text, self.mesh, m=self.m, sigma=self.sigma, n=n)
        cap = self.fast.cap
        min_chunk = max(cap // 2, 1)
        work = sh.spans()
        if chunk is not None:
            chunk = max(int(chunk), min_chunk)
            work = [p for lo, c in work for p in cut_pieces(lo, c, chunk)]

        def launch(off, owned):
            return self._piece(sh, off, owned)

        def finish(buf):
            b = buf.cpu().numpy()
            return bool(b[:, cap].any()), b[:, :cap]

        out = [pos[pos > 0] - 1 for _, _, pos in split_pieces(
            work, launch, finish, min_chunk=min_chunk, depth=depth)]
        if not out:
            return np.empty((0,), np.int64)
        return np.sort(np.concatenate(out))
