"""Multi-process corpus loading: per-rank file ranges, no full-text gather
(port of tpu_smatcher/parallel/multihost.py).

The reference loads the ENTIRE corpus on rank 0 and MPI_Scatterv's shards to
every rank (main.c:386,451-489), an O(n) memory and network hotspot on the
root.  Here every rank reads only the byte range it owns (an np.memmap
window into the corpus file) and places it on its own device.  The (m-1)-
byte halo is NOT read from disk: DistributedCounter exchanges it through an
all-reduce (parallel/dist.py), so disk reads stay disjoint.

Typical entry, one process per rank (torchrun, or the CLI's --devices):

    init_distributed()                    # torch.distributed, env://
    mesh = make_mesh()                    # this rank on its card
    shard, n = load_corpus_shards("corpus.bin", mesh, sigma=4)
    dc = make_distributed("fast", pats, mesh)
    total = dc.count(shard, n=n)          # all-reduced over the ranks
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from tpu_smatcher_torch.parallel.mesh import (DEFAULT_TIMEOUT, Mesh,
                                              pick_backend)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *, device="cuda",
                     store=None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """torch.distributed.init_process_group for this rank; does nothing
    when a group exists.  The reference's MPI_Init (main.c:327).

    With no address and no store, reads torchrun's environment (env://:
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).  coordinator_address is
    "host:port" (or a URL such as tcp://localhost:29500 or file:///path);
    store (a torch.distributed Store, e.g. FileStore) takes its place.  The
    backend is pick_backend's for `device` and this host's ranks
    (LOCAL_WORLD_SIZE, else the world size); every collective times out
    after `timeout`."""
    if dist.is_initialized():
        return
    world = num_processes
    if world is None and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
    world = 1 if world is None else int(world)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = pick_backend(device, local)
    kw = {"timeout": timeout}
    if process_id is not None:
        kw["rank"] = int(process_id)
    if num_processes is not None:
        kw["world_size"] = world
    if store is not None:
        kw["store"] = store
    elif coordinator_address is not None:
        addr = coordinator_address
        kw["init_method"] = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(backend, **kw)


def load_corpus_shards(path: str, mesh: Mesh, *, sigma: int,
                       n: int | None = None):
    """This rank's shard of the corpus file at `path`, read from its own
    byte range only, on the rank's device.

    The file holds pre-encoded codes (bytes < sigma).  Shards are
    right-padded with the out-of-alphabet symbol sigma (pad windows never
    match); for the byte alphabet (sigma = 256) the pad is 0, and the
    returned corpus length must go to DistributedCounter.count(n=...) so
    that only the valid starts count.  Returns (shard, corpus length)."""
    file_n = os.path.getsize(path)
    if n is None:
        n = file_n
    if n > file_n:
        raise ValueError(f"requested n={n} > file size {file_n}")
    per = -(-max(n, 1) // mesh.size)
    start = mesh.rank * per
    stop = min(n, start + per)
    block = np.full(per, sigma if sigma < 256 else 0, dtype=np.uint8)
    if stop > start:
        mm = np.memmap(path, dtype=np.uint8, mode="r")
        block[:stop - start] = mm[start:stop]
        del mm
    return torch.from_numpy(block).to(mesh.device), n


def host_shard_ranges(n: int, mesh: Mesh) -> dict:
    """{rank: [(start, stop)]}: the byte range each rank reads, for
    provisioning and debugging (one range per rank: a rank is a
    process)."""
    k = mesh.size
    per = -(-max(n, 1) // k)
    return {r: [(min(n, r * per), min(n, (r + 1) * per))] for r in range(k)}
