"""The rank layout and text sharding (port of tpu_smatcher/parallel/mesh.py).

Replaces the reference's MPI machinery (MPI_Init/Comm_size, main.c:327-333;
Scatterv with per-rank (m-1)-halo displacements, main.c:463-489) with one
process per rank on torch.distributed, torchrun's layout and the
reference's.  The port's "mesh" is the default process group plus this
rank's device: the text is cut into world-size shards, each rank holds its
own, tables are built on every rank, halos and counts ride all-reduces
(parallel/dist.py).

Backends: NCCL when every rank has a card of its own, gloo otherwise (CPU
ranks, or several ranks sharing one card).
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

#: the process group's timeout: a rank that dies or hangs makes the others
#: raise after this long instead of waiting forever
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the 1-D layout: its rank, the world size and its
    device, on the default process group."""

    rank: int
    size: int
    device: torch.device
    backend: str


def pick_backend(device, local_ranks: int) -> str:
    """NCCL when every one of the `local_ranks` ranks of this host has a
    card of its own, gloo otherwise (CPU ranks; ranks sharing a card,
    which NCCL refuses)."""
    dev = torch.device(device)
    if dev.type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device, rank: int) -> torch.device:
    """The device of `rank`: a CUDA device without an index becomes
    cuda:(rank mod device_count); the CPU stays the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but CUDA is not available; "
                               "pass device='cpu' for the plain torch path")
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def make_mesh(n_devices: int | None = None, *, device="cuda") -> Mesh:
    """The layout over the default process group, this rank on `device`
    (rank_device).  Without a group, starts a one-rank group (NCCL on the
    card, gloo on the CPU) over an in-memory store; collectives then run at
    world size 1 like at any other.  n_devices, when given, must equal the
    world size: ranks are processes, started by torchrun, by
    multihost.init_distributed or by the CLI's --devices."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"requested {n_devices} devices without a process group: "
                "start the ranks with torchrun or "
                "parallel.init_distributed")
        dev = rank_device(device, 0)
        dist.init_process_group(pick_backend(dev, 1), store=dist.HashStore(),
                                rank=0, world_size=1,
                                timeout=DEFAULT_TIMEOUT)
    k = dist.get_world_size()
    if n_devices is not None and n_devices != k:
        raise ValueError(f"requested {n_devices} devices, the process group "
                         f"has {k} ranks")
    rank = dist.get_rank()
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    backend = dist.get_backend()
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL group needs device='cuda'")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(rank, k, dev, backend)


def shard_text(text, mesh: Mesh, *, sigma: int):
    """This rank's shard of a text every rank holds: per = ceil(n/k) bytes
    at offset rank*per, on the rank's device, right-padded to per bytes.

    For sigma <= 255 the pad is the out-of-alphabet symbol sigma (pad
    windows can never match).  For the byte alphabet (sigma = 256) no
    out-of-alphabet byte exists: the pad is 0, and the distributed layer
    counts only the starts before n - m + 1 (parallel/dist.py).

    Returns (shard, original length)."""
    k = mesh.size
    if isinstance(text, torch.Tensor):
        src = text
    else:
        src = torch.from_numpy(np.ascontiguousarray(text, np.uint8))
    if src.dtype != torch.uint8 or src.dim() != 1:
        raise TypeError(f"text must be 1-D uint8, got {src.dtype} "
                        f"{tuple(src.shape)}")
    n = int(src.shape[0])
    per = -(-max(n, 1) // k)
    lo, hi = min(mesh.rank * per, n), min((mesh.rank + 1) * per, n)
    shard = torch.full((per,), sigma if sigma < 256 else 0,
                       dtype=torch.uint8, device=mesh.device)
    shard[:hi - lo] = src[lo:hi].to(mesh.device)
    return shard, n
