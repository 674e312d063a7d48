"""Debug printing (port of tpu_smatcher/utils/debug.py), the cuPrintf
analogue.

The reference vendors NVIDIA's cuPrintf ring-buffer printf for in-kernel
debugging (cuda/cuPrintf.cu, hooks commented out at cuda/cuda_ac.cu:1036-1043;
SURVEY.md §2.4 C17).  The JAX package prints from traced code with
jax.debug.print and from inside Pallas kernels with pl.debug_print.  The
port runs eagerly, so dprint formats on the host; inside a CUDA kernel,
CUDA's own printf is the counterpart of pl.debug_print.
"""

from __future__ import annotations

import torch


def _host(a):
    """A tensor as a host value: a python number for one element, else a
    numpy array."""
    if not isinstance(a, torch.Tensor):
        return a
    a = a.detach().cpu()
    return a.item() if a.numel() == 1 else a.numpy()


def dprint(fmt: str, *args) -> None:
    """Print fmt.format(*args), tensors read to the host first.

    Reading a CUDA tensor synchronises the host with the device, so dprint
    is for debugging only: calls are removed from shipped code, not gated
    by a flag.  Inside a CUDA kernel, CUDA's printf (device-side, flushed at
    the next synchronisation) takes its place while debugging; no shipped
    kernel source keeps one."""
    print(fmt.format(*(_host(a) for a in args)), flush=True)
