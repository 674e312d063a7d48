"""Engine facade of the PyTorch port (port of tpu_smatcher/engines.py:22,108)."""

from __future__ import annotations

import numpy as np
import torch

from tpu_smatcher_torch.core.patterns import PatternSet


def _codes(patterns) -> tuple[np.ndarray, int]:
    if isinstance(patterns, PatternSet):
        return patterns.codes, patterns.sigma
    raise TypeError("make_fast expects a PatternSet")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but CUDA is not available; "
                               "pass device='cpu' for the plain torch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def make_fast(patterns: PatternSet, *, device="cuda", **opts):
    """The shared fast backend on `device` (no implicit fallback to the
    CPU): hand-written CUDA kernels on a CUDA device, their plain torch
    versions on the CPU.  opts: n_stages (table build), tile, cap."""
    from tpu_smatcher_torch.ops.fast import FastScanner, build_fast
    dev = _device(device)
    codes, sigma = _codes(patterns)
    n_stages = opts.pop("n_stages", None)
    return FastScanner(build_fast(codes, sigma, n_stages=n_stages,
                                  device=dev), **opts)
