"""Profiling and tracing (the port's copy of tpu_smatcher/utils/
profiling.py): the reference's three timing mechanisms on PyTorch.

  (a) MPI_Wtime around read / scatter / scan / reduce phases
      (main.c:338-671)                          -> PhaseTimer
  (b) CUDA events around each kernel, averaged across ranks
      (cuda/cuda_wm.cu:269-302, main.c:659-670) -> time_fn (CUDA events on
      a CUDA device, the host clock with the result consumed elsewhere)
  (c) nvprof counter runs (profile.sh)          -> trace (torch.profiler,
      a Chrome / Perfetto trace of the CPU and CUDA activity)

emit_jsonl appends one JSON object per line, in place of the reference's
printf report (main.c:663-671).
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch


class PhaseTimer:
    """Named host-clock phases, as context managers; re-entering a phase
    adds to it.

    >>> pt = PhaseTimer()
    >>> with pt.phase("read"): ...
    >>> pt.report()  # {"read_s": 0.12, ...}
    """

    def __init__(self):
        self.seconds = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + (
                time.perf_counter() - t0)

    def report(self, ndigits: int = 4) -> dict:
        return {f"{k}_s": round(v, ndigits) for k, v in self.seconds.items()}


def time_fn(fn, *args, reps: int = 5, warmup: int = 1,
            bytes_scanned: int | None = None, device=None) -> dict:
    """Timing of fn(*args) with the JAX package's time_jit report: best and
    mean seconds over `reps` after `warmup` calls, the rep count and, when
    bytes_scanned is given, bytes_per_s of the best.

    On a CUDA device (`device`, else the device of the first tensor
    argument) each rep is bracketed by CUDA events and synchronised, so
    the time is the device's; elsewhere it is the host clock around the
    call, which must return its result finished (a host int, a CPU
    tensor)."""
    if device is None:
        device = next((a.device for a in args
                       if isinstance(a, torch.Tensor)), None)
    on_cuda = device is not None and torch.device(device).type == "cuda"
    for _ in range(max(warmup, 0)):
        fn(*args)
    times = []
    for _ in range(max(reps, 1)):
        if on_cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    best = min(times)
    out = {"best_s": best, "mean_s": sum(times) / len(times),
           "reps": len(times)}
    if bytes_scanned is not None:
        out["bytes_per_s"] = bytes_scanned / best
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block (CPU, and CUDA where there is a
    card), written as a Chrome / Perfetto trace into `logdir`; yields the
    profiler (key_averages() for sums by kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def emit_jsonl(path: str, record: dict) -> None:
    """Append one structured metrics record (creates the file if missing)."""
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
