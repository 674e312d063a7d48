"""tpu_smatcher_torch: the PyTorch/CUDA port of tpu_smatcher.

The fast path, make_fast(patterns, device=...).count(text), the seven
named engines, make_engine(name, patterns, device=...), mixed-length
pattern sets, make_mixed(MixedPatternSet, device=...), and the count
distributed over torch.distributed ranks, make_distributed(name,
patterns, mesh), run on an NVIDIA H100 through hand-written CUDA kernels
(csrc/, built with nvcc at first use) and on the CPU through their plain
torch versions.  The port keeps
its own host-side alphabets, pattern sets, corpus readers, data generator
and table checkpoints (core/), table builders (automata/), timing and
debug utilities (utils/), the rank layout (parallel/) and a command line
(python -m tpu_smatcher_torch.cli), and imports nothing of tpu_smatcher.
"""

import time

from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.core.patterns import MixedPatternSet, PatternSet
from tpu_smatcher_torch.engines import (ENGINE_NAMES, make_distributed,
                                        make_engine, make_fast, make_mixed)


def scan(text, patterns, *, engine: str = "fast", reps: int = 1,
         device="cuda", **opts) -> dict:
    """One-call scan of the JAX package's scan(): build the engine on
    `device`, count, return {engine, matches, bytes, preproc_s, scan_s,
    bytes_per_s}.  `patterns` is a PatternSet; `engine` one of
    ENGINE_NAMES or "fast"; opts go to the engine's constructor.  The text
    is placed on the device once, before the timed scans; each count()
    returns a host int, so scan_s (the best of `reps` after a first call)
    holds the device's work."""
    from tpu_smatcher_torch.engines import _device
    from tpu_smatcher_torch.ops.fast import device_text

    dev = _device(device)
    t0 = time.perf_counter()
    eng = make_fast(patterns, device=dev, **opts) if engine == "fast" else \
        make_engine(engine, patterns, device=dev, **opts)
    t_build = time.perf_counter() - t0
    t = device_text(text, dev)
    count = eng.count(t)                   # first call: builds the kernels
    times = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        count = eng.count(t)
        times.append(time.perf_counter() - t0)
    t_scan = min(times)
    n = int(t.shape[0])
    return {"engine": engine, "matches": int(count), "bytes": n,
            "preproc_s": round(t_build, 4), "scan_s": round(t_scan, 4),
            "bytes_per_s": round(n / t_scan, 1)}


__all__ = ["Alphabet", "ENGINE_NAMES", "MixedPatternSet", "PatternSet",
           "make_distributed", "make_engine", "make_fast", "make_mixed",
           "scan"]
