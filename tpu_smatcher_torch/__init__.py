"""tpu_smatcher_torch: the PyTorch/CUDA port of tpu_smatcher.

The fast path, make_fast(patterns, device=...).count(text), and the seven
named engines, make_engine(name, patterns, device=...), run on an NVIDIA
H100 through hand-written CUDA kernels (csrc/, built with nvcc at first
use) and on the CPU through their plain torch versions.  The port keeps
its own host-side alphabets, pattern sets, data generator (core/) and
table builders (automata/), and imports nothing of tpu_smatcher.
"""

from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.core.patterns import PatternSet
from tpu_smatcher_torch.engines import ENGINE_NAMES, make_engine, make_fast

__all__ = ["Alphabet", "ENGINE_NAMES", "PatternSet", "make_engine",
           "make_fast"]
