"""tpu_smatcher_torch: the PyTorch/CUDA port of tpu_smatcher.

The fast path, make_fast(patterns, device=...).count(text), runs on an
NVIDIA H100 through hand-written CUDA kernels (csrc/, built with nvcc at
first use) and on the CPU through their plain torch versions.  The port
keeps its own host-side alphabets, pattern sets and data generator
(core/) and imports nothing of tpu_smatcher.
"""

from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.core.patterns import PatternSet
from tpu_smatcher_torch.engines import make_fast

__all__ = ["Alphabet", "PatternSet", "make_fast"]
