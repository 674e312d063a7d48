"""Host-side alphabets, pattern sets and synthetic data of the port (numpy
only; the port keeps its own copies and imports nothing of tpu_smatcher)."""

from tpu_smatcher_torch.core import datagen
from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.core.patterns import PatternSet

__all__ = ["Alphabet", "PatternSet", "datagen"]
