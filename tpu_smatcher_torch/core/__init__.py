"""Host-side alphabets, pattern sets, corpus readers, table checkpoints and
synthetic data of the port (the port keeps its own copies and imports
nothing of tpu_smatcher)."""

from tpu_smatcher_torch.core import corpus, datagen
from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.core.patterns import MixedPatternSet, PatternSet

__all__ = ["Alphabet", "MixedPatternSet", "PatternSet", "corpus", "datagen"]
