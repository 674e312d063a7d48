"""Pattern sets: p fixed-length-m patterns as a dense (p, m) uint8 array of
code points plus their alphabet (the port's own copy of
tpu_smatcher/core/patterns.py:PatternSet)."""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_smatcher_torch.core.alphabet import Alphabet


@dataclasses.dataclass(frozen=True)
class PatternSet:
    codes: np.ndarray          # (p_size, m) uint8, values < alphabet.size
    alphabet: Alphabet

    def __post_init__(self):
        codes = np.ascontiguousarray(np.asarray(self.codes, dtype=np.uint8))
        if codes.ndim != 2:
            raise ValueError("patterns must be a (p_size, m) array")
        object.__setattr__(self, "codes", codes)
        self.alphabet.validate(codes)

    @property
    def p_size(self) -> int:
        return int(self.codes.shape[0])

    @property
    def m(self) -> int:
        return int(self.codes.shape[1])

    @property
    def sigma(self) -> int:
        return self.alphabet.size
