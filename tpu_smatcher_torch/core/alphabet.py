"""Alphabets and byte encodings (the port's own copy of
tpu_smatcher/core/alphabet.py; numpy only).

Every scan consumes uint8 arrays with values < sigma.  An alphabet with
`chars` maps raw bytes (e.g. ASCII DNA) to those code points; without
`chars` the corpus is taken as pre-encoded.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_DNA = b"ACGT"
#: canonical 20-letter amino-acid order
_PROTEIN = b"ARNDCQEGHILKMFPSTWYV"


@dataclasses.dataclass(frozen=True)
class Alphabet:
    """An alphabet of `size` symbols; `chars[i]` is the raw byte of code i
    when present."""

    size: int
    chars: bytes | None = None
    name: str = ""

    def __post_init__(self):
        if not (2 <= self.size <= 256):
            raise ValueError(f"alphabet size {self.size} not in [2, 256]")
        if self.chars is not None and len(self.chars) != self.size:
            raise ValueError("chars length must equal alphabet size")

    @property
    def sigma(self) -> int:
        return self.size

    @staticmethod
    def binary() -> "Alphabet":
        return Alphabet(2, None, "binary")

    @staticmethod
    def dna() -> "Alphabet":
        return Alphabet(4, _DNA, "dna")

    @staticmethod
    def protein() -> "Alphabet":
        return Alphabet(20, _PROTEIN, "protein")

    @staticmethod
    def ascii128() -> "Alphabet":
        return Alphabet(128, None, "ascii128")

    @staticmethod
    def byte() -> "Alphabet":
        return Alphabet(256, None, "byte")

    @staticmethod
    def of_size(size: int) -> "Alphabet":
        named = {2: Alphabet.binary, 4: Alphabet.dna, 20: Alphabet.protein,
                 128: Alphabet.ascii128, 256: Alphabet.byte}
        if size in named:
            return named[size]()
        return Alphabet(size)

    def encode(self, raw: bytes | np.ndarray) -> np.ndarray:
        """Raw bytes -> uint8 code points in [0, size).  With a char map,
        unknown bytes map to code 0 and lowercase letters are accepted;
        without one, bytes must already be < size."""
        if isinstance(raw, (bytes, bytearray)):
            arr = np.frombuffer(raw, dtype=np.uint8)
        else:
            # validate before the uint8 cast, which would wrap mod 256
            wide = np.asarray(raw)
            if wide.size and (int(wide.max()) > 255 or int(wide.min()) < 0):
                raise ValueError("corpus value outside uint8 range")
            arr = wide.astype(np.uint8)
        if self.chars is None:
            self.validate(arr)
            return arr.copy()
        lut = np.zeros(256, dtype=np.uint8)
        for code, ch in enumerate(self.chars):
            lut[ch] = code
            if 65 <= ch <= 90:
                lut[ch + 32] = code
        return lut[arr]

    def decode(self, codes: np.ndarray) -> bytes:
        """Code points -> raw bytes: through the char map, else as they
        are."""
        codes = np.asarray(codes, dtype=np.uint8)
        if self.chars is None:
            return codes.tobytes()
        lut = np.frombuffer(self.chars, dtype=np.uint8)
        return lut[codes].tobytes()

    def validate(self, codes: np.ndarray) -> None:
        codes = np.asarray(codes)
        if codes.size and int(codes.max()) >= self.size:
            raise ValueError(f"code {int(codes.max())} out of range for "
                             f"sigma={self.size}")
