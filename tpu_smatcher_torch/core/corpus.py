"""Corpus I/O (the port's own copy of tpu_smatcher/core/corpus.py): raw
pre-encoded files, and FASTA / ASCII files encoded through an Alphabet.

load_fasta encodes a file with a char map with the native encoder
(native/builders.cpp:tpu_encode_fasta) where the library loads, else in a
few vectorised numpy passes over its bytes (encode_fasta), to the same
bytes: a '>' at the start of a line opens a header, skipped up to its
'\\n'; '\\n', '\\r', '\\t' and ' ' are dropped; every other byte goes
through the alphabet's LUT (upper and lower case letters to their codes,
anything else to code 0).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from tpu_smatcher_torch import native
from tpu_smatcher_torch.core.alphabet import Alphabet

#: the LUT's mark for a byte that is dropped
SKIP = 255


@dataclasses.dataclass(frozen=True)
class Corpus:
    codes: np.ndarray       # (n,) uint8 encoded text
    alphabet: Alphabet
    name: str = ""

    @property
    def n(self) -> int:
        return int(self.codes.shape[0])


def load_raw(path: str, alphabet: Alphabet, name: str = "") -> Corpus:
    """A whole pre-encoded (or, with a char map, raw) byte file."""
    raw = np.fromfile(path, dtype=np.uint8)
    return Corpus(alphabet.encode(raw), alphabet,
                  name or os.path.basename(path))


def _fasta_lut(alphabet: Alphabet) -> np.ndarray:
    """Raw byte -> code: the alphabet's chars (upper and lower case) to
    their codes, '\\n', '\\r', '\\t' and ' ' to SKIP, anything else to 0
    (Alphabet.encode's wildcard rule)."""
    lut = np.zeros(256, np.uint8)
    for code, ch in enumerate(alphabet.chars):
        lut[ch] = code
        if 65 <= ch <= 90:
            lut[ch + 32] = code
    for ws in b"\n\r\t ":
        lut[ws] = SKIP
    return lut


def header_bytes(raw: np.ndarray) -> np.ndarray:
    """int64 indices of the bytes of header lines, each from a '>' at the
    start of a line (the file's first byte, or one after '\\n') up to, not
    including, the next '\\n' (or the end of the file)."""
    n = raw.shape[0]
    newlines = np.flatnonzero(raw == ord("\n"))
    starts = np.concatenate([[0], newlines + 1])
    starts = starts[starts < n]
    heads = starts[raw[starts] == ord(">")]
    lens = np.append(newlines, n)[np.searchsorted(newlines, heads)] - heads
    # header k's bytes are heads[k] + j for j < lens[k]: one arange over
    # all of them, shifted per header by its start minus its offset
    offsets = np.cumsum(lens) - lens
    return np.repeat(heads - offsets, lens) + np.arange(int(lens.sum()))


def encode_fasta(raw: np.ndarray, alphabet: Alphabet) -> np.ndarray:
    """A FASTA byte stream -> its records' code points, concatenated."""
    raw = np.asarray(raw, np.uint8)
    codes = _fasta_lut(alphabet)[raw]
    codes[header_bytes(raw)] = SKIP
    return codes[codes != SKIP]


def load_fasta(path: str, alphabet: Alphabet, name: str = "") -> Corpus:
    """A FASTA file: header lines skipped, whitespace dropped, encoded.
    With a char map, the native encoder over the whole file, or
    encode_fasta where the library does not load; without one (the bytes
    must already be codes), the JAX package's line loop, which drops every
    ASCII whitespace byte and validates through Alphabet.encode."""
    name = name or os.path.basename(path)
    if alphabet.chars is not None:
        raw = np.fromfile(path, dtype=np.uint8)
        codes = native.encode_fasta_native(raw, _fasta_lut(alphabet))
        if codes is None:
            codes = encode_fasta(raw, alphabet)
        return Corpus(codes, alphabet, name)
    chunks = []
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                continue
            chunks.append(b"".join(line.split()))
    return Corpus(alphabet.encode(b"".join(chunks)), alphabet, name)
