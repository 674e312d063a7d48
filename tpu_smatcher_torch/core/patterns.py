"""Pattern sets (the port's own copy of tpu_smatcher/core/patterns.py).

A PatternSet is p fixed-length-m patterns as a dense (p, m) uint8 array of
code points plus their alphabet.  A MixedPatternSet holds patterns of
several lengths: one PatternSet per distinct length plus the original
(global) id of every row.
"""

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

    @staticmethod
    def from_strings(strings, alphabet: Alphabet) -> "PatternSet":
        rows = _encode_rows(strings, alphabet)
        lens = {len(r) for r in rows}
        if len(lens) != 1:
            raise ValueError(
                f"all patterns must share one length, got {sorted(lens)}")
        return PatternSet(np.stack(rows), alphabet)

    @staticmethod
    def from_fasta(path: str, alphabet: Alphabet) -> "PatternSet":
        """One pattern per FASTA record; all records must share one length
        (MixedPatternSet.from_fasta takes mixed lengths)."""
        return PatternSet.from_strings(_fasta_records(path), alphabet)

    def flat(self) -> np.ndarray:
        """The flattened (p_size * m,) view."""
        return self.codes.reshape(-1)

    def save(self, path: str) -> str:
        """Save as .npz (keys codes, sigma, chars, as the JAX package
        writes them); returns the path written, with '.npz' appended when
        it is missing, as np.savez would."""
        if not path.endswith(".npz"):
            path += ".npz"
        chars = self.alphabet.chars
        np.savez_compressed(
            path, codes=self.codes, sigma=self.alphabet.size,
            chars=(np.frombuffer(chars, np.uint8) if chars
                   else np.zeros(0, np.uint8)))
        return path

    @staticmethod
    def load(path: str) -> "PatternSet":
        with np.load(path) as z:
            chars = z["chars"].tobytes() if z["chars"].size else None
            return PatternSet(z["codes"], Alphabet(int(z["sigma"]), chars))


def _encode_rows(strings, alphabet: Alphabet) -> list:
    return [alphabet.encode(s.encode() if isinstance(s, str) else s)
            for s in strings]


def _fasta_records(path: str) -> list:
    """Raw byte sequences, one per FASTA record ('>' lines start a record;
    whitespace inside a record is dropped)."""
    seqs = []
    cur = []
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                if cur:
                    seqs.append(b"".join(cur))
                    cur = []
            else:
                cur.append(b"".join(line.split()))
    if cur:
        seqs.append(b"".join(cur))
    if not seqs:
        raise ValueError(f"no FASTA records in {path}")
    return seqs


@dataclasses.dataclass(frozen=True)
class MixedPatternSet:
    """Patterns of mixed lengths: one PatternSet per distinct length, in
    ascending order, plus the original (global) id of every row.  A
    MixedScanner (engines.make_mixed) runs one sub-scan per group over one
    device text; each length contributes its own windows-with-a-match
    count, so a start matching patterns of two lengths counts twice."""

    groups: tuple          # tuple[PatternSet, ...], ascending m, one alphabet
    ids: tuple             # tuple[np.ndarray, ...] global id per group row
    alphabet: Alphabet

    def __post_init__(self):
        if not self.groups:
            raise ValueError("MixedPatternSet needs at least one pattern")
        ms = [g.m for g in self.groups]
        if ms != sorted(set(ms)):
            raise ValueError("groups must have distinct, ascending lengths")
        if len(self.ids) != len(self.groups):
            raise ValueError(
                f"ids must have one entry per group: {len(self.ids)} id "
                f"arrays for {len(self.groups)} groups")
        for g, gid in zip(self.groups, self.ids):
            if (g.alphabet.size != self.alphabet.size
                    or g.alphabet.chars != self.alphabet.chars):
                raise ValueError("all groups must share one alphabet "
                                 "(size and character map)")
            if len(gid) != g.p_size:
                raise ValueError("ids must align with group rows")

    @property
    def p_size(self) -> int:
        return sum(g.p_size for g in self.groups)

    @property
    def lengths(self) -> tuple:
        return tuple(g.m for g in self.groups)

    @property
    def sigma(self) -> int:
        return self.alphabet.size

    @staticmethod
    def from_rows(rows, alphabet: Alphabet) -> "MixedPatternSet":
        """rows: encoded uint8 sequences of any lengths; row i gets global
        id i."""
        rows = [np.asarray(r, dtype=np.uint8) for r in rows]
        if not rows:
            raise ValueError("no patterns")
        by_m: dict = {}
        for i, r in enumerate(rows):
            if r.ndim != 1 or r.size == 0:
                raise ValueError(f"pattern {i} must be a non-empty 1-D array")
            by_m.setdefault(r.size, []).append(i)
        groups, ids = [], []
        for m in sorted(by_m):
            idx = by_m[m]
            groups.append(PatternSet(np.stack([rows[i] for i in idx]),
                                     alphabet))
            ids.append(np.asarray(idx, np.int64))
        return MixedPatternSet(tuple(groups), tuple(ids), alphabet)

    @staticmethod
    def from_strings(strings, alphabet: Alphabet) -> "MixedPatternSet":
        return MixedPatternSet.from_rows(_encode_rows(strings, alphabet),
                                         alphabet)

    @staticmethod
    def from_fasta(path: str, alphabet: Alphabet) -> "MixedPatternSet":
        """One pattern per FASTA record, any mix of lengths."""
        return MixedPatternSet.from_strings(_fasta_records(path), alphabet)
