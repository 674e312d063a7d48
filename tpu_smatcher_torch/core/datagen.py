"""Synthetic corpora and pattern sets from a seed, and the ground truth
(the port's own copy of tpu_smatcher/core/datagen.py): numpy, or the
native library's threaded count.  The same seeds give the same bytes as the
JAX package's copy."""

from __future__ import annotations

import numpy as np

from tpu_smatcher_torch import native
from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.core.patterns import PatternSet


def generate_text(n: int, alphabet: Alphabet, seed: int = 0) -> np.ndarray:
    """Uniform random encoded text of length n over the alphabet."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, alphabet.size, size=n, dtype=np.uint8)


def generate_patterns(text: np.ndarray, p_size: int, m: int,
                      alphabet: Alphabet, frac_present: float = 0.5,
                      seed: int = 1) -> PatternSet:
    """p_size patterns of length m: ~frac_present sampled from text windows
    (they occur), the rest uniform random (hits only by chance)."""
    rng = np.random.default_rng(seed)
    n = len(text)
    if n < m:
        raise ValueError("text shorter than pattern length")
    if not 0.0 <= frac_present <= 1.0:
        raise ValueError(f"frac_present must be in [0, 1], got {frac_present}")
    n_present = int(round(p_size * frac_present))
    starts = rng.integers(0, n - m + 1, size=n_present)
    present = (np.stack([text[s:s + m] for s in starts]) if n_present
               else np.zeros((0, m), np.uint8))
    random_part = rng.integers(0, alphabet.size, size=(p_size - n_present, m),
                               dtype=np.uint8)
    codes = np.concatenate([present, random_part], axis=0)
    rng.shuffle(codes, axis=0)
    return PatternSet(codes, alphabet)


def plant(text: np.ndarray, pattern: np.ndarray, positions) -> np.ndarray:
    """Overwrite text with `pattern` at each start position; returns a copy."""
    out = text.copy()
    m = len(pattern)
    for s in positions:
        out[s:s + m] = pattern
    return out


def sliding_windows(text: np.ndarray, m: int) -> np.ndarray:
    """(n - m + 1, m) zero-copy view of all length-m windows."""
    return np.lib.stride_tricks.sliding_window_view(
        np.ascontiguousarray(text), m)


def match_starts(text: np.ndarray,
                 patterns: PatternSet | np.ndarray) -> np.ndarray:
    """Boolean array over window starts: True where the window equals at
    least one pattern."""
    codes = (patterns.codes if isinstance(patterns, PatternSet)
             else np.asarray(patterns, np.uint8))
    m = codes.shape[1]
    if len(text) < m:
        return np.zeros(0, dtype=bool)
    win = sliding_windows(text, m)
    # fixed-size byte keys for set membership
    win_keys = np.ascontiguousarray(win).view([("k", f"V{m}")]).reshape(-1)
    pat_keys = np.ascontiguousarray(codes).view([("k", f"V{m}")]).reshape(-1)
    return np.isin(win_keys, pat_keys)


def count_matches(text: np.ndarray, patterns: PatternSet | np.ndarray,
                  prefer_native: bool = False) -> int:
    """Ground truth: the number of window starts with >= 1 pattern match.

    prefer_native counts with the native library
    (native/builders.cpp:tpu_count_cpu, threaded over the host's cores)
    where it loads, and with numpy otherwise: the numpy oracle materialises
    every window, gigabytes on a full-size corpus."""
    if prefer_native:
        codes = (patterns.codes if isinstance(patterns, PatternSet)
                 else np.asarray(patterns, np.uint8))
        c = native.count_cpu_native(np.asarray(text, np.uint8), codes)
        if c is not None:
            return c
    return int(match_starts(text, patterns).sum())


def match_ids(text: np.ndarray, positions: np.ndarray,
              patterns: PatternSet | np.ndarray) -> np.ndarray:
    """Ground truth for attribution: the id of the pattern matching at each
    of `positions` (which must all be match starts), the smallest id where
    duplicate patterns share the window; int64.  O(N log p) by a search
    over the sorted pattern keys; raises ValueError at a start where no
    pattern matches."""
    codes = (patterns.codes if isinstance(patterns, PatternSet)
             else np.asarray(patterns, np.uint8))
    p, m = codes.shape
    positions = np.asarray(positions, np.int64)
    if positions.size == 0:
        return np.empty(0, np.int64)
    text = np.asarray(text, np.uint8)
    win = text[positions[:, None] + np.arange(m)]
    win_keys = np.ascontiguousarray(win).view([("k", f"V{m}")]).reshape(-1)
    pat_keys = np.ascontiguousarray(codes).view([("k", f"V{m}")]).reshape(-1)
    order = np.argsort(pat_keys, kind="stable")   # stable: ties keep min id
    srt = pat_keys[order]
    idx = np.searchsorted(srt, win_keys, side="left")
    if (idx >= p).any() or (srt[np.minimum(idx, p - 1)] != win_keys).any():
        raise ValueError("positions contain a non-matching window start")
    return order[idx].astype(np.int64)
