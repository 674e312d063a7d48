"""Plain reference of the window count, and its control.

count: the number of window starts s in [0, len(text) - m + 1) whose m
bytes equal at least one row of the panel; count_rows, the same of each
row of a batch of short texts.  Each window is packed exactly
into one int64 key (m * bits <= 64, bits = ceil(log2 sigma); for 64 bits
the sign bit is used, which keeps keys distinct), the panel's keys are
sorted, and each window's key is looked up by a binary search.  Blocks of
BLOCK starts bound the temporaries.

control: the same count with membership decided by a FP_BITS-bit
fingerprint of the key instead of the key itself: a fingerprint filter with
its verify left out.  It breaks the configuration's guarantee that no
window is counted unless it equals a pattern, and the benchmark's
comparison has to reject it.

Plain torch only: imports nothing of the program under test.
"""

from __future__ import annotations

import torch

#: window starts per block
BLOCK = 1 << 24
#: bits of the control's fingerprint
FP_BITS = 20
#: the multipliers of splitmix64's finalizer, as signed int64
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)


def bits_per_char(sigma: int) -> int:
    return max(1, (int(sigma) - 1).bit_length())


def _bits(m: int, sigma: int) -> int:
    bits = bits_per_char(sigma)
    if m * bits > 64:
        raise ValueError(f"m={m} at {bits} bits a byte does not pack into "
                         "64 bits: this reference needs another key")
    return bits


def window_keys(text: torch.Tensor, m: int, sigma: int) -> torch.Tensor:
    """int64 keys of the windows along text's last dimension (length L):
    (..., L - m + 1), each window's bytes packed, first byte highest.  A
    (p, m) panel gives its rows' keys as (p, 1)."""
    bits = _bits(m, sigma)
    n_starts = int(text.shape[-1]) - m + 1
    t = text.to(torch.int64)
    key = torch.zeros(t.shape[:-1] + (n_starts,), dtype=torch.int64,
                      device=text.device)
    for j in range(m):
        key = (key << bits) | t[..., j:j + n_starts]
    return key


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """z >> s as an unsigned 64-bit shift."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def fingerprint(keys: torch.Tensor) -> torch.Tensor:
    """The top FP_BITS bits of splitmix64's finalizer of each key: keys
    that differ land on a fingerprint as at random, so windows of any
    alphabet and length collide with the panel's."""
    z = (keys ^ _shr(keys, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    z = z ^ _shr(z, 31)
    return _shr(z, 64 - FP_BITS)


def _table(panel, sigma, device, control):
    """The panel's sorted distinct keys (fingerprints for the control)."""
    table = window_keys(panel.to(device), int(panel.shape[1]), sigma)[:, 0]
    if control:
        table = fingerprint(table)
    return torch.unique(table)                     # sorted


def _hits(keys, table, control):
    """Which keys are in the table."""
    if control:
        keys = fingerprint(keys)
    idx = torch.searchsorted(table, keys).clamp_(max=table.numel() - 1)
    return table[idx] == keys


def _count(text, panel, sigma, *, control: bool) -> int:
    m = int(panel.shape[1])
    n_starts = int(text.shape[0]) - m + 1
    if n_starts <= 0:
        return 0
    table = _table(panel, sigma, text.device, control)
    total = 0
    for lo in range(0, n_starts, BLOCK):
        hi = min(lo + BLOCK, n_starts)
        keys = window_keys(text[lo:hi + m - 1], m, sigma)
        total += int(_hits(keys, table, control).sum())
    return total


def count(text: torch.Tensor, panel: torch.Tensor, sigma: int) -> int:
    """Window starts of text holding at least one row of panel."""
    return _count(text, panel, sigma, control=False)


def count_rows(rows: torch.Tensor, panel: torch.Tensor, sigma: int
               ) -> torch.Tensor:
    """(R,) int64: count of each row of an (R, L) batch of texts, in
    blocks of BLOCK windows."""
    m = int(panel.shape[1])
    table = _table(panel, sigma, rows.device, False)
    per = max(1, BLOCK // max(1, int(rows.shape[1]) - m + 1))
    return torch.cat([_hits(window_keys(rows[lo:lo + per], m, sigma),
                            table, False).sum(dim=1)
                      for lo in range(0, int(rows.shape[0]), per)])
def control(text: torch.Tensor, panel: torch.Tensor, sigma: int) -> int:
    """count, by fingerprint: at least count, more where a window's
    fingerprint meets a pattern's."""
    return _count(text, panel, sigma, control=True)
