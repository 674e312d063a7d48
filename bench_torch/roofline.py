"""The least time one H100 could take for a kernel's work, and the
operations and bytes that work needs, from the call's shapes.

Copied from the port's chip_smoke.py (its bound constants, bound(),
stage_tests(), fp_filter_ops()), so that later changes to the port cannot
move the yardstick.  A bound charges what the function needs for the
call, whatever implements it: each input byte read once, each output byte
written once, and the int32 operations of rolling fingerprints or window
ids and of the stage tests the starts reach.

Peaks of one H100 SXM (NVIDIA's data sheet) at its 700 W limit: 3.35 TB/s
of HBM, and 33.5 int32 TOP/s, derived from the 67 TFLOP/s float32 rate (64
int32 lanes per SM against 128 float32 ones; a multiply-add counts 2, as
an FMA does).  A card set below 700 W runs slower under load: every run
prints the card's power limit.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
#: three rolling fingerprints, two multiply-adds each to roll one start:
#: fp(i) = fp(i+1) * M + t[i] - t[i+m] * M^m
ROLLING_FP_OPS = 3 * 2 * 2
#: one stage test: key = f0 + C*f1 + D*f2 (2 multiply-adds), the mask, the
#: word index and the bit test
STAGE_TEST_OPS = 8
#: one exact-tier start: the rolling window id (shift, or, mask), the bit
#: test (word index, bit index, shift, and) and the sum
EXACT_START_OPS = 8
#: the pad guard per start: a compare and a select as the byte enters, a
#: compare of the distance with m
GUARD_START_OPS = 3


def bound_s(nbytes: float, ops: float) -> float:
    """Seconds: bytes over the HBM rate or int32 operations over the int32
    rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def stage_tests(fills, k: int) -> float:
    """Expected stage tests per start of a filter that stops at its first
    miss over the first k stages: sum_s prod_{j<s} fill_j (uniform text)."""
    tests, alive = 0.0, 1.0
    for s in range(k):
        tests += alive
        alive *= fills[s]
    return tests


def fp_filter_ops(n: int, m: int, fills, k: int) -> float:
    """int32 operations the fp-tier filters need over n bytes: per start,
    three rolling fingerprint updates and the stage tests of k stages."""
    return (n - m + 1) * (ROLLING_FP_OPS + STAGE_TEST_OPS
                          * stage_tests(fills, k))


def bitmap_fills(bitmaps: torch.Tensor) -> list:
    """Share of set bits of each row of a (k, words) int32 bitmap tensor."""
    b = bitmaps.reshape(bitmaps.shape[0], -1).contiguous().view(torch.uint8)
    shifts = torch.arange(8, device=b.device, dtype=torch.uint8)
    ones = ((b.unsqueeze(-1) >> shifts) & 1).sum(dim=(1, 2))
    return (ones.double() / (b.shape[1] * 8)).tolist()


def cascade_bound_s(n: int, m: int, fills, k1: int, stage_bytes: int,
                    out_bytes: int) -> float:
    """The cascade's call over n bytes: the text, its kt stages and its
    outputs; phase 1's stage tests over every start (phase 2 tests the few
    survivors)."""
    return bound_s(n + stage_bytes + out_bytes, fp_filter_ops(n, m, fills, k1))


def exact_bound_s(n: int, m: int, bitmap_bytes: int, guard: bool) -> float:
    """The exact count's call over n bytes: the text, the bitmap and the
    count; per start the window id and bit test, and the guard's test."""
    ops = EXACT_START_OPS + (GUARD_START_OPS if guard else 0)
    return bound_s(n + bitmap_bytes + 4, (n - m + 1) * ops)
