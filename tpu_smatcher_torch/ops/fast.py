"""The fast path in PyTorch: dense bitmap filters + sparse exact verify.

Port of tpu_smatcher/ops/fast.py.  Two tiers, as in the JAX package:

  - exact tier (sigma^m <= 2^16): the packed window id indexes a terminal
    bitmap; one kernel (cuda_filter.exact_count) counts the hits.
  - fingerprint tier: FastScanner._pick_path routes a scan by the JAX
    package's cost model to one of three forms, each a filter kernel whose
    candidates are compacted (no host sync: the cascade's by a kernel on
    the card, the others by torch ops) and verified exactly against the
    fingerprint-bucketed patterns (ops/verify._verify_matched over the
    text's word view, cuda_filter.words_view; on the card the cascade's
    by a kernel that reads the text itself):
      slot     cuda_filter.filter_slots: 16 candidates + the true count
               per 16,384-start sub-block -> compact_slots
      cascade  cuda_filter.cascade: two-phase filter, 16 survivors per
               128-start row -> compact_valrows, verify_count (on the card
               the cuda_filter.compact_rows and verify_count_live kernels)
      mask     cuda_filter.filter_mask: the per-start mask -> compact_mask

Tables are built on the host with numpy exactly as the JAX package builds
them at one stage width (build_fast; the default width is the H100's, see
there), or carried across from it (FastTables.from_numpy).

Overflow (a sub-block or row with more candidates than its slots, or more
than `cap` in all) never undercounts.  The scan's future retries through
the JAX package's synchronous ladder: the mask pipeline with half-cap,
full-cap and row-dense trials (compact_verify_retry), budget-sized pieces
on saturated tables, and pieces split until they cannot overflow
(_count_chunked).  Then the scanner adapts, as in the JAX package: one more
filter stage after a false-candidate overflow (_k_extra), or the row-dense
mask pass for every later scan after a match-driven one (_match_dense).
fast_count_core, the tiled plain-torch scan, is the counterpart of the JAX
package's xla backend and runs patterns longer than the kernels take.

Text is specified encoded in the alphabet (bytes < sigma).  On a byte >=
sigma the exact tier's unguarded count ORs the shifted bytes into the
window id (ops/keys.wid_keys), as the JAX package's xla path does, where
its Pallas kernel sums them: such a window may count differently there,
and neither count need equal the windows that equal a pattern.  The main
path adds no guard; core() and exact_count(guard=True) drop such windows.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from tpu_smatcher_torch.ops import cuda_filter
from tpu_smatcher_torch.ops.common import (bits_per_char, cdiv, check_count32,
                                           cut_pieces, finish_pair,
                                           split_pieces, stream_count_file,
                                           stream_positions_file)
# compact_valrows stays importable here, beside the JAX package's
from tpu_smatcher_torch.ops.compaction import (  # noqa: F401
    _pack, _take, compact_valrows, nonzero_scatter)
from tpu_smatcher_torch.ops.keys import FP_MULTS, fp_keys, wid_keys
from tpu_smatcher_torch.ops.lookup import bitmap_test, pack_bitmap, pack_rows
from tpu_smatcher_torch.ops.verify import (verify_attr, verify_count,
                                           words_len)
from tpu_smatcher_torch.utils.profiling import span

BITMAP_BITS = 1 << 16
#: per-stage derivation constants: stage s tests key_s = (fp0 + C_s*fp1 +
#: D_s*fp2) mod stage_bits.  Wide stages (stage_bits > 2^16) skip the
#: (0,0)/(1,0) head, which cannot reach bits >= 2^16 (see the JAX package).
STAGE_CD = ((0, 0), (1, 0),
            (0x2FE9, 0x33C9), (0xA909, 0xBA4D), (0xF4D9, 0xE2A9),
            (0x073F, 0x26A7), (0xA38D, 0x1817), (0xA017, 0xBB4B),
            (0x63D9, 0x9A23), (0x0C7B, 0x234D), (0xB145, 0xF907),
            (0xB2B9, 0x6B23), (0x41C9, 0xDB41), (0xB39F, 0xFB23),
            (0x891D, 0x7965), (0xA797, 0x8E7D), (0xA5D5, 0x0F9F),
            (0xD951, 0xC47B), (0x3F3B, 0xA4E3), (0x934B, 0x6D3D),
            (0xBACD, 0x1523), (0x09E9, 0x7D65), (0x3AC3, 0x0C85),
            (0xDB3D, 0xE503), (0x3941, 0x29FD), (0x45AD, 0x89F3),
            (0x6E65, 0x071F), (0xDDEB, 0x9D6B), (0xE22B, 0x9FFB),
            (0xA845, 0x325F), (0xCA45, 0x1C1B), (0x4219, 0xB033))
DEFAULT_TILE = 1 << 24
DEFAULT_CAP = 1 << 16
#: measured joint-FPR correlation of the derived stages (fitted on the TPU
#: build; kept until the port refits it — ROADMAP "How to port")
STAGE_CF = 5.0
#: the slot route's per-block budget (pallas_filter.SLOT_RB * 128 starts,
#: BLOCK_SLOTS candidates); _pick_path and _async_retry read it
SLOT_BLOCK = cuda_filter.SUB_BLOCK
BLOCK_SLOTS = cuda_filter.BLOCK_SLOTS
#: compact_mask's budgets on the mask route and the sync ladder: live
#: 128-start rows kept, and candidates kept per row
CAPROWS = 1 << 16
ROW_SLOTS = 8


def exact_wid_supported(sigma: int, m: int) -> bool:
    return m * bits_per_char(sigma) <= 16


def _wid_keys_np(patterns: np.ndarray, sigma: int) -> np.ndarray:
    bits = bits_per_char(sigma)
    w = np.zeros(len(patterns), np.int64)
    for i in range(patterns.shape[1]):
        w = (w << bits) | patterns[:, i]
    return w


def _fp_keys_np(patterns: np.ndarray, mult: int) -> np.ndarray:
    fp = np.zeros(len(patterns), np.int64)
    rp = 1
    for i in range(patterns.shape[1]):
        fp = (fp + patterns[:, i].astype(np.int64) * rp) & 0xFFFF
        rp = (rp * mult) & 0xFFFF
    return fp


def _fill(bm: np.ndarray, nbits: int) -> float:
    return float(np.count_nonzero(np.unpackbits(bm.view(np.uint8)))) / nbits


#: FastTables fields that hold arrays (torch tensors in the port)
_ARRAY_FIELDS = ("bucket_ids", "packed", "bucket_fp2", "orig_ids",
                 "wid_pids")


@dataclasses.dataclass
class FastTables:
    """The JAX package's FastTables, holding torch tensors on one device.

    bitmaps is ONE (k, stage_bits/32) int32 tensor, stage s in row s (the
    JAX package keeps a tuple of (B, 128) arrays — the same words)."""
    exact: bool
    m: int
    sigma: int
    n_stages: int
    bitmaps: torch.Tensor
    bucket_ids: torch.Tensor | None   # (2^(16+eb) * lmax,) int32, -1 pad
    lmax: int
    packed: torch.Tensor | None       # (p, W) int32
    words: int
    eb: int = 0
    density: float = 0.0
    bucket_fp2: torch.Tensor | None = None
    slot_ok: bool = False
    stage_bits: int = BITMAP_BITS
    stage_fills: tuple = ()
    stage_cd: tuple = ()
    orig_ids: torch.Tensor | None = None
    wid_pids: torch.Tensor | None = None
    n_orig: int = 0

    @property
    def device(self) -> torch.device:
        return self.bitmaps.device

    def cd(self, k: int) -> tuple:
        """(C, D) constants of the first k stages."""
        base = self.stage_cd or STAGE_CD
        return tuple((int(c), int(d)) for c, d in base[:k])

    @classmethod
    def from_numpy(cls, fields: dict, device) -> "FastTables":
        """Tables from the JAX package's FastTables fields as numpy arrays
        (np.asarray of each array; bitmaps a sequence of (B, 128) arrays;
        scalars and tuples as they are)."""
        kw = dict(fields)
        kw["bitmaps"] = torch.from_numpy(np.stack(
            [np.asarray(b, np.int32).reshape(-1) for b in fields["bitmaps"]]
        )).to(device)
        for name in _ARRAY_FIELDS:
            if kw.get(name) is not None:
                # a copy: arrays from JAX are read-only
                kw[name] = torch.from_numpy(np.array(kw[name])).to(device)
        kw["stage_fills"] = tuple(kw.get("stage_fills", ()))
        kw["stage_cd"] = tuple(tuple(int(v) for v in cd)
                               for cd in kw.get("stage_cd", ()))
        return cls(**kw)


def fp_rate(ft: FastTables, k: int, cf: float = STAGE_CF) -> float:
    """Expected per-position false-candidate rate after the first k stages:
    the prefix product of the built stages' fills times the correlation
    factor cf."""
    if ft.exact:
        return 0.0
    fills = ft.stage_fills or tuple(ft.density for _ in range(len(ft.bitmaps)))
    prod = 1.0
    for s in range(min(k, len(fills))):
        prod *= fills[s]
    return min(prod * cf, 1.0)


def cap_for(ft: FastTables) -> int:
    """Default candidate cap: 4x headroom over the pattern count (pattern
    sets drawn from the text match ~p times), within [2^16, 2^20]."""
    if ft.exact or ft.packed is None:
        return DEFAULT_CAP
    p = int(ft.packed.shape[0])
    return max(DEFAULT_CAP, min(1 << 20, 1 << (4 * p - 1).bit_length()))


def stages_for(ft: FastTables, n: int, cap: int) -> int:
    """Stage count so expected false candidates over n starts fit inside
    cap/4 and the per-row rate stays below 1/256 (independence estimate,
    jointly calibrated with the cap margin in the JAX package)."""
    if ft.exact:
        return 1
    k = 1
    while ((n * ft.density ** k > cap / 4 or ft.density ** k > 1 / 256)
           and k < len(ft.bitmaps)):
        k += 1
    return k


def stages_for_block(ft: FastTables, block_positions: int,
                     lam: float = 3.5, cf: float = STAGE_CF) -> int:
    """Stage count so expected false candidates per slot-route block stay
    <= lam; len(ft.bitmaps) + 1 when no built prefix meets it."""
    if ft.exact:
        return 1
    k = 1
    while block_positions * fp_rate(ft, k, cf) > lam:
        if k >= len(ft.bitmaps):
            return len(ft.bitmaps) + 1
        k += 1
    return k


def slot_stages(ft: FastTables, k: int) -> int | None:
    """The slot route's stage count for a scan that needs k stages
    (stages_for): at least the per-block budget's (stages_for_block), or
    None where the route is infeasible: the exact tier, a budget no built
    prefix meets, or one whose extra stages cost more than the mask
    pipeline's whole overhead (48 in the JAX router's bank-gather units,
    B = stage_bits/4096 a stage; fitted on the TPU)."""
    if ft.exact:
        return None
    kb = stages_for_block(ft, SLOT_BLOCK)
    if kb <= len(ft.bitmaps) and (kb - k) * (ft.stage_bits // 4096) <= 48:
        return max(k, kb)
    return None


def _phase1_depth(fills, stage_bits: int, lam_row: float = 4.0):
    """The smallest k whose expected phase-1 survivors per 128-start row,
    128 * prod(fills[:k]) * cf1, fit lam_row; None when no prefix does."""
    cf1 = 2.5 if stage_bits <= BITMAP_BITS else 1.3
    prod = 1.0
    for k, fill in enumerate(fills, 1):
        prod *= fill
        if 128 * prod * cf1 <= lam_row:
            return k
    return None


def k1_for(ft: FastTables, lam_row: float = 4.0) -> int | None:
    """Phase-1 depth of the cascade: the smallest dense stage count whose
    expected survivors per 128-start row, 128 * prod(fills) * cf1, fit
    lam_row; None when no built prefix does."""
    if ft.exact:
        return None
    nb = len(ft.bitmaps)
    fills = ft.stage_fills or (ft.density,) * nb
    return _phase1_depth(fills[:nb], ft.stage_bits, lam_row)


#: the stage widths build_fast chooses among
STAGE_WIDTHS = (4096, 8192, 16384, 32768, 65536, 131072, 262144)
#: shared memory the cascade's phase-1 bitmaps may take: what it stages at
#: p=100k (six 131,072-bit stages), where two of its 512-thread blocks
#: still fit on an H100 SM
PHASE1_SMEM_BYTES = 96 * 1024


def h100_stage_bits(fill0: dict) -> int:
    """The stage width for the H100's cascade, from stage 0's fill at each
    width (fill0: {stage_bits: fill}): the width whose phase 1 needs the
    fewest stages (k1_for's estimate, stage 0's fill standing for every
    stage's) among those whose phase-1 bitmaps fit PHASE1_SMEM_BYTES, the
    narrower on a tie; the widest when none fits.  A shared-memory bit
    test costs the same at any width, so a wider stage filters more per
    test; fewer phase-1 stages leave fewer divergent stage iterations per
    warp."""
    best = None
    for sb in sorted(fill0):
        k1 = _phase1_depth((fill0[sb],) * (PHASE1_SMEM_BYTES * 8 // sb), sb)
        if k1 is not None and (best is None or k1 < best[0]):
            best = (k1, sb)
    return max(fill0) if best is None else best[1]


def build_fast(patterns: np.ndarray, sigma: int, *,
               n_stages: int | None = None,
               stage_bits: int | None = None,
               device) -> FastTables:
    """Host-side table build, identical to tpu_smatcher.ops.fast.build_fast
    at one stage width (see there for the reasoning); tensors go to
    `device`, which the caller names (no implicit CPU).

    The default width departs from the JAX package's.  Its cost model was
    fitted on the TPU, where a gather costs one unit per 4,096-bit bank,
    and picks 16,384 bits at p=10k: stages 46% full, six of them in the
    cascade's phase 1.  On the H100 a bit test in shared memory costs the
    same at any width, and the cascade's time follows its phase-1 stage
    count, so h100_stage_bits picks the width with the fewest phase-1
    stages that fit in shared memory: 131,072 bits at p=10k, 7% full, two
    stages; the widest (262,144 bits, the JAX rule's own last resort) when
    none fits (p well above 100k).  stage_bits= forces a width (the JAX
    package's, for tables equal to its own)."""
    patterns = np.asarray(patterns, np.uint8)
    n_orig = patterns.shape[0]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if exact_wid_supported(sigma, patterns.shape[1]):
        m0 = patterns.shape[1]
        nbits = max(4096, 1 << (m0 * bits_per_char(sigma)))
        keys = _wid_keys_np(patterns, sigma)
        bm = pack_bitmap(keys, nbits)
        # window id -> smallest original pattern id
        wid_pids = np.full((nbits,), -1, np.int32)
        order = np.argsort(-np.arange(n_orig))
        wid_pids[keys[order]] = order.astype(np.int32)
        return FastTables(True, m0, sigma, 1, dev(bm.reshape(1, -1)), None,
                          0, None, 0, wid_pids=dev(wid_pids), n_orig=n_orig)
    # duplicates cannot change the count; keep each deduped row's smallest
    # original id for attribution
    patterns, inv = np.unique(patterns, axis=0, return_inverse=True)
    orig_ids = np.full((patterns.shape[0],), n_orig, np.int64)
    np.minimum.at(orig_ids, inv.reshape(-1), np.arange(n_orig))
    p, m = patterns.shape
    fps = [_fp_keys_np(patterns, FP_MULTS[s]) for s in range(3)]

    def key0_for(sb):
        if sb <= BITMAP_BITS:
            return fps[0] & (sb - 1)
        C, D = STAGE_CD[2]
        return (fps[0] + C * fps[1] + D * fps[2]) & (sb - 1)

    if stage_bits is None:
        fill0 = {sb: _fill(pack_bitmap(key0_for(sb), sb), sb)
                 for sb in STAGE_WIDTHS}
        stage_bits = h100_stage_bits(fill0)
    density = _fill(pack_bitmap(key0_for(stage_bits), stage_bits), stage_bits)
    cd_table = STAGE_CD if stage_bits <= BITMAP_BITS else STAGE_CD[2:]

    need = (math.log(max(DEFAULT_CAP / 4 / (1 << 31) / STAGE_CF, 1e-12))
            / math.log(density)) if 0 < density < 1 else 1
    k_build = int(min(len(cd_table), max(3, math.ceil(need) + 1)))
    smask = stage_bits - 1
    bitmaps, stage_fills = [], []
    for s in range(k_build):
        C, D = cd_table[s]
        bm_s = pack_bitmap((fps[0] + C * fps[1] + D * fps[2]) & smask,
                           stage_bits)
        stage_fills.append(_fill(bm_s, stage_bits))
        bitmaps.append(bm_s.reshape(-1))

    if n_stages is None:
        k, prod = 1, stage_fills[0]
        while prod * STAGE_CF * DEFAULT_TILE > DEFAULT_CAP / 4 and k < k_build:
            prod *= stage_fills[min(k, len(stage_fills) - 1)]
            k += 1
        n_stages = k
    n_stages = min(n_stages, k_build)

    # verification buckets keyed by fp0 plus eb low bits of fp1
    eb = max(0, (8 * p - 1).bit_length() - 16) if p > 0 else 0
    eb = min(eb, 8)
    nbuckets = BITMAP_BITS << eb
    key = fps[0] | ((fps[1] & ((1 << eb) - 1)) << 16) if eb else fps[0]
    size = np.bincount(key, minlength=nbuckets)
    lmax = max(1, int(size.max(initial=0)))
    bucket = np.full((nbuckets, lmax), -1, np.int32)
    bucket_fp2 = np.full((nbuckets, lmax), -1, np.int32)
    # slot of each pattern within its bucket: rank among equal keys, in id
    # order (what a sequential fill gives)
    order = np.argsort(key, kind="stable")
    first = np.searchsorted(key[order], key[order], side="left")
    slot = np.empty(p, np.int64)
    slot[order] = np.arange(p) - first
    bucket[key, slot] = np.arange(p, dtype=np.int32)
    bucket_fp2[key, slot] = fps[2]
    # slot-select verify is exact iff fp2 is unique within every bucket
    slot_ok = len(np.unique(key.astype(np.int64) * 65536 + fps[2])) == p
    packed = pack_rows(patterns)
    return FastTables(False, m, sigma, n_stages, dev(np.stack(bitmaps)),
                      dev(bucket.reshape(-1)), lmax, dev(packed),
                      packed.shape[1], eb, density,
                      dev(bucket_fp2.reshape(-1)), slot_ok, stage_bits,
                      tuple(stage_fills), tuple(cd_table[:k_build]),
                      orig_ids=dev(orig_ids.astype(np.int32)), n_orig=n_orig)


# ---------------------------------------------------------------------------
# compaction (helpers in ops/compaction.py) and the routes' epilogues
# (verification in ops/verify.py), no host sync
# ---------------------------------------------------------------------------

def compact_slots(pos: torch.Tensor, counts: torch.Tensor, *,
                  slots: int = BLOCK_SLOTS, cap: int = DEFAULT_CAP):
    """Candidates of cuda_filter.filter_slots' output: pos (n_sub, slots)
    positions in sub-block order (-1 empty), counts (n_sub,) the true
    per-sub-block counts (the JAX package keeps them in lane `slots` of one
    (n_sub, 128) matrix).  Returns (idxs (cap,) int64 densely packed then
    -1, overflow 0-d bool, n_cand 0-d int64 — the true total).  Overflow if
    any sub-block held more than `slots` candidates or the total exceeds
    cap."""
    counts = counts.to(torch.int64)
    n_cand = counts.sum()
    overflow = (counts > slots).any() | (n_cand > cap)
    return _pack(pos[:, :slots], cap), overflow, n_cand


def compact_mask(mask2d: torch.Tensor, *, caprows: int = CAPROWS,
                 cap: int = DEFAULT_CAP, row_slots: int = ROW_SLOTS):
    """Hierarchical compaction of cuda_filter.filter_mask's (R, 128) mask.

    Keeps the first `caprows` rows holding candidates and the first
    `row_slots` candidates of each, in position order, and packs the first
    `cap` of those.  Returns (idxs (cap,) int64 positions then -1, overflow
    0-d bool, n_cand 0-d int64 — the kept total).  Overflow if more than
    caprows rows hold candidates, a kept row holds more than row_slots, or
    more than cap are kept: the JAX package's conditions and outputs.  JAX
    extracts slot k of every row with a rank reduction; here the kept
    candidates are selected by their in-row cumsum and scattered once."""
    R, width = int(mask2d.shape[0]), int(mask2d.shape[1])
    live = mask2d.sum(1, dtype=torch.int32) > 0
    n_rows = live.sum()
    rows = nonzero_scatter(live, caprows, R)
    row_live = rows < R
    rows_c = rows.clamp(max=R - 1)
    bits = mask2d[rows_c] != 0                          # (caprows, 128)
    cum = torch.cumsum(bits, 1)
    row_ovf = (row_live & (cum[:, -1] > row_slots)).any()
    keep = (bits & (cum <= row_slots) & row_live[:, None]).reshape(-1)
    n_cand = keep.sum()
    lanes = torch.arange(width, device=mask2d.device)
    pos = (rows_c[:, None] * width + lanes).reshape(-1)
    idxs = _take(pos, nonzero_scatter(keep, cap, pos.shape[0]))
    return idxs, (n_rows > caprows) | row_ovf | (n_cand > cap), n_cand


def verify_text(ft: FastTables, text: torch.Tensor, idxs) -> torch.Tensor:
    """verify_count over text's word view (cuda_filter.words_view), as
    span tsm.verify: the slot and mask routes' verify, and the named
    engines'.  The cascade route does not take it: count_from_slots runs
    cuda_filter.verify_count_live, which builds no word view."""
    n = int(text.shape[0])
    with span("tsm.verify", device=text):
        tw = cuda_filter.words_view(text, words_len(n, ft.words))
        return verify_count(tw, idxs, ft, n_starts=n - ft.m + 1)


def count_from_slots(ft: FastTables, text, slots, ovf, *, cap: int):
    """The cascade's epilogue: compact its (R, 16) slots
    (cuda_filter.compact_rows), then verify the live candidates
    (cuda_filter.verify_count_live, under span tsm.verify): on the card
    two kernels that read the candidate count on the device, with no
    word view of the text and no host sync; on the CPU compact_valrows
    and verify_count.  Returns (count 0-d int32, overflow 0-d int32: more
    than cap candidates, or a row past its slots)."""
    with span("tsm.compact", device=slots) as sp:
        idxs, o, n_cand = cuda_filter.compact_rows(slots, ovf, cap=cap)
        if sp:
            sp.attrs["path"] = "cuda" if slots.is_cuda else "torch"
    with span("tsm.verify", device=text):
        return cuda_filter.verify_count_live(text, idxs, n_cand, ft), o


def count_from_sub_blocks(ft: FastTables, text, pos, counts, *, cap: int):
    """The slot route's epilogue: compact filter_slots' output, verify the
    candidates.  Returns (count 0-d int32, overflow 0-d int32)."""
    with span("tsm.compact", device=pos) as sp:
        idxs, o, _ = compact_slots(pos, counts, slots=BLOCK_SLOTS, cap=cap)
        if sp:
            sp.attrs["path"] = "torch"
    return verify_text(ft, text, idxs).to(torch.int32), o.to(torch.int32)


def compact_verify_retry(mask2d, tw, ft: FastTables, *, cap: int,
                         caprows: int, row_slots: int,
                         n_starts: int) -> tuple[int, bool]:
    """The sync ladder's trials over one mask: compact + verify at half the
    cap, then the full cap, then the full cap at 128 row slots (a
    match-dense row can exceed row_slots while the total fits), stopping at
    the first trial that does not overflow.  Each trial reads its result
    back.  Returns (count, overflowed) as python values."""
    caps = [cap // 2, cap] if cap >= 8192 else [cap]
    trials = [(tc, row_slots) for tc in caps] + [(cap, 128)]
    for trial_cap, rs in trials:
        idxs, o, _ = compact_mask(mask2d, caprows=min(caprows, trial_cap),
                                  cap=trial_cap, row_slots=rs)
        c = verify_count(tw, idxs, ft, n_starts=n_starts)
        co = torch.stack([c, o.to(torch.int64)]).tolist()
        if not co[1]:
            break
    return int(co[0]), bool(co[1])


# ---------------------------------------------------------------------------
# the portable tiled scan
# ---------------------------------------------------------------------------

def fast_count_core(text: torch.Tensor, ft: FastTables, *,
                    tile: int = DEFAULT_TILE, cap: int = DEFAULT_CAP,
                    guard: bool = False):
    """Tiled plain-torch scan: (count 0-d int32, overflowed 0-d int32).
    overflowed = 1 means some tile had more than `cap` candidates and the
    count may undercount; with tile <= cap that cannot happen.  guard=True
    drops exact-tier windows holding a byte >= sigma (the pad of
    distributed shards); the fingerprint tier verifies every window and
    needs no guard.  Runs on text's device, launches no kernel and never
    waits for the device."""
    dev = text.device
    n = int(text.shape[0])
    m = ft.m
    count = torch.zeros((), dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    if n < m:
        return count.to(torch.int32), overflow.to(torch.int32)
    n_valid = n - m + 1
    tile = min(tile, n_valid)        # counts do not depend on the tiling
    num_tiles = cdiv(n_valid, tile)
    padded = torch.zeros(num_tiles * tile + m - 1, dtype=torch.uint8,
                         device=dev)
    padded[:n] = text
    iota = torch.arange(tile, device=dev)
    n_st = ft.n_stages
    cd = ft.cd(n_st)
    smask = ft.stage_bits - 1
    for i in range(num_tiles):
        chunk = padded[i * tile:(i + 1) * tile + m - 1]
        valid = iota < min(n_valid - i * tile, tile)
        if ft.exact:
            count += (valid & cuda_filter.exact_hits(
                chunk, ft.bitmaps[0], m=m, sigma=ft.sigma,
                guard=guard)).sum()
            continue
        fps = [fp_keys(chunk, m, FP_MULTS[s]) for s in range(3)]
        cand = valid
        for s in range(n_st):
            C, D = cd[s]
            key = (fps[0] + C * fps[1] + D * fps[2]) & smask
            cand = cand & (bitmap_test(ft.bitmaps[s], key) == 1)
        overflow |= cand.sum() > cap
        idxs = nonzero_scatter(cand, cap, -1)
        tw = cuda_filter.words_view_plain(
            chunk, words_len(tile + m - 1, ft.words))
        count += verify_count(tw, idxs, ft, n_starts=tile)
    return count.to(torch.int32), overflow.to(torch.int32)


def _positions_piece_plain(piece: torch.Tensor, ft: FastTables, *,
                           cap: int):
    """Plain-torch positions of one fp-tier piece, for patterns longer than
    the kernels take (the JAX package's _positions_piece_xla, attr=True):
    (idxs (cap,) int64 matched starts then -1, internal pattern ids (cap,)
    int64 aligned with idxs, overflow 0-d bool).  Every start of the piece
    is owned; the caller offsets by the piece's base."""
    n = int(piece.shape[0])
    m = ft.m
    n_starts = n - m + 1
    k = stages_for(ft, n, cap)
    fps = [fp_keys(piece, m, FP_MULTS[s]) for s in range(3)]
    cand = torch.ones(n_starts, dtype=torch.bool, device=piece.device)
    for s, (C, D) in enumerate(ft.cd(k)):
        key = (fps[0] + C * fps[1] + D * fps[2]) & (ft.stage_bits - 1)
        cand &= bitmap_test(ft.bitmaps[s], key) == 1
    idxs = nonzero_scatter(cand, cap, -1)
    tw = cuda_filter.words_view_plain(piece, words_len(n, ft.words))
    matched, pid = verify_attr(tw, idxs, ft, n_starts=n_starts)
    return (torch.where(matched, idxs, -1), pid, cand.sum() > cap)


def _exact_attr(piece: torch.Tensor, idxs: torch.Tensor,
                wid_pids: torch.Tensor, *, m: int, sigma: int):
    """(cap,) int64 smallest original pattern id at each matched start of
    the exact tier (-1 padding): the packed window id recomputed at the
    match (m byte gathers over the matches only), looked up in the wid ->
    pid table."""
    live = idxs >= 0
    idc = idxs.clamp(0, max(int(piece.shape[0]) - m, 0))
    bits = bits_per_char(sigma)
    key = torch.zeros_like(idc)
    for i in range(m):
        key = (key << bits) | piece[idc + i].to(torch.int64)
    pid = wid_pids[key.clamp(0, int(wid_pids.shape[0]) - 1)].to(torch.int64)
    return torch.where(live, pid, -1)


def _hist_delta(pids: torch.Tensor, *, n_orig: int) -> torch.Tensor:
    """(n_orig,) int32 histogram of the non-negative pids (a per-piece
    delta; the -1 of unmatched slots land in a dropped trash bin)."""
    idx = torch.where(pids >= 0, pids, n_orig)
    out = torch.zeros(n_orig + 1, dtype=torch.int32, device=pids.device)
    return out.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32)
                            )[:n_orig]


def _exact_hist(text: torch.Tensor, wid_pids: torch.Tensor, *, m: int,
                sigma: int, n_orig: int) -> torch.Tensor:
    """(n_orig,) int32 per-pattern counts of the exact tier without
    enumerating matches: every window's id determines its pattern (or
    none), so the ids are histogrammed (torch.bincount, in pieces of
    cuda_filter.PLAIN_PIECE starts) and the counts pushed through the wid
    -> pid table.  The JAX package sorts the ids and searches the edges,
    its measured optimum on the TPU; the histogram is the same."""
    nb = int(wid_pids.shape[0])
    n_starts = int(text.shape[0]) - m + 1
    bits = bits_per_char(sigma)
    wc = torch.zeros(nb + 1, dtype=torch.int64, device=text.device)
    for s in range(0, n_starts, cuda_filter.PLAIN_PIECE):
        e = min(s + cuda_filter.PLAIN_PIECE, n_starts)
        keys = wid_keys(text[s:e + m - 1], m, bits)
        # ids past the table (bytes >= sigma) go to the trash bin nb
        wc += torch.bincount(keys.clamp(max=nb), minlength=nb + 1)
    bins = torch.where(wid_pids < 0, n_orig, wid_pids).to(torch.int64)
    hist = torch.zeros(n_orig + 1, dtype=torch.int64, device=text.device)
    return hist.scatter_add_(0, bins, wc[:nb])[:n_orig].to(torch.int32)


# ---------------------------------------------------------------------------
# the scanner
# ---------------------------------------------------------------------------

def _host_tensor(a) -> torch.Tensor:
    """A host array as a uint8 CPU tensor (a read-only one, such as a
    memory-mapped file's piece, is copied: torch tensors are writable)."""
    a = np.ascontiguousarray(a, np.uint8)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def device_text(text, device: torch.device, ndim: int = 1) -> torch.Tensor:
    """text (or, ndim=2, a batch of texts) as a contiguous uint8 tensor on
    `device`: a host array is copied there, a tensor elsewhere raises."""
    if isinstance(text, torch.Tensor):
        if text.device != device:
            raise ValueError(f"text on {text.device}, scanner on {device}")
        t = text
    else:
        t = _host_tensor(text).to(device)
    if t.dtype != torch.uint8 or t.dim() != ndim:
        raise TypeError(f"text must be {ndim}-D uint8, got {t.dtype} "
                        f"{tuple(t.shape)}")
    check_count32(int(t.numel()))
    return t.contiguous()


def enqueue_sum(scan, texts, device: torch.device):
    """(summed count, ORed overflow) of scan(t) -> (count, overflow) over
    `texts`, on the device, no host sync."""
    count = torch.zeros((), dtype=torch.int64, device=device)
    over = torch.zeros((), dtype=torch.int32, device=device)
    for t in texts:
        c, o = scan(t)
        count += c
        over |= o.to(torch.int32)
    return count, over


class ScanFuture:
    """Handle for an in-flight device scan: the (count, overflow) pair stays
    on the device until result().  On overflow result() runs the retry,
    which counts exactly.  `request`: the traced request of the scan's
    enqueue, which result()'s spans join."""

    __slots__ = ("_co", "_retry", "_request")

    def __init__(self, count_dev, overflow_dev, retry=None, request=None):
        self._co = torch.stack([count_dev.to(torch.int32),
                                overflow_dev.to(torch.int32)])
        self._retry = retry
        self._request = request

    def result(self) -> int:
        with span("tsm.readback", request=self._request):
            c, o = self._co.tolist()
        if o:
            if self._retry is None:
                raise OverflowError("candidate cap exceeded")
            with span("tsm.ladder", request=self._request):
                return self._retry()
        return int(c)


class FastScanner:
    """Shared fast backend on the tables' device; counts equal every
    engine's count (windows holding >= 1 pattern occurrence).

    Patterns of up to cuda_filter.MAX_KERNEL_M bytes take the kernels (the
    JAX package's Pallas backend; on the CPU their plain versions), longer
    ones the tiled fast_count_core (its xla backend)."""

    def __init__(self, ft: FastTables, *, tile: int = DEFAULT_TILE,
                 cap: int | None = None):
        self.ft = ft
        self.tile = tile
        self.cap = cap_for(ft) if cap is None else cap
        self.m = ft.m
        self.sigma = ft.sigma
        self.device = ft.device
        #: overflow retries taken (the JAX package's _retries): the
        #: adaptation below must make them stop
        self.fallback_scans = 0
        #: extra filter stages, bumped after a false-candidate overflow
        self._k_extra = 0
        #: async scans run the row-dense mask pass (_device_count_dense)
        #: after a match-driven overflow
        self._match_dense = False

    def _as_text(self, text, ndim: int = 1) -> torch.Tensor:
        return device_text(text, self.device, ndim)

    def _kernels(self) -> bool:
        return self.m <= cuda_filter.MAX_KERNEL_M

    # -- the async path: one enqueue, no host sync --------------------------

    def count(self, text) -> int:
        with span("tsm.count"):
            if self._kernels():
                return self.count_async(text).result()
            return self._count_retry(self._as_text(text))

    def count_async(self, text) -> ScanFuture:
        """Enqueue a scan; the count stays on the device until
        ScanFuture.result()."""
        with span("tsm.enqueue") as sp:
            t = self._as_text(text)
            c, o = self._async_scan()(t)
            return ScanFuture(c, o, retry=functools.partial(
                self._async_retry, t), request=sp.request)

    def _async_scan(self):
        """The scan count_async runs now: the dense pass after a
        match-driven retry, else the routed one."""
        if self._match_dense and self._kernels():
            return self._device_count_dense
        return self._device_count

    def _zero(self, text):
        return torch.zeros((), dtype=torch.int32, device=text.device)

    def _device_count(self, text):
        """(count, overflow) as device tensors, no host sync."""
        ft = self.ft
        if int(text.shape[0]) < ft.m:
            return self._zero(text), self._zero(text)
        if not self._kernels():
            return fast_count_core(text, ft, tile=self.tile, cap=self.cap)
        if ft.exact:
            return self._exact_count(text), self._zero(text)
        return self._fp_device_count(text)

    def _exact_count(self, text, guard: bool = False):
        """The exact tier's count (0-d int32 on the device), as span
        tsm.exact; its attribute `pairs` is 1 where the kernel took the
        pair path (cuda_filter.exact_pairs on the card), else 0."""
        ft = self.ft
        with span("tsm.exact") as sp:
            if sp:
                pairs = cuda_filter.exact_pairs(ft.m, bits_per_char(ft.sigma),
                                                int(ft.bitmaps[0].shape[0]))
                sp.attrs["pairs"] = int(text.is_cuda and pairs)
            return cuda_filter.exact_count(text, ft.bitmaps[0], m=ft.m,
                                           sigma=ft.sigma, guard=guard)

    def _pick_path(self, n, k):
        """Route an fp-tier scan among the slot route, the two-phase cascade
        and the mask pipeline: the cheapest of _route_costs.  Returns
        (path, k1, k_total)."""
        costs = self._route_costs(n, k)
        path = min(costs, key=lambda p: costs[p][0])
        return path, costs[path][1], costs[path][2]

    def _route_costs(self, n, k) -> dict:
        """{path: (cost, k1, k_total)} of every feasible fp route, by the
        JAX package's cost model in its bank-gather units (fitted on the
        TPU; kept until the port refits them): slot k_s*B + 8, mask
        k*B + 55, cascade k1*B + 11 + (kt-k1)*B/8 + 8, with B =
        stage_bits/4096.  The slot route needs slot_stages, the cascade a
        phase-1 split; the mask route is always feasible."""
        ft = self.ft
        nb = len(ft.bitmaps)
        B = ft.stage_bits // 4096
        costs = {"mask": (k * B + 55, None, k)}
        ks = slot_stages(ft, k)
        if ks is not None:
            ks = min(ks + self._k_extra, nb)
            costs["slot"] = (ks * B + 8, None, ks)
        k1 = k1_for(ft)
        if k1 is not None and nb >= 2:
            k1 = max(1, min(k1 + self._k_extra, nb - 1))
            kt = min(max(k, k1 + 1), nb)
            if kt > k1:
                costs["cascade"] = (k1 * B + 11 + (kt - k1) * B / 8 + 8,
                                    k1, kt)
        return costs

    def _fp_device_count(self, text):
        """(count, overflow) of the routed fp-tier scan, no host sync.  Any
        overflow (cap, sub-block slots, cascade rows, mask rows) is in the
        flag; the future's retry then counts exactly."""
        n = int(text.shape[0])
        with span("tsm.route") as sp:
            path, k1, kt = self._pick_path(n, stages_for(self.ft, n,
                                                         self.cap))
            if sp:
                sp.attrs.update(path=path, k1=k1, kt=kt,
                                bits=self.ft.stage_bits)
        return self._route_count(text, path, k1, kt)

    def _route_count(self, text, path, k1, kt):
        """(count, overflow) of one fp route with its stage counts (as
        _route_costs gives them), no host sync."""
        ft = self.ft
        if path == "cascade":
            with span("tsm.filter"):
                slots, ovf = cuda_filter.cascade(text, ft.bitmaps[:kt],
                                                 m=ft.m, k1=k1, cd=ft.cd(kt))
            return count_from_slots(ft, text, slots, ovf, cap=self.cap)
        if path == "slot":
            with span("tsm.filter"):
                pos, counts = cuda_filter.filter_slots(
                    text, ft.bitmaps[:kt], m=ft.m, cd=ft.cd(kt))
            return count_from_sub_blocks(ft, text, pos, counts, cap=self.cap)
        c, o = self._mask_verify(
            text, kt, caprows=min(self.cap, max(CAPROWS, 1 << 17)),
            row_slots=ROW_SLOTS)
        return c.to(torch.int32), o.to(torch.int32)

    def _mask_verify(self, piece, k, *, caprows, row_slots, matched=False):
        """The mask pipeline: filter_mask -> compact_mask -> word view ->
        exact verify, no host sync.  matched=False: (count 0-d int64,
        overflow 0-d bool); matched=True: (idxs (cap,) int64 candidate
        starts then -1, per-candidate match mask, per-candidate internal
        pattern id or -1, overflow)."""
        ft = self.ft
        n = int(piece.shape[0])
        with span("tsm.filter"):
            mask2d = cuda_filter.filter_mask(piece, ft.bitmaps[:k], m=ft.m,
                                             cd=ft.cd(k))
        with span("tsm.compact", device=mask2d) as sp:
            idxs, o, _ = compact_mask(mask2d,
                                      caprows=min(caprows, mask2d.shape[0]),
                                      cap=self.cap, row_slots=row_slots)
            if sp:
                sp.attrs["path"] = "torch"
        if not matched:
            return verify_text(ft, piece, idxs), o
        with span("tsm.verify", device=piece):
            tw = cuda_filter.words_view(piece, words_len(n, ft.words))
            r, pid = verify_attr(tw, idxs, ft, n_starts=n - ft.m + 1)
        return idxs, r, pid, o

    def _device_count_dense(self, text):
        """The row-dense mask pass (kernels only): full cap and 128 row
        slots on pieces of <= max(cap/2, 2^17) starts, which then cannot
        overflow at <= cap/4 starts; bigger scans bound the extraction at
        min(cap, 2^17) rows x 16 slots.  The steady pass of a match-dense
        scanner and the piece scan of the sync ladder."""
        ft = self.ft
        n = int(text.shape[0])
        if n < ft.m:
            return self._zero(text), self._zero(text)
        if ft.exact:
            return self._exact_count(text), self._zero(text)
        k = stages_for(ft, n, self.cap)
        small = n - ft.m + 1 <= max(self.cap // 2, 1 << 17)
        c, o = self._mask_verify(
            text, k, caprows=self.cap if small else min(self.cap, 1 << 17),
            row_slots=128 if small else 16)
        return c.to(torch.int32), o.to(torch.int32)

    # -- the sync ladder: each step reads its result back -------------------

    def count_with_overflow(self, text) -> tuple[int, bool]:
        """(count, overflowed) of the synchronous path, no adaptation: the
        mask pipeline with its cap trials (fast_count_core beyond the
        kernels' m)."""
        t = self._as_text(text)
        if self._kernels():
            return self._count_pallas(t)
        c, o = fast_count_core(t, self.ft, tile=self.tile, cap=self.cap)
        return int(c), bool(o)

    def _count_pallas(self, text) -> tuple[int, bool]:
        ft = self.ft
        n = int(text.shape[0])
        if n < ft.m:
            return 0, False
        if ft.exact:
            return int(self._exact_count(text)), False
        k = stages_for(ft, n, self.cap)
        if n * ft.density ** k > self.cap / 4 and k >= len(ft.bitmaps):
            # every built stage together still misses the candidate budget
            # (saturated tables): the dense pass over pieces sized to it
            return self._count_chunked(text), False
        return self._count_pallas_whole(text, k)

    def _count_pallas_whole(self, text, k) -> tuple[int, bool]:
        ft = self.ft
        n = int(text.shape[0])
        mask2d = cuda_filter.filter_mask(text, ft.bitmaps[:k], m=ft.m,
                                         cd=ft.cd(k))
        tw = cuda_filter.words_view(text, words_len(n, ft.words))
        return compact_verify_retry(mask2d, tw, ft, cap=self.cap,
                                    caprows=CAPROWS, row_slots=ROW_SLOTS,
                                    n_starts=n - ft.m + 1)

    def _count_retry(self, text) -> int:
        """The synchronous path: the cap trials, then budget-sized pieces
        if every trial overflowed.  Counts are total functions of the
        input, never an error about its density."""
        c, o = self.count_with_overflow(text)
        if o:
            return self._count_chunked(text)
        return c

    def _count_chunked(self, text) -> int:
        """Exact count of the dense core over (m-1)-halo pieces sized to
        the candidate budget of the built stages (one piece unless the
        tables are saturated), split on overflow (common.split_pieces);
        pieces of <= cap/4 starts cannot overflow (the dense pass runs them
        at the full cap and 128 row slots)."""
        n = int(text.shape[0])
        m = self.m
        fn = self._dense_core()
        dk = self.ft.density ** stages_for(self.ft, n, self.cap)
        piece = int(max((self.cap / 4) / max(dk, 1e-12), self.cap // 2))

        def launch(start, owned):
            return torch.stack(fn(text[start:min(start + owned + m - 1, n)]))

        work = cut_pieces(0, n - m + 1, piece)
        return sum(c for _, _, c in split_pieces(
            work, launch, finish_pair, min_chunk=max(self.cap // 4, 1)))

    def _async_retry(self, text) -> int:
        """ScanFuture's overflow fallback: count exactly through the sync
        ladder, then adapt so later scans stop overflowing:

        - match-driven (mean matches per 16,384-start sub-block above
          BLOCK_SLOTS/4, where the Poisson tail overflows some sub-block of
          every large scan): switch async scans to the dense pass;
        - false-candidate-driven: one more filter stage (at most 4);
        - otherwise (stages exhausted, or too many matches for the cap
          margin): the dense pass too, so no scan retries forever."""
        self.fallback_scans += 1
        c = self._count_retry(text)
        if self.ft.exact:
            return c
        n_starts = max(1, int(text.shape[0]) - self.m + 1)
        mean_per_block = c * SLOT_BLOCK / n_starts
        if mean_per_block > BLOCK_SLOTS // 4:
            self._match_dense = True
        elif c <= self.cap // 4 and self._k_extra < 4:
            self._k_extra += 1
        else:
            self._match_dense = True
        return c

    # -- batches, repeats and the distribution core -------------------------

    def scan_many(self, texts) -> list[int]:
        """Counts of a batch of texts, pipelined: every scan is enqueued
        before any result is read."""
        return [f.result() for f in [self.count_async(t) for t in texts]]

    def count_repeat_async(self, text, reps: int) -> ScanFuture:
        """The same text scanned `reps` times back to back, all enqueued
        with no host sync in between; the future holds the summed count
        and the ORed overflow flag and has no retry (as in the JAX
        package).  The timing primitive: (t(reps) - t(1)) / (reps - 1) is
        one scan's device time."""
        with span("tsm.enqueue") as sp:
            t = self._as_text(text)
            return ScanFuture(*self._enqueue_sum([t] * reps),
                              request=sp.request)

    def count_stack_async(self, batch) -> ScanFuture:
        """Total count of a (k, nsh) batch of equal-length texts: the rows'
        scans enqueued back to back and summed on the device.  An overflow
        retries through scan_many (exact)."""
        with span("tsm.enqueue") as sp:
            b = self._as_text(batch, ndim=2)
            return ScanFuture(*self._enqueue_sum(list(b)),
                              retry=lambda: sum(self.scan_many(list(b))),
                              request=sp.request)

    def _enqueue_sum(self, texts):
        """enqueue_sum of the scans count_async runs now."""
        return enqueue_sum(self._async_scan(), texts, self.device)

    def count_stack(self, batch) -> int:
        """The sum of count() over the batch's rows (count_stack_async)."""
        return self.count_stack_async(batch).result()

    def core(self, ext):
        """Per-shard (count 0-d int32, overflow 0-d int32) on the device,
        no host sync: what distribution sums over shards.  Shards and
        halos may be padded with the out-of-alphabet byte sigma, so the
        exact tier runs the guarded count; the fingerprint tier verifies
        every window and runs its routed scan.  Patterns beyond the
        kernels take the tiled core, guarded."""
        t = self._as_text(ext)
        ft = self.ft
        if not self._kernels():
            return fast_count_core(t, ft, tile=self.tile, cap=self.cap,
                                   guard=True)
        if int(t.shape[0]) < ft.m:
            return self._zero(t), self._zero(t)
        if ft.exact:
            return self._exact_count(t, guard=True), self._zero(t)
        return self._fp_device_count(t)

    def _dense_core(self):
        """The per-piece (count, overflow) scan that cannot overflow on
        pieces of <= cap/4 starts: the row-dense mask pass on the kernels
        (their plain versions on the CPU), the tiled fast_count_core beyond
        MAX_KERNEL_M.  The distributed ladder (parallel/dist.py) builds its
        per-shard passes from it."""
        if self._kernels():
            return self._device_count_dense
        return functools.partial(fast_count_core, ft=self.ft,
                                 tile=self.tile, cap=self.cap)

    # -- streaming -----------------------------------------------------------

    def count_file(self, path: str, *, chunk: int = 1 << 28,
                   depth: int = 3) -> int:
        """Count of a pre-encoded corpus file, streamed in `chunk`-byte
        (m-1)-halo pieces, `depth` in flight (common.stream_count_file)."""
        return stream_count_file(self.count_async, self.m, path,
                                 chunk=chunk, depth=depth)

    def positions_file(self, path: str, *,
                       chunk: int = 1 << 28) -> np.ndarray:
        """Sorted int64 match starts of a pre-encoded corpus file, streamed
        in `chunk`-byte (m-1)-halo pieces (common.stream_positions_file)."""
        return stream_positions_file(self.positions, self.m, path,
                                     chunk=chunk)

    # -- positions and attribution ------------------------------------------

    def _need_attr_tables(self, what: str) -> None:
        """Attribution runs on the tables' device only: tables without the
        pattern-id arrays (build_fast always makes them) raise."""
        ft = self.ft
        if not ft.n_orig or (ft.wid_pids is None if ft.exact
                             else ft.orig_ids is None):
            raise ValueError(f"{what}() needs tables with attribution "
                             "(n_orig and wid_pids / orig_ids): build them "
                             "with build_fast")

    def _positions_piece(self, piece):
        """(idxs (cap,) int64 matched starts then -1, overflow 0-d bool)
        over every start of `piece`, no host sync.  Exact tier: exact_mask
        -> compact_mask; fingerprint tier: the mask pipeline with
        attribution."""
        ft = self.ft
        if ft.exact:
            mask2d = cuda_filter.exact_mask(piece, ft.bitmaps[0], m=ft.m,
                                            sigma=ft.sigma)
            # matches (not candidates) can fill a row: 128 row slots; the
            # piece's own row count bounds caprows
            idxs, o, _ = compact_mask(mask2d,
                                      caprows=min(self.cap, mask2d.shape[0]),
                                      cap=self.cap, row_slots=128)
            return idxs, o
        idxs, _, o = self._fp_piece(piece)
        return idxs, o

    def _fp_piece(self, piece):
        """(idxs, internal pids, overflow) of the fingerprint tier's
        matches in `piece`: the mask pipeline with attribution, or the
        plain piece for patterns longer than the kernels take."""
        ft = self.ft
        if not self._kernels():
            return _positions_piece_plain(piece, ft, cap=self.cap)
        k = stages_for(ft, int(piece.shape[0]), self.cap)
        idxs, matched, pid, o = self._mask_verify(
            piece, k, caprows=self.cap, row_slots=128, matched=True)
        return torch.where(matched, idxs, -1), pid, o

    def _attr_piece(self, piece):
        """(idxs, ORIGINAL pattern ids aligned with idxs (-1 padding),
        overflow) of `piece`'s matches, no host sync."""
        ft = self.ft
        if ft.exact:
            idxs, o = self._positions_piece(piece)
            return idxs, _exact_attr(piece, idxs, ft.wid_pids, m=ft.m,
                                     sigma=ft.sigma), o
        idxs, pid, o = self._fp_piece(piece)
        orig = ft.orig_ids[pid.clamp(min=0)].to(torch.int64)
        return idxs, torch.where(pid >= 0, orig, -1), o

    def _drive(self, t, piece_fn, on_piece, *, chunk=None, depth: int = 4,
               to_host: bool = True):
        """Positions and attribution through the split-on-overflow piece
        pipeline (common.split_pieces).  Pieces of owned starts (plus the
        m-1 halo) go through piece_fn (device outputs..., overflow); pieces
        of <= cap/2 starts cannot overflow.  The pieces start presized to
        chunk= starts, or as the whole text: if that overflows, its pieces
        are sized from its match density (one count()) and then halved on
        overflow.  on_piece(start, *outputs) gets every piece that did not
        overflow, its outputs as numpy (read back with the flag, one read
        per piece) or, with to_host=False, as device tensors (only the flag
        is read)."""
        n = int(t.shape[0])
        m = self.m
        total = n - m + 1
        min_chunk = max(self.cap // 2, 1)

        def launch(start, owned):
            *outs, o = piece_fn(t[start:min(start + owned + m - 1, n)])
            read = (*outs, o) if to_host else (o,)
            return outs, torch.cat([x.to(torch.int64).reshape(-1)
                                    for x in read])

        def finish(handle):
            outs, flat = handle
            flat = flat.cpu().numpy()
            if to_host:
                outs = np.split(flat[:-1],
                                np.cumsum([x.numel() for x in outs])[:-1])
            return bool(flat[-1]), outs

        size = total if chunk is None else max(int(chunk), min_chunk)
        if size >= total > min_chunk:
            overflowed, outs = finish(launch(0, total))
            if not overflowed:
                on_piece(0, *outs)
                return
            size = max(min_chunk, min(-(-total // 2), (self.cap // 2) * total
                                      // max(self.count(t), 1)))
        for start, _, outs in split_pieces(
                cut_pieces(0, total, size), launch, finish,
                min_chunk=min_chunk, depth=depth):
            on_piece(start, *outs)

    def positions(self, text, *, chunk: int | None = None,
                  depth: int = 4) -> np.ndarray:
        """Sorted int64 start positions of ALL matching windows, unbounded:
        the text is scanned in (m-1)-halo pieces, `depth` in flight, and a
        piece whose matches exceed the device cap is split and scanned
        again (_drive).  chunk= presizes the pieces (in starts) where the
        density is known."""
        t = self._as_text(text)
        if int(t.shape[0]) < self.m:
            return np.empty((0,), np.int64)
        out = []

        def on_piece(start, idxs):
            idxs = idxs[idxs >= 0]
            if idxs.size:
                out.append((start, idxs + start))

        self._drive(t, self._positions_piece, on_piece, chunk=chunk,
                    depth=depth)
        return _in_text_order(out)[0]

    def matches(self, text):
        """(positions (n,) int64 sorted, pattern_ids (n,) int64): every
        match start and the ORIGINAL id of its pattern (the smallest id of
        byte-identical duplicates), attributed on the device by the verify
        stage (fp tier) or the wid -> pid table (exact tier)."""
        self._need_attr_tables("matches")
        t = self._as_text(text)
        if int(t.shape[0]) < self.m:
            return np.empty((0,), np.int64), np.empty((0,), np.int64)
        out = []

        def on_piece(start, idxs, pids):
            live = idxs >= 0
            if live.any():
                out.append((start, idxs[live] + start, pids[live]))

        self._drive(t, self._attr_piece, on_piece)
        return _in_text_order(out, 2)

    def count_per_pattern(self, text) -> np.ndarray:
        """(p,) int64 match-start counts per original pattern, summed on
        the device; they sum to count(text), and duplicates credit the
        smallest id.  A match-dense exact-tier text (count > cap/2) is
        histogrammed by window id (_exact_hist) instead of enumerated in
        cap-sized pieces."""
        self._need_attr_tables("count_per_pattern")
        t = self._as_text(text)
        ft = self.ft
        n_orig = ft.n_orig
        if ft.exact and int(t.shape[0]) >= ft.m \
                and self.count(t) > self.cap // 2:
            return _exact_hist(t, ft.wid_pids, m=ft.m, sigma=ft.sigma,
                               n_orig=n_orig).cpu().numpy().astype(np.int64)
        acc = torch.zeros(n_orig, dtype=torch.int32, device=t.device)

        def piece_hist(piece):
            _, pids, o = self._attr_piece(piece)
            return _hist_delta(pids, n_orig=n_orig), o

        def on_piece(start, delta):
            acc.add_(delta)

        if int(t.shape[0]) >= self.m:
            self._drive(t, piece_hist, on_piece, to_host=False)
        return acc.cpu().numpy().astype(np.int64)


def _in_text_order(pieces, n_out: int = 1):
    """Concatenate the per-piece arrays of _drive's pieces in text order.
    Pieces own disjoint start ranges and each lists its starts in order,
    so ordering the pieces by start sorts the whole (no element sort)."""
    pieces = sorted(pieces, key=lambda p: p[0])
    if not pieces:
        return tuple(np.empty((0,), np.int64) for _ in range(n_out))
    return tuple(np.concatenate([p[1 + i] for p in pieces])
                 for i in range(n_out))

