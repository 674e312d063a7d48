"""The fast path's kernels: wrappers around the CUDA sources in csrc/,
each beside its plain PyTorch version.  They replace the TPU kernels of
tpu_smatcher/ops/pallas_filter.py:

  exact_count   csrc/exact_count.cu  _exact_flat_kernel (:886), and with
                                     guard=True _exact_kernel (:202)
  exact_mask    csrc/exact_count.cu  _exact_mask_kernel (:220)
  cascade       csrc/cascade.cu      _cascade_kernel (:758)
  filter_mask   csrc/filter.cu       _filter_mask_flat_kernel (:1052)
  filter_slots  csrc/filter.cu       _filter_slots_flat_kernel (:559)
  words_view    csrc/words.cu        _words_kernel (:1011), and the word
                                     views the slot and cascade kernels
                                     fuse on the TPU

and two kernels replace no TPU kernel, the cascade route's epilogue (XLA
code on the TPU, tpu_smatcher/ops/fast.py:compact_valrows and
verify_chunked):

  compact_rows       csrc/compact.cu  ops/compaction.compact_valrows on
                                      the cascade's (R, 16) slots
  verify_count_live  csrc/verify.cu   ops/verify.verify_count over the
                                      word view, on compact_rows' output

A wrapper given a CUDA tensor launches its kernel (or raises); given a CPU
tensor it runs the plain version, which has the same signature and the same
outputs bit for bit.  LAUNCHES counts kernel launches per TPU kernel
replaced (the guarded exact count apart from the unguarded one; the named
engines' stage chain, ops/cuda_engines.stages, counts here too), so a run
can show that its main path went through the kernels.  EPILOGUE_LAUNCHES
counts the epilogue wrappers' calls on the card under the function each
replaces ("verify" for verify_count), apart from LAUNCHES, whose sum
bench_torch/trace.py and chip_smoke.py hold against a profile's device
events of the TPU kernels' counterparts (their __global__ names; the
epilogue's, compact_rows_count_kernel, compact_rows_kernel and
live_verify_kernel, are not among them).
"""

from __future__ import annotations

import ctypes

import torch

from tpu_smatcher_torch.ops.common import bits_per_char, cdiv
from tpu_smatcher_torch.ops.compaction import compact_valrows
from tpu_smatcher_torch.ops.keys import FP_MULTS, fp_keys, max_keys, wid_keys
from tpu_smatcher_torch.ops.lookup import bitmap_test
from tpu_smatcher_torch.ops.verify import verify_count, words_len

#: starts per row of the cascade's compaction and of the filter mask, and
#: survivors the cascade keeps per row
ROW = 128
ROW_SLOTS = 16
#: starts per slot-route sub-block (pallas_filter.SLOT_RB * 128), and the
#: candidates kept per sub-block (pallas_filter.BLOCK_SLOTS)
SUB_BLOCK = 128 * 128
BLOCK_SLOTS = 16
#: longest pattern the kernels take (MAX_FAST_M of the JAX fast path)
MAX_KERNEL_M = 4097
#: slot rows per tile of csrc/compact.cu (512 threads x 8 16-byte loads)
COMPACT_TILE_ROWS = 1024
#: starts per piece of the plain versions (bounds their temporaries; a
#: multiple of ROW and SUB_BLOCK so pieces keep row and sub-block boundaries)
PLAIN_PIECE = 1 << 24

#: kernel launches per wrapper (plain-version calls are not counted)
LAUNCHES = {"exact_count": 0, "exact_count_guard": 0, "exact_mask": 0,
            "cascade": 0, "filter_mask": 0, "filter_slots": 0,
            "words_view": 0, "stages": 0, "stages_flat": 0}
#: calls on the card of the wrappers that replace no TPU kernel, by the
#: function each replaces
EPILOGUE_LAUNCHES = {"compact_valrows": 0, "verify": 0}
#: exact_count and exact_mask launches by the path their kernel took:
#: "pairs" (one lookup in the pair table for two starts) or "bitmap" (one
#: bitmap lookup a start); apart from LAUNCHES
EXACT_PATHS = {"pairs": 0, "bitmap": 0}
#: widest (m+1)-gram id, in bits, for which csrc/exact_count.cu builds its
#: pair table (2^18 entries of 2 bits: 64 KB of shared memory)
PAIR_BITS = 18


def _check(text: torch.Tensor, tables: torch.Tensor, tables_ndim: int):
    if text.dtype != torch.uint8 or text.dim() != 1:
        raise TypeError(f"text must be 1-D uint8, got {text.dtype} "
                        f"{tuple(text.shape)}")
    if tables.dtype != torch.int32 or tables.dim() != tables_ndim:
        raise TypeError(f"bitmap must be {tables_ndim}-D int32, got "
                        f"{tables.dtype} {tuple(tables.shape)}")
    if tables.device != text.device:
        raise ValueError(f"text on {text.device}, bitmap on {tables.device}")
    if not (text.is_contiguous() and tables.is_contiguous()):
        raise ValueError("text and bitmap must be contiguous")
    if text.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {text.device}")


def _launch_args(t: torch.Tensor):
    from tpu_smatcher_torch import _build
    stream = torch.cuda.current_stream(t.device).cuda_stream
    return _build.load(), t.device.index or 0, ctypes.c_void_p(stream)


def _cd_host(cd, k):
    """The first k (C, D) stage pairs as a host array of 2k uint32, (C_0,
    D_0, C_1, D_1, ...), as the kernels' load_cd reads them."""
    return ctypes.cast((ctypes.c_uint32 * (2 * k))(
        *(int(v) for c, d in cd[:k] for v in (c, d))), ctypes.c_void_p)


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


# ---------------------------------------------------------------------------
# kernel 1: exact tier (count with or without the pad guard, and the mask)
# ---------------------------------------------------------------------------

def _check_exact(text, bitmap, m, sigma):
    _check(text, bitmap, 1)
    bits = bits_per_char(sigma)
    if m * bits > 16:
        raise ValueError(f"exact tier needs m*bits <= 16, got m={m} "
                         f"bits={bits}")
    return bits


def exact_pairs(m: int, bits: int, nwords: int) -> bool:
    """Whether csrc/exact_count.cu takes its pair path at these shapes
    (its pairs_fit): the (m+1)-gram ids fit PAIR_BITS bits and the bitmap
    of nwords words covers every window id."""
    return bits * (m + 1) <= PAIR_BITS and nwords * 32 >= 1 << (m * bits)


def _count_path(m, bits, bitmap):
    EXACT_PATHS["pairs" if exact_pairs(m, bits, int(bitmap.shape[0]))
                else "bitmap"] += 1


def exact_count(text: torch.Tensor, bitmap: torch.Tensor, *, m: int,
                sigma: int, guard: bool = False) -> torch.Tensor:
    """Number of starts i < n-m+1 whose packed window id hits `bitmap`
    ((nbits/32,) int32, nbits = max(4096, 2^(m*bits))), as a 0-d int32
    tensor on text's device.  guard=True drops windows holding a byte >=
    sigma (the pad symbol of distributed shards); guard=False is defined
    on in-alphabet text only (the TPU kernel sums shifted bytes where this
    ORs them)."""
    bits = _check_exact(text, bitmap, m, sigma)
    if text.device.type == "cpu":
        return exact_count_plain(text, bitmap, m=m, sigma=sigma, guard=guard)
    out = torch.zeros((), dtype=torch.int32, device=text.device)
    n = int(text.shape[0])
    if n < m:
        return out
    lib, dev, stream = _launch_args(text)
    rc = lib.tsm_exact_count(text.data_ptr(), n, m, bits, sigma, int(guard),
                             bitmap.data_ptr(), int(bitmap.shape[0]),
                             out.data_ptr(), dev, stream)
    name = "exact_count_guard" if guard else "exact_count"
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    _count_path(m, bits, bitmap)
    return out


def exact_hits(chunk: torch.Tensor, bitmap: torch.Tensor, *, m: int,
               sigma: int, guard: bool) -> torch.Tensor:
    """(len(chunk)-m+1,) bool: each start's window id hits bitmap (and,
    with guard, the window holds no byte >= sigma); the plain versions'
    shared step."""
    nbits = int(bitmap.shape[0]) * 32
    keys = wid_keys(chunk, m, bits_per_char(sigma))
    hit = ((bitmap_test(bitmap, keys.clamp(max=nbits - 1)) == 1)
           & (keys < nbits))
    if guard:
        hit &= max_keys(chunk, m) < sigma
    return hit


def exact_count_plain(text: torch.Tensor, bitmap: torch.Tensor, *, m: int,
                      sigma: int, guard: bool = False) -> torch.Tensor:
    """Plain torch version of exact_count (any device)."""
    n_starts = max(0, int(text.shape[0]) - m + 1)
    total = torch.zeros((), dtype=torch.int64, device=text.device)
    for s in range(0, n_starts, PLAIN_PIECE):
        e = min(s + PLAIN_PIECE, n_starts)
        total += exact_hits(text[s:e + m - 1], bitmap, m=m, sigma=sigma,
                            guard=guard).sum()
    return total.to(torch.int32)


def exact_pair_table_plain(bitmap: torch.Tensor, m: int,
                           bits: int) -> torch.Tensor:
    """The pair table csrc/exact_count.cu builds from the bitmap when
    exact_pairs holds: for each (m+1)-gram id g of gb = bits*(m+1) bits, bit
    0 = bitmap bit g >> bits (the window at the gram's first byte) and bit
    1 = bitmap bit g mod 2^(m*bits) (the window one byte on), 16 entries a
    word (entry g at bits 2*(g % 16) of word g // 16), as (max(1,
    2^(gb-4)),) int32; a table of fewer than 16 entries repeats them (entry
    e holds entry e mod 2^gb)."""
    gb = bits * (m + 1)
    g = torch.arange(max(16, 1 << gb), device=bitmap.device) % (1 << gb)
    entry = bitmap_test(bitmap, g >> bits) \
        | bitmap_test(bitmap, g % (1 << (m * bits))) << 1
    shifts = 2 * torch.arange(16, device=bitmap.device)
    words = (entry.view(-1, 16) << shifts).sum(dim=1)        # below 2^32
    return (words - ((words >> 31) << 32)).to(torch.int32)


def exact_pair_count_plain(text: torch.Tensor, table: torch.Tensor, *,
                           m: int, sigma: int,
                           guard: bool = False) -> torch.Tensor:
    """exact_count_plain's count read through the pair table as the pair
    path's clean runs read it: one entry for starts 2k and 2k+1, at the
    (m+1)-gram of bytes 2k .. 2k+m (a zero byte past the text's end).
    Text of bytes below 2^bits (the pair path's other runs take the bitmap
    a start); plain torch, any device, one piece."""
    bits = bits_per_char(sigma)
    n_starts = max(0, int(text.shape[0]) - m + 1)
    ext = torch.cat([text, text.new_zeros(1)])
    g = wid_keys(ext, m + 1, bits)[:n_starts:2]
    entry = (table.to(torch.int64)[g >> 4] >> (2 * (g & 15))) & 3
    hit = torch.stack([entry & 1, entry >> 1], dim=1).reshape(-1)[:n_starts]
    if guard:
        hit = hit & (max_keys(text, m) < sigma)
    return hit.sum().to(torch.int32)


def exact_mask(text: torch.Tensor, bitmap: torch.Tensor, *, m: int,
               sigma: int) -> torch.Tensor:
    """Per-start match mask of the exact tier, pad-guarded:
    (ceil((n-m+1)/128), 128) int8, 1 where the window id hits `bitmap` and
    the window holds no byte >= sigma, 0 elsewhere and at starts >= n-m+1
    (filter_mask's layout).  Requires n >= m.  On the card, one launch of
    csrc/exact_count.cu's mask mode: a thread owns 32 consecutive starts,
    rolls their window ids and ANDs the guard's mask of the bytes >= sigma
    entering their windows, and stores the 32 results as two 16-byte
    writes, every row written; a text at any address (a positions piece)
    is staged from the 16-byte aligned address below it."""
    bits = _check_exact(text, bitmap, m, sigma)
    n = int(text.shape[0])
    if not 1 <= m <= n:
        raise ValueError(f"need 1 <= m <= n; m={m} n={n}")
    if text.device.type == "cpu":
        return exact_mask_plain(text, bitmap, m=m, sigma=sigma)
    rows = cdiv(n - m + 1, ROW)
    mask = torch.empty((rows, ROW), dtype=torch.int8, device=text.device)
    lib, dev, stream = _launch_args(text)
    rc = lib.tsm_exact_mask(text.data_ptr(), n, m, bits, sigma,
                            bitmap.data_ptr(), int(bitmap.shape[0]),
                            mask.data_ptr(), rows, dev, stream)
    _raise_on(rc, "exact_mask")
    LAUNCHES["exact_mask"] += 1
    _count_path(m, bits, bitmap)
    return mask


def exact_mask_plain(text: torch.Tensor, bitmap: torch.Tensor, *, m: int,
                     sigma: int) -> torch.Tensor:
    """Plain torch version of exact_mask (any device)."""
    n = int(text.shape[0])
    n_starts = n - m + 1
    rows = cdiv(n_starts, ROW)
    mask = torch.empty(rows * ROW, dtype=torch.int8, device=text.device)
    for s in range(0, rows * ROW, PLAIN_PIECE):
        width = min(PLAIN_PIECE, rows * ROW - s)
        chunk = torch.zeros(width + m - 1, dtype=torch.uint8,
                            device=text.device)
        chunk[:min(width + m - 1, n - s)] = text[s:s + width + m - 1]
        pos = torch.arange(s, s + width, device=text.device)
        mask[s:s + width] = exact_hits(chunk, bitmap, m=m, sigma=sigma,
                                       guard=True) & (pos < n_starts)
    return mask.view(rows, ROW)


# ---------------------------------------------------------------------------
# kernel 2: two-phase fingerprint cascade
# ---------------------------------------------------------------------------

def cascade(text: torch.Tensor, bitmaps: torch.Tensor, *, m: int, k1: int,
            cd: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 = stages [0, k1) over every start, per-row compaction of the
    first ROW_SLOTS survivors, phase 2 = stages [k1, kt) on those.

    bitmaps: (kt, stage_bits/32) int32, one stage per row; cd: kt (C, D)
    pairs.  Returns (slots (ceil((n-m+1)/128), 16) int32 positions, -1 where
    empty or rejected by phase 2; ovf 0-d int32, 1 iff some row had more
    than 16 phase-1 survivors).  Requires n >= m."""
    _check(text, bitmaps, 2)
    kt = int(bitmaps.shape[0])
    stage_bits = int(bitmaps.shape[1]) * 32
    n = int(text.shape[0])
    if not 0 < k1 < kt or len(cd) < kt:
        raise ValueError(f"need 0 < k1 < kt and kt (C, D) pairs; got k1={k1}"
                         f" kt={kt} len(cd)={len(cd)}")
    if stage_bits & (stage_bits - 1):
        raise ValueError(f"stage_bits must be a power of two: {stage_bits}")
    if not 1 <= m <= min(n, MAX_KERNEL_M):
        raise ValueError(f"need 1 <= m <= min(n, {MAX_KERNEL_M}); m={m} "
                         f"n={n}")
    if text.device.type == "cpu":
        return cascade_plain(text, bitmaps, m=m, k1=k1, cd=cd)
    rows = cdiv(n - m + 1, ROW)
    slots = torch.empty((rows, ROW_SLOTS), dtype=torch.int32,
                        device=text.device)
    ovf = torch.zeros((), dtype=torch.int32, device=text.device)
    lib, dev, stream = _launch_args(text)
    rc = lib.tsm_cascade(text.data_ptr(), n, m, bitmaps.data_ptr(), kt,
                         stage_bits, k1, _cd_host(cd, kt), slots.data_ptr(),
                         rows, ovf.data_ptr(), dev, stream)
    _raise_on(rc, "cascade")
    LAUNCHES["cascade"] += 1
    return slots, ovf


def _stage_hits(fps, bitmaps, cd, stages, smask):
    """AND of the bit tests of `stages` on the derived keys of fps."""
    hit = None
    for s in stages:
        C, D = cd[s]
        key = (fps[0] + C * fps[1] + D * fps[2]) & smask
        h = bitmap_test(bitmaps[s], key) == 1
        hit = h if hit is None else hit & h
    return hit


def cascade_plain(text: torch.Tensor, bitmaps: torch.Tensor, *, m: int,
                  k1: int, cd: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of cascade (any device): ranks each row's
    survivors with a cumsum and scatters the first ROW_SLOTS into place.
    Phase 2 is tested densely; only the survivors' result is kept."""
    kt = int(bitmaps.shape[0])
    smask = int(bitmaps.shape[1]) * 32 - 1
    n = int(text.shape[0])
    n_starts = n - m + 1
    rows = cdiv(n_starts, ROW)
    dev = text.device
    slots = torch.empty((rows, ROW_SLOTS), dtype=torch.int32, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    for s in range(0, n_starts, PLAIN_PIECE):
        e = min(s + PLAIN_PIECE, n_starts)
        width = cdiv(e - s, ROW) * ROW
        chunk = torch.zeros(width + m - 1, dtype=torch.uint8, device=dev)
        chunk[:min(width + m - 1, n - s)] = text[s:s + width + m - 1]
        fps = [fp_keys(chunk, m, mult) for mult in FP_MULTS[:3]]
        pos = torch.arange(s, s + width, device=dev)
        cand = _stage_hits(fps, bitmaps, cd, range(k1), smask) & (pos < e)
        cand = cand.view(-1, ROW)
        rank = torch.cumsum(cand, dim=1) - 1
        ovf |= (rank[:, -1] >= ROW_SLOTS).any()
        keep = cand & (rank < ROW_SLOTS)
        ok = _stage_hits(fps, bitmaps, cd, range(k1, kt), smask).view(-1, ROW)
        col = torch.where(keep, rank, ROW_SLOTS)     # column 16 = trash
        val = torch.where(keep & ok, pos.view(-1, ROW), -1)
        out = torch.full((width // ROW, ROW_SLOTS + 1), -1, dtype=torch.int64,
                         device=dev)
        out.scatter_(1, col, val)
        slots[s // ROW:s // ROW + width // ROW] = out[:, :ROW_SLOTS]
    return slots, ovf.to(torch.int32)


# ---------------------------------------------------------------------------
# kernel 3: k-stage filter, mask and slots modes
# ---------------------------------------------------------------------------

def _check_filter(text, bitmaps, m, cd):
    """Shared argument checks of filter_mask and filter_slots; returns
    (k, stage_bits)."""
    _check(text, bitmaps, 2)
    k = int(bitmaps.shape[0])
    stage_bits = int(bitmaps.shape[1]) * 32
    n = int(text.shape[0])
    if not 1 <= k <= len(cd):
        raise ValueError(f"need k >= 1 stages and k (C, D) pairs; got k={k} "
                         f"len(cd)={len(cd)}")
    if stage_bits & (stage_bits - 1):
        raise ValueError(f"stage_bits must be a power of two: {stage_bits}")
    if not 1 <= m <= min(n, MAX_KERNEL_M):
        raise ValueError(f"need 1 <= m <= min(n, {MAX_KERNEL_M}); m={m} "
                         f"n={n}")
    return k, stage_bits


def filter_mask(text: torch.Tensor, bitmaps: torch.Tensor, *, m: int,
                cd: tuple) -> torch.Tensor:
    """Per-start candidate mask of the k stages in bitmaps ((k,
    stage_bits/32) int32, one stage per row; cd: k (C, D) pairs):
    (ceil((n-m+1)/128), 128) int8, 1 where all k stages hit, 0 elsewhere
    and at starts >= n-m+1.  Requires n >= m."""
    k, stage_bits = _check_filter(text, bitmaps, m, cd)
    if text.device.type == "cpu":
        return filter_mask_plain(text, bitmaps, m=m, cd=cd)
    n = int(text.shape[0])
    rows = cdiv(n - m + 1, ROW)
    mask = torch.empty((rows, ROW), dtype=torch.int8, device=text.device)
    lib, dev, stream = _launch_args(text)
    rc = lib.tsm_filter_mask(text.data_ptr(), n, m, bitmaps.data_ptr(), k,
                             stage_bits, _cd_host(cd, k), mask.data_ptr(),
                             rows, dev, stream)
    _raise_on(rc, "filter_mask")
    LAUNCHES["filter_mask"] += 1
    return mask


def _candidates(text, bitmaps, cd, s, e, width, m):
    """(width,) bool: starts [s, s + width) that hit every stage, False at
    starts >= e (plain versions)."""
    n = int(text.shape[0])
    smask = int(bitmaps.shape[1]) * 32 - 1
    chunk = torch.zeros(width + m - 1, dtype=torch.uint8, device=text.device)
    chunk[:min(width + m - 1, n - s)] = text[s:s + width + m - 1]
    fps = [fp_keys(chunk, m, mult) for mult in FP_MULTS[:3]]
    pos = torch.arange(s, s + width, device=text.device)
    return _stage_hits(fps, bitmaps, cd, range(int(bitmaps.shape[0])),
                       smask) & (pos < e)


def filter_mask_plain(text: torch.Tensor, bitmaps: torch.Tensor, *, m: int,
                      cd: tuple) -> torch.Tensor:
    """Plain torch version of filter_mask (any device)."""
    n_starts = int(text.shape[0]) - m + 1
    rows = cdiv(n_starts, ROW)
    mask = torch.empty(rows * ROW, dtype=torch.int8, device=text.device)
    for s in range(0, rows * ROW, PLAIN_PIECE):
        width = min(PLAIN_PIECE, rows * ROW - s)
        mask[s:s + width] = _candidates(text, bitmaps, cd, s,
                                        min(s + width, n_starts), width, m)
    return mask.view(rows, ROW)


def filter_slots(text: torch.Tensor, bitmaps: torch.Tensor, *, m: int,
                 cd: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """The slot route's filter: for every SUB_BLOCK-start sub-block, its
    first BLOCK_SLOTS candidates by position and its true candidate count.
    Returns (pos (n_sub, 16) int32, -1 where empty; counts (n_sub,) int32),
    n_sub = ceil((n-m+1)/16384).  Requires n >= m."""
    k, stage_bits = _check_filter(text, bitmaps, m, cd)
    if text.device.type == "cpu":
        return filter_slots_plain(text, bitmaps, m=m, cd=cd)
    n = int(text.shape[0])
    n_sub = cdiv(n - m + 1, SUB_BLOCK)
    pos = torch.empty((n_sub, BLOCK_SLOTS), dtype=torch.int32,
                      device=text.device)
    counts = torch.empty((n_sub,), dtype=torch.int32, device=text.device)
    lib, dev, stream = _launch_args(text)
    rc = lib.tsm_filter_slots(text.data_ptr(), n, m, bitmaps.data_ptr(), k,
                              stage_bits, _cd_host(cd, k), pos.data_ptr(),
                              counts.data_ptr(), n_sub, dev, stream)
    _raise_on(rc, "filter_slots")
    LAUNCHES["filter_slots"] += 1
    return pos, counts


def filter_slots_plain(text: torch.Tensor, bitmaps: torch.Tensor, *, m: int,
                       cd: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of filter_slots (any device): ranks each
    sub-block's candidates with a cumsum and scatters the first
    BLOCK_SLOTS into place."""
    n_starts = int(text.shape[0]) - m + 1
    n_sub = cdiv(n_starts, SUB_BLOCK)
    pieces = [sub_block_slots(_candidates(text, bitmaps, cd, s, n_starts,
                                          min(PLAIN_PIECE,
                                              n_sub * SUB_BLOCK - s), m)
                              .view(-1, SUB_BLOCK), s)
              for s in range(0, n_sub * SUB_BLOCK, PLAIN_PIECE)]
    return (torch.cat([p for p, _ in pieces]),
            torch.cat([c for _, c in pieces]))


def sub_block_slots(cand: torch.Tensor, s: int):
    """The slots layout of a (rows, SUB_BLOCK) candidate matrix whose first
    start is s: (pos (rows, 16) int32, the first BLOCK_SLOTS candidates of
    each sub-block by position, -1 where fewer; counts (rows,) int32, the
    true count).  Ranks each sub-block's candidates with a cumsum and
    scatters the first BLOCK_SLOTS into place."""
    rank = torch.cumsum(cand, dim=1) - 1
    keep = cand & (rank < BLOCK_SLOTS)
    col = torch.where(keep, rank, BLOCK_SLOTS)       # column 16 = trash
    val = torch.where(keep, torch.arange(
        s, s + cand.numel(), device=cand.device).view(-1, SUB_BLOCK), -1)
    out = torch.full((cand.shape[0], BLOCK_SLOTS + 1), -1, dtype=torch.int64,
                     device=cand.device)
    out.scatter_(1, col, val)
    return (out[:, :BLOCK_SLOTS].to(torch.int32),
            cand.sum(1).to(torch.int32))


# ---------------------------------------------------------------------------
# kernel 4: the verify word view
# ---------------------------------------------------------------------------

def words_view(text: torch.Tensor, nw: int) -> torch.Tensor:
    """(nw,) int32 little-endian words of the zero-padded text (the first
    nw*4 bytes).  Verify reads words+1 consecutive words per start and
    torch gathers do not clamp, so callers pass nw = fast.words_len(n,
    words), which covers that margin."""
    if text.dtype != torch.uint8 or text.dim() != 1:
        raise TypeError(f"text must be 1-D uint8, got {text.dtype} "
                        f"{tuple(text.shape)}")
    if not text.is_contiguous():
        raise ValueError("text must be contiguous")
    if text.device.type == "cpu":
        return words_view_plain(text, nw)
    if text.device.type != "cuda":
        raise ValueError(f"unsupported device {text.device}")
    out = torch.empty((nw,), dtype=torch.int32, device=text.device)
    lib, dev, stream = _launch_args(text)
    rc = lib.tsm_words_view(text.data_ptr(), int(text.shape[0]),
                            out.data_ptr(), nw, dev, stream)
    _raise_on(rc, "words_view")
    LAUNCHES["words_view"] += 1
    return out


def words_view_plain(text: torch.Tensor, nw: int) -> torch.Tensor:
    """Plain torch version of words_view (any device)."""
    n = int(text.shape[0])
    buf = torch.zeros(nw * 4, dtype=torch.uint8, device=text.device)
    buf[:min(n, nw * 4)] = text[:nw * 4]
    return buf.view(torch.int32)


# ---------------------------------------------------------------------------
# kernel 5: the cascade's compaction (replaces no TPU kernel)
# ---------------------------------------------------------------------------

def _check_rows(slots, ovf, cap):
    if (slots.dtype != torch.int32 or slots.dim() != 2
            or slots.shape[1] != ROW_SLOTS):
        raise TypeError(f"slots must be (R, {ROW_SLOTS}) int32, got "
                        f"{slots.dtype} {tuple(slots.shape)}")
    if ovf.dtype != torch.int32 or ovf.dim() != 0:
        raise TypeError(f"ovf must be 0-d int32, got {ovf.dtype} "
                        f"{tuple(ovf.shape)}")
    if ovf.device != slots.device:
        raise ValueError(f"slots on {slots.device}, ovf on {ovf.device}")
    if not slots.is_contiguous():
        raise ValueError("slots must be contiguous")
    if slots.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {slots.device}")
    if cap < 0:
        raise ValueError(f"need cap >= 0, got {cap}")


def compact_rows(slots: torch.Tensor, ovf: torch.Tensor, *, cap: int):
    """The cascade's compaction: ops/compaction.compact_valrows of its
    (R, 16) int32 slots, with its row-overflow flag ovf (0-d int32) OR-ed
    into the overflow.  Returns (idxs (cap,) int64, the slot values >= 0 in
    row-major order, densely packed, then -1; overflow 0-d int32, more
    than cap candidates or ovf; n_cand 0-d int64, the true total).  On the
    card, two launches of csrc/compact.cu (per-tile counts, then each tile
    ranks and writes its survivors), no host sync."""
    _check_rows(slots, ovf, cap)
    if slots.device.type == "cpu":
        return compact_rows_plain(slots, ovf, cap=cap)
    if slots.data_ptr() % 16:
        raise ValueError("slots must be 16-byte aligned")
    rows = int(slots.shape[0])
    n_tiles = max(1, cdiv(rows, COMPACT_TILE_ROWS))
    counts = torch.empty((n_tiles,), dtype=torch.int32, device=slots.device)
    idxs = torch.empty((cap,), dtype=torch.int64, device=slots.device)
    n_cand = torch.empty((), dtype=torch.int64, device=slots.device)
    overflow = torch.empty((), dtype=torch.int32, device=slots.device)
    lib, dev, stream = _launch_args(slots)
    rc = lib.tsm_compact_rows(slots.data_ptr(), rows, ovf.data_ptr(),
                              counts.data_ptr(), n_tiles, idxs.data_ptr(),
                              cap, n_cand.data_ptr(), overflow.data_ptr(),
                              dev, stream)
    _raise_on(rc, "compact_rows")
    EPILOGUE_LAUNCHES["compact_valrows"] += 1
    return idxs, overflow, n_cand


def compact_rows_plain(slots: torch.Tensor, ovf: torch.Tensor, *, cap: int):
    """Plain torch version of compact_rows (any device): compact_valrows,
    its overflow OR-ed with ovf."""
    idxs, o, n_cand = compact_valrows(slots, cap=cap)
    return idxs, (o | (ovf != 0)).to(torch.int32), n_cand


# ---------------------------------------------------------------------------
# kernel 6: the cascade route's verify (replaces no TPU kernel)
# ---------------------------------------------------------------------------

def _check_live(text, idxs, n_cand, ft):
    if text.dtype != torch.uint8 or text.dim() != 1:
        raise TypeError(f"text must be 1-D uint8, got {text.dtype} "
                        f"{tuple(text.shape)}")
    if idxs.dtype != torch.int64 or idxs.dim() != 1:
        raise TypeError(f"idxs must be 1-D int64, got {idxs.dtype} "
                        f"{tuple(idxs.shape)}")
    if n_cand.dtype != torch.int64 or n_cand.dim() != 0:
        raise TypeError(f"n_cand must be 0-d int64, got {n_cand.dtype} "
                        f"{tuple(n_cand.shape)}")
    if ft.exact:
        raise ValueError("the exact tier has no verify")
    ids, fp2, packed = ft.bucket_ids, ft.bucket_fp2, ft.packed
    if not (ids.dtype == fp2.dtype == packed.dtype == torch.int32
            and packed.dim() == 2 and packed.shape[1] == ft.words):
        raise TypeError("bucket_ids, bucket_fp2 and packed (p, words) must "
                        "be int32")
    dev = text.device
    if not (idxs.device == n_cand.device == ids.device == fp2.device
            == packed.device == dev):
        raise ValueError(f"text on {dev}, candidates or tables elsewhere")
    if not (text.is_contiguous() and idxs.is_contiguous()
            and ids.is_contiguous() and fp2.is_contiguous()
            and packed.is_contiguous()):
        raise ValueError("text, idxs and the tables must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if not 1 <= ft.m <= MAX_KERNEL_M:
        raise ValueError(f"need 1 <= m <= {MAX_KERNEL_M}; m={ft.m}")


def verify_count_live(text: torch.Tensor, idxs: torch.Tensor,
                      n_cand: torch.Tensor, ft) -> torch.Tensor:
    """The cascade route's verify: how many of the first min(n_cand, cap)
    candidate starts in idxs ((cap,) int64, -1 from n_cand on, as
    compact_rows leaves them; n_cand 0-d int64, compact_rows' true total)
    hold a pattern of ft (fast.FastTables, fingerprint tier), as a 0-d
    int32 tensor.  On the card, a memset of the count and one launch of
    csrc/verify.cu, which reads n_cand on the device and each window's
    bytes from the uint8 text: no word view, no host sync, no thread for
    the -1 tail.  On the CPU the plain version."""
    _check_live(text, idxs, n_cand, ft)
    if text.device.type == "cpu":
        return verify_count_live_plain(text, idxs, n_cand, ft)
    count = torch.empty((), dtype=torch.int32, device=text.device)
    lib, dev, stream = _launch_args(text)
    rc = lib.tsm_verify_live(
        text.data_ptr(), int(text.shape[0]), ft.m, idxs.data_ptr(),
        int(idxs.shape[0]), n_cand.data_ptr(), ft.bucket_ids.data_ptr(),
        ft.bucket_fp2.data_ptr(), ft.lmax, ft.eb, int(ft.slot_ok),
        ft.packed.data_ptr(), ft.words, count.data_ptr(), dev, stream)
    _raise_on(rc, "verify_count_live")
    EPILOGUE_LAUNCHES["verify"] += 1
    return count


def verify_count_live_plain(text: torch.Tensor, idxs: torch.Tensor,
                            n_cand: torch.Tensor, ft) -> torch.Tensor:
    """Plain torch version of verify_count_live (any device):
    ops/verify.verify_count over the text's word view.  It verifies the
    whole cap, so it does not read n_cand: the -1 entries count
    nothing."""
    n = int(text.shape[0])
    tw = words_view_plain(text, words_len(n, ft.words))
    return verify_count(tw, idxs, ft, n_starts=n - ft.m + 1).to(torch.int32)
