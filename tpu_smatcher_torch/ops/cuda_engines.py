"""The named engines' fast path: the stage-chain kernel's wrapper beside its
plain PyTorch version, and EngineFastPath (port of
tpu_smatcher/ops/pallas_engines.py).

Each engine's own data structure becomes a filter stage over every window
start, ANDed with the shared exact or fingerprint stages (a stage never
rejects a true match, so counts are preserved):

  AC    prefix d-gram window-id bitmap (the d-deep trie walk as one lookup)
  SH    suffix d-gram bitmap (the backward reversed-trie walk)
  SBOM  suffix d-gram bitmap (oracle acceptance is a superset of suffix
        membership, so the suffix bitmap is the stronger exact filter)
  WM    its SHIFT table: hit iff SHIFT[hash(last 3 chars)] == 0
  SOG   its T table: the shift-or E register unrolled to an AND of m-2
        shifted T-bit streams

A chain is a list of (kind, params) stages, as in the JAX package, with one
table tensor per stage:

  ("wid", (off, d, bits))  bitmap words (nbits/32,) int32
  ("fpset", (k, cd))       (k, stage_bits/32) int32, cd = k (C, D) pairs
  ("wm", (m,))             the extended SHIFT table, (L,) int32
  ("sog", (m, sigma))      the T table's uint32 bits, (sigma^3,) int32

stages() runs the chain in one launch of csrc/stages.cu, which replaces
both _stages_kernel (:115) and _stages_kernel_flat (:213); LAUNCHES counts
it under "stages_flat" where the JAX package would run the flat kernel.
Given a CPU tensor it runs stages_plain, the same outputs bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpu_smatcher_torch.ops import cuda_filter
from tpu_smatcher_torch.ops.common import M32, bits_per_char, cdiv
from tpu_smatcher_torch.ops.cuda_filter import (BLOCK_SLOTS, LAUNCHES,
                                                PLAIN_PIECE, ROW, SUB_BLOCK,
                                                _cd_host, _launch_args,
                                                _raise_on, _stage_hits)
from tpu_smatcher_torch.ops.fast import (ScanFuture, FastScanner,
                                         _wid_keys_np, build_fast, cap_for,
                                         compact_mask,
                                         compact_verify_retry,
                                         count_from_sub_blocks, device_text,
                                         enqueue_sum, slot_stages,
                                         stages_for, verify_attr,
                                         verify_text, words_len)
from tpu_smatcher_torch.ops.keys import FP_MULTS, fp_keys, max_keys, wid_keys
from tpu_smatcher_torch.ops.lookup import bitmap_test, pack_bitmap

#: kernel modes (csrc/stages.cu)
MODES = {"count": 0, "mask": 1, "slots": 2}
_KINDS = {"wid": 0, "fpset": 1, "wm": 2, "sog": 3}
#: the longest chain the kernel takes
MAX_CHAIN = 4
#: a value stage (wm, sog) is chosen only for tables of at most this many
#: entries: the TPU's banked lookup unrolls one gather per 128 entries
#: (MAX_BANKS * 128 of the JAX package), and the kernel stages the table in
#: shared memory
MAX_VALUE_TABLE = 32 * 128


# ---------------------------------------------------------------------------
# the stage-chain kernel
# ---------------------------------------------------------------------------

def _check_chain(text, chain, tables, *, m, sigma, mode, guard, flat):
    if text.dtype != torch.uint8 or text.dim() != 1:
        raise TypeError(f"text must be 1-D uint8, got {text.dtype} "
                        f"{tuple(text.shape)}")
    if text.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {text.device}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    n = int(text.shape[0])
    if not 1 <= m <= min(n, cuda_filter.MAX_KERNEL_M):
        raise ValueError(f"need 1 <= m <= min(n, {cuda_filter.MAX_KERNEL_M})"
                         f"; m={m} n={n}")
    if not 1 <= len(chain) <= MAX_CHAIN or len(tables) != len(chain):
        raise ValueError(f"need 1..{MAX_CHAIN} stages, one table each")
    if sum(kind == "fpset" for kind, _ in chain) > 1:
        raise ValueError("a chain takes at most one fpset stage")
    if flat and (guard or any(k not in ("wid", "fpset") for k, _ in chain)):
        raise ValueError("the flat layout runs wid and fpset stages only, "
                         "without the guard")
    for (kind, params), tab in zip(chain, tables):
        if tab.dtype != torch.int32 or not tab.is_contiguous() or \
                tab.device != text.device:
            raise TypeError(f"{kind} table must be contiguous int32 on "
                            f"{text.device}")
        if kind == "wid":
            off, d, bits = params
            if off < 0 or d < 1 or off + d > m or d * bits > 16:
                raise ValueError(f"bad wid stage {params} for m={m}")
        elif kind == "fpset":
            k, cd = params
            sb = int(tab.shape[-1]) * 32
            if tab.dim() != 2 or int(tab.shape[0]) != k or \
                    sb & (sb - 1) or not 1 <= k <= len(cd):
                raise ValueError(f"bad fpset stage: k={k}, table "
                                 f"{tuple(tab.shape)}, {len(cd)} (C, D)")
        elif kind == "wm":
            if params != (m,) or m < 3:
                raise ValueError(f"wm stage {params} needs m={m} >= 3")
        elif kind == "sog":
            if params[0] != m or not 3 <= m <= 34 or not \
                    1 <= params[1] <= 256:
                raise ValueError(f"sog stage {params} needs 3 <= m={m} <= 34"
                                 " and 1 <= sigma <= 256")
        else:
            raise ValueError(f"unknown stage kind {kind!r}")


def chain_args(chain, tables):
    """tsm_stages' chain arguments: (desc, tables, cd) as ctypes arrays, 5
    int32 per stage (kind, a, b, c, len), one table pointer per stage, and
    the fpset stage's (C, D) pairs or None."""
    desc = (ctypes.c_int32 * (5 * len(chain)))()
    ptrs = (ctypes.c_void_p * len(chain))()
    cd = None
    for i, ((kind, params), tab) in enumerate(zip(chain, tables)):
        if kind == "wid":
            a, b, c, length = *params, tab.numel()
        elif kind == "fpset":
            a, b, c, length = params[0], int(tab.shape[1]) * 32, 0, 0
            cd = _cd_host(params[1], params[0])
        elif kind == "wm":
            a, b, c, length = 0, 0, 0, tab.numel()
        else:
            a, b, c, length = 0, 0, params[1], tab.numel()
        desc[5 * i:5 * i + 5] = [_KINDS[kind], a, b, c, length]
        ptrs[i] = tab.data_ptr()
    return (ctypes.cast(desc, ctypes.c_void_p),
            ctypes.cast(ptrs, ctypes.c_void_p), cd)


def stage_outputs(mode, n_starts, dev):
    """(out0, out1 or None, n_out): the outputs tsm_stages writes in mode
    (count: one zeroed int32)."""
    if mode == "count":
        return torch.zeros((), dtype=torch.int32, device=dev), None, 0
    if mode == "mask":
        n_out = cdiv(n_starts, ROW)
        return torch.empty((n_out, ROW), dtype=torch.int8, device=dev), \
            None, n_out
    n_out = cdiv(n_starts, SUB_BLOCK)
    return (torch.empty((n_out, BLOCK_SLOTS), dtype=torch.int32, device=dev),
            torch.empty((n_out,), dtype=torch.int32, device=dev), n_out)


def stages(text: torch.Tensor, chain, tables, *, m: int, sigma: int,
           mode: str, guard: bool = False, flat: bool = False):
    """Run a stage chain over every start of text (n >= m required).

    mode 'count': 0-d int32, the starts where every stage hits; 'mask':
    (ceil((n-m+1)/128), 128) int8, 1 there, 0 elsewhere and past n-m+1;
    'slots': (pos (n_sub, 16) int32, counts (n_sub,) int32), the first 16
    such starts and their true count per 16,384-start sub-block.  guard
    drops windows holding a byte >= sigma.  flat marks a call the JAX
    package makes on its flat layout (wid/fpset stages, no guard): the same
    kernel, counted as "stages_flat"."""
    _check_chain(text, chain, tables, m=m, sigma=sigma, mode=mode,
                 guard=guard, flat=flat)
    if text.device.type == "cpu":
        return stages_plain(text, chain, tables, m=m, sigma=sigma, mode=mode,
                            guard=guard)
    n = int(text.shape[0])
    desc, ptrs, cd = chain_args(chain, tables)
    out0, out1, n_out = stage_outputs(mode, n - m + 1, text.device)
    lib, dev_idx, stream = _launch_args(text)
    rc = lib.tsm_stages(text.data_ptr(), n, m, sigma, int(guard),
                        MODES[mode], desc, ptrs, len(chain), cd,
                        out0.data_ptr(),
                        None if out1 is None else out1.data_ptr(), n_out,
                        dev_idx, stream)
    name = "stages_flat" if flat else "stages"
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out0 if out1 is None else (out0, out1)


def _value_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] as uint32 values in int64, 0 past the table (the TPU's
    banked lookup, pallas_engines._value_lookup)."""
    L = int(table.shape[0])
    v = table[idx.clamp(max=L - 1)].to(torch.int64) & M32
    return torch.where(idx < L, v, 0)


def _chain_hits(chunk, chain, tables, *, m, sigma, guard, width):
    """(width,) bool: the starts of chunk (width + m - 1 bytes) where every
    stage of the chain hits (and, with guard, the window holds no byte >=
    sigma)."""
    t = chunk.to(torch.int64)
    hit = torch.ones(width, dtype=torch.bool, device=chunk.device)
    for (kind, params), tab in zip(chain, tables):
        if kind == "wid":
            off, d, bits = params
            keys = wid_keys(chunk[off:off + width + d - 1], d, bits)
            nbits = tab.numel() * 32
            hit &= ((bitmap_test(tab, keys.clamp(max=nbits - 1)) == 1)
                    & (keys < nbits))
        elif kind == "fpset":
            k, cd = params
            fps = [fp_keys(chunk, m, mult) for mult in FP_MULTS[:3]]
            hit &= _stage_hits(fps, tab, cd, range(k),
                               int(tab.shape[1]) * 32 - 1)
        elif kind == "wm":
            h = (t[m - 3:m - 3 + width] * 4 + t[m - 2:m - 2 + width]) * 4 \
                + t[m - 1:m - 1 + width]
            hit &= _value_lookup(tab, h) == 0
        else:                                       # sog: (m, sigma)
            sg = params[1]
            ng = width + m - 3
            v = _value_lookup(tab, t[:ng] + t[1:ng + 1] * sg
                              + t[2:ng + 2] * (sg * sg))
            acc = torch.zeros(width, dtype=torch.int64, device=chunk.device)
            for i in range(m - 2):
                acc |= (v[i:i + width] >> i) & 1
            hit &= acc == 0
    if guard:
        hit &= max_keys(chunk, m) < sigma
    return hit


def stages_plain(text: torch.Tensor, chain, tables, *, m: int, sigma: int,
                 mode: str, guard: bool = False, flat: bool = False):
    """Plain torch version of stages (any device), in pieces of PLAIN_PIECE
    starts (a multiple of the mask rows and slot sub-blocks).  It has one
    layout: flat is taken for the wrapper's signature only."""
    n = int(text.shape[0])
    n_starts = n - m + 1
    dev = text.device
    if mode == "count":
        total_out = n_starts
    elif mode == "mask":
        total_out = cdiv(n_starts, ROW) * ROW
    else:
        total_out = cdiv(n_starts, SUB_BLOCK) * SUB_BLOCK
    hits = []
    for s in range(0, total_out, PLAIN_PIECE):
        width = min(PLAIN_PIECE, total_out - s)
        chunk = torch.zeros(width + m - 1, dtype=torch.uint8, device=dev)
        chunk[:min(width + m - 1, n - s)] = text[s:s + width + m - 1]
        pos = torch.arange(s, s + width, device=dev)
        hits.append(_chain_hits(chunk, chain, tables, m=m, sigma=sigma,
                                guard=guard, width=width) & (pos < n_starts))
    cand = torch.cat(hits)
    if mode == "count":
        return cand.sum().to(torch.int32)
    if mode == "mask":
        return cand.to(torch.int8).view(-1, ROW)
    return cuda_filter.sub_block_slots(cand.view(-1, SUB_BLOCK), 0)


# ---------------------------------------------------------------------------
# the engines' fast path
# ---------------------------------------------------------------------------

class EngineFastPath:
    """An engine's stage chain over the shared exact or fingerprint tables
    (build_fast), with exact verification: counts equal the engine's
    portable scan and the ground truth (windows holding >= 1 pattern).
    Runs on `device`: the kernels on the card, their plain versions on the
    CPU.

    kind: 'ac' | 'sh' | 'sbom' | 'wm' | 'sog'; wm takes its extended SHIFT
    table (shift_ext), sog its T table (t_table), as numpy arrays.  cap
    (the candidate cap), caprows and row_slots (compact_mask's budgets) are
    attributes, as in the JAX package."""

    def __init__(self, kind: str, patterns: np.ndarray, sigma: int, *,
                 shift_ext=None, t_table=None, device):
        patterns = np.asarray(patterns, np.uint8)
        p, m = patterns.shape
        self.m, self.sigma = m, sigma
        self.ft = build_fast(patterns, sigma, device=device)
        self.device = self.ft.device
        self.cap = cap_for(self.ft)
        self.caprows = self.cap
        self.row_slots = 8
        self._fallback = None
        #: async scans run on the fallback FastScanner after an overflow
        self._use_fallback_async = False
        bits = bits_per_char(sigma)

        def on_device(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        # a value stage costs more than the stages it saves past this size:
        # lead with a prefix / suffix bitmap stage instead (the JAX choice)
        if kind == "wm" and len(shift_ext) <= MAX_VALUE_TABLE:
            self.stage0 = ("wm", (m,))
            self.tables0 = [on_device(np.asarray(shift_ext, np.int32))]
        elif kind == "sog" and len(t_table) <= MAX_VALUE_TABLE:
            self.stage0 = ("sog", (m, sigma))
            self.tables0 = [on_device(np.asarray(t_table).astype(
                np.uint32).view(np.int32))]
        else:
            d = min(m, 16 // bits)
            off = 0 if kind == "ac" else m - d
            if self.ft.exact and d == m:
                self.stage0 = None          # identical to the exact stage
                self.tables0 = []
            else:
                # the bitmap spans the d-gram key space (2^(d*bits) bits)
                bm = pack_bitmap(_wid_keys_np(patterns[:, off:off + d], sigma),
                                 max(4096, 1 << (d * bits)))
                self.stage0 = ("wid", (off, d, bits))
                self.tables0 = [on_device(bm.reshape(-1))]

    def _stages(self, n: int, k_min: int = 1):
        """(chain, tables, exact): stage 0, then the exact tier's window-id
        stage or the first k fingerprint stages, k from the scan's size."""
        chain, tables = [], []
        if self.stage0 is not None:
            chain.append(self.stage0)
            tables.extend(self.tables0)
        ft = self.ft
        if ft.exact:
            chain.append(("wid", (0, self.m, bits_per_char(self.sigma))))
            tables.append(ft.bitmaps[0])
            return chain, tables, True
        k = min(max(stages_for(ft, n, self.cap), k_min), len(ft.bitmaps))
        chain.append(("fpset", (k, ft.cd(k))))
        tables.append(ft.bitmaps[:k])
        return chain, tables, False

    def _flat_ok(self) -> bool:
        """Whether the JAX package may run the chain on its flat layout:
        every stage's keys are banded matmuls (wid/fpset)."""
        return self.stage0 is None or self.stage0[0] == "wid"

    def _run(self, text, chain, tables, mode, *, guard=False, flat=False):
        return stages(text, chain, tables, m=self.m, sigma=self.sigma,
                      mode=mode, guard=guard, flat=flat)

    def _count_impl(self, ext, guard=False, fused=False):
        """(count 0-d int32, overflow 0-d int32) over the starts of ext, no
        host sync.  guard drops pad-contaminated windows of the exact tier
        (distribution shards); fused selects the async path: the slot mode
        where fast.slot_stages finds it feasible, else the mask."""
        ft = self.ft
        n = int(ext.shape[0])
        zero = torch.zeros((), dtype=torch.int32, device=ext.device)
        if n < self.m:
            return zero, zero
        ks = slot_stages(ft, stages_for(ft, n, self.cap)) if fused else None
        flat = self._flat_ok() and not guard
        chain, tables, exact = self._stages(n, k_min=ks or 1)
        if exact:
            return self._run(ext, chain, tables, "count", guard=guard,
                             flat=flat), zero
        if ks is not None:
            pos, counts = self._run(ext, chain, tables, "slots", flat=flat)
            return count_from_sub_blocks(ft, ext, pos, counts, cap=self.cap)
        mask2d = self._run(ext, chain, tables, "mask", flat=flat)
        idxs, o, _ = compact_mask(
            mask2d, caprows=min(self.caprows, self.cap, mask2d.shape[0]),
            cap=self.cap, row_slots=self.row_slots)
        return verify_text(ft, ext, idxs).to(torch.int32), o.to(torch.int32)

    def _mask_impl(self, ext):
        """The per-start mask over every start of ext; the exact tier's is
        pad-guarded, as it has no verification to reject aliased ids."""
        chain, tables, exact = self._stages(int(ext.shape[0]))
        flat = self._flat_ok() and not exact
        return self._run(ext, chain, tables, "mask", guard=exact, flat=flat)

    def count(self, text) -> int:
        t = device_text(text, self.device)
        n = int(t.shape[0])
        ft = self.ft
        if n < self.m:
            return 0
        if ft.exact:
            return int(self._count_impl(t)[0])
        mask2d = self._mask_impl(t)
        tw = cuda_filter.words_view(t, words_len(n, ft.words))
        c, o = compact_verify_retry(mask2d, tw, ft, cap=self.cap,
                                    caprows=self.caprows,
                                    row_slots=self.row_slots,
                                    n_starts=n - ft.m + 1)
        if o:
            # matches alone exceed the cap at every trial: finish exactly in
            # budget-sized pieces over the same tables
            return self._fallback_scanner()._count_chunked(t)
        return c

    def _fallback_scanner(self) -> FastScanner:
        """A FastScanner over the same tables (identical counts and match
        set): the piece ladder, positions past the cap, attribution."""
        if self._fallback is None:
            self._fallback = FastScanner(self.ft, cap=self.cap)
        return self._fallback

    def core(self, ext):
        """Per-shard (count 0-d int32, overflow 0-d int32), no host sync,
        pad-guarded: what distribution sums over shards."""
        return self._count_impl(device_text(ext, self.device), guard=True)

    def count_async(self, text, retry=None) -> ScanFuture:
        """Enqueue a scan; the count stays on the device until
        ScanFuture.result().  retry overrides the overflow fallback (the
        engines pass their own count).  The chain has no adaptation state,
        so after the first overflow async scans go through the fallback
        FastScanner, whose ladder adapts: one retry, then single scans."""
        t = device_text(text, self.device)
        if self._use_fallback_async:
            return self._fallback_scanner().count_async(t)

        def adapt_retry():
            c = (retry or functools.partial(self.count, t))()
            self._use_fallback_async = True
            self._fallback_scanner().count(t)       # prime its adaptation
            return c

        return ScanFuture(*self._count_impl(t, fused=True), retry=adapt_retry)

    def scan_many(self, texts) -> list[int]:
        """Counts of a batch of texts: every scan enqueued, then read."""
        return [f.result() for f in [self.count_async(t) for t in texts]]

    def count_repeat_async(self, text, reps: int) -> ScanFuture:
        """reps back-to-back scans of the same text, enqueued with no host
        sync in between; their summed count in one future.  An overflow
        re-runs them through the fallback FastScanner and pins later scans
        there, as count_async does."""
        t = device_text(text, self.device)
        if self._use_fallback_async:
            return self._fallback_scanner().count_repeat_async(t, reps)

        def adapt_retry():
            self._use_fallback_async = True
            fb = self._fallback_scanner()
            fb.count(t)                             # prime its adaptation
            return fb.count_repeat_async(t, reps).result()

        scan = functools.partial(self._count_impl, fused=True)
        return ScanFuture(*enqueue_sum(scan, [t] * reps, self.device),
                          retry=adapt_retry)

    def positions(self, text) -> np.ndarray:
        """Sorted int64 starts of ALL matching windows, unbounded: one
        masked scan when its matches fit the cap, else the fallback
        FastScanner's split-on-overflow pieces (the same match set)."""
        t = device_text(text, self.device)
        n = int(t.shape[0])
        ft = self.ft
        if n < self.m:
            return np.empty((0,), np.int64)
        mask2d = self._mask_impl(t)
        idxs, o, _ = compact_mask(
            mask2d, caprows=min(self.caprows, mask2d.shape[0]), cap=self.cap,
            row_slots=self.row_slots)
        if not ft.exact:
            tw = cuda_filter.words_view(t, words_len(n, ft.words))
            matched, _ = verify_attr(tw, idxs, ft, n_starts=n - ft.m + 1)
            idxs = torch.where(matched, idxs, -1)
        flat = torch.cat([idxs, o.to(torch.int64).view(1)]).cpu().numpy()
        if flat[-1]:
            return self._fallback_scanner().positions(t)
        pos = flat[:-1]
        return np.sort(pos[pos >= 0]).astype(np.int64)
