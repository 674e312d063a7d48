"""Inputs of the port's kernel-against-plain checks, shared by chip_smoke.py
and the tests (tests/test_torch_cuda.py on the card, the CPU mirrors):
pattern cases, stage bitmaps of any width, start counts around a kernel's
runs and tiles, the exact kernels' cases of csrc/exact_count.cu — views at
every address mod 16, start counts around a run, a mask row and a tile, a
launch of about 2^18 starts and n = m, sigma 2 to 256 with bytes >= sigma
— and the stage-chain cases of csrc/stages.cu — every chain kind
EngineFastPath builds at m = 3 to 4097 on views at every address mod 16,
fp stages past shared memory, chains outside EngineFastPath's, and
launches above 48 KB of shared memory around a smaller one — and the
compaction's cases of csrc/compact.cu (the cascade's slots with no
candidate, every slot live, exactly cap candidates and one more, a cap
above the slot count, the cascade's row overflow with few candidates;
slots of any row count) and of csrc/verify.cu (compacted candidates at
m = 5 to 32, with and without the extra bucket bits and fp2's slot choice,
no candidate, a -1 tail, exactly cap and more than cap, a match at the
last window start, bytes up to 255).  Every input is
made with numpy from a seed; holding a kernel against its plain version is
the caller's part.  Nothing here builds or launches a kernel."""

import dataclasses
import functools

import numpy as np
import torch

from .core import datagen
from .core.alphabet import Alphabet
from .engines import make_engine
from .ops.cuda_engines import EngineFastPath
from .ops.fast import STAGE_CD, build_fast

#: stages.cu's run (consecutive starts per thread) and tile (starts per
#: block iteration, one slot sub-block); exact_count.cu's, and its tile on
#: the pair path (512 threads a block)
STAGES_RUN, STAGES_TILE = 32, 16384
EXACT_RUN, EXACT_TILE = 32, 8192
EXACT_PAIR_TILE = 16384
#: cascade.cu's run (consecutive starts per thread: one 128-start row) and
#: its tile (starts per block iteration) at both of its shapes: a p=10k
#: table's two 131,072-bit phase-1 stages (256 threads, a row each) and
#: p=100k's six (512 threads, two a row: runs of CASCADE_RUN // 2)
CASCADE_RUN, CASCADE_TILE = 128, 32768
#: starts of a positions piece on the bench corpus (FastScanner._drive:
#: cap/2 = 32,768 matches at the exact tier's density of 0.142), rounded
EXACT_PIECE = 1 << 18


def make_case(sigma, m, p_size, n, seed):
    """(text, patterns): n bytes over the alphabet of size sigma and p_size
    patterns of length m, 60% of them taken from the text."""
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(n, ab, seed=seed)
    pats = datagen.generate_patterns(text, p_size, m, ab, frac_present=0.6,
                                     seed=seed + 1)
    return text, pats


def random_stages(k, stage_bits, fill, seed):
    """(k, stage_bits/32) int32 stage bitmaps, each bit set with
    probability fill, for checks that need stage counts or widths no
    pattern set of their size builds."""
    rng = np.random.default_rng(seed)
    bits = rng.random((k, stage_bits)) < fill
    return np.packbits(bits, axis=1, bitorder="little").view("<i4")


def edge_starts(run, tile):
    """Start counts around a kernel's run of consecutive starts per thread
    and its tile of starts per block iteration."""
    return sorted({run - 1, run, run + 1, tile - 1, tile, tile + 1,
                   2 * tile + run + 1})


def exact_edge_starts():
    """Start counts around the exact kernel's runs and tiles, on both of
    its paths."""
    return sorted(set(edge_starts(EXACT_RUN, EXACT_TILE))
                  | set(edge_starts(EXACT_RUN, EXACT_PAIR_TILE)))


def cascade_edge_starts():
    """Start counts around the cascade's runs, rows and tiles: at one
    thread a row and at two."""
    return sorted(set(edge_starts(CASCADE_RUN, CASCADE_TILE))
                  | set(edge_starts(CASCADE_RUN // 2, CASCADE_TILE)))


def plant_oob(text, sigma, seed, span=None):
    """The text with bytes sigma (the pad) and 255 planted in its first
    span bytes where the alphabet leaves room: dirty runs for wid, lookups
    past the wm and sog tables, windows the guard drops."""
    if sigma >= 256:
        return text
    text = text.copy()
    at = np.random.default_rng(seed).integers(0, span or len(text), 60)
    text[at[::2]] = sigma
    text[at[1::2]] = 255
    return text


def sog_table(codes, sigma):
    """build_sog's T for any 3 <= m <= 34 (bit i set: the gram is at
    offset i of no pattern), as the kernel reads it (uint32)."""
    m = codes.shape[1]
    T = np.full(sigma ** 3, (1 << min(m - 2, 32)) - 1, np.uint64)
    for i in range(m - 2):
        g = (codes[:, i].astype(np.int64) + codes[:, i + 1] * sigma
             + codes[:, i + 2].astype(np.int64) * sigma * sigma)
        np.bitwise_and.at(T, g, ~np.uint64(1 << i))
    return T.astype(np.uint32)


def engine_chain(sigma, m, kind, n, seed, device="cpu"):
    """(text, chain, tables) of the fast path of engine `kind` (ac, sh, wm,
    sog) over a case of n bytes, at any m the kind takes (sog: 3 to 34,
    with sog_table's T)."""
    text, pats = make_case(sigma, m, 40, n, seed=seed)
    if kind == "wm":
        fp = make_engine(kind, pats, device=device).fast_path
    else:               # ac, sh (no table of their own), sog (its T)
        kw = dict(t_table=sog_table(pats.codes, sigma)) if kind == "sog" \
            else {}
        fp = EngineFastPath(kind, pats.codes, sigma, device=device, **kw)
    chain, tables, _ = fp._stages(n)
    return text, chain, tables


def generic_chains(sigma, m, codes, fp_tables):
    """(chain, tables) of chains outside those EngineFastPath builds, which
    stages.cu runs in its generic instantiation: a value stage alone, two
    value stages, the fp stage first, a bitmap smaller than the id space
    (its runs take the per-start path), three wid stages.  fp_tables: a
    (2, words) int32 fpset table on the chains' device."""
    rng = np.random.default_rng(m)
    bits = (sigma - 1).bit_length()
    d = min(4, 16 // bits)
    dev = fp_tables.device

    def on(a):
        return torch.from_numpy(a).to(dev)

    wm = on(rng.integers(0, 3, 200).astype(np.int32))
    sog = on(sog_table(codes, sigma).view(np.int32))
    small = on(random_stages(1, 32 * 3, 0.5, seed=1)[0])
    wide = on(random_stages(1, 4096, 0.6, seed=2)[0])
    fp = ("fpset", (2, STAGE_CD[:2]))
    return [
        ([("wm", (m,))], [wm]),
        ([("sog", (m, sigma)), ("wm", (m,))], [sog, wm]),
        ([fp, ("wid", (1, 3, bits))], [fp_tables, wide]),
        ([("wid", (0, d, bits)), ("wm", (m,)), fp],
         [small, wm, fp_tables]),
        ([("wid", (0, 2, bits)), ("wid", (m - 3, 3, bits)),
          ("wid", (2, 1, bits))], [wide, wide, small]),
    ]


# ---------------------------------------------------------------------------
# the exact kernels' edge cases: each views of one text and a bitmap
# ---------------------------------------------------------------------------

#: (sigma, m) of the exact kernels' edge cases: DNA at the bench tier's m,
#: sigma 2 at m = 16 (m*bits = 16), sigma 20 (bytes in [20, 32) are dropped
#: by the guard but roll as clean bytes), sigma 256 (no guard work) and m = 1;
#: for the pair path (exact_count.cu: (m+1)-grams of at most 18 bits) its
#: widest grams at 1, 2, 3 and 8 bits a byte (sigma 2 m = 16, DNA m = 8,
#: sigma 8 m = 5, sigma 256 m = 1), a table of one word (DNA m = 1), and
#: two shapes past it, which take the bitmap (sigma 20 m = 3, sigma 256 m = 2)
EXACT_EDGE_CASES = [(4, 8), (2, 16), (20, 3), (256, 2), (4, 1), (8, 5),
                    (256, 1)]


def exact_edge_case(sigma, m, device):
    """(views, bitmap): a random bitmap of max(4096, 2^(m*bits)) bits, each
    set with probability 1/2 (so that the guard drops windows that would
    hit), and text over sigma with bytes sigma, 255 and, below 2^bits,
    2^bits - 1 planted (runs that take the per-start path; windows the
    guard drops), as views: 16 of two tiles and a ragged run, at every
    address mod 16; then start counts around a run, a mask row and a tile,
    a positions piece's EXACT_PIECE + 5 starts and n = m, the i-th at
    address i mod 16 (odd for the piece)."""
    bits = max(1, (sigma - 1).bit_length())
    nbits = max(4096, 1 << (m * bits))
    bitmap = torch.from_numpy(random_stages(1, nbits, 0.5, seed=m)[0])
    starts = sorted(set(exact_edge_starts())
                    | {127, 128, 129, EXACT_PIECE + 5, 1})
    rng = np.random.default_rng(sigma + m)
    text = rng.integers(0, sigma, max(starts) + m + 16).astype(np.uint8)
    if sigma < 256:
        at = rng.integers(0, len(text), len(text) // 64)
        text[at[::3]] = sigma
        text[at[1::3]] = 255
        text[at[2::3]] = (1 << bits) - 1
    full = torch.from_numpy(text).to(device)
    two = m - 1 + 2 * EXACT_TILE + 77
    views = [full[i:i + two] for i in range(16)]
    views += [full[i % 16:i % 16 + m - 1 + s] for i, s in enumerate(starts)]
    return views, bitmap.to(device)


# ---------------------------------------------------------------------------
# the stage-chain kernel's edge cases: each a text (views on the device),
# a chain and its tables, m and sigma
# ---------------------------------------------------------------------------

#: (sigma, m, engine kind) of the edge cases: every chain kind
#: EngineFastPath builds (wid, wm + wid, sog + wid, wid + fpset, wm +
#: fpset, sog + fpset), m from 3 to 4097, sog at m = 34, the guard at
#: sigma = 256
STAGE_EDGE_CASES = [(4, 8, "ac"), (4, 8, "wm"), (4, 8, "sog"),
                    (256, 8, "ac"), (4, 3, "wm"), (4, 3, "sog"),
                    (20, 16, "wm"), (4, 32, "ac"), (4, 32, "wm"),
                    (4, 32, "sog"), (2, 32, "sog"), (4, 34, "sog"),
                    (4, 4097, "ac")]

#: (sigma, m) of the generic chains' cases
GENERIC_CASES = [(4, 8), (20, 16), (2, 32)]


def stage_edge_case(sigma, m, kind, device):
    """(views, chain, tables) of engine `kind`'s chain: the text, bytes >=
    sigma planted (runs that take the wid stage's per-start path, lookups
    past the value tables, windows the guard drops), as views at start
    counts around the kernel's run, a mask row and its tile, the i-th at
    address i mod 16 (staged from the aligned address below it)."""
    starts = sorted(set(edge_starts(STAGES_RUN, STAGES_TILE))
                    | {127, 128, 129})
    n = m - 1 + max(starts) + 16
    text, chain, tables = engine_chain(sigma, m, kind, n, seed=sigma + m,
                                       device=device)
    # at m = 4097 the plants stay in the first 3000 bytes, so that windows
    # of the patterns present are left further on
    text = plant_oob(text, sigma, seed=m, span=3000 if m == 4097 else None)
    full = torch.from_numpy(text).to(device)
    views = [full[i % 16:i % 16 + m - 1 + s] for i, s in enumerate(starts)]
    return views, chain, tables


def wide_fp_cases(stage_bits, device):
    """[(view, chain, tables, m)]: 32 fp stages of stage_bits bits (2^17 or
    2^18: past shared memory, the first few there and the rest through
    __ldg; bits set with probability 0.8 so that deep stages run) behind
    each stage 0 (prefix wid, wm, sog) and alone, at m = 32 and 4097, on
    sigma = 4 text with bytes >= sigma planted, aligned and at address 3
    mod 16."""
    bm = torch.from_numpy(random_stages(32, stage_bits, 0.8,
                                        seed=stage_bits)).to(device)
    fp = ("fpset", (32, STAGE_CD[:32]))
    out = []
    for m, kinds in ((32, ("ac", "wm", "sog")), (4097, ("ac", "wm"))):
        n = m - 1 + STAGES_TILE + 77
        chains = []
        for kind in kinds:
            text, chain, tables = engine_chain(4, m, kind, n + 3, seed=m,
                                               device=device)
            chains.append(([chain[0], fp], [tables[0], bm]))
        chains.append(([fp], [bm]))
        t = torch.from_numpy(plant_oob(text, 4, seed=1)).to(device)
        for chain, tables in chains:
            out += [(t[:n], chain, tables, m), (t[3:], chain, tables, m)]
    return out


def generic_case(sigma, m, device):
    """(view, [(chain, tables)]): generic_chains on a text of a tile and a
    ragged run, bytes >= sigma planted, at an odd address."""
    text, pats = make_case(sigma, m, 30, m - 1 + STAGES_TILE + 78, seed=m)
    t = torch.from_numpy(plant_oob(text, sigma, seed=m + 1)).to(device)[1:]
    fp_tables = torch.from_numpy(random_stages(2, 4096, 0.4, seed=m)).to(
        device)
    return t, generic_chains(sigma, m, pats.codes, fp_tables)


def smaller_launch_cases(device):
    """[(text, chain, tables, m)] in launch order: above 48 KB of shared
    memory (two 2^18-bit fp stages: 64 KB and the text buffers; thirteen
    32,768-bit ones: 52 KB), then below (an exact-tier chain), then above
    again: each launch above 48 KB must raise the kernel's limit again."""
    text, chain, tables = engine_chain(4, 32, "wm", 3 * STAGES_TILE, seed=3,
                                       device=device)
    t = torch.from_numpy(text).to(device)
    wide = torch.from_numpy(random_stages(2, 262144, 0.5, seed=1)).to(device)
    mid = torch.from_numpy(random_stages(13, 32768, 0.8, seed=2)).to(device)
    small = engine_chain(4, 8, "wm", 1000, seed=3, device=device)[1:]
    big = ([chain[0], ("fpset", (2, STAGE_CD[:2]))], [tables[0], wide])
    return [(t, *big, 32),
            (t, [chain[0], ("fpset", (13, STAGE_CD[:13]))],
             [tables[0], mid], 32),
            (t, *small, 8),
            (t, *big, 32)]


#: the compaction's edge cases (cuda_filter.compact_rows), on 3,000 rows
#: (three of csrc/compact.cu's 1,024-row tiles, the last ragged) or 5
COMPACT_EDGE_CASES = ["none", "all_live", "at_cap", "cap_plus_one",
                      "cap_above_slots", "ovf_few"]


def sparse_slots(rows, frac, seed):
    """(rows, 16) int32 slots as the cascade leaves them: each slot live
    with probability frac, holding a start of its row's 128 (row * 128 +
    a column), -1 where empty."""
    rng = np.random.default_rng(seed)
    live = rng.random((rows, 16)) < frac
    vals = (np.arange(rows, dtype=np.int64)[:, None] * 128
            + rng.integers(0, 128, (rows, 16)))
    return np.where(live, vals, -1).astype(np.int32)


def compact_edge_case(name, device):
    """(slots (R, 16) int32, ovf 0-d int32, cap) of one of
    COMPACT_EDGE_CASES, on device."""
    ovf, cap = 0, 1024
    if name == "none":
        slots = sparse_slots(3000, 0.0, seed=1)
    elif name == "all_live":
        slots, cap = sparse_slots(3000, 1.0, seed=2), 1 << 16
    elif name in ("at_cap", "cap_plus_one"):
        slots = sparse_slots(3000, 0.05, seed=3)
        cap = int((slots >= 0).sum()) - (name == "cap_plus_one")
    elif name == "cap_above_slots":
        slots = sparse_slots(5, 0.5, seed=4)
    elif name == "ovf_few":
        slots, ovf = sparse_slots(3000, 0.001, seed=5), 1
    else:
        raise ValueError(f"no compaction case {name!r}")
    return (torch.from_numpy(slots).to(device),
            torch.tensor(ovf, dtype=torch.int32, device=device), cap)


#: the verify kernel's cases (cuda_filter.verify_count_live): (m, slot_ok,
#: wide, kind).  m = 5 and 13 end in a partial word and hold bytes up to
#: 255, 8 and 32 end in a whole one; wide tables hold p = 12,000 patterns
#: (some 9,800 distinct), so eb > 0 bits of fp1 extend the bucket key
#: (eb = 0 at p = 200); slot_ok=False tries every slot of a bucket.
#: kind: n_cand 0 (every entry -1), a -1 tail past n_cand, n_cand == cap,
#: n_cand > cap (the first cap candidates kept).
VERIFY_KINDS = ("none", "tail", "at_cap", "above_cap")
VERIFY_EDGE_CASES = [(m, slot_ok, wide, kind) for m in (5, 8, 13, 32)
                     for slot_ok in (True, False) for wide in (False, True)
                     for kind in VERIFY_KINDS]


@functools.lru_cache(maxsize=None)
def _verify_inputs(m, wide, device):
    """(text (n,) uint8, candidates, truth, tables) of the verify cases of
    (m, wide): 6,007 bytes over 256 symbols at odd m (bytes up to 255 in
    the fingerprints and the words) and 20 at even m (the fingerprint tier
    at every m), one pattern planted at the last window start; the
    candidates in compaction order (ascending): every match start, 600
    random starts and the last start; truth: which of them match."""
    sigma = 256 if m % 2 else 20
    ab = Alphabet.of_size(sigma)
    n, p = 6007, 12_000 if wide else 200
    text = datagen.generate_text(n, ab, seed=m)
    pats = datagen.generate_patterns(text, p, m, ab, frac_present=0.5,
                                     seed=m + 1)
    text[n - m:] = pats.codes[0]
    starts = datagen.match_starts(text, pats)
    rng = np.random.default_rng(m + 2)
    cands = np.unique(np.concatenate([np.flatnonzero(starts),
                                      rng.integers(0, n - m + 1, 600),
                                      [n - m]]))
    ft = build_fast(pats.codes, sigma, device=device)
    return torch.from_numpy(text).to(device), cands, starts[cands], ft


def verify_edge_case(m, slot_ok, wide, kind, device):
    """(text, idxs (cap,) int64, n_cand 0-d int64, tables, truth) of one of
    VERIFY_EDGE_CASES on device, as compact_rows leaves the candidates;
    truth: the matches among the first min(n_cand, cap) of them."""
    text, cands, match, ft = _verify_inputs(m, wide, str(device))
    if ft.slot_ok != slot_ok:
        if not ft.slot_ok:
            raise ValueError(f"m={m} wide={wide}: tables not slot_ok")
        ft = dataclasses.replace(ft, slot_ok=False)
    n_live = len(cands)
    cap = {"none": 1024, "tail": n_live + 300, "at_cap": n_live,
           "above_cap": n_live - 7}[kind]
    n_cand = 0 if kind == "none" else n_live
    kept = min(n_cand, cap)
    idxs = np.full(cap, -1, np.int64)
    idxs[:kept] = cands[:kept]
    return (text, torch.from_numpy(idxs).to(device),
            torch.tensor(n_cand, dtype=torch.int64, device=device), ft,
            int(match[:kept].sum()))
