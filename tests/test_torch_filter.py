"""PyTorch port: the kernels' plain versions and the compaction and
verification around them equal the JAX package (Pallas kernels in
interpret mode) on the same inputs.  All integer: tolerance 0.  The CUDA
kernels themselves are held against these plain versions on the card in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_smatcher.ops import fast as jfast
from tpu_smatcher.ops import keys as jkeys
from tpu_smatcher.ops import pallas_filter as pf

from tpu_smatcher_torch import kernel_cases as kc
from tpu_smatcher_torch.core import datagen
from tpu_smatcher_torch.ops import cuda_filter as cf
from tpu_smatcher_torch.ops import fast as tfast
from tpu_smatcher_torch.ops import keys as tkeys
from tpu_smatcher_torch.ops import verify as tverify
from tpu_smatcher_torch.ops.common import bits_per_char

from torch_cases import dense_case, make_case, wide_case

#: (sigma, m, p): the exact-tier cases of tests/test_fast.py
EXACT_CASES = [(2, 8, 16), (2, 16, 16), (4, 8, 200)]


def _exact_ns(m):
    return [m - 1, m, 127, 128 * 3, 40_000]


def _exact_inputs(sigma, m, p):
    text, pats = make_case(sigma, m, p, 40_000, seed=3 * sigma + m)
    return text, pats, jfast.build_fast(pats.codes, sigma)


@pytest.fixture(scope="module")
def jax_exact():
    """exact_count_pallas(interpret=True) for every (sigma, m, n) case."""
    out = {}
    for sigma, m, p in EXACT_CASES:
        text, _, jft = _exact_inputs(sigma, m, p)
        for n in _exact_ns(m):
            out[sigma, m, n] = int(pf.exact_count_pallas(
                jnp.asarray(text[:n]), jft.bitmaps[0], m=m, sigma=sigma, n=n,
                interpret=True))
    return out


@pytest.mark.parametrize("sigma,m,p", EXACT_CASES)
def test_exact_plain_matches_pallas(jax_exact, sigma, m, p):
    text, pats, _ = _exact_inputs(sigma, m, p)
    tft = tfast.build_fast(pats.codes, sigma, device="cpu")
    for n in _exact_ns(m):
        t = torch.from_numpy(text[:n].copy())
        got = cf.exact_count_plain(t, tft.bitmaps[0], m=m, sigma=sigma)
        assert got.dtype == torch.int32 and got.dim() == 0
        assert int(got) == jax_exact[sigma, m, n], n
        assert int(got) == datagen.count_matches(text[:n], pats), n


def _cascade_inputs(kind):
    text, pats = wide_case(0.02) if kind == "sparse" else dense_case()
    jft = jfast.build_fast(pats.codes, 4, stage_bits=32768)
    n = len(text)
    k1 = jfast.k1_for(jft)
    kt = min(max(jfast.stages_for(jft, n, 1 << 14), k1 + 1),
             len(jft.bitmaps))
    return text, pats, jft, k1, kt


@pytest.fixture(scope="module")
def jax_cascade():
    """cascade_pallas(interpret=True) on the sparse wide case and the dense
    one: {kind: (packed (R/8, 128), words, ovf)} as numpy."""
    out = {}
    for kind in ("sparse", "dense"):
        text, pats, jft, k1, kt = _cascade_inputs(kind)
        n = len(text)
        packed, tw, ovf = pf.cascade_pallas(
            jnp.asarray(text), jft.bitmaps[:kt], m=pats.m, n=n, k1=k1,
            n_stages=kt, cd=jft.cd(kt),
            nw_min=jfast.words_len(n, jft.words), interpret=True)
        out[kind] = (np.asarray(packed), np.asarray(tw),
                     int(np.asarray(ovf)[0, 0]))
    return out


@pytest.mark.parametrize("kind,want_ovf", [("sparse", 0), ("dense", 1)])
def test_cascade_plain_matches_pallas(jax_cascade, kind, want_ovf):
    text, pats, jft, k1, kt = _cascade_inputs(kind)
    tft = tfast.build_fast(pats.codes, 4, stage_bits=32768, device="cpu")
    t = torch.from_numpy(text)
    slots, ovf = cf.cascade_plain(t, tft.bitmaps[:kt], m=pats.m, k1=k1,
                                  cd=tft.cd(kt))
    packed, _, jovf = jax_cascade[kind]
    R = -(-(len(text) - pats.m + 1) // 128)
    # (R/8, 128) packed row-major is the same memory as (R, 16)
    want = packed.reshape(-1, 16)[:R]
    assert slots.shape == (R, 16) and slots.dtype == torch.int32
    assert np.array_equal(slots.numpy(), want)
    assert int(ovf) == jovf == want_ovf
    # a CPU tensor runs the plain version, and launches nothing
    before = dict(cf.LAUNCHES)
    s2, o2 = cf.cascade(t, tft.bitmaps[:kt], m=pats.m, k1=k1, cd=tft.cd(kt))
    assert torch.equal(s2, slots) and int(o2) == int(ovf)
    assert cf.LAUNCHES == before


MASK32 = np.uint64(0xFFFFFFFF)


def _run_starts(n_starts, run):
    """The first start of each run of `run` consecutive starts."""
    return np.arange(0, n_starts, run)


def _rolling_fps(text, m, mult, run):
    """numpy mirror of the cascade kernel's fingerprints (csrc/cascade.cu,
    fp_filter.cuh): uint32 Horner's rule on the first window of each run of
    `run` starts, then fp(i+1) = (fp(i) - t[i]) * M^-1 + t[i+m] * M^(m-1)
    mod 2^32 for the rest of the run; the low 16 bits of each."""
    n_starts = len(text) - m + 1
    # zero past the text's end, as the kernel's tiles are
    t = np.concatenate([text, np.zeros(run, np.uint8)]).astype(np.uint64)
    inv = np.uint64(pow(mult, -1, 1 << 32))
    top = np.uint64(pow(mult, m - 1, 1 << 32))
    firsts = _run_starts(n_starts, run)
    f = np.zeros(len(firsts), np.uint64)
    for j in range(m - 1, -1, -1):
        f = (f * np.uint64(mult) + t[firsts + j]) & MASK32
    out = np.zeros(len(firsts) * run, np.uint64)
    for k in range(run):
        i = firsts + k
        out[i] = f
        f = ((f - t[i]) * inv + t[i + m] * top) & MASK32
    return (out[:n_starts] & np.uint64(0xFFFF)).astype(np.int64)


def _rolling_wids(text, m, bits, run):
    """numpy mirror of the unguarded exact count's window ids
    (csrc/exact_count.cu): per run of `run` starts, the first window's m-1
    bytes by Horner, then key = ((key << bits) | t[i+m-1]) & (2^(m*bits)-1)
    per start.  A run that reads a byte >= 2^bits rebuilds every id from
    its m bytes (the ORed id), as the kernel does."""
    n_starts = len(text) - m + 1
    t = np.concatenate([text, np.zeros(48, np.uint8)]).astype(np.int64)
    kmask = (1 << (m * bits)) - 1
    out = np.empty(n_starts, np.int64)
    for s in _run_starts(n_starts, run):
        e = min(s + run, n_starts)
        if (t[s:s + 48] >= 1 << bits).any():
            for i in range(s, e):
                key = 0
                for j in range(m):
                    key = (key << bits) | int(t[i + j])
                out[i] = key
            continue
        key = 0
        for j in range(m - 1):
            key = (key << bits) | int(t[s + j])
        for i in range(s, e):
            key = ((key << bits) | int(t[i + m - 1])) & kmask
            out[i] = key
    return out


@pytest.mark.parametrize("m", [1, 2, 8, 16, 32, 257, 4097])
@pytest.mark.parametrize("sigma", [4, 256])
def test_rolling_recurrences_match_keys(sigma, m):
    """The redesigned kernels' recurrences, mirrored in numpy over runs of
    128 (cascade) and 32 (exact count) starts on a text whose start count is
    a multiple of neither, equal the port's and the JAX package's key
    functions: the three base fingerprints for every m, the window ids where
    the exact tier takes m (m*bits <= 16), on in-alphabet bytes and with
    bytes up to 255 planted."""
    rng = np.random.default_rng(sigma + m)
    text = rng.integers(0, sigma, m - 1 + 1001).astype(np.uint8)
    n_starts = len(text) - m + 1
    # one compiled JAX program per m: eager jnp ops would compile per shape
    jax_fps = jax.jit(lambda x: [jkeys.fp_keys(x, m, mult)
                                 for mult in tkeys.FP_MULTS[:3]])
    want = jax_fps(jnp.asarray(text.astype(np.int32)))
    for mult, jwant in zip(tkeys.FP_MULTS[:3], want):
        got = _rolling_fps(text, m, mult, kc.CASCADE_RUN)
        assert np.array_equal(got, tkeys.fp_keys(torch.from_numpy(text), m,
                                                 mult)[:n_starts])
        assert np.array_equal(got, np.asarray(jwant)[:n_starts])
    bits = bits_per_char(sigma)
    if m * bits > 16:
        return
    dirty = text.copy()
    dirty[rng.integers(0, len(text), 9)] = 255
    for x in (text, dirty):
        got = _rolling_wids(x, m, bits, 32)
        assert np.array_equal(got, tkeys.wid_keys(torch.from_numpy(x), m,
                                                  bits)[:n_starts])
        assert np.array_equal(got, np.asarray(jkeys.wid_keys(
            jnp.asarray(x.astype(np.int32)), m, bits))[:n_starts])


def test_exact_wrapper_on_cpu_runs_plain():
    text, pats, _ = _exact_inputs(4, 8, 200)
    tft = tfast.build_fast(pats.codes, 4, device="cpu")
    t = torch.from_numpy(text)
    before = dict(cf.LAUNCHES)
    got = cf.exact_count(t, tft.bitmaps[0], m=8, sigma=4)
    assert int(got) == datagen.count_matches(text, pats)
    assert cf.LAUNCHES == before
    with pytest.raises(TypeError):
        cf.exact_count(t.to(torch.int32), tft.bitmaps[0], m=8, sigma=4)


def test_word_view_matches_pallas(jax_cascade):
    """words_view == words_view_pallas and the cascade's fused word view,
    over the verify range words_len(n, words)."""
    text, pats, jft, _, _ = _cascade_inputs("sparse")
    n = len(text) - 5                       # not a multiple of 4
    nw = jfast.words_len(n, jft.words)
    got = cf.words_view(torch.from_numpy(text[:n].copy()), nw)
    want = np.asarray(pf.words_view_pallas(jnp.asarray(text[:n]), nw=nw,
                                           interpret=True))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    # the kernel's fused view; a block-aligned text (as here) has no
    # margin words in JAX, which the port always pads (with zeros)
    full = cf.words_view(torch.from_numpy(text),
                         jfast.words_len(len(text), jft.words)).numpy()
    fused = jax_cascade["sparse"][1]
    k = min(len(fused), len(full))
    assert np.array_equal(full[:k], fused[:k]) and not full[k:].any()


@pytest.mark.parametrize("slot_ok", [True, False])
def test_verify_matched_matches_jax(slot_ok):
    text, pats, jft, _, _ = _cascade_inputs("sparse")
    tft = tfast.build_fast(pats.codes, 4, stage_bits=32768, device="cpu")
    assert tft.slot_ok                      # so both flags are exact here
    n, m = len(text), pats.m
    n_starts = n - m + 1
    rng = np.random.default_rng(17)
    true_starts = np.flatnonzero(datagen.match_starts(text, pats))
    idxs = np.concatenate([
        true_starts, rng.integers(0, n_starts, 3000), [-1, -1, 0],
        [n_starts - 1, n_starts, n - 1]]).astype(np.int32)
    rng.shuffle(idxs)
    tw = cf.words_view(torch.from_numpy(text), tfast.words_len(n, tft.words))
    kw = dict(m=m, words=jft.words, lmax=jft.lmax, eb=jft.eb,
              n_starts=n_starts, slot_ok=slot_ok)
    want = np.asarray(jfast._verify_matched(
        jnp.asarray(tw.numpy()), jnp.asarray(idxs), jft.bucket_ids,
        jft.packed, jft.bucket_fp2, **kw))
    got = tverify._verify_matched(
        tw, torch.from_numpy(idxs.astype(np.int64)), tft.bucket_ids,
        tft.packed, tft.bucket_fp2, **kw)
    assert np.array_equal(got.numpy(), want)
    assert want.sum() == np.isin(idxs, true_starts).sum()


def test_compact_valrows_matches_jax():
    rng = np.random.default_rng(11)
    R = 256
    vals = np.full((R, 16), -1, np.int32)
    for r in range(R):
        k = rng.integers(0, 5)
        vals[r, rng.choice(16, size=k, replace=False)] = rng.integers(
            0, 1 << 20, size=k)
    for cap in (1024, 64):                  # 64 < n_cand: overflow
        want_i, want_o, want_n = jfast.compact_valrows(
            jnp.asarray(vals.reshape(-1, 128)), caprows=R // 8, cap=cap,
            row_slots=32)                   # >= 8 rows x 4 live lanes
        got_i, got_o, got_n = tfast.compact_valrows(torch.from_numpy(vals),
                                                    cap=cap)
        assert np.array_equal(got_i.numpy(), np.asarray(want_i))
        assert bool(got_o) == bool(int(want_o)) == (cap == 64)
        assert int(got_n) == int(want_n)


def test_nonzero_scatter_matches_jax():
    rng = np.random.default_rng(2)
    mask = rng.random(5000) < 0.01
    for size in (100, 20):                  # 20 < set elements: truncated
        want = np.asarray(jfast.nonzero_scatter(jnp.asarray(mask), size, -7))
        got = tfast.nonzero_scatter(torch.from_numpy(mask), size, -7)
        assert np.array_equal(got.numpy(), want)


def _compact_reference(slots, ovf, cap):
    """compact_rows' outputs by numpy: the live slot values in row-major
    order, the first cap of them, then -1; overflow; the true total."""
    flat = slots.reshape(-1).astype(np.int64)
    live = flat[flat >= 0]
    idxs = np.full(cap, -1, np.int64)
    idxs[:min(cap, len(live))] = live[:cap]
    return idxs, int(len(live) > cap or ovf != 0), len(live)


@pytest.mark.parametrize("name", kc.COMPACT_EDGE_CASES)
def test_compact_valrows_at_the_kernels_edges(name):
    """compact_valrows, and compact_rows on the CPU, at the edges
    csrc/compact.cu must keep: no candidate, every slot live, n_cand ==
    cap, n_cand == cap + 1 (the first cap kept in row order), a cap above
    the slot count, the cascade's row overflow with few candidates."""
    slots, ovf, cap = kc.compact_edge_case(name, "cpu")
    want_i, want_o, want_n = _compact_reference(slots.numpy(), int(ovf), cap)
    idxs, o, n_cand = tfast.compact_valrows(slots, cap=cap)
    assert idxs.dtype == torch.int64 and np.array_equal(idxs.numpy(), want_i)
    assert bool(o) == (want_n > cap) and int(n_cand) == want_n
    idxs, o, n_cand = cf.compact_rows(slots, ovf, cap=cap)
    assert np.array_equal(idxs.numpy(), want_i)
    assert o.dtype == torch.int32 and o.dim() == 0 and int(o) == want_o
    assert n_cand.dtype == torch.int64 and int(n_cand) == want_n
    if name == "cap_plus_one":
        assert want_n == cap + 1 and want_o == 1
    if name == "ovf_few":
        assert 0 < want_n < cap and want_o == 1


@pytest.mark.parametrize("ovf", [0, 1])
def test_compact_rows_on_cpu_runs_compact_valrows(monkeypatch, ovf):
    """Given CPU tensors, the wrapper runs compact_valrows and returns its
    outputs unchanged, the overflow OR-ed with the cascade's ovf, and
    counts no launch."""
    slots = torch.from_numpy(kc.sparse_slots(2500, 0.01, seed=6))
    calls = []

    def spy(vals2d, *, cap):
        calls.append(cap)
        return real(vals2d, cap=cap)

    real = cf.compact_valrows
    monkeypatch.setattr(cf, "compact_valrows", spy)
    before = dict(cf.EPILOGUE_LAUNCHES)
    for cap in (64, 4096):                  # 64 < n_cand: overflow
        want_i, want_o, want_n = real(slots, cap=cap)
        idxs, o, n_cand = cf.compact_rows(
            slots, torch.tensor(ovf, dtype=torch.int32), cap=cap)
        assert torch.equal(idxs, want_i) and torch.equal(n_cand, want_n)
        assert int(o) == (int(want_o) | ovf)
    assert calls == [64, 4096]
    assert cf.EPILOGUE_LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "rank", "width", "ovf_dtype",
                                 "ovf_rank", "device_mix", "cap"])
def test_compact_rows_rejects_what_the_kernel_does_not_take(bad):
    slots = torch.from_numpy(kc.sparse_slots(10, 0.1, seed=7))
    ovf = torch.zeros((), dtype=torch.int32)
    cap, err = 64, TypeError
    if bad == "dtype":
        slots = slots.to(torch.int64)
    elif bad == "rank":
        slots = slots.reshape(-1)
    elif bad == "width":
        slots = slots.reshape(20, 8)
    elif bad == "ovf_dtype":
        ovf = ovf.to(torch.bool)
    elif bad == "ovf_rank":
        ovf = ovf.reshape(1)
    elif bad == "device_mix":
        ovf, err = torch.zeros((), dtype=torch.int32, device="meta"), \
            ValueError
    else:
        cap, err = -1, ValueError
    with pytest.raises(err):
        cf.compact_rows(slots, ovf, cap=cap)


@pytest.mark.parametrize("m,slot_ok,wide,kind", kc.VERIFY_EDGE_CASES)
def test_verify_count_live_plain_matches_verify_count(m, slot_ok, wide,
                                                      kind):
    """verify_count_live on the CPU (its plain path) equals verify_count
    over the word view and the true matches among the live candidates, at
    the edges csrc/verify.cu must keep: a partial and a whole last word,
    eb = 0 and above, fp2's slot choice and every slot tried, n_cand 0,
    below cap with a -1 tail, equal to cap and above it, a match at the
    last window start; and counts no launch."""
    text, idxs, n_cand, ft, truth = kc.verify_edge_case(m, slot_ok, wide,
                                                        kind, "cpu")
    n = int(text.shape[0])
    assert (ft.eb > 0) == wide and ft.slot_ok == slot_ok
    assert ft.words == -(-m // 4)
    cap = int(idxs.shape[0])
    assert {"none": int(n_cand) == 0, "tail": 0 < int(n_cand) < cap,
            "at_cap": int(n_cand) == cap,
            "above_cap": int(n_cand) > cap}[kind]
    if kind in ("tail", "at_cap"):
        assert int(idxs[int(n_cand) - 1]) == n - m     # the last start
    tw = cf.words_view(text, tverify.words_len(n, ft.words))
    want = tverify.verify_count(tw, idxs, ft, n_starts=n - m + 1)
    before = dict(cf.EPILOGUE_LAUNCHES)
    got = cf.verify_count_live(text, idxs, n_cand, ft)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(want) == truth
    assert (truth > 0) == (kind != "none")
    assert cf.EPILOGUE_LAUNCHES == before


@pytest.mark.parametrize("bad", ["text_dtype", "idxs_dtype", "n_cand_rank",
                                 "exact", "device_mix"])
def test_verify_count_live_rejects_what_the_kernel_does_not_take(bad):
    text, idxs, n_cand, ft, _ = kc.verify_edge_case(8, True, False, "tail",
                                                    "cpu")
    err = TypeError
    if bad == "text_dtype":
        text = text.to(torch.int32)
    elif bad == "idxs_dtype":
        idxs = idxs.to(torch.int32)
    elif bad == "n_cand_rank":
        n_cand = n_cand.reshape(1)
    elif bad == "exact":
        ft, err = tfast.build_fast(np.zeros((1, 4), np.uint8), 4,
                                   device="cpu"), ValueError
    else:
        n_cand, err = n_cand.to("meta"), ValueError
    with pytest.raises(err):
        cf.verify_count_live(text, idxs, n_cand, ft)


#: (sigma, m) of the k-stage filter cases: DNA, a protein-sized alphabet at
#: m=8 (fingerprint tier), and a pattern longer than one 128-start row
FILTER_CASES = [(4, 16), (4, 32), (20, 8), (4, 129)]


def _filter_ns(m):
    return [m, 1000, 1001, 70_003]


def _filter_runs(m, stage_bits):
    """(n, k, slots) of the filter parity runs at one stage width.  Each
    Pallas call costs seconds of tracing in interpret mode (the slot
    kernel's most), so the two widths share the text lengths: together
    they run every n of _filter_ns and both k for each (sigma, m) through
    the mask, and every run but the 1000-byte one (which the ragged 1001
    covers) through the slots.  At 4096 bits k=1 over 70,003 starts
    overflows every sub-block, the ragged last one included."""
    if stage_bits == 4096:
        return [(m, 3, True), (70_003, 1, True)]
    return [(1000, 1, False), (1001, 3, True)]


def _filter_inputs(sigma, m, stage_bits):
    text, pats = make_case(sigma, m, 300, 70_003, seed=sigma + m)
    return (text, pats,
            jfast.build_fast(pats.codes, sigma, stage_bits=stage_bits),
            tfast.build_fast(pats.codes, sigma, stage_bits=stage_bits,
                             device="cpu"))


@pytest.mark.parametrize("stage_bits", [4096, 32768])
@pytest.mark.parametrize("sigma,m", FILTER_CASES)
def test_filter_plain_matches_pallas(sigma, m, stage_bits):
    """filter_mask_plain == filter_mask_pallas on the valid starts (the
    padding is zero in both), and filter_slots_plain == the slot rows of
    filter_slots_pallas per sub-block: the first 16 positions and the
    true count, including sub-blocks with more than 16 candidates."""
    text, pats, jft, tft = _filter_inputs(sigma, m, stage_bits)
    overflowed = False
    for n, k, slots in _filter_runs(m, stage_bits):
        t = torch.from_numpy(text[:n].copy())
        jt = jnp.asarray(text[:n])
        jargs = dict(m=m, n=n, n_stages=k, cd=jft.cd(k), interpret=True)
        args = dict(m=m, cd=tft.cd(k))
        n_starts = n - m + 1
        want = np.asarray(pf.filter_mask_pallas(
            jt, jft.bitmaps[:k], **jargs)).reshape(-1)
        got = cf.filter_mask_plain(t, tft.bitmaps[:k], **args)
        assert got.dtype == torch.int8
        assert got.shape == (-(-n_starts // 128), 128), n
        got = got.numpy().reshape(-1)
        assert np.array_equal(got[:n_starts], want[:n_starts]), (n, k)
        assert not got[n_starts:].any() and not want[n_starts:].any()
        before = dict(cf.LAUNCHES)   # a CPU tensor runs the plain versions
        assert np.array_equal(
            cf.filter_mask(t, tft.bitmaps[:k], **args).numpy().reshape(-1),
            got)
        assert cf.LAUNCHES == before
        if not slots:
            continue

        slotmat, _ = pf.filter_slots_pallas(jt, jft.bitmaps[:k], **jargs)
        slotmat = np.asarray(slotmat)
        n_sub = -(-n_starts // cf.SUB_BLOCK)
        pos, counts = cf.filter_slots_plain(t, tft.bitmaps[:k], **args)
        assert pos.dtype == counts.dtype == torch.int32
        assert pos.shape == (n_sub, cf.BLOCK_SLOTS) and counts.shape == (n_sub,)
        assert np.array_equal(pos.numpy(), slotmat[:n_sub, :cf.BLOCK_SLOTS])
        assert np.array_equal(counts.numpy(), slotmat[:n_sub, cf.BLOCK_SLOTS])
        assert not slotmat[n_sub:, cf.BLOCK_SLOTS].any()
        assert int(counts.sum()) == int(got.sum())
        overflowed |= bool((counts > cf.BLOCK_SLOTS).any())
        p2, c2 = cf.filter_slots(t, tft.bitmaps[:k], **args)
        assert torch.equal(p2, pos) and torch.equal(c2, counts)
        assert cf.LAUNCHES == before
    if stage_bits == 4096:          # k=1 at 70,003 starts fills sub-blocks
        assert overflowed


@pytest.mark.parametrize("sigma,m", FILTER_CASES)
def test_words_view_plain_matches_pallas(sigma, m):
    """words_view_plain == words_view_pallas on the text's ceil(n/4) words,
    and the verify margin after them is zero in both."""
    text, pats = make_case(sigma, m, 300, 70_003, seed=sigma + m)
    words = -(-m // 4)
    for n in _filter_ns(m):
        nw = jfast.words_len(n, words)
        want = np.asarray(pf.words_view_pallas(jnp.asarray(text[:n]), nw=nw,
                                               interpret=True))
        got = cf.words_view_plain(torch.from_numpy(text[:n].copy()), nw)
        assert got.dtype == torch.int32 and got.shape == (nw,)
        q = -(-n // 4)
        got = got.numpy()
        assert np.array_equal(got[:q], want[:q]), n
        assert not got[q:].any() and not want[q:].any()
        before = dict(cf.LAUNCHES)
        assert np.array_equal(
            cf.words_view(torch.from_numpy(text[:n].copy()), nw).numpy(), got)
        assert cf.LAUNCHES == before
