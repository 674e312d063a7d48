"""A numpy mirror of the exact-tier kernels' decomposition
(tpu_smatcher_torch/csrc/exact_count.cu: the unguarded count, the guarded
count and the mask), step for step: text tiles of 8,192 starts staged from
the 16-byte aligned address at or below the text (junk before the view),
runs of 32 consecutive starts per thread, the rolling window id with its
per-start path for dirty runs (a byte >= 2^bits, or a bitmap smaller than
the id space), the guard's mask of entering bytes >= sigma smeared over m
starts (bytes in [sigma, 2^bits) dropped by the guard, clean for the id),
the last partial run, the counts as the runs' popcounts and the mask as
two 16-byte stores per run over all rows*128 entries (0 past n-m+1).  The
run code is the stage-chain kernel's (csrc/wid_run.cuh), so the mirror
runs test_torch_stages_mirror's wid_run and guard_run.

The mirror is held against the plain torch versions (exact_mask_plain,
exact_count_plain with the guard on and off) on kernel_cases' exact edge
cases (views at every offset mod 16, start counts around a run, a mask row
and a tile, a positions piece of about 2^18 starts, n = m) at sigma in {2,
4, 20, 256} and m in {1, 2, 3, 8, 16}, with a random bitmap and one
smaller than the id space; and against the JAX package's exact_mask_pallas
/ exact_count_pallas(guard=True) in interpret mode on
test_torch_positions.py's exact inputs (the same shapes).  All integer:
tolerance 0.  The CUDA kernels themselves are held against the plain
versions on the card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_smatcher.ops import fast as jfast
from tpu_smatcher.ops import pallas_filter as pf

from tpu_smatcher_torch import kernel_cases as kc
from tpu_smatcher_torch.ops import cuda_filter as cf
from tpu_smatcher_torch.ops import fast as tfast
from tpu_smatcher_torch.ops.common import bits_per_char

from test_torch_filter_mirror import _tile_buffers, mask_stores
from test_torch_positions import EXACT_INPUTS
from test_torch_stages_mirror import guard_run, wid_run

RUN, TILE = kc.EXACT_RUN, kc.EXACT_TILE
U1 = np.uint64(1)


def run_hits(text, bitmap, m, sigma, guard, shift):
    """(runs,) uint64 hit masks of every run of every tile of the text at
    an address with `shift` = address % 16 (0 for a run past the last
    start): the rolling id's mask, ANDed with the guard's where sigma <
    256, the last run cut to its valid starts."""
    n_starts = len(text) - m + 1
    bufs = _tile_buffers(text, shift, m, tile=TILE)
    starts = np.arange(len(bufs) * TILE // RUN) * RUN
    live = starts < n_starts
    i0 = starts[live]
    t, p = i0 // TILE, shift + i0 % TILE
    hits = wid_run(bufs, t, p, shift, (0, m, bits_per_char(sigma)),
                   bitmap.numpy())
    if guard and sigma < 256:
        hits &= guard_run(bufs, t, p, shift, m, max(sigma, 0))
    valid = n_starts - i0
    short = valid < RUN
    hits[short] &= (U1 << valid[short].astype(np.uint64)) - U1
    out = np.zeros(len(starts), np.uint64)
    out[live] = hits
    return out


def mirror(text, bitmap, *, m, sigma, shift):
    """exact_count.cu's three outputs: the unguarded and the guarded count
    (the runs' popcounts) and the mask (the runs below R*128 stored)."""
    guarded = run_hits(text, bitmap, m, sigma, True, shift)
    rows = -(-(len(text) - m + 1) // 128)
    return {"count": int(np.bitwise_count(
                run_hits(text, bitmap, m, sigma, False, shift)).sum()),
            "guarded": int(np.bitwise_count(guarded).sum()),
            "mask": mask_stores(guarded[:rows * 128 // RUN])}


def _assert_mirror_equals_plain(text, bitmap, m, sigma, shift):
    t = torch.from_numpy(np.ascontiguousarray(text))
    kw = dict(m=m, sigma=sigma)
    got = mirror(text, bitmap, shift=shift, **kw)
    want = cf.exact_mask_plain(t, bitmap, **kw).numpy()
    assert np.array_equal(got["mask"], want), shift
    assert got["guarded"] == int(cf.exact_count_plain(t, bitmap, guard=True,
                                                      **kw)) == want.sum()
    assert got["count"] == int(cf.exact_count_plain(t, bitmap, **kw))
    return got["count"] - got["guarded"]


#: (sigma, m): m*bits up to 16 at sigma 2, 4, 20 and 256
MIRROR_CASES = [(2, 16), (2, 1), (4, 8), (4, 2), (20, 3), (20, 2), (256, 2),
                (256, 1)]


@pytest.mark.parametrize("sigma,m", MIRROR_CASES)
def test_exact_mirror_matches_plain(sigma, m):
    """The mirror's counts and mask equal the plain versions on the views
    of an exact edge case: every offset mod 16 (two tiles and a ragged
    run), start counts around a run, a mask row and a tile, a positions
    piece, n = m; bytes >= sigma planted (at sigma = 20 also bytes in [20,
    32)); the guard drops windows wherever sigma < 256."""
    views, bitmap = kc.exact_edge_case(sigma, m, "cpu")
    dropped = 0
    for i, v in enumerate(views):
        dropped += _assert_mirror_equals_plain(v.numpy(), bitmap, m, sigma,
                                               shift=i % 16)
    assert (dropped > 0) == (sigma < 256)


def test_exact_mirror_small_bitmap():
    """A bitmap smaller than 2^(m*bits) bits: every run takes the
    per-start path and ids past the bitmap miss."""
    views, bitmap = kc.exact_edge_case(4, 8, "cpu")
    small = bitmap[:128].clone()
    for i in (0, 5, 16 + 7, len(views) - 2):
        _assert_mirror_equals_plain(views[i].numpy(), small, 8, 4,
                                    shift=i % 16)


def test_exact_mirror_guard_on_bytes_between_sigma_and_radix():
    """sigma = 20 (bits = 5): a byte in [20, 32) keeps the run clean for
    the rolling id but drops the m windows that hold it."""
    m, sigma = 3, 20
    bitmap = torch.full((1024,), -1, dtype=torch.int32)     # every id hits
    text = np.zeros(m - 1 + 3 * RUN, np.uint8)
    for at in (0, 1, m - 1, 40, len(text) - 1):
        txt = text.copy()
        txt[at] = 27
        got = mirror(txt, bitmap, m=m, sigma=sigma, shift=9)
        want = np.ones(len(txt) - m + 1, np.int8)
        want[max(0, at - m + 1):at + 1] = 0
        assert np.array_equal(got["mask"].reshape(-1)[:len(want)], want)
        assert not got["mask"].reshape(-1)[len(want):].any()
        assert got["count"] == len(want) and got["guarded"] == want.sum()


@pytest.fixture(scope="module")
def pallas_exact():
    """{name: (exact_mask_pallas (R, 128), guarded count)} in interpret
    mode on test_torch_positions.py's exact inputs."""
    out = {}
    for name, make in EXACT_INPUTS.items():
        text, pats = make()
        jft = jfast.build_fast(pats.codes, 4)
        n = len(text)
        kw = dict(m=8, sigma=4, n=n, interpret=True)
        mask = pf.exact_mask_pallas(jnp.asarray(text), jft.bitmaps[0], **kw)
        count = pf.exact_count_pallas(jnp.asarray(text), jft.bitmaps[0],
                                      guard=True, **kw)
        out[name] = (np.asarray(mask), int(count))
    return out


@pytest.mark.parametrize("name", list(EXACT_INPUTS))
def test_exact_mirror_matches_pallas(pallas_exact, name):
    """The mirror's mask and guarded count equal the TPU kernels' on DNA
    m=8 with the pad symbol and 200 planted (some inside matches), and on
    the pad window whose packed id aliases a pattern's, at address 13 mod
    16."""
    text, pats = EXACT_INPUTS[name]()
    bitmap = tfast.build_fast(pats.codes, 4, device="cpu").bitmaps[0]
    got = mirror(text, bitmap, m=8, sigma=4, shift=13)
    want_mask, want_count = pallas_exact[name]
    rows = got["mask"].shape[0]
    assert np.array_equal(got["mask"], want_mask[:rows])
    assert not want_mask[rows:].any()
    assert got["guarded"] == want_count
