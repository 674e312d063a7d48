"""Distribution of the PyTorch port (tpu_smatcher_torch.parallel) against
the JAX package's: the cases of tests/test_parallel.py, test_sigma256.py's
two distribution cases, __graft_entry__.dryrun_multichip's four sub-cases
and DistributedPositions, each run by the port on k gloo ranks of the CPU
(tests/torch_dist_worker.py, one spawn per world size, all its cases in
it) and by the JAX package on make_mesh(k) over the conftest's 8 virtual
devices, on the same bytes; both must equal datagen.  Tolerance 0."""

import concurrent.futures

import numpy as np
import pytest

from tpu_smatcher.core import datagen as jdatagen
from tpu_smatcher.engines import make_distributed as jmake_distributed
from tpu_smatcher.engines import make_fast as jmake_fast
from tpu_smatcher.parallel import make_mesh as jmake_mesh
from tpu_smatcher.parallel import shard_text as jshard_text
from tpu_smatcher.parallel.dist import DistributedCounter as JCounter
from tpu_smatcher.parallel.dist import DistributedPositions as JPositions
from tpu_smatcher.parallel.dist import exchange_halo as jexchange_halo

import torch_dist_worker as W
from torch_cases import jax_pats

CASES8 = [f"exact:{e}" for e in W.ENGINES] + [
    "mesh", "straddle", "uneven", "async", "async256", "s256-wm",
    "s256-fast", "s256-ac", "s256-fp", "s256-n", "s256-zero",
    "ladder-dense", "ladder-pieces", "tiny", "dry-exact", "dry-fp",
    "dry-s256", "dry-mixed", "pos-exact", "pos-fp", "pos-dense",
    "pos-chunk", "halo4", "halo256"]
#: world size -> the cases its ranks run
WORLDS = {1: ["mesh"], 2: ["mesh"], 4: ["mesh", "wrap-mode"], 8: CASES8}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world size: [rank 0's results, rank 1's, ...]}: the four groups
    run at once."""
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as ex:
        futs = {k: ex.submit(W.run_ranks, k, cases,
                             str(tmp_path_factory.mktemp(f"world{k}")))
                for k, cases in WORLDS.items()}
        return {k: f.result() for k, f in futs.items()}


def port(ranks, k, case, *, error=False):
    """Case `case`'s result at world size k, the same on every rank (its
    error message where error=True)."""
    res = [r[case] for r in ranks[k]]
    assert all(r == res[0] for r in res), f"{case}: ranks differ"
    key = "error" if error else "ok"
    assert key in res[0], f"{case}: {res[0]}"
    return res[0][key]


def truth(text, pats):
    return jdatagen.count_matches(text, jax_pats(pats))


def jax_engine(name, pats, k, **opts):
    return jmake_distributed(name, jax_pats(pats), jmake_mesh(k), **opts)


def jax_counter(pats, k, *, cap=None, ladder=True):
    """The JAX package's DistributedCounter over make_fast's core (the
    worker's _counter)."""
    opts = ({"tile": 1 << 12, "backend": "xla"} if cap is None
            else {"cap": cap, "backend": "pallas", "interpret": True})
    fast = jmake_fast(jax_pats(pats), **opts)
    return JCounter(fast.core, jmake_mesh(k), m=pats.m, sigma=pats.sigma,
                    fast=fast if ladder else None)


def test_ranks_are_gloo_and_import_no_jax(ranks):
    for k, results in ranks.items():
        for r in results:
            assert r["backend"] == "gloo"
            assert r["imports_jax"] == [], r["imports_jax"]


@pytest.mark.parametrize("engine", W.ENGINES)
def test_distributed_count_exact(ranks, engine):
    text, pats = W.inputs("exact")
    want = jax_engine(engine, pats, 8, **W.ENGINE_OPTS).count(text)
    assert port(ranks, 8, f"exact:{engine}") == want == truth(text, pats)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_mesh_size_invariance(ranks, k):
    text, pats = W.inputs("mesh")
    want = jax_engine("ac", pats, k, lanes=32).count(text)
    assert port(ranks, k, "mesh") == want == truth(text, pats)


def test_boundary_straddling_matches(ranks):
    text, pats = W.inputs("straddle")
    expected = truth(text, pats)
    assert expected >= 8
    got = port(ranks, 8, "straddle")
    for engine in ("ac", "wm", "sbom"):
        want = jax_engine(engine, pats, 8, lanes=16,
                          tile=1 << 12).count(text)
        assert got[engine] == want == expected, engine


def test_uneven_text_length(ranks):
    text, pats = W.inputs("uneven")
    want = jax_engine("wm", pats, 8, tile=1 << 12).count(text)
    assert port(ranks, 8, "uneven") == want == truth(text, pats)


def test_distributed_count_async_pipelined(ranks):
    for case in ("async", "async256"):
        text, pats = W.inputs(case)
        expected = truth(text, pats)
        dc = jax_engine("wm", pats, 8, tile=1 << 12)
        got = port(ranks, 8, case)
        assert got["many"] == dc.scan_many([text, text]) == [expected] * 2
        assert got["async"] == dc.count_async(text).result() == expected


@pytest.mark.parametrize("engine", ["wm", "fast", "ac"])
def test_sigma256_wrap_correction(ranks, engine):
    text, pats = W.inputs(f"s256-{engine}")
    expected = truth(text, pats)
    assert expected >= 1
    want = jax_engine(engine, pats, 8, tile=1 << 12).count(text)
    assert port(ranks, 8, f"s256-{engine}") == want == expected


def test_sigma256_wrap_false_positive_subtracted(ranks):
    text, pats = W.inputs("s256-fp")
    want = jax_engine("wm", pats, 8, tile=1 << 12).count(text)
    assert port(ranks, 8, "s256-fp") == want == truth(text, pats)


def test_sigma256_explicit_n_on_numpy_input(ranks):
    """An explicit n= wins over the length of a pre-padded numpy text:
    the seam (text ++ 0-pad) spells the pattern and must not count, in the
    count and in the positions."""
    padded, pats, n_true = W.inputs("s256-n")
    want = jax_engine("wm", pats, 8, tile=1 << 12).count(padded, n=n_true)
    got = port(ranks, 8, "s256-n")
    assert got["count"] == want == truth(padded[:n_true], pats)
    starts = np.flatnonzero(jdatagen.match_starts(padded[:n_true],
                                                  jax_pats(pats)))
    np.testing.assert_array_equal(got["positions"], starts)


def test_sigma256_zero_pad_pattern_subtracted(ranks):
    text, pats = W.inputs("s256-zero")
    expected = truth(text, pats)
    assert expected >= 2
    want = jax_engine("wm", pats, 8, tile=1 << 12).count(text)
    assert port(ranks, 8, "s256-zero") == want == expected


def test_distributed_total_on_match_dense_overflow(ranks):
    """Ladder step 1: the raw flag reports the shard overflow (as the JAX
    package's does on the same text and cap), count() is exact through
    the dense per-shard pass, and without a ladder the count raises."""
    text, pats = W.inputs("ladder-dense")
    expected = truth(text, pats)
    assert expected > 1024
    got = port(ranks, 8, "ladder-dense")
    _, jax_flag = jax_counter(pats, 8, cap=1024).count_with_overflow(text)
    assert got["raw_overflow"] is True and jax_flag
    assert got["count"] == expected
    assert got["bare"].startswith("OverflowError")


def test_distributed_total_piece_fallback(ranks):
    """Ladder step 2: 'A'*16 over an all-'A' text, every start a match,
    overflows the dense shard pass too; the SPMD pieces count exactly."""
    text, pats = W.inputs("ladder-pieces")
    got = port(ranks, 8, "ladder-pieces")
    assert got["raw_overflow"] is True
    assert got["count"] == 120_000 - 15 == truth(text, pats)
    assert got["small"] == [], "a split left a piece below cap/4"


def test_distribution_sigma256_wrap_mode(ranks):
    """test_sigma256.py's case on 4 ranks: shard_text 0-pads the byte
    alphabet, and the all-zero pattern never counts the pad."""
    text, pats = W.inputs("wrap-mode")
    jsharded, jn = jshard_text(text, jmake_mesh(4), sigma=256)
    assert (np.asarray(jsharded)[jn:] == 0).all()
    want = jax_counter(pats, 4, ladder=False).count(text)
    got = port(ranks, 4, "wrap-mode")
    assert got == {"n": len(text), "pad_zero": True, "count": want}
    assert want == truth(text, pats) == 0


def test_tiny_shard_raises_clearly(ranks):
    text, pats = W.inputs("tiny")
    with pytest.raises(ValueError, match="fewer devices"):
        jax_counter(pats, 8, ladder=False).count(text)
    err = port(ranks, 8, "tiny", error=True)
    assert err.startswith("ValueError") and "fewer devices" in err


@pytest.mark.parametrize("case", ["dry-exact", "dry-fp", "dry-s256",
                                  "dry-mixed"])
def test_dryrun_multichip_case(ranks, case):
    """__graft_entry__.dryrun_multichip(8)'s sub-cases: exact tier + ac,
    the fp tier at m=16, the sigma=256 wrap, mixed lengths 5/8/16 as one
    distributed sub-scan per group."""
    got = port(ranks, 8, case)
    if case == "dry-mixed":
        text, groups = W.inputs(case)
        want = sum(jax_counter(g, 8).count(text) for g in groups)
        assert got == want == sum(truth(text, g) for g in groups)
        return
    text, pats = W.inputs(case)
    expected = truth(text, pats)
    assert got["fast"] == jax_counter(pats, 8).count(text) == expected
    if case == "dry-exact":
        want = jax_engine("ac", pats, 8, lanes=16).count(text)
        assert got["ac"] == want == expected


@pytest.mark.parametrize("case", ["pos-exact", "pos-fp"])
def test_distributed_positions(ranks, case):
    """Every rank returns the same sorted global starts: the JAX
    package's DistributedPositions (Pallas in interpret mode) and
    datagen's, on the exact tier (m=8) and the fp tier (m=16)."""
    text, pats = W.inputs(case)
    jp = JPositions(jmake_fast(jax_pats(pats), backend="pallas",
                               interpret=True), jmake_mesh(8))
    want = np.flatnonzero(jdatagen.match_starts(text, jax_pats(pats)))
    got = port(ranks, 8, case)
    np.testing.assert_array_equal(jp.positions(text), want)
    np.testing.assert_array_equal(got, want)


def test_distributed_positions_split_pieces(ranks):
    """ladder-pieces' all-'A' text at cap=1024: 15,000 matches per shard,
    pieces split on every rank until each fits, every start once."""
    text, pats = W.inputs("pos-dense")
    want = np.flatnonzero(jdatagen.match_starts(text, jax_pats(pats)))
    assert want.size == 120_000 - 15
    got = port(ranks, 8, "pos-dense")
    np.testing.assert_array_equal(got["positions"], want)
    assert got["small"] == [], "a split left a piece below cap/2"


def test_distributed_positions_presized_pieces(ranks):
    """positions(chunk=1000): the pieces presized within each span (the
    shard's own windows, then the seam), the same starts as datagen's."""
    text, pats = W.inputs("pos-chunk")
    want = np.flatnonzero(jdatagen.match_starts(text, jax_pats(pats)))
    np.testing.assert_array_equal(port(ranks, 8, "pos-chunk"), want)


@pytest.mark.parametrize("case", ["halo4", "halo256"])
def test_exchange_halo(ranks, case):
    """Each rank's shard + halo equals the JAX package's exchange_halo
    under shard_map on 8 devices: the right neighbour's first m-1 bytes,
    the pad sigma after the last shard (sigma = 4), shard 0's head there
    for sigma = 256."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    text, pats = W.inputs(case)
    mesh = jmake_mesh(8)
    sharded, _ = jshard_text(text, mesh, sigma=pats.sigma)
    fn = jax.jit(shard_map(
        lambda local: jexchange_halo(local, axis="data", k=8,
                                     halo=pats.m - 1, sigma=pats.sigma),
        mesh=mesh, in_specs=P("data"), out_specs=P("data")))
    want = np.asarray(fn(sharded)).reshape(8, -1)
    got = [r[case]["ok"] for r in ranks[8]]
    for r in range(8):
        np.testing.assert_array_equal(got[r], want[r], err_msg=f"rank {r}")
