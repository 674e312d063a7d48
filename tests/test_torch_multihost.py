"""Corpus loading per rank (tpu_smatcher_torch.parallel.multihost) against
the JAX package's: test_multihost.py's cases on 8 gloo ranks of the CPU,
and test_multiprocess.py's two-process count, each rank reading only its
own byte range of the file (tests/torch_dist_worker.py).  Tolerance 0."""

import concurrent.futures

import numpy as np
import pytest
import torch

from tpu_smatcher.core import datagen as jdatagen
from tpu_smatcher.engines import make_fast as jmake_fast
from tpu_smatcher.parallel import make_mesh as jmake_mesh
from tpu_smatcher.parallel.dist import DistributedCounter as JCounter
from tpu_smatcher.parallel.multihost import (
    host_shard_ranges as jhost_shard_ranges,
    load_corpus_shards as jload_corpus_shards)
from tpu_smatcher_torch.parallel.mesh import Mesh
from tpu_smatcher_torch.parallel.multihost import host_shard_ranges

import torch_dist_worker as W
from torch_cases import jax_pats

#: world size -> the cases its ranks run; each case's corpus is written to
#: <case>.bin in the group's directory first
WORLDS = {8: ["mh4", "mh256"], 2: ["two-process"]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    dirs = {k: tmp_path_factory.mktemp(f"world{k}") for k in WORLDS}
    for k, cases in WORLDS.items():
        for case in cases:
            W.inputs(case)[0].tofile(dirs[k] / f"{case}.bin")
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as ex:
        futs = {k: ex.submit(W.run_ranks, k, cases, str(dirs[k]))
                for k, cases in WORLDS.items()}
        return {k: (f.result(), str(dirs[k])) for k, f in futs.items()}


def rank_results(ranks, k, case):
    res = [r[case] for r in ranks[k][0]]
    for r in res:
        assert "ok" in r, f"{case}: {r}"
    return [r["ok"] for r in res]


def jax_count(path, pats, sigma):
    mesh = jmake_mesh(8)
    arr, n_file = jload_corpus_shards(path, mesh, sigma=sigma)
    eng = jmake_fast(jax_pats(pats), backend="xla", tile=1 << 12)
    dc = JCounter(eng.core, mesh, m=pats.m, sigma=sigma)
    return dc.count(arr, n=n_file if sigma >= 256 else None)


def test_load_matches_file(ranks):
    """The eight ranks' shards, in rank order, are the file and then the
    out-of-alphabet pad, as the JAX package's sharded array is."""
    text, _ = W.inputs("mh4")
    res = rank_results(ranks, 8, "mh4")
    assert all(r["n"] == len(text) for r in res)
    back = np.concatenate([np.asarray(r["shard"], np.uint8) for r in res])
    jarr, jn = jload_corpus_shards(f"{ranks[8][1]}/mh4.bin", jmake_mesh(8),
                                   sigma=4)
    np.testing.assert_array_equal(back, np.asarray(jarr))
    np.testing.assert_array_equal(back[:len(text)], text)
    assert (back[len(text):] == 4).all()


def test_ranges_cover_disjointly():
    n = 100_003
    mesh = Mesh(0, 8, torch.device("cpu"), "gloo")
    spans = sorted(r for v in host_shard_ranges(n, mesh).values() for r in v)
    jspans = sorted(r for v in jhost_shard_ranges(n, jmake_mesh(8)).values()
                    for r in v)
    assert spans == jspans
    assert spans[0][0] == 0 and spans[-1][1] == n
    for (_, b), (c, _) in zip(spans, spans[1:]):
        assert b == c


@pytest.mark.parametrize("case,sigma", [("mh4", 4), ("mh256", 256)])
def test_distributed_count_from_file_shards(ranks, case, sigma):
    """Counts from the file's shards, the corpus length through count(n=)
    (for sigma = 256 it keeps the 0-pad out of the count)."""
    text, pats = W.inputs(case)
    res = rank_results(ranks, 8, case)
    want = jax_count(f"{ranks[8][1]}/{case}.bin", pats, sigma)
    assert [r["count"] for r in res] == [want] * 8
    assert want == jdatagen.count_matches(text, jax_pats(pats))


def test_two_process_distributed_count(ranks):
    """test_multiprocess.py's layout: two processes, each reading only its
    own half of the file, the halo exchanged between them."""
    text, pats = W.inputs("two-process")
    res = rank_results(ranks, 2, "two-process")
    want = jdatagen.count_matches(text, jax_pats(pats))
    assert [r["count"] for r in res] == [want, want]
    assert [r["n"] for r in res] == [len(text)] * 2
