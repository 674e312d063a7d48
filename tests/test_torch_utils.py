"""The port's KMP, its torch.profiler trace and top-level scan() against
the JAX package's, on the CPU (tolerance 0 for tables and counts)."""

import json

import numpy as np
import pytest
import torch

import tpu_smatcher as jts
from tpu_smatcher.automata.kmp import kmp_count as jkmp_count
from tpu_smatcher.automata.kmp import pre_kmp as jpre_kmp
from tpu_smatcher.utils.debug import dprint as jdprint

import tpu_smatcher_torch as ts
from tpu_smatcher_torch.automata import kmp_count, pre_kmp
from tpu_smatcher_torch.core import datagen
from tpu_smatcher_torch.utils import dprint, trace

from torch_cases import jax_pats, make_case


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("sigma", [2, 4, 20])
def test_pre_kmp_and_kmp_count_equal_jax_and_naive(seed, sigma):
    rng = np.random.default_rng(10 * seed + sigma)
    m = int(rng.integers(1, 12))
    p = rng.integers(0, sigma, m).astype(np.uint8)
    t = rng.integers(0, sigma, 3000).astype(np.uint8)
    if seed == 0:                 # a pattern with long borders
        p = np.zeros(m, np.uint8)
    np.testing.assert_array_equal(pre_kmp(p), jpre_kmp(p))
    naive = sum(1 for i in range(len(t) - m + 1) if (t[i:i + m] == p).all())
    assert kmp_count(p, t) == jkmp_count(p, t) == naive


def test_pre_kmp_known():
    p = np.array([0, 1, 0, 1, 0, 0], np.uint8)      # "ababaa"
    np.testing.assert_array_equal(pre_kmp(p), [-1, 0, -1, 0, -1, 3, 1])
    assert kmp_count(p, p[:3]) == 0 and kmp_count(p[:0], p) == 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.ones(1000).cumsum(0)
    assert prof.key_averages()
    assert json.loads((tmp_path / "trace.json").read_text())


@pytest.mark.parametrize("sigma,m,engine", [(4, 8, "fast"), (4, 16, "fast"),
                                            (4, 8, "wm")])
def test_scan_on_the_cpu_equals_jax_scan(sigma, m, engine):
    text, pats = make_case(sigma, m, 30, 30_000, seed=70 + m)
    jopts = {"backend": "xla"} if engine == "fast" else {"fastpath": False}
    want = jts.scan(text, jax_pats(pats), engine=engine, tile=1 << 12,
                    **jopts)
    r = ts.scan(text, pats, engine=engine, device="cpu", reps=2,
                tile=1 << 12)
    assert set(r) == set(want) == {"engine", "matches", "bytes", "preproc_s",
                                   "scan_s", "bytes_per_s"}
    assert r["matches"] == want["matches"] == \
        datagen.count_matches(text, pats)
    assert r["engine"] == engine and r["bytes"] == want["bytes"] == 30_000
    assert r["bytes_per_s"] > 0 and r["scan_s"] > 0


@pytest.mark.parametrize("arg", ["tensor", "scalar"])
def test_dprint_formats_like_jax(arg, capfd):
    """dprint formats a tensor argument read to the host, and a python
    scalar, as the JAX package's dprint prints the same values."""
    import jax.numpy as jnp
    if arg == "tensor":
        jargs = (jnp.arange(3, dtype=jnp.int32), jnp.float32(1.5))
        targs = (torch.arange(3, dtype=torch.int32), torch.tensor(1.5))
        want = "v=[0 1 2] f=1.5"
    else:
        jargs = targs = (7, 2.5)
        want = "v=7 f=2.5"
    jdprint("v={} f={}", *jargs)
    jout = capfd.readouterr().out
    dprint("v={} f={}", *targs)
    out = capfd.readouterr().out
    assert out == jout == want + "\n"
