"""PyTorch port, the slice as a whole: make_fast(pats, device=...).count
equals the JAX package and the ground truth; overflow retries are exact,
visible and adapt as the JAX package's do; the port imports nothing of the
JAX package and never falls back silently.  All integer: tolerance 0."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_smatcher.core import datagen as jdatagen
from tpu_smatcher.engines import make_fast as jax_make_fast
from tpu_smatcher.ops import fast as jfast

import tpu_smatcher_torch
from tpu_smatcher_torch import _build, make_fast
from tpu_smatcher_torch.core import datagen
from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.core.patterns import PatternSet
from tpu_smatcher_torch.ops import fast as tfast

from torch_cases import CASES, dense_case, jax_pats, make_case, wide_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("sigma,m,p_size,n", CASES)
def test_slice_matches_jax(sigma, m, p_size, n):
    text, pats = make_case(sigma, m, p_size, n, seed=3 * sigma + m)
    truth = datagen.count_matches(text, pats)
    jeng = jax_make_fast(jax_pats(pats), tile=1 << 14, cap=1 << 12,
                         backend="xla")
    eng = make_fast(pats, device="cpu")
    assert eng.ft.exact == jeng.ft.exact
    assert eng.count(text) == jeng.count(text) == truth
    assert eng.fallback_scans == 0


@pytest.mark.parametrize("frac", [0.02, 0.5])
def test_wide_case_routes_like_jax(frac):
    """On the saturating wide case the port takes JAX's cascade entry,
    (k1, kt) included, and counts exactly without a retry — also at
    frac 0.5, where JAX's compact_valrows overflows a packed 1024-start
    row (a lane-repack artefact the port does not have) and retries."""
    text, pats = wide_case(frac)
    jft = jfast.build_fast(pats.codes, 4, stage_bits=32768)
    tft = tfast.build_fast(pats.codes, 4, stage_bits=32768, device="cpu")
    jeng = jfast.FastScanner(jft, cap=1 << 14, backend="pallas",
                             interpret=True)
    eng = tfast.FastScanner(tft, cap=1 << 14)
    n = len(text)
    k = tfast.stages_for(tft, n, eng.cap)
    assert k == jfast.stages_for(jft, n, jeng.cap)
    assert eng._pick_path(n, k) == jeng._pick_path(n, k)
    assert eng._pick_path(n, k)[0] == "cascade"
    assert eng.count(text) == datagen.count_matches(text, pats)
    assert eng.fallback_scans == 0


def _jax_pallas(codes, sigma, stage_bits, **kw):
    return jfast.FastScanner(jfast.build_fast(codes, sigma,
                                              stage_bits=stage_bits),
                             backend="pallas", interpret=True, **kw)


def test_dense_corpus_falls_back_exact():
    """A run of matches overflows the cascade's rows on the async path; the
    sync path (mask pipeline, row-dense trial) counts it without overflow;
    the retry is exact and switches the scanner to the dense pass — each
    step as in the JAX package on the same input."""
    text, pats = dense_case()
    truth = datagen.count_matches(text, pats)
    # a 4096 cap holds the run's 2028 matches and keeps the sync trials'
    # compactions small; the route (cascade) is the default cap's
    jeng = _jax_pallas(pats.codes, 4, 32768, cap=1 << 12)
    eng = tfast.FastScanner(tfast.build_fast(pats.codes, 4,
                                             stage_bits=32768, device="cpu"),
                            cap=1 << 12)
    assert eng.count_with_overflow(text) == jeng.count_with_overflow(text) \
        == (truth, False)
    assert eng.count(text) == jeng.count(text) == truth
    assert eng.fallback_scans == jeng._retries == 1
    assert (eng._k_extra, eng._match_dense) == \
        (jeng._k_extra, jeng._match_dense) == (0, True)
    assert eng.count(text) == truth and eng.fallback_scans == 1   # steady


def test_retry_adds_a_stage_after_false_candidate_overflow():
    """_async_retry on a match-sparse text: exact count, and one more
    filter stage for later scans, routed as the JAX package routes it."""
    ab = Alphabet.of_size(4)
    text = datagen.generate_text(1 << 17, ab, seed=9)
    pats = datagen.generate_patterns(text, 3000, 32, ab, frac_present=0.0,
                                     seed=10)
    jeng = _jax_pallas(pats.codes, 4, 8192)
    eng = tfast.FastScanner(tfast.build_fast(pats.codes, 4,
                                             stage_bits=8192, device="cpu"))
    n = len(text)
    k = tfast.stages_for(eng.ft, n, eng.cap)
    before = eng._pick_path(n, k)
    truth = datagen.count_matches(text, pats)
    assert eng._async_retry(torch.from_numpy(text)) == \
        jeng._async_retry(text) == truth
    assert eng.fallback_scans == 1 and eng._k_extra == jeng._k_extra == 1
    assert not eng._match_dense
    assert eng._pick_path(n, k) == jeng._pick_path(n, k) != before
    assert eng.count(text) == truth


def test_fast_count_core_and_overflow_flag():
    """The tiled core counts exactly; an all-match corpus overflows a small
    cap on the raw API (test_fast.py::test_overflow_flag's case)."""
    for case in (CASES[2], CASES[3], CASES[5]):
        sigma, m, p, n = case
        text, pats = make_case(sigma, m, p, n, seed=3 * sigma + m)
        ft = tfast.build_fast(pats.codes, sigma, device="cpu")
        c, o = tfast.fast_count_core(torch.from_numpy(text), ft,
                                     tile=1 << 14, cap=1 << 12)
        assert (int(c), int(o)) == (datagen.count_matches(text, pats), 0)
    ft = tfast.build_fast(np.zeros((1, 16), np.uint8), 4, device="cpu")
    zeros = torch.zeros(40_000, dtype=torch.uint8)
    _, o = tfast.fast_count_core(zeros, ft, tile=1 << 14, cap=1 << 8)
    assert int(o) == 1
    c, o = tfast.fast_count_core(zeros, ft, tile=1 << 8, cap=1 << 8)
    assert (int(c), int(o)) == (40_000 - 15, 0)


def test_long_patterns_run_the_tiled_core():
    """m > 4097 is beyond the kernels: the scanner runs fast_count_core."""
    ab = Alphabet.dna()
    text = datagen.generate_text(12_000, ab, seed=43)
    pats = datagen.generate_patterns(text, 4, 4100, ab, frac_present=0.5,
                                     seed=44)
    eng = make_fast(pats, device="cpu")
    assert eng.count(text) == datagen.count_matches(text, pats) >= 1


def test_count_async_and_device_checks():
    text, pats = make_case(4, 16, 64, 50_000, seed=5)
    eng = make_fast(pats, device="cpu")
    fut = eng.count_async(torch.from_numpy(text))
    assert fut.result() == datagen.count_matches(text, pats)
    assert eng.count(text[:10]) == 0                  # n < m
    with pytest.raises(TypeError):
        eng.count(torch.zeros(100, dtype=torch.int32))


def test_port_imports_no_jax():
    """A fresh interpreter that imports the port, makes data with its own
    generator, counts and enumerates positions and pattern ids on the CPU,
    and counts through the seven named engines, with and without their
    fast path (attributing without it), then imports the oracles, the
    numpy references and every tool and runs the soak's first trial, then
    counts and enumerates with the native library, holds no jax and no
    tpu_smatcher* module."""
    code = (
        "import sys\n"
        "import tpu_smatcher_torch as t\n"
        "from tpu_smatcher_torch.core import datagen\n"
        "ab = t.Alphabet.dna()\n"
        "text = datagen.generate_text(20000, ab, seed=1)\n"
        "pats = datagen.generate_patterns(text, 20, 16, ab, seed=2)\n"
        "s = t.make_fast(pats, device='cpu')\n"
        "c = s.count(text)\n"
        "assert c == datagen.count_matches(text, pats), c\n"
        "pos, ids = s.matches(text)\n"
        "assert len(s.positions(text)) == len(pos) == c\n"
        "assert s.count_per_pattern(text).sum() == c\n"
        "for name in t.ENGINE_NAMES:\n"
        "    m = int(name[3:]) if name.startswith('sog') else 16\n"
        "    ps = datagen.generate_patterns(text, 20, m, ab, seed=3)\n"
        "    want = datagen.count_matches(text, ps)\n"
        "    for fastpath in (True, False):\n"
        "        e = t.make_engine(name, ps, device='cpu', fastpath=fastpath)\n"
        "        assert e.count(text) == want, (name, fastpath)\n"
        "    assert e.count_per_pattern(text).sum() == want, name\n"
        "from tpu_smatcher_torch.oracles import ORACLES\n"
        "from tpu_smatcher_torch.ops import numpy_ref\n"
        "from tpu_smatcher_torch.engines import build_tables\n"
        "from tpu_smatcher_torch.tools import (compare_sweeps,\n"
        "    find_fp_collision, ladder, soak, sweep)\n"
        "assert ORACLES['ac'](text, pats.codes, 4) == c\n"
        "tb = build_tables('sh', pats, device='cpu')['main']\n"
        "assert numpy_ref.scan_sh_np(text, tb) == c\n"
        "assert soak.run_trial(soak.trials(1)[0], 'cpu') == []\n"
        "from tpu_smatcher_torch import native\n"
        "assert native.load() is not None\n"
        "assert native.count_cpu_native(text, pats.codes) == c\n"
        "assert len(native.match_enum_native(text, pats.codes)[0]) == c\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'tpu_smatcher' or k.startswith('tpu_smatcher.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_ab_cascade_needs_a_card():
    """The in-process cascade A/B refuses to run without CUDA, before it
    builds anything."""
    from tpu_smatcher_torch import ab_cascade
    assert ab_cascade.main([REPO]) == 1


@pytest.mark.parametrize("sigma,m,p,seed", [(4, 16, 50, 1), (20, 8, 300, 7),
                                            (256, 32, 10, 40)])
def test_datagen_matches_jax(sigma, m, p, seed):
    """The port's data generator makes the JAX package's bytes."""
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(5000, ab, seed=seed)
    jab = jax_pats(PatternSet(np.zeros((1, 1), np.uint8), ab)).alphabet
    jtext = jdatagen.generate_text(5000, jab, seed=seed)
    assert np.array_equal(text, jtext)
    for frac in (0.0, 0.5, 1.0):
        pats = datagen.generate_patterns(text, p, m, ab, frac_present=frac,
                                         seed=seed + 1)
        jp = jdatagen.generate_patterns(jtext, p, m, jab, frac_present=frac,
                                        seed=seed + 1)
        assert np.array_equal(pats.codes, jp.codes)
        assert datagen.count_matches(text, pats) == \
            jdatagen.count_matches(jtext, jp)
    planted = datagen.plant(text, pats.codes[0], [0, 100, 4000])
    assert np.array_equal(planted, jdatagen.plant(jtext, jp.codes[0],
                                                  [0, 100, 4000]))


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_make_fast_cuda_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pats = PatternSet(np.zeros((2, 8), np.uint8), Alphabet.dna())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpu_smatcher_torch.make_fast(pats)
    with pytest.raises(ValueError):
        make_fast(pats, device="meta")
