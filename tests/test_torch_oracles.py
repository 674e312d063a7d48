"""The port's conformance oracles (tpu_smatcher_torch/oracles) and numpy
scan references (tpu_smatcher_torch/ops/numpy_ref.py) against the JAX
package's on the same seeded inputs, and against datagen.

Tolerance 0: every output is an integer count.  The table dataclasses of
the two packages have the same fields; the one difference the numpy
references meet is where pack_rows lives (the JAX package's
automata/verify.py, the port's ops/lookup.py)."""

import numpy as np
import pytest

from tpu_smatcher.automata import (build_ac as j_build_ac,
                                   build_sbom as j_build_sbom,
                                   build_sh as j_build_sh,
                                   build_sog as j_build_sog,
                                   build_verify as j_build_verify,
                                   build_wm as j_build_wm)
from tpu_smatcher.ops import numpy_ref as j_nref
from tpu_smatcher.oracles import ORACLES as J_ORACLES
from tpu_smatcher_torch.automata import (build_ac, build_sbom, build_sh,
                                         build_sog, build_verify, build_wm)
from tpu_smatcher_torch.core import datagen
from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.ops import numpy_ref as nref
from tpu_smatcher_torch.oracles import ORACLES
import torch_cases  # noqa: F401  (one torch thread per test process)

SIGMAS = (2, 4, 20, 256)
MS = (8, 16, 32)


def _case(sigma, m, n=3000, p=30):
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(n, ab, seed=sigma + m)
    pats = datagen.generate_patterns(text, p, m, ab, frac_present=0.6,
                                     seed=sigma * m)
    return text, pats.codes


def _shared_suffix():
    """tests/test_automata.py's shared-suffix set: 40 DNA patterns ending
    in the same 3-gram, one planted three times."""
    ab = Alphabet.dna()
    rng = np.random.default_rng(3)
    base = rng.integers(0, 4, size=(40, 8)).astype(np.uint8)
    base[:, 5:] = ab.encode(b"ACG")
    text = datagen.plant(datagen.generate_text(6000, ab, seed=4), base[7],
                         [100, 200, 300])
    return text, base


def _oracle_names(m):
    return [k for k in ORACLES if not k.startswith("sog") or int(k[3:]) == m]


def test_oracle_sets_match():
    assert sorted(ORACLES) == sorted(J_ORACLES)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("sigma", SIGMAS)
def test_oracles_match_jax_and_datagen(sigma, m):
    """Every port oracle (and sog{m} at its width) counts what the JAX
    package's oracle of the same name counts, and datagen's truth."""
    text, codes = _case(sigma, m)
    truth = datagen.count_matches(text, codes)
    assert truth > 0
    for name in _oracle_names(m):
        got = ORACLES[name](text, codes, sigma)
        assert got == J_ORACLES[name](text, codes, sigma) == truth, name


def test_oracles_shared_suffix():
    text, codes = _shared_suffix()
    truth = datagen.count_matches(text, codes)
    assert truth >= 3
    for name in _oracle_names(8):
        assert ORACLES[name](text, codes, 4) == \
            J_ORACLES[name](text, codes, 4) == truth, name


def test_oracle_errors_match():
    """The oracles refuse what the JAX package's refuse: SOG off its
    width, Wu-Manber below B = 3 or on an unsupported alphabet."""
    text, codes = _case(4, 8)
    for fn in ("sog16", "wm"):
        bad = codes[:, :2] if fn == "wm" else codes
        for table in (ORACLES, J_ORACLES):
            with pytest.raises(ValueError):
                table[fn](text, bad, 4)
    for table in (ORACLES, J_ORACLES):
        with pytest.raises(ValueError):
            table["wm"](text, codes, 5)


def _scans(text, codes, sigma, m):
    """{name: (port count, JAX count)} of every numpy reference scan, each
    over its own package's tables."""
    out = {}
    ac, jac = build_ac(codes, sigma), j_build_ac(codes, sigma, native=False)
    if sigma < 256:        # the lane scan pads with the symbol sigma
        out["ac"] = (nref.scan_ac_np(text, ac, lanes=16),
                     j_nref.scan_ac_np(text, jac, lanes=16))
    out["ac_flat"] = (nref.scan_ac_flat_np(text, ac),
                      j_nref.scan_ac_flat_np(text, jac))
    vt = build_verify(codes, sigma)
    jvt = j_build_verify(codes, sigma)
    out["wm"] = (nref.scan_wm_np(text, build_wm(codes, sigma), vt),
                 j_nref.scan_wm_np(text, j_build_wm(codes, sigma,
                                                    native=False), jvt))
    out["sh"] = (nref.scan_sh_np(text, build_sh(codes, sigma)),
                 j_nref.scan_sh_np(text, j_build_sh(codes, sigma,
                                                    native=False)))
    out["sbom"] = (nref.scan_sbom_np(text, build_sbom(codes, sigma), vt),
                   j_nref.scan_sbom_np(text, j_build_sbom(codes, sigma,
                                                          native=False),
                                       jvt))
    if m in (8, 16, 32):
        sog = build_sog(codes, sigma, m)
        jsog = j_build_sog(codes, sigma, m, native=False)
        out["sog"] = (nref.scan_sog_np(text, sog, vt),
                      j_nref.scan_sog_np(text, jsog, jvt))
        np.testing.assert_array_equal(nref.sog_candidates_np(text, sog),
                                      j_nref.sog_candidates_np(text, jsog))
    return out


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("sigma", SIGMAS)
def test_numpy_ref_matches_jax_and_datagen(sigma, m):
    text, codes = _case(sigma, m)
    truth = datagen.count_matches(text, codes)
    for name, (got, want) in _scans(text, codes, sigma, m).items():
        assert got == want == truth, name


def test_numpy_ref_shared_suffix_and_short_text():
    text, codes = _shared_suffix()
    assert build_verify(codes, 4).lmax >= 30
    truth = datagen.count_matches(text, codes)
    for name, (got, want) in _scans(text, codes, 4, 8).items():
        assert got == want == truth, name
    short = np.zeros(5, np.uint8)
    assert nref.scan_ac_np(short, build_ac(codes, 4)) == 0
    assert nref.scan_wm_np(short, build_wm(codes, 4),
                           build_verify(codes, 4)) == 0


def test_segment_text_matches_jax():
    text, _ = _case(4, 8, n=1001)
    np.testing.assert_array_equal(nref.segment_text(text, 7, 8, 4),
                                  j_nref.segment_text(text, 7, 8, 4))
