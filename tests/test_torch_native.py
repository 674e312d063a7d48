"""The port's native library (tpu_smatcher_torch/native) on the CPU: the
counterpart of every case of tests/test_native.py, plus what the port wires
to it.  Tolerance 0 throughout.

- The five table builders: the native path equals the port's numpy path
  field for field, and both equal the JAX package's builders with
  native=False (its numpy branch; its own native library is never called
  here).  native=True / "auto" / False follow the JAX package's rules, and
  make_engine builds natively by default.
- count_cpu_native and match_enum_native equal datagen's numpy count and
  attribution, and a scanner's matches(); load_fasta gives the same bytes
  with and without the native encoder; the CLI's --verify and the soak's
  NATIVE ORACLE check count with the port's library.
- Six processes loading into one empty build directory at once each get a
  working library (the build renames a finished file into place).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from tpu_smatcher import automata as jauto

from tpu_smatcher_torch import automata as tauto
from tpu_smatcher_torch import cli, make_engine, make_fast, native
from tpu_smatcher_torch.core import corpus, datagen
from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.core.patterns import PatternSet
from tpu_smatcher_torch.engines import build_tables
from tpu_smatcher_torch.tools import soak

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: builder name -> (port builder, JAX builder, extra positional args of m)
BUILDERS = {
    "ac": (tauto.build_ac, jauto.build_ac, lambda m: ()),
    "sh": (tauto.build_sh, jauto.build_sh, lambda m: ()),
    "sbom": (tauto.build_sbom, jauto.build_sbom, lambda m: ()),
    "wm": (tauto.build_wm, jauto.build_wm, lambda m: ()),
    "sog": (tauto.build_sog, jauto.build_sog, lambda m: (m,)),
}
#: the wrapper each builder calls
WRAPPERS = {"ac": "build_ac_native", "sh": "build_sh_native",
            "sbom": "build_sbom_native", "wm": "build_wm_native",
            "sog": "build_sog_native"}


def _assert_dataclass_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, (f.name, x, y)


def case(sigma, m, p, seed=0):
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(50_000, ab, seed=seed)
    return datagen.generate_patterns(text, p, m, ab, seed=seed + 1).codes


def three_ways(name, codes, sigma):
    """The native table, asserted equal to the port's numpy table and to
    the JAX package's numpy table."""
    tb, jb, extra = BUILDERS[name]
    args = (codes, sigma, *extra(codes.shape[1]))
    nat = tb(*args, native=True)
    _assert_dataclass_equal(nat, tb(*args, native=False))
    _assert_dataclass_equal(nat, jb(*args, native=False))
    return nat


@pytest.mark.parametrize("sigma,m,p", [(4, 8, 200), (4, 32, 64),
                                       (20, 16, 100), (2, 16, 50)])
def test_ac_native_matches_numpy(sigma, m, p):
    t = three_ways("ac", case(sigma, m, p, seed=sigma + m), sigma)
    assert t.n_states > 1 and t.delta.shape == (t.n_states, sigma + 1)


@pytest.mark.parametrize("sigma,m,p", [(4, 8, 200), (20, 16, 100),
                                       (2, 32, 50)])
def test_sh_native_matches_numpy(sigma, m, p):
    three_ways("sh", case(sigma, m, p, seed=7), sigma)


@pytest.mark.parametrize("sigma,m,p", [(4, 8, 200), (20, 16, 100),
                                       (4, 32, 64)])
def test_sbom_native_matches_numpy(sigma, m, p):
    three_ways("sbom", case(sigma, m, p, seed=9), sigma)


def test_sbom_duplicate_patterns():
    """Duplicates share a terminal state, their ids in insertion order."""
    pats = np.tile(np.array([[0, 1, 2, 3]], np.uint8), (3, 1))
    t = three_ways("sbom", pats, 4)
    assert t.final_ids.shape[1] == 3
    assert list(t.final_ids[t.final_count == 3][0]) == [0, 1, 2]


@pytest.mark.parametrize("sigma,m,p", [(4, 8, 60), (20, 32, 45), (2, 5, 20),
                                       (128, 12, 30)])
def test_wm_native_matches_numpy(sigma, m, p):
    pats = np.random.default_rng(17).integers(0, sigma, (p, m)).astype(
        np.uint8)
    three_ways("wm", pats, sigma)


@pytest.mark.parametrize("sigma,width", [(4, 8), (20, 16), (8, 32)])
def test_sog_native_matches_numpy(sigma, width):
    pats = np.random.default_rng(18).integers(0, sigma, (40, width)).astype(
        np.uint8)
    three_ways("sog", pats, sigma)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_native_rejects_out_of_range(name):
    """A pattern byte >= sigma is a ValueError on the native path."""
    tb, _, extra = BUILDERS[name]
    pats = np.full((2, 8), 5, np.uint8)
    with pytest.raises(ValueError):
        tb(pats, 4, *extra(8), native=True)


def test_native_sbom_rejects_out_of_range_bytes():
    with pytest.raises(ValueError):
        native.build_sbom_native(np.array([[200, 1, 2, 3]], np.uint8), 4)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_native_argument_rules(name, monkeypatch):
    """True and "auto" call the library; without it True raises
    RuntimeError and "auto" builds with numpy; False never calls it."""
    tb, _, extra = BUILDERS[name]
    pats = case(4, 8, 30, seed=3)
    args = (pats, 4, *extra(8))
    calls = []
    real = getattr(native, WRAPPERS[name])
    monkeypatch.setattr(native, WRAPPERS[name],
                        lambda *a: calls.append(1) or real(*a))
    want = tb(*args, native=False)
    assert calls == []
    _assert_dataclass_equal(tb(*args), want)
    _assert_dataclass_equal(tb(*args, native=True), want)
    assert len(calls) == 2
    monkeypatch.setattr(native, "load", lambda: None)
    with pytest.raises(RuntimeError, match="unavailable"):
        tb(*args, native=True)
    _assert_dataclass_equal(tb(*args, native="auto"), want)


@pytest.mark.parametrize("name", ["ac", "sh", "sbom", "wm", "sog8"])
def test_make_engine_builds_natively(name, monkeypatch):
    """build_tables (and so make_engine) takes the native path by default,
    and the engine counts the ground truth."""
    ab = Alphabet.dna()
    text = datagen.generate_text(20_000, ab, seed=21)
    pats = datagen.generate_patterns(text, 30, 8, ab, seed=22)
    wrapper = WRAPPERS[name[:3] if name.startswith("sog") else name]
    calls = []
    real = getattr(native, wrapper)
    monkeypatch.setattr(native, wrapper,
                        lambda *a: calls.append(1) or real(*a))
    build_tables(name, pats, device="cpu")
    assert calls == [1]
    eng = make_engine(name, pats, device="cpu")
    assert eng.count(text) == datagen.count_matches(text, pats)


def test_no_native_variable(monkeypatch):
    """TPU_SMATCHER_NO_NATIVE: load() is None, every wrapper None, and the
    callers fall back to numpy."""
    monkeypatch.setenv("TPU_SMATCHER_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    assert native.load() is None
    ab = Alphabet.dna()
    text = datagen.generate_text(20_000, ab, seed=5)
    pats = datagen.generate_patterns(text, 20, 8, ab, seed=6)
    assert native.count_cpu_native(text, pats.codes) is None
    assert native.match_enum_native(text, pats.codes) is None
    assert (datagen.count_matches(text, pats, prefer_native=True)
            == datagen.count_matches(text, pats))
    with pytest.raises(RuntimeError):
        tauto.build_ac(pats.codes, 4, native=True)


def test_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """build() reports a failed compile with the compiler's stderr and
    leaves no library behind; load() turns it into None."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="error"):
        native.build()
    assert os.listdir(tmp_path / "build") == []
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    assert native.load() is None


def test_native_fasta_encoder_matches_numpy(tmp_path, monkeypatch):
    """load_fasta with the native encoder and without it give the same
    bytes: headers, lower case, wildcards and whitespace."""
    fasta = (b">chr1 test header\n"
             b"ACGTacgtNNRY\n"
             b"GGCC AATT\n"          # interior space dropped
             b">chr2\nTTTT\r\nacgt\n")
    p = tmp_path / "t.fa"
    p.write_bytes(fasta)
    ab = Alphabet.dna()
    want = ab.encode(b"ACGTacgtNNRYGGCCAATTTTTTacgt")
    raw = np.frombuffer(fasta, np.uint8)
    np.testing.assert_array_equal(
        native.encode_fasta_native(raw, corpus._fasta_lut(ab)), want)
    np.testing.assert_array_equal(corpus.load_fasta(str(p), ab).codes, want)
    monkeypatch.setattr(native, "encode_fasta_native", lambda *a: None)
    np.testing.assert_array_equal(corpus.load_fasta(str(p), ab).codes, want)


@pytest.mark.parametrize("ab", [Alphabet.dna(), Alphabet.protein()])
def test_native_fasta_fuzz_against_numpy(ab):
    """Random streams over the bytes the rules treat apart: the native
    encoder equals the numpy encode_fasta."""
    lut = corpus._fasta_lut(ab)
    pool = np.frombuffer(b"ACGTacgtNWw>\n\r\t xZ>>\n\n\x0b\x0c\xff", np.uint8)
    rng = np.random.default_rng(9)
    for _ in range(300):
        raw = pool[rng.integers(0, pool.size, int(rng.integers(0, 300)))]
        np.testing.assert_array_equal(native.encode_fasta_native(raw, lut),
                                      corpus.encode_fasta(raw, ab))


@pytest.mark.parametrize("sigma,m,p,n", [(4, 8, 50, 40_000),
                                         (20, 32, 40, 30_000),
                                         (2, 16, 30, 20_000),
                                         (256, 12, 25, 20_000),
                                         (4, 1, 2, 5_000)])
def test_native_cpu_count_matches_numpy(sigma, m, p, n):
    """count_matches(prefer_native=True) equals the numpy oracle, at m = 1
    and sigma = 256 too; texts of 2^16 ends and more run threaded."""
    rng = np.random.default_rng(sigma * 1000 + m)
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(n, ab, seed=int(rng.integers(1e6)))
    if m == 1:
        codes = rng.integers(0, sigma, (p, 1)).astype(np.uint8)
        want = int(np.isin(text, codes.ravel()).sum())
    else:
        pats = datagen.generate_patterns(text, p, m, ab, frac_present=0.6,
                                         seed=int(rng.integers(1e6)))
        codes = pats.codes
        want = datagen.count_matches(text, pats)
    assert want > 0
    assert native.count_cpu_native(text, codes) == want
    assert datagen.count_matches(text, codes, prefer_native=True) == want


def test_native_count_threaded_on_a_larger_text():
    """2^20 bytes: the count splits over the host's threads and still
    equals numpy, duplicates included."""
    ab = Alphabet.dna()
    text = datagen.generate_text(1 << 20, ab, seed=31)
    pats = datagen.generate_patterns(text, 300, 10, ab, frac_present=0.7,
                                     seed=32)
    codes = np.concatenate([pats.codes, pats.codes[:7]])
    assert (native.count_cpu_native(text, codes)
            == datagen.count_matches(text, pats))


def test_native_match_enum_parity():
    """match_enum_native: ascending positions, the smallest id on
    duplicates, equal to datagen's count and match_ids."""
    ab = Alphabet.dna()
    text = datagen.generate_text(200_000, ab, seed=51)
    pats = datagen.generate_patterns(text, 200, 9, ab, frac_present=0.8,
                                     seed=52)
    codes = np.concatenate([pats.codes, pats.codes[:5]], axis=0)  # dups
    pos, ids = native.match_enum_native(text, codes)
    assert pos.dtype == ids.dtype == np.int64
    assert len(pos) == datagen.count_matches(text, pats)
    assert np.all(np.diff(pos) > 0)
    assert np.array_equal(pos, np.flatnonzero(datagen.match_starts(text,
                                                                   pats)))
    assert np.array_equal(ids, datagen.match_ids(text, pos, codes))


@pytest.mark.parametrize("m", [1, 8])
def test_native_match_enum_small(m):
    """m = 1 and a text below the threading threshold."""
    ab = Alphabet.dna()
    text = datagen.generate_text(3_000, ab, seed=41)
    codes = np.concatenate([text[100:100 + m], text[7:7 + m],
                            text[100:100 + m]]).reshape(3, m)
    pos, ids = native.match_enum_native(text, codes)
    assert np.array_equal(pos, np.flatnonzero(datagen.match_starts(text,
                                                                   codes)))
    assert np.array_equal(ids, datagen.match_ids(text, pos, codes))


@pytest.mark.parametrize("engine", ["fast", "wm"])
def test_scanner_matches_equal_native_enum(engine):
    """A scanner's matches() on the CPU (make_fast, and wm without its
    fast path, attributing through the port's scanner) equals the native
    enumerator, as sorted arrays."""
    ab = Alphabet.dna()
    text = datagen.generate_text(120_000, ab, seed=53)
    pats = datagen.generate_patterns(text, 64, 8, ab, frac_present=0.7,
                                     seed=54)
    eng = (make_fast(pats, device="cpu") if engine == "fast"
           else make_engine("wm", pats, device="cpu", fastpath=False))
    pos, ids = (np.asarray(x) for x in eng.matches(text))
    npos, nids = native.match_enum_native(text, pats.codes)
    order = np.argsort(pos, kind="stable")
    assert np.array_equal(pos[order], npos)
    assert np.array_equal(ids[order], nids)


def test_cli_verify_counts_natively(tmp_path, capsys, monkeypatch):
    """--verify takes its ground truth from the native counter, for a
    plain and a mixed set, equal to the numpy count."""
    ab = Alphabet.dna()
    text = datagen.generate_text(40_000, ab, seed=61)
    pats = datagen.generate_patterns(text, 30, 8, ab, frac_present=0.6,
                                     seed=62)
    tpath = tmp_path / "corpus.bin"
    text.tofile(tpath)
    ppath = pats.save(str(tmp_path / "p.npz"))
    fa = tmp_path / "mixed.fa"
    rows = [text[s:s + m] for s, m in ((10, 5), (200, 9), (3000, 9))]
    fa.write_bytes(b"".join(b">p%d\n%s\n" % (i, ab.decode(r))
                            for i, r in enumerate(rows)))
    calls = []
    real = native.count_cpu_native
    monkeypatch.setattr(native, "count_cpu_native",
                        lambda *a: calls.append(1) or real(*a))
    base = ["--text", str(tpath), "--m", "8", "--alphabet", "4",
            "--algo", "fast", "--device", "cpu", "--verify", "--json"]
    cli.main(base + ["--patterns", ppath])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert calls == [1]
    assert res["ground_truth"] == res["matches"] == datagen.count_matches(
        text, pats)
    cli.main(base + ["--patterns", str(fa)])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(calls) == 3                       # one count per length
    want = sum(datagen.count_matches(text, PatternSet(np.stack(g), ab))
               for g in ([rows[0]], rows[1:]))
    assert res["ground_truth"] == res["matches"] == want


def test_soak_checks_the_native_oracle(monkeypatch):
    """The soak holds the native count to datagen's on every trial: a
    wrong native count is reported as NATIVE ORACLE."""
    tr = soak.trials(2)[1]
    assert soak.run_trial(tr, "cpu") == []
    monkeypatch.setattr(native, "count_cpu_native", lambda *a: -1)
    bad = soak.run_trial(tr, "cpu")
    assert len(bad) == 1 and bad[0].startswith(f"[{tr.index}] NATIVE ORACLE "
                                                "-1 != ")


_RACE_CHILD = """
import sys, time
import numpy as np
from tpu_smatcher_torch import native
native.BUILD_DIR = sys.argv[1]
start = float(sys.argv[2])
while time.time() < start:
    time.sleep(0.002)
lib = native.load()
assert lib is not None, "no library"
text = (np.arange(200_000) % 4).astype(np.uint8)
pats = np.array([[0, 1, 2, 3], [3, 0, 1, 2]], np.uint8)
print(native.count_cpu_native(text, pats))
"""


def test_concurrent_first_loads_race_free(tmp_path):
    """Six processes load into one empty build directory at once, their
    starts 0.2 s apart, so that later ones find a build under way: each
    compiles to a file of its own and renames it into place, so every one
    loads a whole library; one library is left, no temporary file."""
    build_dir = str(tmp_path / "build")
    start = time.time() + 3.0       # after every child has imported
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("TPU_SMATCHER_NO_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", _RACE_CHILD, build_dir,
                               str(start + 0.2 * i)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(6)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    text = (np.arange(200_000) % 4).astype(np.uint8)
    want = native.count_cpu_native(text, np.array([[0, 1, 2, 3],
                                                   [3, 0, 1, 2]], np.uint8))
    assert want == 50_000 + 49_999
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert int(out.strip()) == want
    left = os.listdir(build_dir)
    assert len(left) == 1 and left[0].endswith(".so"), left
