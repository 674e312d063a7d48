"""The port's file front end and table checkpoints against the JAX
package's, on the CPU, tolerance 0 (bytes, codes, ids and counts):
Alphabet.decode; PatternSet / MixedPatternSet from strings and FASTA, and
.npz files saved by one package and loaded by the other; load_raw and
load_fasta against both of the JAX package's FASTA encoders (its native
LUT, and its line loop on input without '\\v' or '\\f', where the two
differ); checkpoints of every table class, and fast tables saved by one
package and counted by the other."""

import dataclasses

import numpy as np
import pytest

from tpu_smatcher import native
from tpu_smatcher.core import checkpoint as jcheckpoint
from tpu_smatcher.core import corpus as jcorpus
from tpu_smatcher.core.alphabet import Alphabet as JAlphabet
from tpu_smatcher.core.patterns import MixedPatternSet as JMixedPatternSet
from tpu_smatcher.core.patterns import PatternSet as JPatternSet
from tpu_smatcher.engines import build_tables as jbuild_tables
from tpu_smatcher.engines import make_engine_from_tables as \
    jmake_engine_from_tables
from tpu_smatcher.ops import fast as jfast

from tpu_smatcher_torch.automata import (build_ac, build_sbom, build_sh,
                                         build_sog, build_verify, build_wm)
from tpu_smatcher_torch.core import checkpoint, corpus, datagen
from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.core.patterns import MixedPatternSet, PatternSet
from tpu_smatcher_torch.engines import build_tables, make_engine_from_tables
from tpu_smatcher_torch.ops import fast as tfast

from torch_cases import assert_tables_equal, jax_pats, make_case


def _jab(ab):
    return JAlphabet(ab.size, ab.chars, ab.name)


# ---------------------------------------------------------------------------
# alphabets and pattern sets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ab", [Alphabet.dna(), Alphabet.protein(),
                                Alphabet.byte(), Alphabet(5)])
def test_alphabet_decode(ab):
    codes = np.random.default_rng(ab.size).integers(0, ab.size, 500,
                                                    dtype=np.uint8)
    got = ab.decode(codes)
    assert got == _jab(ab).decode(codes)
    if ab.chars is not None:
        np.testing.assert_array_equal(ab.encode(got), codes)


def test_pattern_set_from_strings_fasta_and_flat(tmp_path):
    ab = Alphabet.dna()
    fa = tmp_path / "p.fa"
    fa.write_bytes(b">a\nACGT\nACGT\n>b\nTTTTACGT\n>c desc\nacgtacgt\n")
    ps = PatternSet.from_fasta(str(fa), ab)
    jps = JPatternSet.from_fasta(str(fa), _jab(ab))
    assert ps.p_size == 3 and ps.m == 8
    np.testing.assert_array_equal(ps.codes, jps.codes)
    np.testing.assert_array_equal(ps.codes[2], [0, 1, 2, 3, 0, 1, 2, 3])
    np.testing.assert_array_equal(ps.flat(), jps.flat())
    strs = ["ACGTNACG", b"ttttaaaa"]
    np.testing.assert_array_equal(PatternSet.from_strings(strs, ab).codes,
                                  JPatternSet.from_strings(strs,
                                                           _jab(ab)).codes)
    with pytest.raises(ValueError, match="one length"):
        PatternSet.from_strings(["ACG", "ACGT"], ab)
    (tmp_path / "empty.fa").write_bytes(b">only a header\n")
    with pytest.raises(ValueError, match="no FASTA records"):
        PatternSet.from_fasta(str(tmp_path / "empty.fa"), ab)


def test_mixed_pattern_set_from_fasta(tmp_path):
    ab = Alphabet.dna()
    fa = tmp_path / "mixed.fa"
    fa.write_bytes(b">a\nACGTA\n>b\nACGT\nACGT\n>c\r\nggg\r\nTTa\r\n"
                   b">d\nNNNNN\n\n>e\nAC GT  A\n")
    mx = MixedPatternSet.from_fasta(str(fa), ab)
    jmx = JMixedPatternSet.from_fasta(str(fa), _jab(ab))
    assert mx.lengths == jmx.lengths == (5, 6, 8)
    for g, gid, jg, jgid in zip(mx.groups, mx.ids, jmx.groups, jmx.ids):
        np.testing.assert_array_equal(g.codes, jg.codes)
        np.testing.assert_array_equal(gid, jgid)
    strs = ["ACGTAC", "AC", "tttttt"]
    mxs = MixedPatternSet.from_strings(strs, ab)
    jmxs = JMixedPatternSet.from_strings(strs, _jab(ab))
    for g, jg in zip(mxs.groups, jmxs.groups):
        np.testing.assert_array_equal(g.codes, jg.codes)


@pytest.mark.parametrize("ab", [Alphabet.dna(), Alphabet(7)])
def test_pattern_set_save_load_across_packages(tmp_path, ab):
    codes = np.random.default_rng(3).integers(0, ab.size, (20, 9),
                                              dtype=np.uint8)
    ps = PatternSet(codes, ab)
    path = ps.save(str(tmp_path / "port"))
    assert path.endswith("port.npz")
    jps = JPatternSet.load(path)
    np.testing.assert_array_equal(jps.codes, codes)
    assert (jps.alphabet.size, jps.alphabet.chars) == (ab.size, ab.chars)
    jpath = JPatternSet(codes, _jab(ab)).save(str(tmp_path / "jax.npz"))
    assert jpath.endswith("jax.npz")
    back = PatternSet.load(jpath)
    np.testing.assert_array_equal(back.codes, codes)
    assert (back.alphabet.size, back.alphabet.chars) == (ab.size, ab.chars)
    np.testing.assert_array_equal(PatternSet.load(path).codes, codes)


# ---------------------------------------------------------------------------
# corpora
# ---------------------------------------------------------------------------

#: the FASTA inputs the encoders must agree on: CRLF line ends, lowercase,
#: N and other bytes outside the alphabet (code 0), '>' inside a line
#: (data), no final newline, blank lines, a leading blank, a header that
#: ends the file
FASTA_CASES = {
    "crlf": b">chr1 first\r\nACGTacgt\r\nNNac\r\n>chr2\r\nTTGA\r\n",
    "outside": b">x\nACGTNRYKM*-.acgtn0123\n",
    "gt_inside": b">h\nAC>GT\nA>\n>>g\nTT\n",
    "no_final_newline": b">h\nACGT\nAC",
    "blank_lines": b"\n\n>h\n\nACGT\n\n\nTTTT\n\n>h2\n\nGG\n",
    "leading_blank": b" >not a header\nACGT\n\t\nAC G T\n",
    "header_at_end": b"ACGT\n>last header, no newline",
    "no_header": b"ACGTACGT\nTTTT",
    "empty": b"",
}


def _write(tmp_path, data, name="c.fa"):
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def _jax_python_fasta(monkeypatch, path, ab):
    """The JAX package's line loop: its load_fasta with the native encoder
    unavailable."""
    monkeypatch.setattr(native, "encode_fasta_native", lambda *a: None)
    return jcorpus.load_fasta(path, _jab(ab)).codes


@pytest.mark.parametrize("name", sorted(FASTA_CASES))
@pytest.mark.parametrize("ab", [Alphabet.dna(), Alphabet.protein()])
def test_load_fasta_equals_both_jax_encoders(tmp_path, monkeypatch, name,
                                             ab):
    path = _write(tmp_path, FASTA_CASES[name])
    got = corpus.load_fasta(path, ab)
    assert got.name == "c.fa" and got.n == got.codes.size
    assert got.codes.dtype == np.uint8
    raw = np.fromfile(path, np.uint8)
    want = native.encode_fasta_native(raw, jcorpus._fasta_lut(_jab(ab)))
    if want is not None:
        np.testing.assert_array_equal(got.codes, want)
    np.testing.assert_array_equal(got.codes,
                                  _jax_python_fasta(monkeypatch, path, ab))


def test_load_fasta_follows_the_native_lut_on_vt_ff(tmp_path):
    """'\\v' and '\\f' are data (code 0) for the native LUT the port
    follows; the JAX package's line loop drops them."""
    path = _write(tmp_path, b">h\nAC\x0bGT\x0c\n")
    np.testing.assert_array_equal(corpus.load_fasta(path,
                                                    Alphabet.dna()).codes,
                                  [0, 1, 0, 2, 3, 0])


def test_load_fasta_fuzz_against_the_native_encoder():
    """Random streams over the bytes the rules treat apart."""
    if native.load() is None:
        pytest.skip("the JAX package's native library did not load")
    ab = Alphabet.dna()
    lut = jcorpus._fasta_lut(_jab(ab))
    pool = np.frombuffer(b"ACGTacgtN>\n\r\t xZ>>\n\n", np.uint8)
    rng = np.random.default_rng(9)
    for _ in range(300):
        raw = pool[rng.integers(0, pool.size, int(rng.integers(0, 200)))]
        np.testing.assert_array_equal(corpus.encode_fasta(raw, ab),
                                      native.encode_fasta_native(raw, lut))


def test_load_fasta_without_a_char_map(tmp_path, monkeypatch):
    """Pre-encoded records: the line loop, which drops every ASCII
    whitespace byte and validates the codes."""
    ab = Alphabet(4)
    data = b">h\n\x00\x01\x02\x03\r\n\x03\x0b\x02\n>g\n\x01\x01"
    path = _write(tmp_path, data)
    got = corpus.load_fasta(path, ab).codes
    np.testing.assert_array_equal(got, [0, 1, 2, 3, 3, 2, 1, 1])
    np.testing.assert_array_equal(got,
                                  _jax_python_fasta(monkeypatch, path, ab))
    with pytest.raises(ValueError, match="sigma=4"):
        corpus.load_fasta(_write(tmp_path, b">h\n\x07\n", "bad.fa"), ab)


@pytest.mark.parametrize("ab", [Alphabet.dna(), Alphabet(4)])
def test_load_raw(tmp_path, ab):
    text = datagen.generate_text(5_000, Alphabet(4), seed=5)
    data = ab.decode(text) if ab.chars else text.tobytes()
    path = _write(tmp_path, data, "c.bin")
    got = corpus.load_raw(path, ab)
    np.testing.assert_array_equal(got.codes, text)
    np.testing.assert_array_equal(got.codes,
                                  jcorpus.load_raw(path, _jab(ab)).codes)
    assert got.name == "c.bin"


def test_fasta_round_trip_of_a_corpus(tmp_path):
    """A text written as FASTA (60-byte lines, two records, through
    decode) loads back as the same codes."""
    ab = Alphabet.dna()
    text = datagen.generate_text(10_007, ab, seed=6)
    raw = ab.decode(text)
    half = len(raw) // 2
    lines = [b">rec1 one"] + [raw[i:min(i + 60, half)]
                              for i in range(0, half, 60)]
    lines += [b">rec2"] + [raw[i:min(i + 60, len(raw))]
                           for i in range(half, len(raw), 60)]
    path = _write(tmp_path, b"\n".join(lines) + b"\n")
    np.testing.assert_array_equal(corpus.load_fasta(path, ab).codes, text)


# ---------------------------------------------------------------------------
# table checkpoints
# ---------------------------------------------------------------------------

def _assert_equal_dc(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if hasattr(va, "shape"):
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
            assert np.asarray(va).dtype == np.asarray(vb).dtype, f.name
        else:
            assert va == vb, f.name


@pytest.fixture(scope="module")
def setup():
    return make_case(4, 8, 50, 20_000, seed=11)


@pytest.mark.parametrize("builder", [
    lambda c, s: build_ac(c, s),
    lambda c, s: build_sh(c, s),
    lambda c, s: build_sbom(c, s),
    lambda c, s: build_wm(c, s),
    lambda c, s: build_sog(c, s, 8),
    lambda c, s: build_verify(c, s),
], ids=["ac", "sh", "sbom", "wm", "sog8", "verify"])
def test_roundtrip_each_class(tmp_path, setup, builder):
    """Save and load in the port, and load the port's file in the JAX
    package: the same fields."""
    _, pats = setup
    tb = builder(pats.codes, pats.sigma)
    p = tmp_path / "t.npz"
    checkpoint.save_tables(p, tb)
    _assert_equal_dc(tb, checkpoint.load_tables(p))
    _assert_equal_dc(tb, jcheckpoint.load_tables(p))


def test_roundtrip_dict_and_engine(tmp_path, setup):
    """build_tables' dicts through a file, in both directions: the wm
    engine over the loaded tables counts as the JAX package's."""
    text, pats = setup
    p, jp = tmp_path / "wm.npz", tmp_path / "jwm.npz"
    checkpoint.save_tables(p, build_tables("wm", pats))
    jcheckpoint.save_tables(jp, jbuild_tables("wm", jax_pats(pats)))
    want = datagen.count_matches(text, pats)
    for path in (p, jp):
        out = checkpoint.load_tables(path)
        assert set(out) == {"main", "verify"}
        eng = make_engine_from_tables("wm", out, device="cpu")
        assert eng.count(text) == want
        jeng = jmake_engine_from_tables("wm", jcheckpoint.load_tables(path))
        assert jeng.count(text) == want


def _fast_case(kind):
    """(text, pats, stage_bits) of the exact tier, the fp tier and wide
    stages."""
    if kind == "exact":
        text, pats = make_case(4, 8, 200, 30_000, seed=12)
        return text, pats, None
    if kind == "fp":
        text, pats = make_case(20, 16, 40, 30_000, seed=13)
        return text, pats, None
    ab = Alphabet.dna()
    text = datagen.generate_text(1 << 16, ab, seed=31)
    pats = datagen.generate_patterns(text, 300, 16, ab, frac_present=0.5,
                                     seed=32)
    return text, pats, 1 << 17


@pytest.mark.parametrize("kind", ["exact", "fp", "wide"])
def test_fast_tables_across_packages(tmp_path, kind):
    """A FastTables saved by the JAX package loads into the port (on the
    CPU) and one saved by the port loads into the JAX package: the fields
    agree, and both scanners count and attribute (count_per_pattern,
    orig_ids / wid_pids) the same."""
    text, pats, stage_bits = _fast_case(kind)
    truth = datagen.count_matches(text, pats)
    jft = jfast.build_fast(pats.codes, pats.sigma, stage_bits=stage_bits)
    tft = tfast.build_fast(pats.codes, pats.sigma, stage_bits=stage_bits,
                           device="cpu")
    assert jft.exact == (kind == "exact")
    jp, tp = tmp_path / "jax.npz", tmp_path / "port.npz"
    jcheckpoint.save_tables(jp, jft)
    checkpoint.save_tables(tp, tft)

    ported = checkpoint.load_tables(jp, device="cpu")
    assert_tables_equal(jft, ported)
    assert_tables_equal(jft, checkpoint.load_tables(tp, device="cpu"))
    eng = make_engine_from_tables("fast", {"main": ported}, device="cpu")
    want_per = jfast.FastScanner(jft, backend="xla").count_per_pattern(text)
    assert eng.count(text) == truth
    np.testing.assert_array_equal(eng.count_per_pattern(text), want_per)

    # the JAX package's default: FastTables on its device (its scanner
    # does not take numpy tables); it reads its JSON tuples back as lists,
    # on its own files too
    jloaded = jcheckpoint.load_tables(tp)
    assert_tables_equal(dataclasses.replace(
        jloaded, stage_fills=tuple(jloaded.stage_fills),
        stage_cd=tuple(tuple(cd) for cd in jloaded.stage_cd)), tft)
    jeng = jfast.FastScanner(jloaded, backend="xla")
    assert jeng.count(text) == truth
    np.testing.assert_array_equal(np.asarray(jeng.count_per_pattern(text)),
                                  want_per)


def test_fast_tables_load_on_the_device_asked_for(tmp_path, setup):
    """load_tables builds FastTables on `device`; build_tables' dict of a
    fast table goes through a file too."""
    text, pats = setup
    p = tmp_path / "fast.npz"
    checkpoint.save_tables(p, build_tables("fast", pats, device="cpu"))
    out = checkpoint.load_tables(p, device="cpu")
    assert set(out) == {"main"} and out["main"].device.type == "cpu"
    eng = make_engine_from_tables("fast", out, device="cpu")
    assert eng.count(text) == datagen.count_matches(text, pats)
    with pytest.raises(TypeError, match="checkpointable"):
        checkpoint.save_tables(p, pats)
