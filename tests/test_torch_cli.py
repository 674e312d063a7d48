"""The port's command line (python -m tpu_smatcher_torch.cli) against the
JAX package's cli.main on the same files: test_cli.py's four cases,
test_mixed.py's three CLI cases, --algo all, a --devices 2 run on two gloo
ranks and every refusal.  The JAX side runs its xla backend, the port
--device cpu; their JSON `matches` must be equal.  Tolerance 0."""

import json

import numpy as np
import pytest

from tpu_smatcher import cli as jcli
from tpu_smatcher_torch import cli
from tpu_smatcher_torch.core import datagen
from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.ops.fast import STAGE_WIDTHS

JAX = ["--backend", "xla"]
PORT = ["--device", "cpu"]


@pytest.fixture(scope="module")
def corpus_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    ab = Alphabet.dna()
    text = datagen.generate_text(60_000, ab, seed=11)
    pats = datagen.generate_patterns(text, 40, 8, ab, frac_present=0.6,
                                     seed=12)
    tpath = d / "corpus.bin"
    np.asarray(text, np.uint8).tofile(tpath)
    ppath = pats.save(str(d / "pats.npz"))
    truth = datagen.count_matches(text, pats)
    return str(tpath), str(ppath), truth, d, text, pats


def _json(out):
    return json.loads(out.strip().splitlines()[-1])


def both(capsys, argv):
    """(JAX result, port result): the last JSON line of each CLI."""
    jcli.main(argv + JAX)
    j = _json(capsys.readouterr().out)
    cli.main(argv + PORT)
    return j, _json(capsys.readouterr().out)


def _base(corpus_files, algo="fast"):
    tpath, ppath = corpus_files[:2]
    return ["--text", tpath, "--patterns", ppath, "--m", "8",
            "--alphabet", "4", "--algo", algo]


def test_cli_text_run(corpus_files, capsys):
    j, p = both(capsys, _base(corpus_files) + ["--json"])
    assert p["matches"] == j["matches"] == corpus_files[2]


def test_cli_stream(corpus_files, capsys):
    """--stream scans the corpus from disk in (m-1)-halo pieces and writes
    positions without loading the file."""
    truth, d = corpus_files[2], corpus_files[3]
    argv = ["--stream", "--chunk", "25000", "--verify", "--json"]
    jcli.main(_base(corpus_files) + argv + JAX
              + ["--positions", str(d / "jpos.npy")])
    j = _json(capsys.readouterr().out)
    cli.main(_base(corpus_files) + argv + PORT
             + ["--positions", str(d / "pos.npy")])
    p = _json(capsys.readouterr().out)
    assert p["matches"] == j["matches"] == truth
    assert p["ground_truth"] == j["ground_truth"] == truth
    np.testing.assert_array_equal(np.load(d / "pos.npy"),
                                  np.load(d / "jpos.npy"))
    assert np.load(d / "pos.npy").size == truth


def test_cli_stream_requires_patterns(corpus_files):
    argv = ["--stream", "--text", corpus_files[0], "--m", "8", "--p-size",
            "10", "--alphabet", "4"]
    with pytest.raises(SystemExit):
        jcli.main(argv)
    with pytest.raises(SystemExit, match="requires --patterns"):
        cli.main(argv + PORT)


def test_cli_per_pattern(corpus_files, tmp_path, capsys):
    jcli.main(_base(corpus_files) + JAX + ["--json", "--per-pattern",
                                           str(tmp_path / "jper.npy")])
    j = _json(capsys.readouterr().out)
    cli.main(_base(corpus_files) + PORT + ["--json", "--per-pattern",
                                           str(tmp_path / "per.npy")])
    p = _json(capsys.readouterr().out)
    per = np.load(tmp_path / "per.npy")
    np.testing.assert_array_equal(per, np.load(tmp_path / "jper.npy"))
    assert per.sum() == p["matches"] == j["matches"] == corpus_files[2]


def test_cli_algo_all_agree(corpus_files, capsys):
    """--algo all runs every engine (sog8 at m=8), cross-checks them and
    the ground truth, exits 0."""
    jcli.main(_base(corpus_files, "all") + JAX + ["--verify"])
    jout = capsys.readouterr().out
    cli.main(_base(corpus_files, "all") + PORT + ["--verify"])
    out = capsys.readouterr().out
    assert "ALL ENGINES AGREE" in out and "ALL ENGINES AGREE" in jout
    j, p = _json(jout), _json(out)
    assert [r["engine"] for r in p] == [r["engine"] for r in j] == [
        "ac", "sh", "sbom", "wm", "fast", "sog8"]
    assert [r["matches"] for r in p] == [r["matches"] for r in j] == [
        corpus_files[2]] * 6


def test_cli_profile_reports_spans(tmp_path, capsys):
    """--profile writes the Chrome trace of the timed scans, which holds
    the port's spans, and their summary under "spans", with the routes
    the scans took and their stage width."""
    from tpu_smatcher_torch.utils import profiling
    logdir = tmp_path / "prof"
    cli.main(["--synthetic", "--n", "60000", "--m", "16", "--p-size", "40",
              "--alphabet", "4", "--algo", "fast", "--reps", "3",
              "--verify", "--json", "--profile", str(logdir)] + PORT)
    p = _json(capsys.readouterr().out)
    assert p["matches"] == p["ground_truth"]
    spans = p["spans"]
    assert spans["tsm.count"]["calls"] == 3
    assert sum(spans["tsm.route"]["paths"].values()) == 3
    ((bits, calls),) = spans["tsm.route"]["bits"].items()
    assert calls == 3 and int(bits) in STAGE_WIDTHS
    for name in ("tsm.enqueue", "tsm.filter", "tsm.compact", "tsm.verify",
                 "tsm.readback"):
        row = spans[name]
        assert row["calls"] == 3 and 0 <= row["self_ms"] <= row["host_ms"]
    names = {e.get("name") for e in json.loads(
        (logdir / "trace.json").read_text())["traceEvents"]}
    assert {"tsm.count", "tsm.route", "tsm.verify"} <= names
    assert not profiling.tracing()


def _fasta(path, text, lengths, seed):
    rng = np.random.default_rng(seed)
    chars = b"ACGT"
    with open(path, "w") as f:
        for i, m in enumerate(lengths):
            s = int(rng.integers(0, len(text) - m + 1))
            f.write(f">p{i}\n"
                    + "".join(chr(chars[c]) for c in text[s:s + m]) + "\n")


def test_mixed_cli_fasta(tmp_path, capsys):
    """A mixed-length FASTA pattern file goes through the mixed scanner,
    agrees with the ground truth, and writes (start, length) positions."""
    ab = Alphabet.dna()
    text = datagen.generate_text(30_000, ab, seed=61)
    tpath = tmp_path / "corpus.bin"
    np.asarray(text, np.uint8).tofile(tpath)
    rng = np.random.default_rng(62)
    fa = tmp_path / "pats.fa"
    _fasta(fa, text, [int(rng.choice([5, 9])) for _ in range(20)], 63)
    argv = ["--text", str(tpath), "--patterns", str(fa), "--m", "8",
            "--alphabet", "4", "--algo", "fast", "--verify", "--json"]
    jcli.main(argv + JAX + ["--positions", str(tmp_path / "jpos.npy")])
    j = _json(capsys.readouterr().out)
    cli.main(argv + PORT + ["--positions", str(tmp_path / "pos.npy")])
    p = _json(capsys.readouterr().out)
    assert p["matches"] == p["ground_truth"] == j["matches"]
    pos = np.load(tmp_path / "pos.npy")
    assert pos.ndim == 2 and pos.shape == (p["matches"], 2)
    np.testing.assert_array_equal(pos, np.load(tmp_path / "jpos.npy"))


def test_mixed_cli_algo_all_skips_sog(tmp_path, capsys):
    """--algo all with a mixed set runs every per-length engine, skips SOG
    with a note, cross-checks and exits 0."""
    ab = Alphabet.dna()
    text = datagen.generate_text(20_000, ab, seed=71)
    tpath = tmp_path / "corpus.bin"
    np.asarray(text, np.uint8).tofile(tpath)
    fa = tmp_path / "pats.fa"
    _fasta(fa, text, [5, 8, 8, 11], 72)
    argv = ["--text", str(tpath), "--patterns", str(fa), "--m", "8",
            "--alphabet", "4", "--algo", "all", "--verify", "--json"]
    jcli.main(argv)
    j = _json(capsys.readouterr().out)
    cli.main(argv + PORT)
    cap = capsys.readouterr()
    p = _json(cap.out)
    assert "skipping sog engines" in cap.err
    assert [r["engine"] for r in p] == [r["engine"] for r in j] == [
        "ac", "sh", "sbom", "wm", "fast"]
    assert [r["matches"] for r in p] == [r["matches"] for r in j]
    assert all(r["matches"] == r["ground_truth"] for r in p)


def test_mixed_cli_explicit_sog_clear_exit(tmp_path):
    ab = Alphabet.dna()
    tpath = tmp_path / "corpus.bin"
    datagen.generate_text(5_000, ab, seed=73).tofile(tpath)
    fa = tmp_path / "pats.fa"
    fa.write_text(">a\nACGTA\n>b\nACGTACGT\n")
    argv = ["--text", str(tpath), "--patterns", str(fa), "--m", "8",
            "--alphabet", "4", "--algo", "sog8"]
    with pytest.raises(SystemExit, match="mixes lengths"):
        jcli.main(argv)
    with pytest.raises(SystemExit, match="mixes lengths"):
        cli.main(argv + PORT)


def test_cli_devices_two(corpus_files, tmp_path, capfd):
    """--devices 2 outside torchrun: the CLI starts two gloo ranks itself,
    rank 0 prints the count (equal to the JAX CLI's on a 2-device mesh)
    and writes the distributed positions; on a named engine the ranks skip
    --positions and --per-pattern, as the JAX CLI does."""
    truth, text, pats = corpus_files[2], corpus_files[4], corpus_files[5]
    jcli.main(_base(corpus_files) + JAX + ["--devices", "2", "--json"])
    j = _json(capfd.readouterr().out)
    cli.main(_base(corpus_files) + PORT + [
        "--devices", "2", "--verify", "--json",
        "--positions", str(tmp_path / "pos.npy")])
    cap = capfd.readouterr()
    p = _json(cap.out)
    assert "backend gloo" in cap.err
    assert p["matches"] == p["ground_truth"] == j["matches"] == truth
    np.testing.assert_array_equal(
        np.load(tmp_path / "pos.npy"),
        np.flatnonzero(datagen.match_starts(text, pats)))

    cli.main(_base(corpus_files, "wm") + PORT + [
        "--devices", "2", "--json", "--positions", str(tmp_path / "w.npy"),
        "--per-pattern", str(tmp_path / "wper.npy")])
    cap = capfd.readouterr()
    assert _json(cap.out)["matches"] == truth
    assert "--positions skipped (wm)" in cap.err
    assert "--per-pattern skipped (wm)" in cap.err
    assert not (tmp_path / "w.npy").exists()
    assert not (tmp_path / "wper.npy").exists()


def _refusal_argv(corpus_files, tmp_path, which):
    base = _base(corpus_files) + ["--devices", "2"]
    if which == "stream":
        return base + ["--stream"], "single-device"
    if which == "tables":
        return base + ["--tables", str(tmp_path / "t.npz")], "single-device"
    if which == "save-tables":
        return (base + ["--save-tables", str(tmp_path / "t.npz")],
                "single-device")
    fa = tmp_path / "mixed.fa"
    fa.write_text(">a\nACGTA\n>b\nACGTACGT\n")
    return (["--text", corpus_files[0], "--patterns", str(fa), "--m", "8",
             "--alphabet", "4", "--devices", "2"], "single-device")


@pytest.mark.parametrize("which", ["stream", "tables", "save-tables",
                                   "mixed"])
def test_cli_refusals_on_several_devices(corpus_files, tmp_path, which):
    """The JAX CLI's refusals of several devices, made by the port before
    any rank starts."""
    argv, msg = _refusal_argv(corpus_files, tmp_path, which)
    with pytest.raises(SystemExit):
        jcli.main(argv + JAX)
    with pytest.raises(SystemExit, match=msg):
        cli.main(argv + PORT)


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_text_reads_its_own_range(corpus_files, rank):
    """On several ranks a --text corpus is read per rank: rank_text needs
    no whole text (None here) and gives the rank's byte range of the file
    and the corpus length."""
    import torch
    from tpu_smatcher_torch.parallel.mesh import Mesh
    args = cli.build_parser().parse_args(_base(corpus_files) + PORT
                                         + ["--devices", "2"])
    text, pats = corpus_files[4], corpus_files[5]
    shard, n = cli.rank_text(args, None, pats,
                             Mesh(rank, 2, torch.device("cpu"), "gloo"))
    per = len(text) // 2
    assert n == len(text)
    np.testing.assert_array_equal(shard.numpy(),
                                  text[rank * per:(rank + 1) * per])


def test_rank_text_refuses_codes_out_of_range(corpus_files, tmp_path):
    """A code >= sigma in a rank's range raises, as loading the whole
    --text corpus on one device does (Alphabet.validate)."""
    import torch
    from tpu_smatcher_torch.parallel.mesh import Mesh
    bad = np.asarray(corpus_files[4], np.uint8).copy()
    bad[-1] = 7
    path = tmp_path / "bad.bin"
    bad.tofile(path)
    argv = ["--text", str(path), "--patterns", corpus_files[1], "--m", "8",
            "--alphabet", "4"]
    with pytest.raises(ValueError, match="out of range"):
        cli.load_inputs(cli.build_parser().parse_args(argv + PORT))
    args = cli.build_parser().parse_args(argv + PORT + ["--devices", "2"])
    mesh = Mesh(1, 2, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="out of range"):
        cli.rank_text(args, None, corpus_files[5], mesh)
    cli.rank_text(args, None, corpus_files[5], Mesh(0, 2, mesh.device,
                                                    "gloo"))
