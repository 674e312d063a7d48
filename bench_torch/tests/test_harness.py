"""The harness's own checks, on the CPU at a size a test run holds:

  - the plain reference against a brute-force count;
  - the control (the reference by fingerprint, put in the program's
    place) comes out not correct;
  - a sound run comes out correct, and runs with the timed path broken
    underneath come out not correct: an answer altered where it is made,
    half of the corpus left out and the count of the rest doubled, the
    last answer for the same tensor given again, and, on four gloo ranks,
    the halo exchange between ranks left out;
  - without a card, or without the program beside it, a run exits non-zero
    and prints no result.

The runs skip the harness's look for a card (run.run_ranks with device
"cpu"), where the port runs its kernels' plain versions.

    python -m pytest bench_torch/tests -q
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench_torch import gen, rank, run, spec  # noqa: E402
from bench_torch.references import window_count  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 3_000_000_007
#: the cells of BENCHMARK.json cut to these corpus bytes and panel sizes.
#: A half of the corpus doubled reads the whole's count by chance, about
#: once in sqrt(count) runs: the fp cells' counts are about p/2
TINY_N = 1 << 16
TINY_P = 3000
#: a configuration on four ranks (one corpus, a shard a rank), cut as tiny
FOUR_RANKS = {"n": 1 << 16, "sigma": 4, "ranks": 4, "text": "uniform",
              "reference": "window_count"}
CELLS = ["est_dna_256m.m32_p10k", "est_dna_256m.m8_p10k"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A copy of BENCHMARK.json whose cells are cut to tiny sizes, with
    two cells on four ranks: the m=8 panel, and one of dense seams (m=4,
    most window ids in the panel)."""
    d = tmp_path_factory.mktemp("tiny")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert [w["name"] for w in bench["workloads"]] == CELLS
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg["n"] = TINY_N
        c["file"] = str(d / f"{c['name']}.json")
        with open(c["file"], "w") as f:
            json.dump(cfg, f)
    (d / "x4.json").write_text(json.dumps(FOUR_RANKS))
    bench["configs"].append({"name": "x4", "file": str(d / "x4.json")})
    traffic = d / "traffic"
    traffic.mkdir()
    for w in bench["workloads"]:
        with open(os.path.join(ROOT, "bench_torch", "traffic",
                               f"{w['traffic']}.json")) as f:
            t = json.load(f)
        t["p"] = TINY_P
        with open(traffic / f"{w['traffic']}.json", "w") as f:
            json.dump(t, f)
    with open(traffic / "m4_dense.json", "w") as f:
        json.dump({"m": 4, "p": 200, "frac_present": 0.0}, f)
    bench["workloads"] += [
        {"name": "x4.m8_p10k", "config": "x4", "traffic": "m8_p10k",
         "chips": 4},
        {"name": "x4.m4_dense", "config": "x4", "traffic": "m4_dense",
         "chips": 4}]
    bench["traffic_dir"] = str(traffic)
    path = d / "bench.json"
    path.write_text(json.dumps(bench))
    return str(path)


def cpu_run(bench_path, workload, worker=None, seconds=0.2):
    args = run.parse(["--workload", workload, "--seed", str(SEED),
                      "--seconds", str(seconds), "--trace", "0",
                      "--bench", bench_path])
    cell = spec.load(workload, ROOT, bench_path)
    return run.assemble(cell, run.run_ranks(cell, args, "cpu", worker),
                        False, "cpu")


def brute(text, panel):
    m = panel.shape[1]
    pats = {bytes(r) for r in panel}
    return sum(bytes(text[i:i + m]) in pats for i in range(len(text) - m + 1))


@pytest.mark.parametrize("sigma,m", [(4, 8), (4, 32), (20, 8), (2, 64),
                                     (256, 3), (4, 1)])
def test_reference_against_brute_force(sigma, m):
    cfg = {"n": 5000, "sigma": sigma}
    text, panel = gen.make_inputs(cfg, {"m": m, "p": 50}, SEED + m,
                                  torch.device("cpu"))
    want = brute(text.numpy(), panel.numpy())
    assert want > 0
    assert window_count.count(text, panel, sigma) == want


def test_reference_blocks(monkeypatch):
    """Counts do not depend on where the blocks of starts are cut."""
    cfg = {"n": 10_000, "sigma": 4}
    text, panel = gen.make_inputs(cfg, {"m": 8, "p": 300}, SEED,
                                  torch.device("cpu"))
    whole = window_count.count(text, panel, 4)
    monkeypatch.setattr(window_count, "BLOCK", 333)
    assert window_count.count(text, panel, 4) == whole


def test_reference_rows():
    """count_rows of a batch is count of each row alone."""
    cfg = {"n": 20_000, "sigma": 4}
    text, panel = gen.make_inputs(cfg, {"m": 6, "p": 200}, SEED,
                                  torch.device("cpu"))
    rows = text[:19_980].reshape(999, 20)
    want = [window_count.count(r, panel, 4) for r in rows]
    assert sum(want) > 0
    assert window_count.count_rows(rows, panel, 4).tolist() == want


def test_inputs_and_edits_follow_the_seed():
    cfg = {"n": 4096, "sigma": 20}
    traffic = {"m": 8, "p": 64}
    a = gen.make_inputs(cfg, traffic, 2**40 + 5, torch.device("cpu"))
    b = gen.make_inputs(cfg, traffic, 2**40 + 5, torch.device("cpu"))
    c = gen.make_inputs(cfg, traffic, 2**40 + 6, torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    e, f = gen.Edits(2**40 + 5, 0, 4096, 8), gen.Edits(2**40 + 5, 0,
                                                       4096, 8)
    picks = [e(i) for i in range(gen.EDIT_CHUNK + 10)]
    assert [f(i) for i in range(gen.EDIT_CHUNK + 10)] == picks
    assert all(8 <= s <= 4096 - e.width - 8 and 0 <= b < gen.EDIT_BLOCKS
               for s, b in picks)
    assert gen.Edits(2**40 + 5, 1, 4096, 8)(0) != picks[0]
    blocks = gen.make_blocks(a[1], 20, 2**40 + 5, 0)
    assert blocks.shape == (gen.EDIT_BLOCKS, e.width)
    assert torch.equal(blocks, gen.make_blocks(b[1], 20, 2**40 + 5, 0))
    rows = {bytes(r) for r in a[1].numpy()}
    held = [sum(bytes(r) in rows for r in blk.reshape(-1, 8).numpy())
            for blk in blocks]
    assert min(held) == 0 and max(held) == gen.EDIT_ROWS


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny, workload, monkeypatch):
    """Every request's answer is compared, and the edits make them
    differ."""
    counts = []
    real = rank.Requests.__call__

    def call(self, timed=False):
        real(self, timed)
        counts.append(self.values[-1])

    monkeypatch.setattr(rank.Requests, "__call__", call)
    out = cpu_run(tiny, workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] == len(counts) > 1 and out["failed"] == 0
    assert sum(a != b for a, b in zip(counts, counts[1:])) > len(counts) / 2
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert set(out["metrics"]) == {
        m["name"] for m in bench["end_to_end"]
        if workload in m.get("workloads", [workload])}
    assert list(out)[-1] == "checks"


def test_control_is_not_correct(tiny, monkeypatch):
    """The reference by fingerprint, put in the program's place."""
    class Control:
        def __init__(self, panel, sigma):
            self.panel, self.sigma = panel.clone(), sigma

        def count(self, text):
            return window_count.control(text, self.panel, self.sigma)

    monkeypatch.setattr(rank, "system",
                        lambda cell, panel, device, world:
                        Control(panel, cell.sigma))
    for workload in CELLS:
        out = cpu_run(tiny, workload)
        assert not out["correct"], out["checks"]
        assert out["checks"]["count_gap"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_altered_answer_is_not_correct(tiny, monkeypatch, workload):
    from tpu_smatcher_torch.ops import fast
    real = fast.ScanFuture.result
    monkeypatch.setattr(fast.ScanFuture, "result",
                        lambda self: real(self) + 1)
    out = cpu_run(tiny, workload)
    assert not out["correct"] and out["checks"]["count_gap"]["value"] == 1


@pytest.mark.parametrize("workload", CELLS)
def test_half_the_corpus_is_not_correct(tiny, monkeypatch, workload):
    from tpu_smatcher_torch.ops import fast
    real = fast.FastScanner.count_async

    class Doubled:
        def __init__(self, future):
            self.future = future

        def result(self):
            return 2 * self.future.result()

    def half(self, text):
        return Doubled(real(self, text[:text.shape[0] // 2 + self.m - 1]))

    monkeypatch.setattr(fast.FastScanner, "count_async", half)
    out = cpu_run(tiny, workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_remembered_answer_is_not_correct(tiny, monkeypatch, workload):
    """A program that gives its last answer for the same tensor again."""
    from tpu_smatcher_torch.ops import fast
    real = fast.FastScanner.count
    memo = {}

    def count(self, text):
        key = (id(self), text.data_ptr())
        if key not in memo:
            memo[key] = real(self, text)
        return memo[key]

    monkeypatch.setattr(fast.FastScanner, "count", count)
    out = cpu_run(tiny, workload)
    assert not out["correct"], out["checks"]


def test_four_ranks_sound_and_without_halo(tiny):
    out = cpu_run(tiny, "x4.m4_dense")
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4
    out = cpu_run(tiny, "x4.m8_p10k")
    assert out["correct"], out["checks"]
    worker = [sys.executable, os.path.join(HERE, "no_halo_worker.py")]
    out = cpu_run(tiny, "x4.m4_dense", worker=worker)
    assert not out["correct"], out["checks"]


def test_without_a_card_exits_non_zero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "est_dna_256m.m8_p10k", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_without_the_program_exits_non_zero(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench_torch"),
                    tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "bench_torch/run.py", "--workload",
                        "est_dna_256m.m8_p10k", "--seed", "1", "--seconds",
                        "1"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_imports_neither_jax_nor_the_jax_package():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "bench_torch")):
        for name in files:
            if not name.endswith(".py") or name == os.path.basename(
                    __file__):
                continue
            with open(os.path.join(dirpath, name)) as f:
                src = f.read()
            for bad in ("import jax", "from jax", "import tpu_smatcher\n",
                        "import tpu_smatcher.", "from tpu_smatcher ",
                        "from tpu_smatcher.", "import bench\n",
                        "import bench ", "from bench ", '"bench.py"',
                        "'bench.py'"):
                assert bad not in src, (name, bad)


class _Event:
    def __init__(self, name, start, end, cuda, annotation=False, id=0,
                 parent=None):
        from torch.autograd import DeviceType
        self.name = name
        self.time_range = type("R", (), {"start": start, "end": end})()
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU
        self.is_user_annotation = annotation
        self.id = id
        self.cpu_parent = parent


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_trace_reduction_and_readers():
    """Busy time is the union of the device's events, annotations left
    out; the readers' arithmetic on a made-up session of two counts."""
    from bench_torch import roofline, trace
    casc = "void (anonymous namespace)::cascade_kernel<true>(x)"
    edit = _Event(trace.EDIT, 0, 5, False, id=1)
    copy = _Event("aten::copy_", 1, 4, False, id=2, parent=edit)
    ev = [edit, copy, _Event("cudaMemcpyAsync", 2, 3, False, id=7,
                             parent=copy),
          _Event("Memcpy DtoD", 5, 8, True, id=7),
          _Event("aten::nonzero", 0, 100, False, id=3),
          _Event(casc, 10, 40, True), _Event("nccl:all_reduce", 10, 90, True),
          _Event("gather", 30, 50, True), _Event(casc, 60, 90, True),
          _Event("Memcpy DtoH", 95, 100, True, id=2)]
    bitmaps = torch.tensor([[-1, 0], [0x0F0F0F0F, 0]], dtype=torch.int32)
    calls = {"cascade": [dict(n=1000, m=8, k1=1, bitmaps=bitmaps,
                              out_bytes=64)] * 2}
    tr = trace.Trace(_Prof(ev), 2, 100e-6, {"cascade": 2}, calls)
    tr.host = {"cpu_ms_per_count": 0.5}
    assert len(tr.device) == 4 and tr.complete() and tr.harness == 1
    assert tr.busy_s == pytest.approx(75e-6)        # [10,50] [60,90] [95,100]
    bd = tr.breakdown()
    assert bd["device_ops"][0] == [casc, pytest.approx(60e-6)]
    assert bd["idle_gaps"][0] == ["aten::nonzero", pytest.approx(15e-6)]
    cell = spec.load("est_dna_256m.m32_p10k", ROOT)
    read = {name: spec.reader(name)(tr) for name in (
        "host.launches_per_count", "device.idle_share",
        "epilogue.device_ms", "cascade_roofline",
        "host.cpu_ms_per_count")}
    assert read["host.launches_per_count"] == 2.0
    assert read["device.idle_share"] == pytest.approx(0.25)
    assert read["epilogue.device_ms"] == pytest.approx(25e-6 * 1e3 / 2)
    assert read["host.cpu_ms_per_count"] == 0.5
    assert roofline.bitmap_fills(bitmaps) == [0.5, 0.25]
    bound = roofline.cascade_bound_s(1000, 8, [0.5, 0.25], 1, 16, 64)
    assert read["cascade_roofline"] == pytest.approx(
        100 * 2 * bound / 60e-6)
    assert cell.reader("exact_count_roofline")(tr) is None


def test_end_to_end_readers():
    run_record = {"bytes_per_count": 1000, "counts": 40, "window_s": 2.0,
                  "latency_ms": [float(i) for i in range(1, 101)],
                  "setup_s": 7.5}
    assert spec.reader("scan_GBps")(run_record) == pytest.approx(2e-5)
    assert spec.reader("count_p95_ms")(run_record) == pytest.approx(95.95)
    assert spec.reader("setup_s")(run_record) == 7.5


def test_every_listed_metric_has_a_reader(tmp_path):
    """A cell that lists a metric with no reader file is refused."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        spec.load(w["name"], ROOT)
    bench["per_layer"].append({"name": "no.such_metric", "unit": "ms"})
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(bench))
    with pytest.raises(SystemExit, match="no.such_metric"):
        spec.load(bench["workloads"][0]["name"], ROOT, str(path))
