"""The port's tracer (tpu_smatcher_torch/utils/profiling.py) on the CPU:
the span trees of the count path's tiers and routes, self times, tracing
under torch.profiler, the overflow ladder's span, the distributed spans on
two gloo ranks, and counts equal with tracing on and off."""

import numpy as np
import pytest
import torch

from tpu_smatcher_torch.core import datagen
from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.core.patterns import PatternSet
from tpu_smatcher_torch.ops import fast as tfast
from tpu_smatcher_torch.utils import profiling

import torch_dist_worker as W
from torch_cases import make_case, wide_case

DIST = ("tsm.dist.halo", "tsm.dist.scan", "tsm.dist.seam",
        "tsm.dist.all_reduce")


@pytest.fixture
def traced():
    """Tracing on over a cleared store, off again after the test."""
    profiling.clear()
    profiling.enable()
    try:
        yield
    finally:
        profiling.disable()
        profiling.clear()


@pytest.fixture(scope="module")
def fp_case():
    """m = 32 against 32,768-bit stages: the router picks the cascade."""
    text, pats = wide_case(0.02)
    eng = tfast.FastScanner(tfast.build_fast(pats.codes, pats.sigma,
                                             stage_bits=32768, device="cpu"))
    return torch.from_numpy(text), eng, datagen.count_matches(text, pats)


@pytest.fixture(scope="module")
def exact_case():
    """DNA, m = 8: the exact tier."""
    text, pats = make_case(4, 8, 64, 50_000, seed=3)
    eng = tfast.FastScanner(tfast.build_fast(pats.codes, 4, device="cpu"))
    return torch.from_numpy(text), eng, datagen.count_matches(text, pats)


def tree(spans):
    """[(name, parent's name)] of one request's spans, in opening order."""
    names = {s.id: s.name for s in spans}
    return [(s.name, names.get(s.parent)) for s in spans]


def test_tracing_off_records_nothing_and_creates_no_events(
        fp_case, exact_case, monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("a CUDA event was created with tracing off")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    profiling.clear()
    assert not profiling.tracing()
    for text, eng, truth in (fp_case, exact_case):
        assert eng.count(text) == truth
    assert profiling.requests(last=4) == [] and profiling.summary() == {}
    off = profiling.span("tsm.count", device=fp_case[0])
    assert off is profiling.span("tsm.verify") and not off
    with off as sp:
        assert sp is off and sp.request is None


def test_fp_count_span_tree(fp_case, traced):
    text, eng, truth = fp_case
    assert eng.count(text) == truth
    (req,) = profiling.requests(last=4)
    assert tree(req) == [
        ("tsm.count", None), ("tsm.enqueue", "tsm.count"),
        ("tsm.route", "tsm.enqueue"), ("tsm.filter", "tsm.enqueue"),
        ("tsm.compact", "tsm.enqueue"), ("tsm.verify", "tsm.enqueue"),
        ("tsm.readback", "tsm.count")]
    assert len({s.request for s in req}) == 1
    assert req[0].root and not any(s.root for s in req[1:])
    route = req[2].attrs
    assert route["path"] == "cascade" and 1 <= route["k1"] < route["kt"]
    assert route["bits"] == eng.ft.stage_bits == 32768
    assert all(s.t1_ns >= s.t0_ns for s in req)
    # no device markers on the CPU
    assert all(s.device_ms is None for s in req)


def test_exact_count_span_tree(exact_case, traced):
    text, eng, truth = exact_case
    assert eng.count(text) == truth
    assert eng.count(text) == truth
    reqs = profiling.requests(last=4)
    assert len(reqs) == 2 and reqs[0][0].request < reqs[1][0].request
    for req in reqs:
        assert tree(req) == [
            ("tsm.count", None), ("tsm.enqueue", "tsm.count"),
            ("tsm.exact", "tsm.enqueue"), ("tsm.readback", "tsm.count")]
    assert [len(r) for r in profiling.requests(last=1)] == [4]


def test_self_time_is_the_span_less_its_children(fp_case, traced):
    text, eng, _ = fp_case
    eng.count(text)
    eng.count(text)
    spans = [s for r in profiling.requests(last=2) for s in r]
    children = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s)
    rows = profiling.summary()
    assert set(rows) == {s.name for s in spans}
    for name, row in rows.items():
        mine = [s for s in spans if s.name == name]
        host = sum(s.host_ms for s in mine)
        kids = sum(c.host_ms for s in mine for c in children.get(s.id, []))
        assert row["calls"] == len(mine)
        assert row["host_ms"] == pytest.approx(host, rel=1e-12)
        assert row["self_ms"] == pytest.approx(host - kids, rel=1e-12,
                                               abs=1e-9)
        assert row["device_ms"] is None
    assert rows["tsm.route"]["paths"] == {"cascade": 2}
    assert rows["tsm.route"]["bits"] == {32768: 2}
    assert rows["tsm.count"]["self_ms"] < rows["tsm.count"]["host_ms"]


def test_compact_span_carries_its_path(fp_case, traced):
    """The cascade route's tsm.compact span says which compaction ran
    ("torch" here, the plain version; "cuda" on the card), and summary()
    counts the calls by it."""
    text, eng, truth = fp_case
    assert eng.count(text) == truth
    assert eng.count(text) == truth
    compacts = [s for r in profiling.requests(last=2) for s in r
                if s.name == "tsm.compact"]
    assert [s.attrs["path"] for s in compacts] == ["torch", "torch"]
    assert profiling.summary()["tsm.compact"]["paths"] == {"torch": 2}


def test_exact_span_carries_its_kernel_path(exact_case, traced):
    """The exact tier's tsm.exact span says whether the kernel took the
    pair path: 0 on the CPU (the plain version runs), and summary() counts
    the calls by it."""
    text, eng, truth = exact_case
    assert eng.count(text) == truth
    assert eng.count(text) == truth
    exacts = [s for r in profiling.requests(last=2) for s in r
              if s.name == "tsm.exact"]
    assert [s.attrs["pairs"] for s in exacts] == [0, 0]
    assert profiling.summary()["tsm.exact"]["pairs"] == {0: 2}


def test_the_store_is_bounded_and_keeps_whole_requests(exact_case, traced,
                                                       monkeypatch):
    """The oldest spans leave a full store; a request that lost one is
    not whole.  The records kept are not tracked by the garbage
    collector."""
    import collections
    import gc
    text, eng, _ = exact_case
    monkeypatch.setattr(profiling, "_store", collections.deque(maxlen=10))
    for _ in range(5):
        eng.count(text)                   # 4 spans a count
    reqs = profiling.requests(last=5)
    assert [len(r) for r in reqs] == [4, 4]
    assert profiling.summary()["tsm.readback"]["calls"] == 3
    gc.collect()
    assert not any(gc.is_tracked(rec) for rec in profiling._store)


def test_profiler_turns_tracing_on(exact_case):
    text, eng, truth = exact_case
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.tracing()
        assert eng.count(text) == truth
    assert not profiling.tracing()
    (req,) = profiling.requests(last=4)
    want = ["tsm.count", "tsm.enqueue", "tsm.exact", "tsm.readback"]
    assert [s.name for s in req] == want
    ranges = {e.name: e for e in prof.events() if e.name.startswith("tsm.")}
    assert sorted(ranges) == sorted(want)
    assert ranges["tsm.exact"].cpu_parent.name == "tsm.enqueue"
    eng.count(text)                       # off again: nothing more
    assert len(profiling.requests(last=4)) == 1
    profiling.clear()


def test_overflow_records_the_ladder(traced):
    """Every window matches: the slot route overflows, and the future's
    retry (tsm.ladder, under the count) counts exactly."""
    pats = PatternSet(np.zeros((1, 8), np.uint8), Alphabet.protein())
    text = torch.zeros(50_000, dtype=torch.uint8)
    eng = tfast.FastScanner(tfast.build_fast(pats.codes, 20, device="cpu"),
                            cap=1 << 12)
    assert eng.count(text) == 50_000 - 7
    assert eng.fallback_scans == 1
    (req,) = profiling.requests(last=4)
    t = tree(req)
    assert t[:2] == [("tsm.count", None), ("tsm.enqueue", "tsm.count")]
    assert ("tsm.route", "tsm.enqueue") in t
    assert [n for n, parent in t if parent == "tsm.count"] == [
        "tsm.enqueue", "tsm.readback", "tsm.ladder"]
    assert req[2].attrs["path"] == "slot"


def test_dist_spans_on_two_gloo_ranks(tmp_path):
    text, pats = W.inputs("spans")
    truth = datagen.count_matches(text, pats)
    for r in W.run_ranks(2, ["spans"], str(tmp_path)):
        got = r["spans"]["ok"]
        assert got["count"] == truth and got["requests"] == 1
        spans = [tuple(s) for s in got["spans"]]
        assert spans[:2] == [("tsm.count", None),
                             ("tsm.enqueue", "tsm.count")]
        for name in DIST:
            assert (name, "tsm.enqueue") in spans, name
        assert ("tsm.route", "tsm.dist.scan") in spans
        assert ("tsm.route", "tsm.dist.seam") in spans
        assert spans[-1] == ("tsm.readback", "tsm.count")


def _force(eng, monkeypatch, path):
    """Route every fp scan of eng to `path` ("dense": the row-dense mask
    pass a match-driven retry switches to)."""
    if path == "dense":
        eng._match_dense = True
        return
    costs = eng._route_costs
    monkeypatch.setattr(
        eng, "_pick_path",
        lambda n, k: (path, *costs(n, k)[path][1:]))


@pytest.mark.parametrize("path", ["exact", "slot", "cascade", "mask",
                                  "dense"])
def test_counts_equal_with_tracing_on_and_off(path, monkeypatch):
    m = 8 if path == "exact" else 32
    text, pats = make_case(4, m, 64, 1 << 16, seed=5)
    eng = tfast.FastScanner(tfast.build_fast(pats.codes, 4, device="cpu"))
    if path != "exact":
        _force(eng, monkeypatch, path)
    truth = datagen.count_matches(text, pats)
    t = torch.from_numpy(text)
    profiling.clear()
    off = eng.count(t)
    profiling.enable()
    try:
        on = eng.count(t)
        (req,) = profiling.requests(last=4)
    finally:
        profiling.disable()
        profiling.clear()
    assert off == on == truth and eng.fallback_scans == 0
    names = [s.name for s in req]
    if path == "exact":
        assert "tsm.exact" in names and "tsm.route" not in names
    elif path == "dense":
        assert "tsm.route" not in names and "tsm.filter" in names
    else:
        assert req[2].attrs["path"] == path
    if path != "exact":
        assert names.count("tsm.compact") == names.count("tsm.verify") == 1
