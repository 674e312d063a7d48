"""The readers of the port's spans (host.dispatch_ms, compact.device_ms,
verify.device_ms, through bench_torch/spans.py) on a made-up store of
spans, and each case in which they read nothing.

    python -m pytest bench_torch/tests -q
"""

import os
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_torch import spec  # noqa: E402
from tpu_smatcher_torch.utils import profiling  # noqa: E402

READERS = ("host.dispatch_ms", "compact.device_ms", "verify.device_ms")


@pytest.fixture
def store(monkeypatch):
    """A cleared store with tracing on, whose requests() gives the spans
    the device ms of the returned dict (by span id; a CPU run records
    none); off and cleared after."""
    device = {}
    real = profiling.requests

    def requests(last):
        return [[s._replace(device_ms=device.get(s.id, s.device_ms))
                 for s in req] for req in real(last)]
    monkeypatch.setattr(profiling, "requests", requests)
    profiling.clear()
    profiling.enable()
    try:
        yield device
    finally:
        profiling.disable()
        profiling.clear()


def fp_request(store, compact_ms=1.0, verify_ms=2.0):
    """One count's spans as the fingerprint route makes them, with device
    intervals set by hand (None: missing)."""
    with profiling.span("tsm.count"):
        with profiling.span("tsm.enqueue"):
            with profiling.span("tsm.route"):
                pass
            with profiling.span("tsm.compact") as c:
                pass
            with profiling.span("tsm.verify") as v:
                pass
        with profiling.span("tsm.readback"):
            sum(range(10_000))
    for sp, ms in ((c, compact_ms), (v, verify_ms)):
        if ms is not None:
            store[sp.id] = ms


def read(name, counts):
    return spec.reader(name)(types.SimpleNamespace(counts=counts))


def test_readers_on_whole_requests(store):
    fp_request(store, 1.0, 2.0)
    fp_request(store, 3.0, 4.0)
    fp_request(store, 5.0, 6.0)
    reqs = profiling.requests(last=2)
    want = sum(r[0].host_ms - r[-1].host_ms for r in reqs) / 2
    assert [s.name for s in reqs[0]][-1] == "tsm.readback"
    assert read("host.dispatch_ms", 2) == pytest.approx(want)
    assert 0 < want < reqs[0][0].host_ms
    assert read("compact.device_ms", 2) == pytest.approx(4.0)
    assert read("verify.device_ms", 2) == pytest.approx(5.0)
    assert read("compact.device_ms", 3) == pytest.approx(3.0)


def test_fewer_whole_requests_than_counts(store):
    fp_request(store)
    fp_request(store)
    assert all(read(name, 3) is None for name in READERS)
    assert all(read(name, 0) is None for name in READERS)
    profiling.clear()
    assert all(read(name, 1) is None for name in READERS)


def test_a_request_lacking_the_span(store):
    fp_request(store)
    with profiling.span("tsm.count"):              # the exact tier
        with profiling.span("tsm.enqueue"):
            with profiling.span("tsm.exact"):
                pass
        with profiling.span("tsm.readback"):
            pass
    assert read("compact.device_ms", 2) is None
    assert read("verify.device_ms", 2) is None
    assert read("host.dispatch_ms", 2) is not None
    with profiling.span("tsm.enqueue") as sp:      # no tsm.count root
        pass
    with profiling.span("tsm.readback", request=sp.request):
        pass
    assert read("host.dispatch_ms", 1) is None
    assert read("host.dispatch_ms", 3) is None


def test_a_device_interval_missing(store):
    fp_request(store)
    fp_request(store, 1.0, None)
    assert read("compact.device_ms", 2) == pytest.approx(1.0)
    assert read("verify.device_ms", 2) is None


def test_a_port_without_the_tracer(store, monkeypatch):
    fp_request(store)
    monkeypatch.delattr(profiling, "requests")
    assert all(read(name, 1) is None for name in READERS)


def test_readers_on_a_cpu_count(store):
    """A real count of the port on the CPU: host time is read, the device
    intervals are missing."""
    import torch
    from tpu_smatcher_torch import make_fast
    from tpu_smatcher_torch.core import datagen
    from tpu_smatcher_torch.core.alphabet import Alphabet
    ab = Alphabet.dna()
    text = datagen.generate_text(1 << 15, ab, seed=4)
    pats = datagen.generate_patterns(text, 32, 32, ab, seed=5)
    eng = make_fast(pats, device="cpu")
    for _ in range(2):
        assert eng.count(torch.from_numpy(text)) == \
            datagen.count_matches(text, pats)
    assert read("host.dispatch_ms", 2) > 0
    assert read("compact.device_ms", 2) is None
    assert read("verify.device_ms", 2) is None
