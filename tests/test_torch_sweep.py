"""The port's sweep (tpu_smatcher_torch/tools/sweep.py) on the CPU at a
tiny scale — one corpus shape per sigma, cut to 32 KB, p = 100 — against
the JAX package's engines on the same text, its JSON lines against the
reference sweep's keys, and its int32-wrap guard.

Tolerance 0: every count is an integer."""

import json

import pytest

from tpu_smatcher_torch.core import datagen
from tpu_smatcher_torch.core.alphabet import Alphabet
from tpu_smatcher_torch.tools import sweep
import torch_cases  # noqa: F401  (one torch thread per test process)

#: the reference sweep's JSON keys (scripts/sweep.py)
REFERENCE_SWEEP_KEYS = {"corpus", "n", "sigma", "m", "p_size", "engine",
                        "matches", "scan_s", "first_scan_s", "bytes_per_s",
                        "device_scan_s", "device_bytes_per_s", "queue",
                        "spread", "method", "backend"}


@pytest.fixture(scope="module")
def tiny_sweep(tmp_path_factory):
    """One corpus per sigma, cut to 32 KB, p = 100, on the CPU."""
    out = str(tmp_path_factory.mktemp("sweep") / "s.jsonl")
    corpora = [(name, 32 << 10, sigma) for name, _, sigma in sweep.CORPORA
               if name in ("random2", "ecoli", "athaliana_faa", "world192")]
    res = sweep.sweep(corpora, [100], device="cpu", reps=1, window=1e-3,
                      out=out, log=lambda s: None)
    return res, out


def test_sweep_tiny_counts_match_jax(tiny_sweep):
    """Each engine's count equals the JAX package's engine (portable scan,
    fastpath=False; make_fast on its xla backend) on the same text."""
    from tpu_smatcher.engines import make_engine as j_make_engine
    from tpu_smatcher.engines import make_fast as j_make_fast
    from torch_cases import jax_pats
    res, _ = tiny_sweep
    assert res["failures"] == []
    lines = [r for r in res["records"] if "matches" in r]
    assert len(lines) == 4 * len(sweep.DEFAULT_ENGINES)
    texts = {}
    for r in lines:
        key = (r["corpus"], r["sigma"])
        if key not in texts:
            ab = Alphabet.of_size(r["sigma"])
            text = datagen.generate_text(r["n"], ab, seed=1)
            pats = datagen.generate_patterns(text, 100, 8, ab,
                                             frac_present=0.5, seed=2)
            texts[key] = (text, jax_pats(pats))
        text, jp = texts[key]
        if r["engine"] == "fast":
            want = j_make_fast(jp, backend="xla").count(text)
        else:
            want = j_make_engine(r["engine"], jp, fastpath=False).count(text)
        assert r["matches"] == want == r["gate"], r
        assert r["gate_n"] == r["n"] == 32 << 10


def test_sweep_lines_hold_the_reference_keys(tiny_sweep):
    res, out = tiny_sweep
    with open(out) as fh:
        rows = [json.loads(line) for line in fh]
    assert rows == res["records"]
    for r in rows:
        assert REFERENCE_SWEEP_KEYS <= set(r), set(r)
        assert r["backend"] == "cpu" and r["method"] == "host_clock"
        assert r["card"] is None and r["overflow"] is False
        assert r["queue"] >= 4 and r["queue"] * r["matches"] < 2 ** 31
    routes = {(r["corpus"], r["engine"]): r["route"] for r in rows}
    assert routes[("ecoli", "fast")] == "exact"
    assert routes[("ecoli", "ac")] == "wid"
    assert routes[("world192", "wm")] == "wm+fpset"
    assert "GB/s" in sweep.table(rows)


class _Repeat:
    """A count_repeat_async stand-in whose sum wraps like an int32."""

    def __init__(self, count):
        self.count = count

    def __call__(self, text, q):
        total = (self.count * q + 2 ** 31) % 2 ** 32 - 2 ** 31

        class F:
            def result(self):
                return total
        return F()


def test_sweep_caps_q_below_the_int32_wrap():
    """q x count stays below 2^31, and a repeat whose sum is not q x count
    (a wrap) fails loudly."""
    count = 3_980_000
    dev, spread, q = sweep.device_rate(_Repeat(count), None, count,
                                       cuda=False, window=10.0, reps=1)
    assert q == (2 ** 31 - 1) // count            # the window wanted more
    assert q * count < 2 ** 31
    wrong = _Repeat(count)
    wrong.count = count + 1
    with pytest.raises(AssertionError, match="summed"):
        sweep.device_rate(wrong, None, count, cuda=False, window=1e-3,
                          reps=1)
