"""The port's experiment and conformance tools (tpu_smatcher_torch/tools)
on the CPU: the soak's trials (single-device and on 4 gloo ranks), the
ladder's CPU rungs, compare_sweeps' statistics and the fingerprint
collision (the sweep's tests are in tests/test_torch_sweep.py).

Tolerance 0: every count is an integer; compare_sweeps' statistics are
checked to 1e-12 of hand-computed values."""

import json

import numpy as np
import pytest

from tpu_smatcher_torch.core import datagen
from tpu_smatcher_torch.ops.fast import (FP_MULTS, FastScanner, _fp_keys_np,
                                         build_fast)
from tpu_smatcher_torch.tools import (compare_sweeps, find_fp_collision,
                                      ladder, soak, sweep)
import torch_cases  # noqa: F401  (one torch thread per test process)

def test_soak_draws_the_reference_trials():
    """The reference's rng 987 in its order: (sigma, m, p, n) of trials 0,
    6 and 13 (the long-pattern corner), and which trials distribute."""
    ts = soak.trials(14)
    assert [(t.sigma, t.m, t.p, t.n) for t in (ts[0], ts[6], ts[13])] == [
        (2, 48, 72, 41473), (128, 300, 14, 36380), (8, 700, 29, 10088)]
    assert set(np.unique(ts[6].text)) <= {126, 127}
    assert set(np.unique(ts[13].text)) <= {6, 7}
    assert [t.index for t in ts if soak.is_dist(t)] == [0, 5, 10]
    assert {t.engine for t in ts} <= set(soak.ENGINES)


def test_soak_first_14_trials_cpu():
    """The first 14 trials on the CPU, trials 0, 5 and 10 in one group of
    four gloo ranks: every rank holds the all-reduced count, and none
    imports JAX."""
    res = soak.soak(14, device="cpu", log=lambda s: None)
    assert res["failures"] == []
    assert res["trials"] == 14 and res["dist_trials"] == [0, 5, 10]
    assert len(res["ranks"]) == 4
    for r in res["ranks"]:
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert sorted(r["counts"]) == ["0", "10", "5"]
        assert r["imports_jax"] == []


def test_soak_trial_reports_an_exception():
    """A trial that raises prints its line instead of stopping the soak."""
    tr = soak.trials(1)[0]
    tr.engine = "no-such-engine"
    bad = soak.run_trial(tr, "cpu")
    assert len(bad) == 1 and bad[0].startswith("[0] EXC (2,48,72,41473)")


def test_soak_group_failures_name_the_trial():
    """A rank count that differs from datagen's is reported as a line of
    its trial; equal counts report nothing."""
    ts = {t.index: t for t in soak.trials(6)}
    truth = {k: datagen.count_matches(ts[k].text, ts[k].pats) for k in (0, 5)}
    ranks = [{"counts": {str(k): c for k, c in truth.items()}}
             for _ in range(4)]
    assert soak.group_failures(ranks, ts) == []
    ranks[2] = {"counts": {"0": truth[0], "5": truth[5] + 1}}
    bad = soak.group_failures(ranks, ts)
    assert len(bad) == 1 and bad[0].startswith("[5] dist ")


def test_ladder_cpu_rungs(tmp_path):
    """oracle, numpy and portable rungs of the five engines hold parity on
    the CPU; the card rungs are not run there."""
    rows = ladder.ladder(n=1 << 16, p=200, oracle_n=1 << 14, reps=1,
                         device="cpu", log=lambda s: None)
    assert [(r["engine"], r["rung"]) for r in rows] == [
        (e, rung) for e in ("ac", "wm", "sog8", "sh", "sbom")
        for rung in ("oracle", "numpy", "portable")]
    assert all(r["parity"] and r["device"] == "cpu" for r in rows)
    out = tmp_path / "ladder.jsonl"
    assert ladder.main(["--device", "cpu", "--n", str(1 << 14), "--p", "50",
                        "--oracle-n", str(1 << 12), "--reps", "1",
                        "--engines", "ac,sh", "--out", str(out)]) == 0
    assert len(out.read_text().splitlines()) == 6


@pytest.mark.parametrize("tool", [soak, sweep, ladder])
def test_tools_default_to_the_card(tool, monkeypatch):
    """Without CUDA the entry points refuse to run unless --device cpu is
    passed; nothing falls back to the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([]) == 1


def _sweep_file(path, rates):
    with open(path, "w") as fh:
        for i, (sync, dev) in enumerate(rates):
            fh.write(json.dumps({"corpus": f"c{i}", "p_size": 1000,
                                 "engine": "fast", "bytes_per_s": sync,
                                 "device_bytes_per_s": dev}) + "\n")
        fh.write(json.dumps({"corpus": "c0", "p_size": 1000, "engine": "ac",
                             "error": "x"}) + "\n")


def test_compare_sweeps_statistics(tmp_path):
    """Relative disagreements 0.0, 0.1, 0.2, 0.5 (sync) and 0.0 .. 1.0
    (device): medians and p90s by linear interpolation, and the worst
    cell."""
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    _sweep_file(a, [(100.0, 10.0), (100.0, 10.0), (100.0, 10.0),
                    (100.0, 10.0), (100.0, 10.0)])
    _sweep_file(b, [(100.0, 10.0), (110.0, 12.5), (120.0, 15.0),
                    (150.0, 17.5), (100.0, 20.0)])
    cells = compare_sweeps.load(str(a))
    assert len(cells) == 5                 # the error line is left out
    out = compare_sweeps.compare(cells, compare_sweeps.load(str(b)))
    sync = sorted([0.0, 0.1, 0.2, 0.5, 0.0])
    assert out["sync"]["median"] == pytest.approx(0.1, abs=1e-12)
    assert out["sync"]["p90"] == pytest.approx(
        float(np.percentile(sync, 90)), abs=1e-12)
    assert out["sync"]["p90"] == pytest.approx(0.38, abs=1e-12)
    assert out["device"]["median"] == pytest.approx(0.5, abs=1e-12)
    assert out["device"]["p90"] == pytest.approx(0.9, abs=1e-12)
    assert out["device"]["max"] == pytest.approx(1.0, abs=1e-12)
    assert out["device"]["at"] == ("c4", 1000, "fast")
    assert out["sync"]["n"] == out["device"]["n"] == 5
    assert compare_sweeps.main([str(a), str(b)]) == 0


def test_fp_collision_vector_collides_under_the_port_multipliers():
    """x and x + FP_COLLISION_D share fp0, fp1 and fp2 under the port's
    FP_MULTS (as the fast tables compute them), not a fourth."""
    d = find_fp_collision.FP_COLLISION_D
    assert len(d) == 16 and d.any()
    assert find_fp_collision.collides(d)
    assert not find_fp_collision.collides(d, FP_MULTS[3:4])
    rng = np.random.default_rng(23)
    lo, hi = np.maximum(0, -d), np.minimum(3, 3 - d)
    xs = np.stack([rng.integers(lo, hi + 1) for _ in range(50)]
                  ).astype(np.uint8)
    ys = (xs + d[None, :]).astype(np.uint8)
    assert not (xs == ys).all(axis=1).any()
    for mult in FP_MULTS[:3]:
        np.testing.assert_array_equal(_fp_keys_np(xs, mult),
                                      _fp_keys_np(ys, mult))
    assert (_fp_keys_np(xs, FP_MULTS[3]) != _fp_keys_np(ys,
                                                         FP_MULTS[3])).any()


def test_fp_collision_search_small():
    """The meet-in-the-middle search at a size the CPU takes in a moment:
    whatever it returns collides."""
    d = find_fp_collision.search(m=6, split=3)
    assert d is None or (d.any() and find_fp_collision.collides(d))


def test_fp_collision_cell_converges_cpu():
    """The adversarial cell at 256 KB on the plain versions.  At the slot
    route's 4,096-bit stages, where its collisions crowd the per-block
    slots: 8 exact scans that retry while the scanner adapts, then none
    over 3 more.  At the default width the cascade's 16 slots a 128-start
    row hold them: 11 exact scans, no retry."""
    from tpu_smatcher_torch import make_fast
    text, pats = find_fp_collision.collision_case(1 << 18)
    truth = datagen.count_matches(text, pats)
    eng = FastScanner(build_fast(pats.codes, 4, stage_bits=4096,
                                 device="cpu"))
    assert [eng.count(text) for _ in range(8)] == [truth] * 8
    mid = eng.fallback_scans
    assert mid >= 1
    for _ in range(3):
        assert eng.count(text) == truth
    assert eng.fallback_scans == mid
    eng = make_fast(pats, device="cpu")
    assert [eng.count(text) for _ in range(11)] == [truth] * 11
    assert eng.fallback_scans == 0
