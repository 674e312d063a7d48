"""Randomized conformance soak of the port (the counterpart of
scripts/soak.py).

60 random (sigma, m, p, n, planted-fraction) configurations, drawn from
the reference's generator (rng 987) in its order, so trial t has the
reference's (sigma, m, p, n).  Every seventh trial (t % 7 == 6) is the
adversarial corner: m in 150..1024 over a text of the alphabet's two
highest code points.  Each trial runs, against datagen's ground truth:

  - make_fast on `device` and, when that is the card, on the CPU too (the
    kernels and their plain versions: the reference's Pallas and xla
    backends);
  - the randomly drawn engine (wm, sh, sbom or ac), its fast path on even
    trials and off on odd ones;
  - the native oracle (datagen.count_matches(prefer_native=True), the
    port's native library) against datagen's numpy count, on every trial;
  - the port's oracle of that engine (oracles.ORACLES) on trials with
    n <= 2^16;
  - positions on every third trial;
  - a distributed count on every fifth trial, over 4 ranks, skipped where
    a shard is shorter than m - 1.  Those trials run in one group of four
    processes of this module, started once, each regenerating the trials
    from the seed: gloo ranks on the CPU, or four ranks sharing one card.

Any mismatch or exception prints the trial's line; the run then exits 1.

    python -m tpu_smatcher_torch.tools.soak [--device cuda|cpu] [--trials 60]
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

#: the reference soak's generator seed and its length
SEED = 987
TRIALS = 60
ENGINES = ("wm", "sh", "sbom", "ac")
#: the distributed trials' world size (the reference's make_mesh(4))
DIST_WORLD = 4
#: the port's oracles run on trials no longer than this
ORACLE_N = 1 << 16
#: make_fast's and the engines' tile (the reference soak's)
TILE = 1 << 12
#: a rank's collectives give up after this long; the group after GROUP_S
GROUP_TIMEOUT = datetime.timedelta(seconds=120)
GROUP_S = 900

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclasses.dataclass
class Trial:
    index: int
    sigma: int
    m: int
    p: int
    n: int
    text: np.ndarray
    pats: object            # core.patterns.PatternSet
    engine: str             # the randomly drawn engine

    @property
    def shape(self) -> str:
        return f"({self.sigma},{self.m},{self.p},{self.n})"


def trials(count: int = TRIALS) -> list[Trial]:
    """The first `count` trials, drawn as scripts/soak.py draws them: the
    engine's draw follows the trial's own, as in the reference when no
    check before it raised."""
    from tpu_smatcher_torch.core import datagen
    from tpu_smatcher_torch.core.alphabet import Alphabet
    from tpu_smatcher_torch.core.patterns import PatternSet
    rng = np.random.default_rng(SEED)
    out = []
    for t in range(count):
        sigma = int(rng.choice([2, 4, 8, 20, 128, 256]))
        ab = Alphabet.of_size(sigma)
        if t % 7 == 6:
            # long patterns over the two highest code points: the regime
            # where the reference's f32 fingerprint sums once broke
            m = int(rng.choice([150, 300, 513, 700, 1024]))
            n = int(rng.integers(4 * m, 60_000))
            p = int(rng.integers(1, 40))
            text = rng.choice(np.array([max(sigma - 2, 0), sigma - 1],
                                       np.uint8), n)
            starts = rng.integers(0, n - m + 1, p)
            pats = PatternSet(np.stack([text[s:s + m] for s in starts]), ab)
        else:
            m = int(rng.choice([3, 4, 6, 8, 12, 16, 24, 32, 48, 64]))
            p = int(rng.integers(1, 200))
            n = int(rng.integers(m, 50_000))
            frac = float(rng.uniform(0, 1))
            text = datagen.generate_text(n, ab, seed=t)
            pats = datagen.generate_patterns(text, p, m, ab,
                                             frac_present=frac, seed=t + 1)
        out.append(Trial(t, sigma, m, p, n, text, pats,
                         str(rng.choice(list(ENGINES)))))
    return out


def is_dist(tr: Trial) -> bool:
    """Whether trial tr counts distributed: every fifth, where each of the
    DIST_WORLD shards holds at least m - 1 bytes (the halo)."""
    return tr.index % 5 == 0 and -(-tr.n // DIST_WORLD) >= tr.m - 1


def run_trial(tr: Trial, device: str) -> list[str]:
    """The failure lines of trial tr's single-device checks (empty when
    all hold)."""
    from tpu_smatcher_torch import make_engine, make_fast
    from tpu_smatcher_torch.core import datagen
    from tpu_smatcher_torch.oracles import ORACLES
    text, pats = tr.text, tr.pats
    truth = datagen.count_matches(text, pats)
    bad = []

    def check(label, got, want=truth):
        if got != want:
            bad.append(f"[{tr.index}] {label} {got} != {want} {tr.shape}")

    try:
        check("NATIVE ORACLE",
              datagen.count_matches(text, pats, prefer_native=True))
        if tr.n <= ORACLE_N:
            check(f"oracle-{tr.engine}",
                  ORACLES[tr.engine](text, pats.codes, tr.sigma))
        fast = make_fast(pats, device=device, tile=TILE)
        check(f"fast-{device}", fast.count(text))
        if device != "cpu":
            check("fast-cpu",
                  make_fast(pats, device="cpu", tile=TILE).count(text))
        eng = make_engine(tr.engine, pats, device=device,
                          fastpath=tr.index % 2 == 0, tile=TILE)
        check(tr.engine, eng.count(text))
        if tr.index % 3 == 0:
            pos = fast.positions(text)
            want = np.nonzero(datagen.match_starts(text, pats))[0]
            if not np.array_equal(pos, want):
                bad.append(f"[{tr.index}] positions {len(pos)} != "
                           f"{len(want)} {tr.shape}")
    except Exception as e:          # the soak reports it and goes on
        bad.append(f"[{tr.index}] EXC {tr.shape}: {type(e).__name__} "
                   f"{str(e)[:150]}")
    return bad


# ---------------------------------------------------------------------------
# the distributed trials: one group of DIST_WORLD processes
# ---------------------------------------------------------------------------

def start_group(count: int, device: str, store_dir: str) -> list:
    """Start the DIST_WORLD ranks of the distributed trials among the
    first `count`, over a FileStore in store_dir; wait_group reads their
    results."""
    cmd = [sys.executable, "-m", "tpu_smatcher_torch.tools.soak", "--rank",
           "--store", store_dir, "--device", device, "--trials", str(count)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(cmd[:4] + [str(r)] + cmd[4:], cwd=_ROOT,
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             start_new_session=True)
            for r in range(DIST_WORLD)]


def wait_group(procs, store_dir: str, timeout: float = GROUP_S) -> list:
    """Each rank's result dict, rank 0 first; a rank that fails or
    outlives `timeout` raises with its output (every rank is killed)."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"soak rank {r} rc {p.returncode}:\n{out}")
    results = []
    for r in range(len(procs)):
        with open(os.path.join(store_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def group_failures(results, by_index) -> list[str]:
    """Failure lines of the group's results against the ground truth: every
    rank must hold the all-reduced count."""
    from tpu_smatcher_torch.core import datagen
    bad = []
    for key, got in results[0]["counts"].items():
        tr = by_index[int(key)]
        truth = datagen.count_matches(tr.text, tr.pats)
        per_rank = [res["counts"][key] for res in results]
        if any(c != truth for c in per_rank):
            bad.append(f"[{tr.index}] dist {per_rank} != {truth} "
                       f"{tr.shape}")
    return bad


def rank_main(rank: int, store_dir: str, device: str, count: int) -> int:
    """One rank of the group: every distributed trial among the first
    `count` through make_distributed("fast"), in order; writes
    rank<rank>.json into store_dir."""
    import torch.distributed as dist
    from tpu_smatcher_torch import make_distributed
    from tpu_smatcher_torch.ops import cuda_filter as cf
    from tpu_smatcher_torch.parallel import init_distributed, make_mesh
    init_distributed(num_processes=DIST_WORLD, process_id=rank,
                     device=device,
                     store=dist.FileStore(os.path.join(store_dir, "store"),
                                          DIST_WORLD),
                     timeout=GROUP_TIMEOUT)
    mesh = make_mesh(DIST_WORLD, device=device)
    for k in cf.LAUNCHES:
        cf.LAUNCHES[k] = 0
    counts = {}
    for tr in trials(count):
        if is_dist(tr):
            dc = make_distributed("fast", tr.pats, mesh, device=device,
                                  tile=TILE)
            counts[str(tr.index)] = dc.count(tr.text)
    out = {"backend": mesh.backend, "device": str(mesh.device),
           "counts": counts, "launches": dict(cf.LAUNCHES),
           "imports_jax": sorted(
               m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "tpu_smatcher"))}
    with open(os.path.join(store_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# the soak
# ---------------------------------------------------------------------------

def soak(count: int = TRIALS, *, device: str = "cuda", log=print) -> dict:
    """Run the first `count` trials on `device`, the distributed ones in
    one group of DIST_WORLD processes, started first.  Returns {"trials",
    "failures": [lines], "dist_trials": [indices], "ranks": [each rank's
    result], "seconds"}."""
    t0 = time.perf_counter()
    all_trials = trials(count)
    dist_ids = [tr.index for tr in all_trials if is_dist(tr)]
    failures, ranks = [], []
    with tempfile.TemporaryDirectory() as store:
        procs = start_group(count, device, store) if dist_ids else []
        try:
            for tr in all_trials:
                bad = run_trial(tr, device)
                for line in bad:
                    log(line)
                failures += bad
                if tr.index % 10 == 9:
                    log(f"...{tr.index + 1}/{count} done, {len(failures)} "
                        f"failures ({time.perf_counter() - t0:.1f} s)")
        finally:
            if procs:
                try:
                    ranks = wait_group(procs, store)
                except RuntimeError as e:
                    failures.append(f"dist group: {e}")
                    log(failures[-1])
    if ranks:
        bad = group_failures(ranks, {tr.index: tr for tr in all_trials})
        for line in bad:
            log(line)
        failures += bad
    secs = time.perf_counter() - t0
    log(f"SOAK {'FAILED' if failures else 'PASSED'} {len(failures)} "
        f"({count} trials, {len(dist_ids)} distributed on "
        f"{DIST_WORLD} ranks, {secs:.1f} s)")
    return {"trials": count, "failures": failures, "dist_trials": dist_ids,
            "ranks": ranks, "seconds": secs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--trials", type=int, default=TRIALS)
    # one rank of the distributed group (start_group)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args.rank, args.store, args.device, args.trials)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("soak: CUDA is not available (pass --device cpu)",
                  file=sys.stderr)
            return 1
    res = soak(args.trials, device=args.device)
    return 1 if res["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
