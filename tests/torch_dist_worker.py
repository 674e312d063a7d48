"""One rank of the port's distribution tests (tests/test_torch_parallel.py,
tests/test_torch_multihost.py, tests/test_torch_tracing.py): joins a gloo
group of CPU ranks over a FileStore, runs the named cases through
tpu_smatcher_torch.parallel and writes each case's result (or its error)
to OUT_DIR/rank<RANK>.json.

    python tests/torch_dist_worker.py RANK WORLD STORE_DIR OUT_DIR CASE...

It imports the port only, never JAX or tpu_smatcher; its result file says
so.  The cases' inputs come from inputs(name), which the tests also call
to run the JAX package on the same bytes."""

import contextlib
import datetime
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tpu_smatcher_torch.core import datagen  # noqa: E402
from tpu_smatcher_torch.core.alphabet import Alphabet  # noqa: E402
from tpu_smatcher_torch.core.patterns import PatternSet  # noqa: E402

#: each group's collectives give up after this long (a rank that died)
GROUP_TIMEOUT = datetime.timedelta(seconds=120)

ENGINES = ("ac", "wm", "sog8", "sh", "sbom")
#: test_parallel.py's make_distributed options of its engine cases
ENGINE_OPTS = {"lanes": 64, "tile": 1 << 12}


def make_case(sigma, m, p_size, n, seed):
    """test_parallel.py's make_case: (text, patterns)."""
    ab = Alphabet.of_size(sigma)
    text = datagen.generate_text(n, ab, seed=seed)
    pats = datagen.generate_patterns(text, p_size, m, ab, frac_present=0.6,
                                     seed=seed + 1)
    return text, pats


def toy_setup(m=8, p=64, n=4096, seed=3):
    """__graft_entry__._toy_setup's (text, patterns)."""
    ab = Alphabet.dna()
    text = datagen.generate_text(n, ab, seed=seed)
    return text, datagen.generate_patterns(text, p, m, ab, seed=seed + 1)


def _straddle():
    ab = Alphabet.dna()
    m, n = 8, 80_000
    per = n // 8
    pat = ab.encode(b"ACGTTGCA")
    plant_at = []
    for b in range(1, 8):
        plant_at += [b * per - m + 1, b * per - 1, b * per]
    plant_at.append(n - m)
    text = datagen.plant(datagen.generate_text(n, ab, seed=17), pat,
                         plant_at)
    return text, PatternSet(pat[None, :], ab)


def _s256_wrap(n):
    m = 8
    text, pats = make_case(256, m, 32, n, seed=33)
    return datagen.plant(text, pats.codes[0], [n - m, n - m - 3]), pats


def _s256_false_positive():
    ab = Alphabet.of_size(256)
    text = datagen.generate_text(80_000, ab, seed=44)
    wrap_pat = np.concatenate([text[-4:], text[:4]]).astype(np.uint8)
    return text, PatternSet(wrap_pat[None, :], ab)


def _s256_explicit_n():
    """(padded text, patterns, true length)."""
    ab = Alphabet.of_size(256)
    n_true = 10_003
    text = datagen.generate_text(n_true, ab, seed=66)
    padded = np.zeros(10_008, np.uint8)
    padded[:n_true] = text
    seam_pat = np.concatenate([text[-3:], np.zeros(5, np.uint8)])
    return padded, PatternSet(seam_pat[None, :].astype(np.uint8), ab), n_true


def _s256_zero_pad():
    ab = Alphabet.of_size(256)
    m, n = 8, 100_003
    zero_pat = np.zeros((1, m), np.uint8)
    text = datagen.plant(datagen.generate_text(n, ab, seed=55), zero_pat[0],
                         [500, n - m])
    return text, PatternSet(zero_pat, ab)


def _ladder_dense():
    ab = Alphabet.of_size(4)
    text = datagen.generate_text(160_000, ab, seed=31)
    pats = datagen.generate_patterns(text, 32, 16, ab, frac_present=0.5,
                                     seed=32)
    text = datagen.plant(text, pats.codes[0],
                         list(range(0, 160_000 - 16, 80)))
    return text, pats


def _ladder_pieces():
    return (np.zeros(120_000, np.uint8),
            PatternSet(np.zeros((1, 16), np.uint8), Alphabet.dna()))


def _wrap_mode():
    """test_sigma256.py's _case: all-0xFF text, the all-zero pattern."""
    return (np.full(1001, 0xFF, np.uint8),
            PatternSet(np.zeros((1, 8), np.uint8), Alphabet.byte()))


def _dry_s256():
    ab = Alphabet.byte()
    text = datagen.generate_text(8192 - 3, ab, seed=12)
    return text, datagen.generate_patterns(text, 48, 8, ab, seed=13)


def _dry_mixed():
    """(text, [patterns of lengths 5, 8, 16])."""
    ab = Alphabet.dna()
    text = datagen.generate_text(8192, ab, seed=14)
    return text, [datagen.generate_patterns(text, p, m, ab, seed=15 + m)
                  for m, p in ((5, 32), (8, 48), (16, 64))]


def _multihost(sigma):
    """test_multihost.py's corpora: (text, patterns)."""
    if sigma == 4:
        ab = Alphabet.dna()
        text = datagen.generate_text(100_003, ab, seed=51)
        return text, datagen.generate_patterns(text, 80, 8, ab,
                                               frac_present=0.6, seed=52)
    ab = Alphabet.of_size(256)
    m = 8
    text = datagen.generate_text(50_003, ab, seed=61)
    pats = datagen.generate_patterns(text, 40, m, ab, frac_present=0.6,
                                     seed=62)
    text = datagen.plant(text, pats.codes[0], [len(text) - m])
    return datagen.plant(text, np.zeros(m, np.uint8), [1000]), pats


def _two_process():
    """test_multiprocess.py's corpus: DNA, m=9."""
    ab = Alphabet.dna()
    text = datagen.generate_text(40_000, ab, seed=77)
    return text, datagen.generate_patterns(text, 50, 9, ab,
                                           frac_present=0.6, seed=77)


INPUTS = {
    "exact": lambda: make_case(4, 8, 64, 200_000, seed=3),
    "mesh": lambda: make_case(4, 16, 32, 120_000, seed=9),
    "straddle": _straddle,
    "uneven": lambda: make_case(4, 8, 32, 100_003, seed=21),
    "async": lambda: make_case(4, 8, 32, 100_000, seed=27),
    "async256": lambda: make_case(256, 8, 16, 50_003, seed=28),
    "s256-wm": lambda: _s256_wrap(100_003),
    "s256-fast": lambda: _s256_wrap(100_003),
    "s256-ac": lambda: _s256_wrap(80_000),
    "s256-fp": _s256_false_positive,
    "s256-n": _s256_explicit_n,
    "s256-zero": _s256_zero_pad,
    "ladder-dense": _ladder_dense,
    "ladder-pieces": _ladder_pieces,
    "wrap-mode": _wrap_mode,
    "tiny": lambda: (np.zeros(32, np.uint8),
                     PatternSet(np.zeros((1, 8), np.uint8), Alphabet.dna())),
    "dry-exact": lambda: toy_setup(n=8192),
    "dry-fp": lambda: toy_setup(m=16, p=96, n=8192, seed=11),
    "dry-s256": _dry_s256,
    "dry-mixed": _dry_mixed,
    "pos-exact": lambda: make_case(4, 8, 64, 16_384, seed=81),
    "pos-fp": lambda: make_case(4, 16, 32, 16_384, seed=83),
    "pos-dense": _ladder_pieces,
    "pos-chunk": lambda: make_case(4, 8, 64, 16_384, seed=81),
    "halo4": lambda: make_case(4, 8, 32, 100_003, seed=21),
    "halo256": lambda: make_case(256, 8, 16, 50_003, seed=28),
    "mh4": lambda: _multihost(4),
    "mh256": lambda: _multihost(256),
    "two-process": _two_process,
    "spans": lambda: make_case(4, 16, 32, 60_000, seed=9),
}


def inputs(name):
    """The numpy inputs of case `name` (its INPUTS key is the part before
    a ':')."""
    return INPUTS[name.split(":")[0]]()


# ---------------------------------------------------------------------------
# the cases, run on every rank
# ---------------------------------------------------------------------------

def _counter(pats, mesh, *, cap=None, ladder=True):
    """DistributedCounter over make_fast's core (tile 2^12), with the
    scanner as its ladder unless ladder=False."""
    from tpu_smatcher_torch import make_fast
    from tpu_smatcher_torch.parallel import DistributedCounter
    opts = {"tile": 1 << 12} if cap is None else {"cap": cap}
    fast = make_fast(pats, device="cpu", **opts)
    return DistributedCounter(fast.core, mesh, m=pats.m, sigma=pats.sigma,
                              fast=fast if ladder else None), fast


def _engine(name, pats, mesh, **opts):
    from tpu_smatcher_torch import make_distributed
    return make_distributed(name, pats, mesh, device="cpu", **opts)


@contextlib.contextmanager
def _small_pieces(min_chunk):
    """Yields a list that gets the (offset, starts) of every piece read
    from a shard, outside its seam, with fewer than min_chunk starts: a
    split into halves makes none."""
    from tpu_smatcher_torch.parallel import dist
    small, piece = [], dist._Sharded.piece

    def spy(self, off, owned):
        if off < self.per - self.halo and owned < min_chunk:
            small.append([off, owned])
        return piece(self, off, owned)
    dist._Sharded.piece = spy
    try:
        yield small
    finally:
        dist._Sharded.piece = piece


def run_case(name, mesh, data_dir):
    """The result of case `name` on this rank: json-able."""
    from tpu_smatcher_torch.parallel import (DistributedPositions,
                                             load_corpus_shards, shard_text)
    kind, _, arg = name.partition(":")
    inp = inputs(name)
    if kind == "exact":
        text, pats = inp
        return _engine(arg, pats, mesh, **ENGINE_OPTS).count(text)
    if kind == "mesh":
        text, pats = inp
        return _engine("ac", pats, mesh, lanes=32).count(text)
    if kind == "straddle":
        text, pats = inp
        return {e: _engine(e, pats, mesh, lanes=16, tile=1 << 12).count(text)
                for e in ("ac", "wm", "sbom")}
    if kind in ("uneven", "s256-fp", "s256-zero"):
        text, pats = inp
        return _engine("wm", pats, mesh, tile=1 << 12).count(text)
    if kind in ("async", "async256"):
        text, pats = inp
        dc = _engine("wm", pats, mesh, tile=1 << 12)
        many = dc.scan_many([text, text])
        return {"many": many, "async": dc.count_async(text).result()}
    if kind in ("s256-wm", "s256-fast", "s256-ac"):
        text, pats = inp
        return _engine(kind[5:], pats, mesh, tile=1 << 12).count(text)
    if kind == "s256-n":
        padded, pats, n_true = inp
        from tpu_smatcher_torch import make_fast
        count = _engine("wm", pats, mesh, tile=1 << 12).count(padded,
                                                               n=n_true)
        dp = DistributedPositions(make_fast(pats, device="cpu"), mesh)
        return {"count": count,
                "positions": dp.positions(padded, n=n_true).tolist()}
    if kind == "ladder-dense":
        text, pats = inp
        dc, _ = _counter(pats, mesh, cap=1024)
        raw = dc.count_with_overflow(text)
        out = {"raw_overflow": raw[1], "count": dc.count(text)}
        bare, _ = _counter(pats, mesh, cap=1024, ladder=False)
        try:
            bare.count(text)
        except OverflowError as e:
            out["bare"] = f"OverflowError: {e}"
        return out
    if kind == "ladder-pieces":
        text, pats = inp
        dc, _ = _counter(pats, mesh, cap=1024)
        with _small_pieces(256) as small:
            out = {"raw_overflow": dc.count_with_overflow(text)[1],
                   "count": dc.count(text)}
        return {**out, "small": small}
    if kind == "wrap-mode":
        text, pats = inp
        shard, n = shard_text(text, mesh, sigma=256)
        per = int(shard.shape[0])
        pad = shard[max(0, min(per, n - mesh.rank * per)):]
        dc, _ = _counter(pats, mesh, ladder=False)
        return {"n": n, "pad_zero": bool((pad == 0).all()),
                "count": dc.count(text)}
    if kind == "tiny":
        text, pats = inp
        dc, _ = _counter(pats, mesh, ladder=False)
        dc.count(text)
        return "no error"
    if kind in ("dry-exact", "dry-fp", "dry-s256"):
        text, pats = inp
        out = {"fast": _counter(pats, mesh)[0].count(text)}
        if kind == "dry-exact":
            out["ac"] = _engine("ac", pats, mesh, lanes=16).count(text)
        return out
    if kind == "dry-mixed":
        text, groups = inp
        return sum(_counter(g, mesh)[0].count(text) for g in groups)
    if kind in ("pos-exact", "pos-fp"):
        text, pats = inp
        _, fast = _counter(pats, mesh)
        return DistributedPositions(fast, mesh).positions(text).tolist()
    if kind == "pos-chunk":
        text, pats = inp          # pieces presized, the seam's apart
        _, fast = _counter(pats, mesh)
        return DistributedPositions(fast, mesh).positions(
            text, chunk=1000).tolist()
    if kind in ("halo4", "halo256"):
        from tpu_smatcher_torch.parallel.dist import exchange_halo
        text, pats = inp
        shard, _ = shard_text(text, mesh, sigma=pats.sigma)
        return exchange_halo(shard, mesh, halo=pats.m - 1,
                             sigma=pats.sigma).tolist()
    if kind == "pos-dense":
        text, pats = inp          # every start matches: pieces split
        _, fast = _counter(pats, mesh, cap=1024)
        with _small_pieces(512) as small:
            pos = DistributedPositions(fast, mesh).positions(text).tolist()
        return {"positions": pos, "small": small}
    if kind in ("mh4", "mh256", "two-process"):
        text, pats = inp
        path = os.path.join(data_dir, f"{kind}.bin")
        shard, n = load_corpus_shards(path, mesh, sigma=pats.sigma)
        # the routed core may overflow a sub-block's slots on these small
        # shards: the ladder makes the count total
        dc, _ = _counter(pats, mesh)
        return {"n": n, "shard": shard.numpy().tolist() if kind == "mh4"
                else None, "count": dc.count(shard, n=n)}
    if kind == "spans":
        from tpu_smatcher_torch.utils import profiling
        text, pats = inp          # the fingerprint tier: a routed core
        dc, _ = _counter(pats, mesh)
        profiling.enable()
        try:
            profiling.clear()
            count = dc.count(text)
            reqs = profiling.requests(last=4)
        finally:
            profiling.disable()
        names = {s.id: s.name for r in reqs for s in r}
        return {"count": count, "requests": len(reqs),
                "spans": [[s.name, names.get(s.parent)] for s in reqs[-1]]}
    raise KeyError(name)


def run_ranks(world, cases, store_dir, *, timeout=300):
    """Start `world` ranks of this worker over `store_dir` (a fresh
    directory, which also holds the cases' data files), wait for them and
    return each rank's result dict, rank 0 first.  A rank that fails or
    outlives `timeout` fails the caller with its output."""
    import subprocess
    out_dir = os.path.join(store_dir, "out")
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(store_dir), out_dir, *cases],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            logs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (rc, out, err) in enumerate(logs):
        if rc != 0:
            raise RuntimeError(f"rank {r} of {world} failed rc={rc}\n"
                               f"stdout:{out}\nstderr:{err}")
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def main(argv):
    rank, world = int(argv[1]), int(argv[2])
    store_dir, out_dir, cases = argv[3], argv[4], argv[5:]
    import torch
    import torch.distributed as dist
    from tpu_smatcher_torch.parallel import init_distributed, make_mesh
    torch.set_num_threads(1)
    init_distributed(num_processes=world, process_id=rank, device="cpu",
                     store=dist.FileStore(os.path.join(store_dir, "store"),
                                          world),
                     timeout=GROUP_TIMEOUT)
    mesh = make_mesh(world, device="cpu")
    out = {"backend": mesh.backend}
    for name in cases:
        try:
            out[name] = {"ok": run_case(name, mesh, store_dir)}
        except Exception as e:         # recorded for the test to judge
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    out["imports_jax"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "tpu_smatcher"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
