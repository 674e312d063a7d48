"""smatcher-style command line driver of the PyTorch port (port of
tpu_smatcher/cli.py).

The replacement for the reference's `./smatcher <alg> -m -p_size -n
-alphabet [-c]` (main.c:20-30, 324-718): explicit corpus/pattern paths or
synthetic generation, engine selection that takes effect, per-phase wall
timings in place of the reference's read/scatter/CPU/gather report
(main.c:663-671), and a JSON result line, always printed last.  Exit codes:
2 when the engines of --algo all disagree, 3 when --verify fails.

Runs on the card unless --device cpu is given.  --devices N counts over N
ranks on torch.distributed (the reference's mpirun -np N layout): under
torchrun the CLI joins the group and N must equal its world size; outside
one it starts N local ranks itself, rank i on cuda:(i mod device_count)
(or the CPU).  The backend is NCCL when every rank has a card of its own,
gloo otherwise.  Rank 0 prints the results.

Examples:
  python -m tpu_smatcher_torch.cli --synthetic --n 1000000 --m 8 \\
      --p-size 1000 --alphabet 4 --algo fast
  python -m tpu_smatcher_torch.cli --text corpus.bin --patterns pats.npz \\
      --m 8 --algo all --verify
  python -m tpu_smatcher_torch.cli --synthetic --n 100000 --m 8 \\
      --p-size 100 --alphabet 4 --algo ac --devices 2 --device cpu
  torchrun --nproc-per-node 2 -m tpu_smatcher_torch.cli ... --devices 2
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

#: how long spawned ranks may take in all before the CLI gives up on them
SPAWN_TIMEOUT_S = 3600


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-smatcher-torch",
        description="Multi-pattern string matching on PyTorch / CUDA "
                    "(AC / SH / SBOM / WM / SOG / shared fast path)")
    p.add_argument("--algo", default="fast",
                   choices=["ac", "sh", "sbom", "wm", "sog8", "sog16",
                            "sog32", "fast", "all"],
                   help="engine; 'fast' = shared fast path, "
                        "'all' = run every engine and cross-check counts")
    p.add_argument("--m", type=int, required=True, help="pattern length")
    p.add_argument("--p-size", type=int, default=0, help="number of patterns")
    p.add_argument("--alphabet", type=int, default=4,
                   help="alphabet size (2/4/8/20/128/256)")
    src = p.add_argument_group("corpus")
    src.add_argument("--text", help="pre-encoded corpus file (bytes < sigma)")
    src.add_argument("--fasta",
                     help="FASTA corpus file (encoded via alphabet)")
    src.add_argument("--synthetic", action="store_true",
                     help="generate a uniform random corpus")
    src.add_argument("--n", type=int, default=0,
                     help="corpus length (required with --synthetic)")
    src.add_argument("--seed", type=int, default=0)
    pat = p.add_argument_group("patterns")
    pat.add_argument("--patterns",
                     help="pattern file: .npz (PatternSet.save), .fa/.fasta "
                          "(one record per pattern), or raw fixed-width "
                          "records")
    pat.add_argument("--frac-present", type=float, default=0.5,
                     help="synthetic patterns: fraction sampled from the text")
    pat.add_argument("--save-patterns", metavar="OUT.npz",
                     help="write the (possibly generated) pattern set to disk "
                          "— the reference's -c dataset-creation workflow "
                          "(main.c:48-50)")
    src.add_argument("--save-corpus", metavar="OUT.bin",
                     help="write the (possibly generated) encoded corpus")
    run = p.add_argument_group("execution")
    run.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                     help="where the scans run: the card (kernels) or the "
                          "CPU (their plain torch versions)")
    run.add_argument("--devices", type=int, default=1,
                     help="count over this many ranks (torch.distributed)")
    run.add_argument("--lanes", type=int, default=8192, help="AC scan lanes")
    run.add_argument("--q", type=int, default=1,
                     help="AC portable scan: chars consumed per composed-"
                          "table step")
    run.add_argument("--tile", type=int, default=1 << 20,
                     help="filter-engine tile (window starts per tile)")
    run.add_argument("--reps", type=int, default=1, help="timed repetitions")
    run.add_argument("--stream", action="store_true",
                     help="stream the --text corpus from disk (count_file / "
                          "positions_file) instead of loading it — for "
                          "corpora larger than host memory; requires "
                          "--patterns and a single device")
    run.add_argument("--chunk", type=int, default=1 << 28,
                     help="streamed piece size in bytes (--stream)")
    run.add_argument("--verify", action="store_true",
                     help="cross-check against the host ground truth "
                          "(the native library's threaded count; numpy, "
                          "which loads every window, where it does not "
                          "build)")
    run.add_argument("--json", action="store_true",
                     help="print only the JSON result line")
    ckpt = p.add_argument_group("tables checkpoint")
    ckpt.add_argument("--save-tables", metavar="PATH",
                      help="serialize the engine's preprocessing tables to "
                           ".npz after building (core.checkpoint)")
    ckpt.add_argument("--tables", metavar="PATH",
                      help="load prebuilt tables instead of preprocessing "
                           "(single-engine runs)")
    run.add_argument("--positions", metavar="OUT.npy",
                     help="also write match start positions (any engine on "
                          "one device, the fast engine on several) to a "
                          ".npy file")
    run.add_argument("--per-pattern", metavar="OUT.npy",
                     help="also write per-pattern match-start counts "
                          "((p,) int64, sums to the total; single device, "
                          "in-memory corpus) to a .npy file")
    prof = p.add_argument_group("profiling")
    prof.add_argument("--profile", metavar="LOGDIR",
                      help="record a torch.profiler trace of the timed scans "
                           "(Chrome / Perfetto; with --reps > 1), and the "
                           "port's spans over them, summed by name, under "
                           "\"spans\" in the JSON result")
    return p


def load_inputs(args, mesh=None):
    """(text, patterns, seconds).  On several ranks (mesh) a --text corpus
    stays on disk as a memmap: each rank reads its own byte range
    (rank_text), and the whole file is read only where patterns are
    sampled from it or --verify needs it."""
    from tpu_smatcher_torch.core import corpus, datagen
    from tpu_smatcher_torch.core.alphabet import Alphabet

    ab = Alphabet.of_size(args.alphabet)
    t0 = time.time()
    if args.stream:
        # the corpus stays on disk, scanned piecewise by count_file /
        # positions_file: it may exceed host memory
        if not args.text:
            sys.exit("--stream requires --text (a pre-encoded corpus file)")
        if not args.patterns:
            sys.exit("--stream requires --patterns (patterns cannot be "
                     "sampled from an unloaded corpus)")
        text = None
    elif args.synthetic:
        if not args.n:
            sys.exit("--synthetic requires --n")
        text = datagen.generate_text(args.n, ab, seed=args.seed)
    elif args.text and mesh is not None:
        text = np.memmap(args.text, dtype=np.uint8, mode="r")
    elif args.text:
        text = corpus.load_raw(args.text, Alphabet(args.alphabet)).codes
    elif args.fasta:
        text = corpus.load_fasta(args.fasta, ab).codes
    else:
        sys.exit("one of --synthetic/--text/--fasta is required")

    if args.patterns:
        pats = load_patterns(args, ab)
    else:
        if not args.p_size:
            sys.exit("--p-size (or --patterns) is required")
        pats = datagen.generate_patterns(text, args.p_size, args.m, ab,
                                         frac_present=args.frac_present,
                                         seed=args.seed + 1)
    return text, pats, time.time() - t0


def load_patterns(args, ab):
    """The --patterns file: a PatternSet, or a MixedPatternSet for FASTA
    records of several lengths."""
    from tpu_smatcher_torch.core.patterns import (MixedPatternSet,
                                                  PatternSet, _fasta_records)
    if args.patterns.endswith(".npz"):
        return PatternSet.load(args.patterns)
    if args.patterns.endswith((".fa", ".fasta")):
        # mixed lengths are detected from the records themselves
        records = _fasta_records(args.patterns)
        if len({len(r) for r in records}) == 1:
            return PatternSet.from_strings(records, ab)
        # mixed-length records: one sub-scanner per length
        pats = MixedPatternSet.from_strings(records, ab)
        print(f"mixed-length pattern set: lengths {pats.lengths} "
              f"({pats.p_size} patterns)", file=sys.stderr)
        return pats
    raw = np.fromfile(args.patterns, dtype=np.uint8)
    if raw.size % args.m:
        sys.exit(f"pattern file size {raw.size} not a multiple of "
                 f"m={args.m}")
    return PatternSet(raw.reshape(-1, args.m), ab)


def save_inputs(args, text, pats) -> None:
    """--save-patterns / --save-corpus (rank 0 only)."""
    if args.save_patterns:
        if not hasattr(pats, "save"):
            sys.exit("--save-patterns supports uniform-length sets only "
                     "(mixed sets load directly from FASTA)")
        written = pats.save(args.save_patterns)
        if written != args.save_patterns:
            print(f"patterns written to {written}", file=sys.stderr)
    if args.save_corpus and text is not None:
        np.asarray(text, np.uint8).tofile(args.save_corpus)


def check_distributed(args) -> None:
    """The refusals of several ranks, made before any rank starts and
    before any corpus is read (only a FASTA pattern file can mix
    lengths)."""
    from tpu_smatcher_torch.core.alphabet import Alphabet
    from tpu_smatcher_torch.core.patterns import MixedPatternSet
    if args.devices <= 1:
        return
    if args.stream:
        raise SystemExit("--stream is single-device; shard big corpora "
                         "with parallel.multihost.load_corpus_shards "
                         "instead")
    if (args.patterns and args.patterns.endswith((".fa", ".fasta"))
            and isinstance(load_patterns(args, Alphabet.of_size(
                args.alphabet)), MixedPatternSet)):
        raise SystemExit("mixed-length pattern sets run single-device")
    if args.tables or args.save_tables:
        raise SystemExit(
            "--tables/--save-tables are single-device options — run the "
            "checkpoint step with --devices 1")


def rank_text(args, text, pats, mesh):
    """(this rank's shard on its device, the corpus length): a --text
    corpus read from the rank's own byte range of the file
    (load_corpus_shards), any other cut from the text every rank holds
    (shard_text)."""
    from tpu_smatcher_torch.parallel import (host_shard_ranges,
                                             load_corpus_shards, shard_text)
    if not args.text:
        return shard_text(text, mesh, sigma=pats.sigma)
    shard, n = load_corpus_shards(args.text, mesh, sigma=pats.sigma)
    lo, hi = host_shard_ranges(n, mesh)[mesh.rank][0]
    if pats.sigma < 256 and hi > lo:
        top = int(shard[:hi - lo].max())
        if top >= pats.sigma:
            raise ValueError(f"code {top} out of range for alphabet size "
                             f"{pats.sigma}")
    return shard, n


def build_scanner(name, pats, args, dev, mesh):
    """(scanner, the FastScanner of distributed --positions or None)."""
    from tpu_smatcher_torch.core.patterns import MixedPatternSet
    from tpu_smatcher_torch.engines import (attach_fastpath, build_tables,
                                            make_distributed, make_engine,
                                            make_engine_from_tables,
                                            make_fast, make_mixed)
    q = args.q if name == "ac" else 1
    if isinstance(pats, MixedPatternSet):
        if args.tables or args.save_tables:
            raise SystemExit("--tables/--save-tables need a uniform-length "
                             "set (checkpoints hold one engine's tables)")
        opts = {} if name == "fast" else {"lanes": args.lanes,
                                          "tile": args.tile}
        return make_mixed(pats, engine=name, device=dev, **opts), None
    if mesh is not None:
        opts = {} if name == "fast" else {"lanes": args.lanes,
                                          "tile": args.tile}
        dc = make_distributed(name, pats, mesh, device=dev.type, **opts)
        return dc, (dc.fast if name == "fast" else None)
    if args.tables or args.save_tables:
        from tpu_smatcher_torch.core.checkpoint import load_tables, save_tables
        if args.tables:
            if args.algo == "all":
                raise SystemExit(
                    "--tables holds ONE engine's checkpoint; --algo all "
                    "would feed it to every engine — pass the matching "
                    "--algo")
            tables = load_tables(args.tables, device=dev)
        else:
            # build once, save, construct from the same tables (no rebuild)
            tables = build_tables(name, pats, device=dev)
            path = args.save_tables
            if args.algo == "all":       # one file per engine, not overwrite
                base = path[:-4] if path.endswith(".npz") else path
                path = f"{base}.{name}.npz"
            save_tables(path, tables)
        scanner = make_engine_from_tables(
            name, tables, device=dev, lanes=args.lanes, q=q,
            tile=args.tile if name != "fast" else 1 << 24)
        if name != "fast":               # the engine's kernel path
            attach_fastpath(scanner, name, pats.codes, pats.sigma)
            scanner.pattern_codes = np.asarray(pats.codes, np.uint8)
            scanner.pattern_sigma = pats.sigma
        return scanner, None
    if name == "fast":
        return make_fast(pats, device=dev), None
    return make_engine(name, pats, device=dev, lanes=args.lanes,
                       tile=args.tile, q=q), None


def run_stream(name, scanner, args, t_build, say):
    """--stream: the corpus stays on disk."""
    size = os.path.getsize(args.text)
    t0 = time.time()
    count = scanner.count_file(args.text, chunk=args.chunk)
    t_first = time.time() - t0
    t_scan = t_first
    if args.reps > 1:
        times = []
        for _ in range(args.reps):
            t0 = time.time()
            count = scanner.count_file(args.text, chunk=args.chunk)
            times.append(time.time() - t0)
        t_scan = min(times)
    if args.per_pattern:
        print("--per-pattern skipped: needs an in-memory corpus "
              "(drop --stream)", file=sys.stderr)
    if args.positions:
        try:
            pos = scanner.positions_file(args.text, chunk=args.chunk)
        except NotImplementedError as e:
            print(f"--positions skipped ({name}): {e}", file=sys.stderr)
        else:
            if isinstance(pos, tuple):   # mixed: (starts, lengths)
                pos = np.stack(pos, axis=1)
            np.save(args.positions, pos)
            say(f"[{name:5s}] {len(pos)} match positions -> "
                f"{args.positions}")
    return {
        "engine": name,
        "matches": int(count),
        "time_preproc_s": round(t_build, 4),
        "time_first_scan_s": round(t_first, 4),
        "time_scan_s": round(t_scan, 4),
        "bytes_per_s": round(size / t_scan, 1),
        "device_bytes_per_s": round(size / t_scan, 1),
    }


def run_engine(name, text, pats, args, dev, mesh, say, shard=None):
    """One engine's result dict; `shard` is rank_text's (shard, n) on
    several ranks."""
    from tpu_smatcher_torch.core.patterns import MixedPatternSet
    from tpu_smatcher_torch.ops.fast import device_text

    mixed = isinstance(pats, MixedPatternSet)
    t0 = time.time()
    scanner, fast = build_scanner(name, pats, args, dev, mesh)
    t_build = time.time() - t0
    if text is None:
        return run_stream(name, scanner, args, t_build, say)

    count_kw = {}
    if mesh is None:
        tdev = device_text(text, dev)
    else:
        # the true length rides along so that a sigma=256 count knows
        # where the corpus ends
        tdev, n_true = shard
        count_kw = {"n": n_true}
    t0 = time.time()
    count = scanner.count(tdev, **count_kw)
    t_first = time.time() - t0           # includes the kernels' build
    t_scan = t_scan_dev = t_first
    spans = None
    if args.reps > 1:
        from tpu_smatcher_torch.utils import profiling
        lead = mesh is None or mesh.rank == 0
        profile = args.profile and lead
        ctx = (profiling.trace(args.profile) if profile
               else contextlib.nullcontext())
        if profile:
            profiling.clear()
        with ctx:
            times = []
            for _ in range(args.reps):
                t0 = time.time()
                count = scanner.count(tdev, **count_kw)
                times.append(time.time() - t0)
        if profile:
            spans = profiling.summary()
        t_scan = t_scan_dev = min(times)
        # the device's steady rate: queue the scans, read the last; the
        # per-call rate above includes one host round trip per scan
        q = max(args.reps, 5)
        t0 = time.time()
        fs = [scanner.count_async(tdev, **count_kw) for _ in range(q)]
        for f in fs:
            f.result()
        t_many = time.time() - t0
        t0 = time.time()
        scanner.count_async(tdev, **count_kw).result()
        t_one = time.time() - t0
        d = (t_many - t_one) / (q - 1)
        if d > 1e-5:
            t_scan_dev = d
    if args.positions:
        try:
            if mesh is not None:
                if fast is None:
                    raise NotImplementedError(
                        "distributed --positions runs on the fast engine "
                        "only (counts are identical across engines)")
                from tpu_smatcher_torch.parallel import DistributedPositions
                pos = DistributedPositions(fast, mesh).positions(tdev,
                                                                 **count_kw)
            else:
                pos = scanner.positions(tdev)
        except NotImplementedError as e:
            print(f"--positions skipped ({name}): {e}", file=sys.stderr)
        else:
            if mixed:                        # (starts, lengths)
                pos = np.stack(pos, axis=1)
            if mesh is None or mesh.rank == 0:
                np.save(args.positions, pos)
            say(f"[{name:5s}] {len(pos)} match positions -> "
                f"{args.positions}")
    if args.per_pattern:
        try:
            if mesh is not None:
                raise NotImplementedError("--per-pattern runs single-device")
            per = scanner.count_per_pattern(tdev)
        except (NotImplementedError, ValueError) as e:
            print(f"--per-pattern skipped ({name}): {e}", file=sys.stderr)
        else:
            np.save(args.per_pattern, per)
            say(f"[{name:5s}] per-pattern counts (sum {per.sum()}) -> "
                f"{args.per_pattern}")

    out = {
        "engine": name,
        "matches": int(count),
        "time_preproc_s": round(t_build, 4),
        "time_first_scan_s": round(t_first, 4),
        "time_scan_s": round(t_scan, 4),
        "bytes_per_s": round(len(text) / t_scan, 1),
        "device_bytes_per_s": round(len(text) / t_scan_dev, 1),
    }
    if spans is not None:
        out["spans"] = spans
    return out


def engine_names(args, pats) -> list:
    from tpu_smatcher_torch.core.patterns import MixedPatternSet
    mixed = isinstance(pats, MixedPatternSet)
    if args.algo != "all":
        if mixed and args.algo.startswith("sog"):
            sys.exit(f"--algo {args.algo} needs every pattern to have "
                     f"length {args.algo[3:]}; this set mixes lengths "
                     f"{pats.lengths} — use fast/ac/sh/sbom/wm (one "
                     "sub-scanner per length)")
        return [args.algo]
    names = ["ac", "sh", "sbom", "wm", "fast"]
    if mixed:
        # SOG widths are per length (m == 8/16/32): skip it for mixed sets
        print("skipping sog engines: SOG requires one shared pattern "
              "length in {8, 16, 32}, pattern set mixes lengths "
              f"{pats.lengths}", file=sys.stderr)
    elif args.m in (8, 16, 32):
        names.append(f"sog{args.m}")
    return names


def run(args, mesh=None) -> int:
    """Every engine of the run on this rank; rank 0 prints.  Returns the
    exit code."""
    import torch
    from tpu_smatcher_torch.core import datagen
    from tpu_smatcher_torch.core.patterns import MixedPatternSet

    text, pats, t_read = load_inputs(args, mesh)
    shard = None
    if mesh is not None:
        # sharded once, before any timing: re-sharding per rep would time
        # the read and the host-to-device copy, not the scan
        t0 = time.time()
        shard = rank_text(args, text, pats, mesh)
        t_read += time.time() - t0
    lead = mesh is None or mesh.rank == 0
    if lead:
        save_inputs(args, text, pats)

    def say(msg):
        if lead and not args.json:
            print(msg, flush=True)

    dev = mesh.device if mesh is not None else torch.device(args.device)
    if dev.type == "cuda" and dev.index is None:
        from tpu_smatcher_torch.engines import _device
        dev = _device(dev)
    results = []
    for name in engine_names(args, pats):
        r = run_engine(name, text, pats, args, dev, mesh, say, shard)
        r["time_read_s"] = round(t_read, 4)
        results.append(r)
        say(f"[{r['engine']:5s}] matches={r['matches']}  "
            f"preproc {r['time_preproc_s'] * 1e3:.1f}ms  "
            f"scan {r['time_scan_s'] * 1e3:.1f}ms  "
            f"({r['bytes_per_s'] / 1e9:.3f} GB/s)")

    exit_code = 0
    if args.algo == "all":
        counts = {r["matches"] for r in results}
        agree = len(counts) == 1
        say("cross-check: " + ("ALL ENGINES AGREE" if agree
                               else f"MISMATCH {sorted(counts)}"))
        if not agree:
            exit_code = 2

    if args.verify and lead:
        if text is None:                 # --stream: memmap for ground truth
            text = np.memmap(args.text, dtype=np.uint8, mode="r")
        if isinstance(pats, MixedPatternSet):
            truth = sum(datagen.count_matches(text, g, prefer_native=True)
                        for g in pats.groups)
        else:
            truth = datagen.count_matches(text, pats, prefer_native=True)
        ok = all(r["matches"] == truth for r in results)
        for r in results:
            r["ground_truth"] = int(truth)
        say(f"ground truth: {truth} -> {'OK' if ok else 'FAILED'}")
        if not ok and not exit_code:
            exit_code = 3

    # the JSON result line always comes last: on disagreement it carries
    # the per-engine counts; the exit code still signals
    if lead:
        print(json.dumps(results if len(results) > 1 else results[0]),
              flush=True)
    return exit_code


def _in_torchrun() -> bool:
    return "TORCHELASTIC_RUN_ID" in os.environ or (
        "RANK" in os.environ and "WORLD_SIZE" in os.environ)


def _rank_main(rank: int, world: int, store_path: str, argv) -> None:
    """One rank started by the CLI: join the group over the file store,
    run, exit with the run's code (rank 0's is the CLI's)."""
    import torch
    import torch.distributed as dist
    from tpu_smatcher_torch.parallel import init_distributed, make_mesh
    args = build_parser().parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_distributed(num_processes=world, process_id=rank,
                     device=args.device,
                     store=dist.FileStore(store_path, world))
    try:
        code = run(args, make_mesh(world, device=args.device))
    finally:
        dist.destroy_process_group()
    sys.stdout.flush()
    os._exit(code)


def spawn_ranks(args, argv) -> int:
    """Start args.devices local ranks (spawned processes) over a file
    store in a temporary directory; wait for all.  Returns rank 0's exit
    code, or the first failing rank's."""
    import torch.multiprocessing as mp
    from tpu_smatcher_torch.parallel.mesh import pick_backend
    world = args.devices
    print(f"ranks: {world} local processes, backend "
          f"{pick_backend(args.device, world)}", file=sys.stderr)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="tsm-ranks-")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, os.path.join(tmp, "store"), argv))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.time() + SPAWN_TIMEOUT_S
        for p in procs:
            p.join(max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    codes = [p.exitcode for p in procs]
    failed = [c for c in codes[1:] if c]
    return codes[0] if codes[0] or not failed else failed[0]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.devices > 1 or _in_torchrun():
        if _in_torchrun():
            import torch.distributed as dist
            from tpu_smatcher_torch.parallel import (init_distributed,
                                                     make_mesh)
            init_distributed(device=args.device)
            world = dist.get_world_size()
            if dist.get_rank() == 0:
                print(f"ranks: {world} (torchrun), backend "
                      f"{dist.get_backend()}", file=sys.stderr)
            if args.devices != world:
                sys.exit(f"--devices {args.devices} != the torchrun world "
                         f"size {world}")
            check_distributed(args)
            code = run(args, make_mesh(world, device=args.device))
            dist.destroy_process_group()
        else:
            check_distributed(args)
            code = spawn_ranks(args, argv)
    else:
        code = run(args)
    if code:
        sys.exit(code)


if __name__ == "__main__":
    main()
