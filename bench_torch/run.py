"""Benchmark of tpu_smatcher_torch on NVIDIA cards.

    python3 bench_torch/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout that holds BENCHMARK.json and the port.  CELL
names an entry of BENCHMARK.json's workloads (bench_torch/spec.py finds its
configuration, traffic and metrics).  The run needs as many CUDA cards as
the cell asks for and fails without them; a cell on k cards runs k rank
processes of this script, one per card, over NCCL.

--trace 0 prints the cell's end-to-end metrics, --trace 1 its per-layer
metrics: each metric is read by its own file, bench_torch/metrics/<name>.py
(spec.py), from the window's record (counts, seconds, every count's
host-clock latency, set-up seconds) or from the traced run (the process's
CPU time over rank.HOST_S seconds of counts, then torch.profiler sessions
of rank.TRACE_S seconds each).  A traced run also gives the device's busy
and window seconds and a breakdown of the top device ops and idle gaps.

Every request edits the corpus and counts it (rank.py).  Every count the
run made is compared with the plain reference's count of the same edited
corpus, made from the seed: `correct` holds only where every one is equal
(the limit is 0) and none raised.  The last line of standard
output is the result, a JSON object; the comparisons are the last lines
of standard error and the result's last key, "checks".
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_torch import spec  # noqa: E402

#: the limit of every compared number: counts are exact
COUNT_GAP_LIMIT = 0
#: seconds a rank process may take; the first run of a cell builds the
#: kernels
RANK_TIMEOUT_S = 1150


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank process of a multi-card cell (started by this script)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--bench", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def card_line():
    """The card's name and power limit, by nvidia-smi where it runs."""
    import torch
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    return (f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: "
            f"{' | '.join(smi) or 'not available'}; torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(cell, args, device, worker=None):
    """Each rank's dict: in this process on one card, else from one process
    per rank (`worker`, by default this script, with the rank options)."""
    from bench_torch import rank
    import torch
    if cell.chips == 1:
        dev = torch.device(device, 0) if device == "cuda" else \
            torch.device(device)
        return [rank.run(cell, args.seed, args.seconds, bool(args.trace),
                         device=dev, t_start=T_START)]
    worker = worker or [sys.executable, os.path.abspath(__file__)]
    port = free_port()
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for r in range(cell.chips):
                env = dict(os.environ, LOCAL_RANK=str(r))
                procs.append(subprocess.Popen(worker + [
                    "--workload", cell.name, "--seed", str(args.seed),
                    "--seconds", str(args.seconds), "--trace",
                    str(args.trace), "--rank", str(r), "--port", str(port),
                    "--t0", repr(T_START), "--device", device,
                    "--out", os.path.join(tmp, f"rank{r}.json")]
                    + (["--bench", args.bench] if args.bench else []), env=env,
                    cwd=ROOT, stdout=subprocess.DEVNULL))
            deadline = time.time() + RANK_TIMEOUT_S
            for p in procs:
                p.wait(timeout=max(deadline - time.time(), 1))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise SystemExit(f"rank processes {bad} failed (exit codes "
                             f"{[procs[r].returncode for r in bad]})")
        out = []
        for r in range(cell.chips):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out.append(json.load(f))
        return out


def rank_main(args, cell):
    """A rank process: joins the group, runs its share, writes its dict."""
    import datetime
    import torch
    import torch.distributed as dist
    from bench_torch import rank
    if args.device == "cuda":
        dev = torch.device("cuda", args.rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://127.0.0.1:{args.port}",
                            rank=args.rank, world_size=cell.chips,
                            timeout=datetime.timedelta(seconds=600))
    try:
        res = rank.run(cell, args.seed, args.seconds, bool(args.trace),
                       device=dev, t_start=args.t0, rank=args.rank,
                       world=cell.chips)
    finally:
        dist.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(res, f)


def compare(ranks):
    """(gap, wrong, expected): the largest |count - reference| over every
    request of every rank (None where no count came back), the most
    requests of one rank that raised or differed, and the reference's
    counts, one a request."""
    n_req = len(ranks[0]["values"])
    base = sum(r["ref_base"] for r in ranks)
    expected = [base + sum(d) for d in zip(*(r["ref_deltas"]
                                             for r in ranks))]
    gap, wrong = None, 0
    for r in ranks:
        if len(r["values"]) != n_req or len(expected) != n_req:
            return None, n_req, expected
        bad = 0
        for i, (v, e) in enumerate(zip(r["values"], expected)):
            if v is None or v != e:
                if bad == 0:
                    log(f"request {i}: count {v}, reference {e}")
                bad += 1
            if v is not None:
                gap = max(gap or 0, abs(v - e))
        wrong = max(wrong, bad)
    return gap, wrong, expected


def assemble(cell, ranks, traced, kind):
    """The result line's object, checks last."""
    gap, wrong, expected = compare(ranks)
    r0 = ranks[0]
    correct = gap is not None and gap <= COUNT_GAP_LIMIT and wrong == 0
    if traced:
        values = r0["per_layer"]
        listed = cell.per_layer
    else:
        values = {}
        run_record = {"bytes_per_count": cell.n,
                      "counts": r0["window_counts"],
                      "window_s": r0["window_s"],
                      "latency_ms": r0["latency_ms"],
                      "setup_s": r0["setup_s"]}
        for m in cell.end_to_end:
            v = cell.reader(m["name"])(run_record)
            if v is None:
                log(f"{m['name']}: nothing to read in this run")
            else:
                values[m["name"]] = v
        listed = cell.end_to_end
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in listed if m["name"] in values}
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": max(r.get("memory_peak_bytes", 0)
                                       for r in ranks)}
    out = {"correct": correct, "attempted": len(r0["values"]),
           "failed": wrong, "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = statistics.fmean(r["busy_s"] for r in ranks)
        device["window_s"] = statistics.fmean(r["window_s"] for r in ranks)
        out["breakdown"] = r0["breakdown"]
    log(f"{len(expected)} requests, {len(set(expected))} distinct reference "
        f"counts ({min(expected, default=None)}-"
        f"{max(expected, default=None)})")
    out["checks"] = {
        "count_gap": {"value": gap, "limit": COUNT_GAP_LIMIT},
        "failed_counts": {"value": wrong, "limit": 0}}
    return out


def print_result(out):
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)


def main(argv=None):
    args = parse(argv if argv is not None else sys.argv[1:])
    cell = spec.load(args.workload, ROOT, args.bench)
    if args.rank is not None:
        rank_main(args, cell)
        return 0
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: this benchmark measures the port on the card "
            "and does not run on the CPU")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA devices, "
            f"{torch.cuda.device_count()} found")
        return 3
    log(card_line())
    log(f"{cell.name}: n={cell.n} sigma={cell.sigma} m={cell.m} "
        f"p={cell.traffic['p']} chips={cell.chips} seed={args.seed} "
        f"seconds={args.seconds} trace={args.trace}")
    ranks = run_ranks(cell, args, "cuda")
    print_result(assemble(cell, ranks, bool(args.trace),
                          torch.cuda.get_device_name(0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
