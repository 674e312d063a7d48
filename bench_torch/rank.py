"""One rank of a cell's run: inputs from the seed, the system under test,
warm-up, the measured (or traced) window, then the reference.

A request updates the resident corpus by one edit (gen.Edits: a block of
gen.EDIT_ROWS * m bytes, some of them panel rows, written over the corpus,
the previous request's edit put back) and then counts the whole corpus, synchronously (one client, one request in
flight), through the program's public entry:

  one card     make_fast(panel, device=...).count(text);
  k ranks      make_distributed("fast", panel, make_mesh(k)).count(shard),
               one process per card, each holding its 1/k of the corpus
               and editing its own shard.

No two requests in a row count the same bytes, and the blocks add
different numbers of matches, so answers change from request to request.  A count's latency is the host clock (time.perf_counter) from the
call to the returned int; the edit before it is in the window, not in the
latency.  The window runs until `seconds` have passed on the host clock.
On k ranks, which must make the same calls, the ranks agree on its end
over a gloo group of the benchmark's own: first at the count where half
the window has passed at the slowest rank's warm-up pace, then every
CHECK_S seconds of counts at that pace.

After the window the program's state is freed; the rank regenerates its
inputs and edits from the seed, and the plain reference
(bench_torch/references/) counts its own window starts of the unedited
corpus and the change each edit makes.  It takes nothing the program made.
"""

from __future__ import annotations

import gc
import sys
import time
import traceback

import torch

from bench_torch import gen, trace

#: seconds of warm-up after the first count (its counts are compared too)
WARM_S = 1.0
#: seconds of the traced run's untraced stretch whose process CPU time is
#: read, then host-clock seconds of a traced session, and the sessions
#: tried for one that kept every kernel record
HOST_S = 1.0
TRACE_S = 1.0
PROFILE_TRIES = 5
#: on k ranks: counts between two checks of the warm-up's end; the share
#: of a window's expected counts before its end is first checked, and
#: seconds of counts between later checks (a check is a gloo all-reduce,
#: about a millisecond)
WARM_EVERY = 16
FIRST_CHECK = 0.5
CHECK_S = 0.25
#: edits whose change the reference counts at a time
REF_EDITS = 1 << 16


def log(msg):
    print(msg, file=sys.stderr, flush=True)


class Group:
    """The ranks' agreement on when a window ends; one rank agrees alone."""

    def __init__(self, world: int):
        self.pg = None
        self.pace_s = None
        if world > 1:
            import torch.distributed as dist
            self.pg = dist.new_group(backend="gloo")

    def barrier(self):
        if self.pg is not None:
            import torch.distributed as dist
            dist.barrier(group=self.pg)

    def any(self, flag: bool) -> bool:
        if self.pg is None:
            return flag
        import torch.distributed as dist
        t = torch.tensor([int(flag)])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.pg)
        return bool(t.item())

    def all(self, flag: bool) -> bool:
        return not self.any(not flag)

    def agree_pace(self, seconds_per_count: float):
        """Keeps the slowest rank's seconds a count, agreed by all."""
        if self.pg is None:
            return
        import torch.distributed as dist
        t = torch.tensor([seconds_per_count], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.pg)
        self.pace_s = max(float(t.item()), 1e-9)

    def checks(self, seconds: float):
        """(first, every): the count at which a window's end is first
        checked, and the counts between later checks."""
        if self.pg is None:
            return 1, 1
        if self.pace_s is None:
            return WARM_EVERY, WARM_EVERY
        return (max(1, int(FIRST_CHECK * seconds / self.pace_s)),
                max(1, int(CHECK_S / self.pace_s)))


class Requests:
    """The run's requests in order: each edits the resident text and
    counts it.  values[i] is what request i returned (None where it
    raised); latency_s and done_s hold the timed requests' latencies and
    return times.  With `annotate` (traced sessions) each edit runs under
    the range trace.EDIT."""

    def __init__(self, eng, text, blocks, edits):
        self.eng, self.text, self.blocks, self.edits = eng, text, blocks, \
            edits
        self.pristine = text.clone()
        self.w = edits.width
        self.prev = None
        self.values = []
        self.raised = 0
        self.latency_s = []
        self.done_s = []
        self.annotate = False

    def edit(self):
        w = self.w
        start, block = self.edits(len(self.values))
        if self.prev is not None:
            self.text[self.prev:self.prev + w].copy_(
                self.pristine[self.prev:self.prev + w])
        self.text[start:start + w].copy_(self.blocks[block])
        self.prev = start

    def __call__(self, timed: bool = False):
        if self.annotate:
            with torch.profiler.record_function(trace.EDIT):
                self.edit()
        else:
            self.edit()
        t0 = time.perf_counter()
        try:
            v = int(self.eng.count(self.text))
        except Exception:                   # a failed count, counted
            v = None
            self.raised += 1
            if self.raised == 1:
                log(f"count raised:\n{traceback.format_exc()}")
        if timed:
            t1 = time.perf_counter()
            self.latency_s.append(t1 - t0)
            self.done_s.append(t1)
        self.values.append(v)


def window(requests, seconds, group, timed=False):
    """Requests until `seconds` have passed; returns (counts, seconds)."""
    first, every = group.checks(seconds)
    group.barrier()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i, check = 0, first
    while True:
        requests(timed)
        i += 1
        if i >= check:
            if group.any(time.perf_counter() >= deadline):
                break
            check = i + every
    return i, time.perf_counter() - t0


def system(cell, panel, device, world):
    """The system under test over the panel: an object whose count()
    counts its argument."""
    from tpu_smatcher_torch import engines
    from tpu_smatcher_torch.core.alphabet import Alphabet
    from tpu_smatcher_torch.core.patterns import PatternSet
    pats = PatternSet(panel.cpu().numpy(), Alphabet.of_size(cell.sigma))
    if world > 1:
        from tpu_smatcher_torch.parallel import make_mesh
        mesh = make_mesh(world, device=device.type)
        return engines.make_distributed("fast", pats, mesh,
                                        device=device.type)
    return engines.make_fast(pats, device=device)


def tenths(done_s, t0, seconds):
    """Counts a second in each tenth of a window, for the log."""
    bins = [0] * 10
    for t in done_s:
        bins[min(9, int(10 * (t - t0) / seconds))] += 1
    return [round(10 * b / seconds, 1) for b in bins]


def run(cell, seed, seconds, traced, *, device, t_start, rank=0, world=1):
    """This rank's share of the run, as a JSON-able dict."""
    from tpu_smatcher_torch.ops import cuda_filter
    group = Group(world)
    text, panel = gen.make_inputs(cell.config, cell.traffic, seed, device)
    per = cell.n // world
    lo = rank * per
    shard = text[lo:lo + per].clone() if world > 1 else text
    del text
    edits = gen.Edits(seed, rank, per, cell.m)
    blocks = gen.make_blocks(panel, cell.sigma, seed, rank)
    req = Requests(system(cell, panel, device, world), shard, blocks, edits)
    del shard, panel, blocks
    req()                                   # builds and loads the kernels
    counts, secs = window(req, WARM_S, group)
    group.agree_pace(secs / counts)
    out = {"setup_s": time.time() - t_start}
    if traced:
        cpu0 = time.process_time()
        counts, _ = window(req, HOST_S, group)
        host = {"cpu_ms_per_count": (time.process_time() - cpu0) * 1e3
                / counts}
        req.annotate = True
        for tries in range(1, PROFILE_TRIES + 1):
            tr = trace.session(lambda: window(req, TRACE_S, group),
                               cuda_filter.LAUNCHES)
            if group.all(tr.complete()):
                break
        log(f"rank {rank}: traced {tr.counts} counts in {tr.window_s:.3f} s"
            f", session {tries}, port kernel events {tr.port_events()} of "
            f"{sum(tr.launches.values())} launches, {tr.harness} device "
            "events of the benchmark's edits left out")
        tr.host = host
        out.update(busy_s=tr.busy_s, window_s=tr.window_s)
        if rank == 0:
            out["per_layer"] = {}
            for metric in cell.per_layer:
                v = cell.reader(metric["name"])(tr)
                if v is None:
                    log(f"{metric['name']}: nothing to read in this run")
                else:
                    out["per_layer"][metric["name"]] = v
            out["breakdown"] = tr.breakdown()
        del tr
    else:
        first = len(req.values)
        counts, secs = window(req, seconds, group, timed=True)
        t0 = req.done_s[0] - req.latency_s[0]
        out.update(window_counts=counts, window_s=secs,
                   latency_ms=[s * 1e3 for s in req.latency_s]
                   if rank == 0 else [])
        log(f"rank {rank}: {counts} counts in {secs:.3f} s (requests "
            f"{first}-{first + counts - 1}), set-up {out['setup_s']:.3f} s, "
            f"overflow retries {getattr(req.eng, 'fallback_scans', 'n/a')}"
            f", counts a second by tenth {tenths(req.done_s, t0, secs)}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    out.update(values=req.values, raised=req.raised)
    del req
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    base, deltas = reference_partial(cell, seed, device, rank, world,
                                     len(out["values"]))
    out.update(ref_base=base, ref_deltas=deltas)
    return out


def reference_partial(cell, seed, device, rank, world, n_requests):
    """The plain reference's count of this rank's window starts in the
    unedited corpus, and the change of it each of the first n_requests
    edits makes, over inputs regenerated from the seed."""
    ref = cell.reference()
    text, panel = gen.make_inputs(cell.config, cell.traffic, seed, device)
    m = cell.m
    per = cell.n // world
    lo = rank * per
    hi = min(lo + per, cell.n - m + 1)
    base = ref.count(text[lo:hi + m - 1], panel, cell.sigma) \
        if hi > lo else 0
    edits = gen.Edits(seed, rank, per, m)
    blocks = gen.make_blocks(panel, cell.sigma, seed, rank)
    w = edits.width
    span = torch.arange(w + 2 * m - 2, device=device)
    deltas = []
    for a in range(0, n_requests, REF_EDITS):
        todo = [edits(i) for i in range(a, min(a + REF_EDITS, n_requests))]
        starts = torch.tensor([s for s, _ in todo], device=device)
        picks = torch.tensor([b for _, b in todo], device=device)
        # the windows an edit at s touches: starts s-m+1 .. s+w-1
        before = text[lo + starts[:, None] - m + 1 + span]
        after = before.clone()
        after[:, m - 1:m - 1 + w] = blocks[picks]
        deltas += (ref.count_rows(after, panel, cell.sigma)
                   - ref.count_rows(before, panel, cell.sigma)).tolist()
    return base, deltas
