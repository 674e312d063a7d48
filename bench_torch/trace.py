"""A traced window: torch.profiler over a stretch of counts, reduced to
what the per-layer readers (bench_torch/metrics/) read.

Device events are the profiler's kernel, copy and set events (not the
ranges it annotates on the device's timeline, such as "nccl:all_reduce",
which repeat the kernels under them); busy time is the union of their
intervals, and the window is the host clock around the
traced counts, which end in a read-back.  The port's own kernels (their
__global__ names, KERNEL_SYMBOLS) are held against the port's launch
counters (tpu_smatcher_torch.ops.cuda_filter.LAUNCHES): torch.profiler now
and then drops kernel records, and a session that lost some is run again.

While a session runs, the wrappers of the kernels whose rooflines are read
record each call's shapes (Spies), from which roofline.py computes the
bound of the call.  The benchmark's own edit of the corpus before each
count runs under a range named EDIT; the device events its ops launched
(those whose id, the profiler's correlation id, is that of a runtime call
under the range) are left out of the session's device events
(Trace.harness counts them).
"""

from __future__ import annotations

import bisect
import collections
import contextlib

import torch

#: the __global__ functions of tpu_smatcher_torch/csrc
KERNEL_SYMBOLS = ("exact_kernel", "cascade_kernel", "filter_kernel",
                  "words_kernel", "stages_kernel")
#: entries of each list of the breakdown
BREAKDOWN_ROWS = 10
#: the range the benchmark's own edit of the corpus runs under
EDIT = "bench_torch.edit"
#: CPU events a gap's name is looked for among, walking back from the last
#: one that started before the gap's middle
_WALK = 64


def ours(name: str) -> bool:
    return any(f"::{k}" in name for k in KERNEL_SYMBOLS)


def annotation(e) -> bool:
    """A range the profiler draws on the device's timeline over kernels
    (a record_function's, a collective's, the profiler's own step)."""
    return (getattr(e, "is_user_annotation", False)
            or e.name.startswith(("ProfilerStep", "nccl:", "gloo:")))


class Spies:
    """Records the shapes of every call of cuda_filter.cascade and
    cuda_filter.exact_count while installed."""

    def __init__(self):
        self.calls = collections.defaultdict(list)

    @contextlib.contextmanager
    def installed(self):
        from tpu_smatcher_torch.ops import cuda_filter as cf
        real = {"cascade": cf.cascade, "exact_count": cf.exact_count}

        def cascade(text, bitmaps, *, m, k1, cd):
            slots, ovf = real["cascade"](text, bitmaps, m=m, k1=k1, cd=cd)
            self.calls["cascade"].append(dict(
                n=int(text.shape[0]), m=m, k1=k1, bitmaps=bitmaps,
                out_bytes=slots.numel() * slots.element_size()
                + ovf.numel() * ovf.element_size()))
            return slots, ovf

        def exact_count(text, bitmap, *, m, sigma, guard=False):
            out = real["exact_count"](text, bitmap, m=m, sigma=sigma,
                                      guard=guard)
            self.calls["exact_count"].append(dict(
                n=int(text.shape[0]), m=m, guard=bool(guard),
                bitmap_bytes=bitmap.numel() * bitmap.element_size()))
            return out

        cf.cascade, cf.exact_count = cascade, exact_count
        try:
            yield self
        finally:
            cf.cascade, cf.exact_count = real["cascade"], real["exact_count"]


class Trace:
    """One traced session, reduced.

    device: [(name, start_us, end_us)] of the device's events, by start,
    without the benchmark's edits' (harness: how many those were);
    cpu: [(name, start_us, end_us)] of the host's events, by start;
    counts: counts completed in the session; window_s: its host-clock
    seconds; launches: the port's launch counters' deltas; calls: the
    Spies' records; host: what the run read of the host over an untraced
    stretch of counts just before (cpu_ms_per_count, the process's CPU
    time a count)."""

    def __init__(self, prof, counts, window_s, launches, calls):
        from torch.autograd import DeviceType
        events = prof.events()
        edits = {e.id for e in events
                 if e.device_type != DeviceType.CUDA
                 and e.name.startswith("cuda") and _under_edit(e)}
        dev, cpu = [], []
        self.harness = 0
        for e in events:
            tr = e.time_range
            row = (e.name, float(tr.start), float(tr.end))
            if e.device_type == DeviceType.CUDA:
                if annotation(e):
                    continue
                if e.id in edits:
                    self.harness += 1
                else:
                    dev.append(row)
            else:
                cpu.append(row)
        dev.sort(key=lambda r: r[1])
        cpu.sort(key=lambda r: r[1])
        self.device, self.cpu = dev, cpu
        self.counts = counts
        self.window_s = window_s
        self.launches = launches
        self.calls = calls
        self.host = {}
        self.busy_intervals = _union([(s, e) for _, s, e in dev])
        self.busy_s = sum(e - s for s, e in self.busy_intervals) / 1e6

    def port_events(self) -> int:
        return sum(1 for name, _, _ in self.device if ours(name))

    def complete(self) -> bool:
        """Every launch of the port's kernels has its record."""
        return self.port_events() == sum(self.launches.values())

    def seconds(self, pick) -> float:
        """Device seconds of the events whose name pick() accepts."""
        return sum(e - s for name, s, e in self.device if pick(name)) / 1e6

    def breakdown(self) -> dict:
        """The device ops that took most time, and the idle gaps summed by
        the innermost host event under each gap's middle ("python" where
        the host ran no profiled op), each [name, seconds]."""
        ops = collections.Counter()
        for name, s, e in self.device:
            ops[name] += (e - s) / 1e6
        gaps = collections.Counter()
        starts = [s for _, s, _ in self.cpu]
        iv = self.busy_intervals
        for (_, e0), (s1, _) in zip(iv, iv[1:]):
            gaps[self._host_at((e0 + s1) / 2, starts)] += (s1 - e0) / 1e6
        return {"device_ops": [[k, v] for k, v in
                               ops.most_common(BREAKDOWN_ROWS)],
                "idle_gaps": [[k, v] for k, v in
                              gaps.most_common(BREAKDOWN_ROWS)]}

    def _host_at(self, t, starts) -> str:
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - _WALK, -1), -1):
            name, s, e = self.cpu[j]
            if s <= t <= e:
                return name
        return "python"


def _under_edit(e) -> bool:
    """A CPU op inside the benchmark's edit range."""
    p = getattr(e, "cpu_parent", None)
    while p is not None:
        if p.name == EDIT:
            return True
        p = p.cpu_parent
    return False


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def session(run_counts, launch_counter):
    """One profiled session: run_counts() runs the traced counts and
    returns (counts, window_s).  Returns a Trace."""
    from torch.profiler import ProfilerActivity
    spies = Spies()
    before = dict(launch_counter)
    with spies.installed(), torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        counts, window_s = run_counts()
    launches = {k: v - before[k] for k, v in launch_counter.items()}
    return Trace(prof, counts, window_s, launches, dict(spies.calls))
