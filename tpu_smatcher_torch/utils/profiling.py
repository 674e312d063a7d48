"""Tracing of the port: spans at the layer boundaries of the count path,
and torch.profiler traces (the reference's nvprof runs, profile.sh).

A span (`with span(name): ...`) records its name, its request, its parent
span, its host start and end (time.perf_counter_ns) and attributes.  With
device=t, a CUDA tensor, it also records a pair of timing CUDA events at
its edges on the current stream of t's device; they are resolved into
device_ms once a later read-back (a tsm.readback or tsm.ladder span) has
finished them, by cudaEventQuery, never by a wait of the tracer's own.

The first span opened on a thread with no span open is a root: it starts
a request, and the spans opened inside it on that thread inherit its id.
A span opened with request=id and no span open joins that request (a
future's read-back joins its scan's request).

Tracing is on after enable() (until disable()), and while a torch.profiler
session records (torch.autograd.profiler._is_profiler_enabled); under the
profiler each span is also one of its ranges, so a trace shows the spans
on the profiler's clock beside the device's events.  Off, span() tests
that flag and returns a shared object that does nothing: no record, no
CUDA call, no lock.

The last STORE_SPANS closed spans are kept in memory: requests(last=n)
gives the last n whole requests, summary() sums the spans by name,
clear() empties the store.  They are kept as tuples of ints and strings,
which the garbage collector stops tracking, so a full store adds nothing
to the collections of the rest of the program.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
import typing

import torch
import torch.autograd.profiler as _autograd_profiler

#: closed spans kept (the oldest are dropped first)
STORE_SPANS = 1 << 18

#: a profiler range at a lower cost than torch.profiler.record_function
_RecordFunction = torch._C._profiler._RecordFunctionFast

_enabled = False
_store: collections.deque = collections.deque(maxlen=STORE_SPANS)
#: (span id, device index, start, end) of the device markers that wait
#: for a read-back, and the resolved device ms by span id
_pending: collections.deque = collections.deque(maxlen=STORE_SPANS)
_device_ms: dict = {}
#: resolved timing events, by device index, for the next markers
_free_events = collections.defaultdict(list)
#: perf_counter_ns of the last clear(): a request opened before it is not
#: whole
_cleared_ns = 0
_span_ids = itertools.count()
_request_ids = itertools.count()
_local = threading.local()


def enable() -> None:
    """Record spans from now on, profiler or not."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record spans only while a torch.profiler session records."""
    global _enabled
    _enabled = False


def tracing() -> bool:
    """Whether span() records now."""
    return _enabled or _autograd_profiler._is_profiler_enabled


class _Off:
    """The span of tracing off: a shared object that does nothing, and is
    falsy.  Its __enter__ (set below) is a builtin that returns it, which
    costs no Python frame."""

    __slots__ = ()
    request = None

    def __exit__(self, exc_type, exc, tb):
        return None

    def __bool__(self):
        return False


_OFF = _Off()
_Off.__enter__ = itertools.repeat(_OFF).__next__


def span(name: str, *, device=None, request=None):
    """A context manager timing its block as span `name` while tracing is
    on (a shared no-op while it is off).  device: a tensor, whose CUDA
    stream gets the span's device markers (none for a CPU tensor);
    request: the request a span opened with no span open joins.  A live
    span is truthy, and its attrs, a dict, take the span's attributes
    inside the block (the call takes none, so that it allocates nothing
    while tracing is off)."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return Span(name, device, request)


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Record(typing.NamedTuple):
    """A closed span: id, parent (a span id, None at a request's top),
    request, root (it started the request), name, host start and end
    (perf_counter_ns), attrs, and device_ms (None until its device markers
    are resolved, or without them)."""

    id: int
    parent: int | None
    request: int
    root: bool
    name: str
    t0_ns: int
    t1_ns: int
    attrs: dict
    device_ms: float | None = None

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6


class Span:
    """An open span (span() returns it while tracing is on).  On exit it
    stores its Record's fields as one flat tuple of ints and strings, its
    attrs last as name, value, name, value ..., which the cyclic garbage
    collector stops tracking at its first collection (a tuple holding
    tuples may take two): a full store costs the rest of the program no
    collection time."""

    __slots__ = ("name", "id", "parent", "request", "root", "t0_ns",
                 "attrs", "_device", "_events", "_range")

    def __init__(self, name, device, request):
        self.name = name
        self.request = request
        self.attrs = {}
        self._device = device
        self._events = self._range = None
        self.root = False

    def __enter__(self):
        stack = _stack()
        self.id = next(_span_ids)
        if stack:
            top = stack[-1]
            self.parent, self.request = top.id, top.request
        else:
            self.parent = None
            if self.request is None:
                self.request, self.root = next(_request_ids), True
        if _autograd_profiler._is_profiler_enabled:
            self._range = _RecordFunction(self.name)
            self._range.__enter__()
        dev = self._device
        if dev is not None and dev.is_cuda:
            stream = torch.cuda.current_stream(dev.device)
            start = _event(stream.device_index)
            start.record(stream)
            self._events = (stream, start)
        stack.append(self)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._events is not None:
            stream, start = self._events
            end = _event(stream.device_index)
            end.record(stream)
            _pending.append((self.id, stream.device_index, start, end))
        self._device = self._events = None
        stack = _local.stack
        if stack and stack[-1] is self:
            stack.pop()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        _store.append((self.id, self.parent, self.request, self.root,
                       self.name, self.t0_ns, t1,
                       *(sum(self.attrs.items(), ()) if self.attrs else ())))
        if self.name in _READ_BACKS:
            _resolve()
        return False


#: spans that end after a read-back, which finishes every device marker
#: recorded before it on the stream
_READ_BACKS = ("tsm.readback", "tsm.ladder")


def _event(device_index: int):
    """A timing event for a marker on device `device_index`: a resolved
    one again, else a new one."""
    free = _free_events[device_index]
    return free.pop() if free else torch.cuda.Event(enable_timing=True)


def _resolve() -> None:
    """device_ms of the pending spans whose end marker has completed; their
    events go back to the free list."""
    for _ in range(len(_pending)):
        item = _pending.popleft()
        sid, index, start, end = item
        if end.query():
            _device_ms[sid] = start.elapsed_time(end)
            if len(_device_ms) > STORE_SPANS:
                del _device_ms[next(iter(_device_ms))]
            _free_events[index] += (start, end)
        else:
            _pending.append(item)


def _record(rec: tuple) -> Record:
    return Record(*rec[:7], dict(zip(rec[7::2], rec[8::2])),
                  _device_ms.get(rec[0]))


def clear() -> None:
    """Empty the store.  A request that has a span open meanwhile is not
    whole afterwards."""
    global _cleared_ns
    _store.clear()
    _pending.clear()
    _device_ms.clear()
    _cleared_ns = time.perf_counter_ns()


def requests(last: int) -> list:
    """The last `last` whole requests (fewer if the store holds fewer),
    oldest first; each a list of its closed spans in the order they
    opened (Records).  A request is whole when its root opened after the
    last clear() and, once the store is full, after the oldest span kept
    closed: every span of the request closed after its root opened, so
    none of them has left the store."""
    _resolve()
    floor = _cleared_ns
    if len(_store) == _store.maxlen:
        floor = max(floor, _store[0][6])
    by_req: dict = {}
    roots = []
    for rec in _store:
        by_req.setdefault(rec[2], []).append(rec)
        if rec[3] and rec[5] > floor:
            roots.append(rec[2])
    roots.sort()
    return [[_record(rec) for rec in sorted(by_req[r])]
            for r in roots[max(len(roots) - last, 0):]]


#: span attributes whose calls summary() counts by value: (attr, key)
_COUNTED_ATTRS = (("path", "paths"), ("bits", "bits"), ("pairs", "pairs"))


def summary() -> dict:
    """{span name: {calls, host_ms, self_ms, device_ms}} over the store:
    host ms summed, self ms the spans less their children's host ms,
    device ms summed over the spans that have it (None where none has);
    a name whose spans carry a `path`, a `bits` (tsm.route's stage width)
    or a `pairs` attribute (tsm.exact's kernel path) also gets `paths`,
    `bits` or `pairs`, the calls by its value."""
    _resolve()
    spans = [_record(rec) for rec in _store]
    child_ms = collections.Counter()
    for s in spans:
        if s.parent is not None:
            child_ms[s.parent] += s.host_ms
    out: dict = {}
    for s in spans:
        row = out.setdefault(s.name, {"calls": 0, "host_ms": 0.0,
                                      "self_ms": 0.0, "device_ms": None})
        row["calls"] += 1
        row["host_ms"] += s.host_ms
        row["self_ms"] += s.host_ms - child_ms[s.id]
        if s.device_ms is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + s.device_ms
        for attr, key in _COUNTED_ATTRS:
            if attr in s.attrs:
                calls = row.setdefault(key, {})
                calls[s.attrs[attr]] = calls.get(s.attrs[attr], 0) + 1
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block (CPU, and CUDA where there is a
    card), written as a Chrome / Perfetto trace into `logdir`; yields the
    profiler (key_averages() for sums by kernel).  The port's spans are
    recorded inside it, and are ranges of the trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
