"""The port's spans of a traced session (tpu_smatcher_torch.utils.
profiling), for the per-layer readers that read them.

Tracing is on while a torch.profiler session records, and rank.run calls
the readers right after the last session, so the tracer's last tr.counts
requests are that session's counts.  A port without the tracer has no
spans, and its readers read nothing."""


def last_requests(tr):
    """The tracer's last tr.counts requests (each a list of its spans), or
    None: no counts, no tracer, or fewer whole requests than counts."""
    from tpu_smatcher_torch.utils import profiling
    requests = getattr(profiling, "requests", None)
    if requests is None or not tr.counts:
        return None
    reqs = requests(last=tr.counts)
    if len(reqs) < tr.counts:
        return None
    return reqs


def device_ms(tr, name):
    """Mean device ms a count between the device markers of the spans
    named `name`, summed over each request; None where a request has no
    such span or one lacks its device interval (a CPU run)."""
    reqs = last_requests(tr)
    if reqs is None:
        return None
    total = 0.0
    for spans in reqs:
        ms = [s.device_ms for s in spans if s.name == name]
        if not ms or any(v is None for v in ms):
            return None
        total += sum(ms)
    return total / len(reqs)
