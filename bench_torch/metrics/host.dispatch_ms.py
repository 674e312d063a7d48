"""host.dispatch_ms: the port's own host work a count, without its wait
for the device: the mean over the traced session's counts of the
tsm.count span's host ms less its tsm.readback children's (the port's
spans, tpu_smatcher_torch.utils.profiling, recorded while the profiler
runs).  None where the port has no spans, or the tracer holds fewer whole
requests than the session's counts, or one lacks the spans."""

from bench_torch.spans import last_requests


def read(tr):
    reqs = last_requests(tr)
    if reqs is None:
        return None
    total = 0.0
    for spans in reqs:
        roots = [s for s in spans if s.name == "tsm.count" and s.root]
        if len(roots) != 1:
            return None
        root = roots[0]
        total += root.host_ms - sum(s.host_ms for s in spans
                                    if s.name == "tsm.readback"
                                    and s.parent == root.id)
    return total / len(reqs)
