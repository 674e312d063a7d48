"""host.launches_per_count: the device's kernel, copy and set events per
count in the traced window (torch.profiler), with the port's own kernels'
events held against its launch counters."""


def read(tr):
    if not tr.counts or not tr.device or not tr.complete():
        return None
    return len(tr.device) / tr.counts
