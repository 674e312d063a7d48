"""epilogue.device_ms: device milliseconds per count of the events that
are neither the port's own kernels nor collectives: on the fingerprint
routes the torch compaction and verify around the filter kernel, and the
count's read-back."""

from bench_torch.trace import ours


def read(tr):
    if not tr.counts or not tr.calls.get("cascade"):
        return None
    s = tr.seconds(lambda name: not ours(name) and "nccl" not in name.lower())
    return s * 1e3 / tr.counts
