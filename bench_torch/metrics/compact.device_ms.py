"""compact.device_ms: device ms a count between the device markers (CUDA
events) of the port's tsm.compact spans: the compaction of the filter's
candidates (ops/fast.compact_valrows on the cascade route), summed over a
count and averaged over the traced session's counts."""

from bench_torch.spans import device_ms


def read(tr):
    return device_ms(tr, "tsm.compact")
