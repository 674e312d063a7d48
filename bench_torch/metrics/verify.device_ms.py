"""verify.device_ms: device ms a count between the device markers (CUDA
events) of the port's tsm.verify spans: the text's word view
(cuda_filter.words_view) and the exact verify of the compacted candidates
(ops/fast.verify_count), summed over a count and averaged over the traced
session's counts."""

from bench_torch.spans import device_ms


def read(tr):
    return device_ms(tr, "tsm.verify")
