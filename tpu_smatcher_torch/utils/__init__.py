"""Tracing (the count path's spans, torch.profiler traces) and debug
printing of the port."""

from tpu_smatcher_torch.utils.debug import dprint
from tpu_smatcher_torch.utils.profiling import trace

__all__ = ["dprint", "trace"]
