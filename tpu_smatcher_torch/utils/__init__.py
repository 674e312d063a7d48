"""Timing, tracing, metrics records and debug printing of the port."""

from tpu_smatcher_torch.utils.debug import dprint
from tpu_smatcher_torch.utils.profiling import (PhaseTimer, emit_jsonl,
                                                time_fn, trace)

__all__ = ["PhaseTimer", "dprint", "emit_jsonl", "time_fn", "trace"]
