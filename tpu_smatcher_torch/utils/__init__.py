"""Timing, tracing and metrics records of the port (utils/debug.py's
dprint is not ported yet)."""

from tpu_smatcher_torch.utils.profiling import (PhaseTimer, emit_jsonl,
                                                time_fn, trace)

__all__ = ["PhaseTimer", "emit_jsonl", "time_fn", "trace"]
