from .debug_nans import NanCheck
from .perf import (
    Checkpoint,
    StageMetrics,
    block,
    checkpoint,
    runtime_alert,
    start_profiler_trace,
    stop_profiler_trace,
    timeit,
    trace_annotation,
)

__all__ = [
    "NanCheck",
    "Checkpoint",
    "StageMetrics",
    "block",
    "checkpoint",
    "runtime_alert",
    "start_profiler_trace",
    "stop_profiler_trace",
    "timeit",
    "trace_annotation",
]
