"""Stage timers, structured stage metrics and profiler helpers — port of
``shot_fpfh_tpu.utils.perf``.

PyTorch returns before the card finishes, so every timer here synchronizes
CUDA (when it is in use) before it reads the clock: a stage's seconds
include the device work it queued.  ``StageMetrics`` emits the same JSON
records as the reference (``stage``, ``seconds``, counters and their
``*_per_sec`` rates) and marks each stage in profiler traces.
``start_profiler_trace``/``stop_profiler_trace`` record a
``torch.profiler`` trace of everything between them into a chrome trace
file.
"""

from __future__ import annotations

import json
import logging
import os
import time
from functools import wraps
from time import perf_counter
from typing import Any, Callable

import torch

logger = logging.getLogger(__name__)


def sync() -> None:
    """Wait for queued CUDA work (no-op without an initialized card)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def block(x):
    """Wait for the queued work of every CUDA device a tensor of the nested
    tuple / list / dict ``x`` lives on; returns ``x``."""
    devices = set()

    def visit(item):
        if isinstance(item, torch.Tensor):
            if item.is_cuda:
                devices.add(item.device)
        elif isinstance(item, (tuple, list)):
            for sub in item:
                visit(sub)
        elif isinstance(item, dict):
            for sub in item.values():
                visit(sub)

    visit(x)
    for device in devices:
        torch.cuda.synchronize(device)
    return x


def timeit(func: Callable) -> Callable:
    """Log the wall-clock seconds of each call, its device work included."""

    @wraps(func)
    def wrapper(*args, **kwargs):
        start = perf_counter()
        result = block(func(*args, **kwargs))
        logger.info("Function %s took %.2f seconds", func.__name__, perf_counter() - start)
        return result

    return wrapper


def runtime_alert(time_limit: float) -> Callable[[Callable], Callable]:
    """Warn when a call takes more than ``time_limit`` seconds."""

    def deco(func: Callable) -> Callable:
        @wraps(func)
        def wrapper(*args, **kwargs):
            start = perf_counter()
            result = block(func(*args, **kwargs))
            elapsed = perf_counter() - start
            if elapsed > time_limit:
                logger.warning("Function %s took more than %.2f seconds (%.2f seconds)",
                               func.__name__, time_limit, elapsed)
            return result

        return wrapper

    return deco


def checkpoint(time_ref: float | None = None) -> Callable[..., None]:
    """Closure logging the time elapsed since its previous call."""
    sync()
    ref = perf_counter() if time_ref is None else time_ref

    def _closure(message: str = "") -> None:
        nonlocal ref
        sync()
        now = perf_counter()
        if message:
            logger.info("%s: %.2f seconds", message, now - ref)
        ref = now

    return _closure


class Checkpoint:
    """Class form of :func:`checkpoint` (logs the raw seconds)."""

    def __init__(self, time_reference: float | None = None) -> None:
        sync()
        self._ref = perf_counter() if time_reference is None else time_reference

    def __call__(self, message: str = "") -> None:
        sync()
        now = perf_counter()
        if message:
            logger.info("%s: %s", message, now - self._ref)
        self._ref = now


def trace_annotation(name: str) -> torch.profiler.record_function:
    """Context manager naming the enclosed span ``name`` in profiler traces
    (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


_trace: list[tuple[torch.profiler.profile, str]] = []


def start_profiler_trace(log_dir: str) -> None:
    """Start recording the host and (when present) CUDA activity."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _trace.append((prof, log_dir))


def stop_profiler_trace() -> str:
    """Stop the recording :func:`start_profiler_trace` began and write it as
    a chrome trace into its ``log_dir``; returns the file's path."""
    prof, log_dir = _trace.pop()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


class StageMetrics:
    """Per-stage wall-clock + throughput counters, dumpable as JSON."""

    def __init__(self) -> None:
        self.stages: list[dict[str, Any]] = []
        self._start: float | None = None
        self._name: str | None = None
        self._annotation = None

    def start(self, name: str) -> None:
        sync()
        self._name = name
        self._annotation = trace_annotation(name)
        self._annotation.__enter__()
        self._start = perf_counter()

    def stop(self, **counters: float) -> dict[str, Any]:
        sync()
        elapsed = perf_counter() - self._start
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
            self._annotation = None
        record: dict[str, Any] = {"stage": self._name, "seconds": elapsed}
        for key, value in counters.items():
            record[key] = value
            if value:
                record[f"{key}_per_sec"] = value / elapsed if elapsed > 0 else float("inf")
        self.stages.append(record)
        logger.info("%s", json.dumps(record))
        return record

    def summary(self) -> dict[str, Any]:
        return {
            "total_seconds": sum(s["seconds"] for s in self.stages),
            "stages": self.stages,
        }
