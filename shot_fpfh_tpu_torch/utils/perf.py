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

Inside a stage, :func:`span` marks a step of the host's work and
:func:`blocking` a statement that waits for the card (a read of a device
value to the host, a host-to-device copy from pageable memory, an
operation whose output size the host must learn).  Both are ranges of the
profiler's trace while a profiler records, and nothing but two clock reads
otherwise; the stage that is open counts them into its record (``spans``:
``{name: {count, host_s}}``; ``host_syncs`` and ``host_sync_s`` for the
blocking ones, its own two synchronizes included as site ``stage``).
:func:`add_counts` adds numbers the host already holds to the open stage's
counters.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from contextvars import ContextVar
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


class _StageCounts:
    """What the spans and blocking reads of one open stage add up to."""

    __slots__ = ("host_syncs", "host_sync_s", "spans", "counters")

    def __init__(self) -> None:
        self.host_syncs = 0
        self.host_sync_s = 0.0
        self.spans: dict[str, dict[str, float]] = {}
        self.counters: dict[str, int] = {}

    def add(self, name: str, seconds: float) -> None:
        entry = self.spans.get(name)
        if entry is None:
            self.spans[name] = {"count": 1, "host_s": seconds}
        else:
            entry["count"] += 1
            entry["host_s"] += seconds


# the counts of the StageMetrics stage open in this context, if one is
_OPEN_STAGE: ContextVar[_StageCounts | None] = ContextVar("open_stage", default=None)


class _Span:
    """The context manager :func:`span` and :func:`blocking` return."""

    __slots__ = ("name", "waits", "_range", "_t0")

    def __init__(self, name: str, waits: int = 0) -> None:
        self.name = name
        self.waits = waits
        self._range = None

    def __enter__(self) -> "_Span":
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        seconds = perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        counts = _OPEN_STAGE.get()
        if counts is not None:
            counts.add(self.name, seconds)
            if self.waits:
                counts.host_syncs += self.waits
                counts.host_sync_s += seconds


def span(name: str) -> _Span:
    """Context manager marking the interval ``name``: a
    ``torch.profiler.record_function`` range while a profiler records (on
    the device trace's clock), no dispatcher call otherwise.  It never
    synchronizes.  The open ``StageMetrics`` stage counts it and its host
    seconds under ``spans``."""
    return _Span(name)


def blocking(site: str, waits: int = 1) -> _Span:
    """:func:`span` ``sync[site]`` around one statement that waits for the
    card ``waits`` times (``torch.linalg.svd`` reads its status back twice);
    the open stage also adds ``waits`` to ``host_syncs`` and the host
    seconds to ``host_sync_s``."""
    return _Span(f"sync[{site}]", waits)


def add_counts(**counters: int) -> None:
    """Add host-known numbers (never a device value: reading one would
    wait for the card) to the open ``StageMetrics`` stage, which records
    their sums as counters; nothing while no stage is open."""
    counts = _OPEN_STAGE.get()
    if counts is not None:
        for key, value in counters.items():
            counts.counters[key] = counts.counters.get(key, 0) + value


_NOTHING = contextlib.nullcontext()


def uploading(x, device) -> _Span | contextlib.nullcontext:
    """``blocking("upload")`` when moving ``x`` to ``device`` copies it from
    the host to a CUDA device: PyTorch waits for the device's queue before
    such a copy from pageable memory.  A no-op context otherwise (``device``
    None, not CUDA, or ``x`` a tensor already on a card)."""
    if (device is None or torch.device(device).type != "cuda"
            or (isinstance(x, torch.Tensor) and x.is_cuda)):
        return _NOTHING
    return blocking("upload")


class StageMetrics:
    """Per-stage wall-clock + throughput counters, dumpable as JSON.  A
    stage's record also holds what its spans and blocking reads add up to
    (``host_syncs``, ``host_sync_s``, ``spans``; no rates of them), and
    the counters :func:`add_counts` added while it was open."""

    def __init__(self) -> None:
        self.stages: list[dict[str, Any]] = []
        self._start: float | None = None
        self._name: str | None = None
        self._annotation = None
        self._counts: _StageCounts | None = None
        self._outer: _StageCounts | None = None

    def start(self, name: str) -> None:
        self._counts = _StageCounts()
        self._outer = _OPEN_STAGE.get()
        _OPEN_STAGE.set(self._counts)
        with blocking("stage"):
            sync()
        self._name = name
        self._annotation = trace_annotation(name)
        self._annotation.__enter__()
        self._start = perf_counter()

    def stop(self, **counters: float) -> dict[str, Any]:
        with blocking("stage"):
            sync()
        elapsed = perf_counter() - self._start
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
            self._annotation = None
        _OPEN_STAGE.set(self._outer)
        counts = self._counts
        record: dict[str, Any] = {"stage": self._name, "seconds": elapsed}
        for key, value in {**counts.counters, **counters}.items():
            record[key] = value
            if value:
                record[f"{key}_per_sec"] = value / elapsed if elapsed > 0 else float("inf")
        record.update(host_syncs=counts.host_syncs, host_sync_s=counts.host_sync_s,
                      spans=counts.spans)
        self.stages.append(record)
        logger.info("%s", json.dumps(record))
        return record

    def summary(self) -> dict[str, Any]:
        return {
            "total_seconds": sum(s["seconds"] for s in self.stages),
            "stages": self.stages,
        }
