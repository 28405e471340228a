"""Stage timers and structured stage metrics — port of
``shot_fpfh_tpu.utils.perf``.

PyTorch returns before the card finishes, so every timer here synchronizes
CUDA (when it is in use) before it reads the clock: a stage's seconds
include the device work it queued.  ``StageMetrics`` emits the same JSON
records as the reference (``stage``, ``seconds``, counters and their
``*_per_sec`` rates).
"""

from __future__ import annotations

import json
import logging
from time import perf_counter
from typing import Any, Callable

import torch

logger = logging.getLogger(__name__)


def sync() -> None:
    """Wait for queued CUDA work (no-op without an initialized card)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


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


class StageMetrics:
    """Per-stage wall-clock + throughput counters, dumpable as JSON."""

    def __init__(self) -> None:
        self.stages: list[dict[str, Any]] = []
        self._start: float | None = None
        self._name: str | None = None

    def start(self, name: str) -> None:
        sync()
        self._name = name
        self._start = perf_counter()

    def stop(self, **counters: float) -> dict[str, Any]:
        sync()
        elapsed = perf_counter() - self._start
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
