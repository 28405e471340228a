"""One reader a per-layer metric, ``<name>.py`` with ``read(run)``: the
metric's value from a ``harness.RunData``, or None when the run holds
nothing to read (the metric is then left out of the line)."""

from __future__ import annotations


def stage_ms(run, stage: str) -> float | None:
    """The mean milliseconds of a pipeline stage (``StageMetrics``) over
    every pair of the window."""
    times = [p.stages[stage] for p in run.pairs if stage in p.stages]
    return 1e3 * sum(times) / len(times) if times else None
