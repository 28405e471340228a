"""The reduction of a ``torch.profiler`` trace to what the per-layer
metrics read: device activity (kernels, copies, fills) as intervals, the
host's operations and named ranges, and the idle gaps between device work.

The profiler's chrome trace is written to a temporary file, read back and
deleted; times in it are microseconds on one clock for host and device.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from functools import cached_property

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Sorted, merged ``(start, end)`` intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(merged: list[tuple[float, float]], lo: float, hi: float) -> float:
    """Length of ``[lo, hi]`` that the merged intervals cover."""
    i = max(bisect.bisect_right(merged, (lo, float("inf"))) - 1, 0)
    total = 0.0
    while i < len(merged) and merged[i][0] < hi:
        s, e = merged[i]
        total += max(0.0, min(e, hi) - max(s, lo))
        i += 1
    return total


@dataclass
class Trace:
    """A traced window: device intervals and host events, in microseconds."""

    start: float
    end: float
    device: list[tuple[float, float, str, str]] = field(default_factory=list)
    host: list[tuple[float, float, str, str]] = field(default_factory=list)

    @classmethod
    def from_events(cls, events: list[dict], start: float, end: float) -> "Trace":
        trace = cls(start=start, end=end)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ts, dur, cat = float(e["ts"]), float(e["dur"]), e.get("cat")
            item = (ts, ts + dur, str(e.get("name", "")), cat)
            if cat in DEVICE_CATS:
                trace.device.append(item)
            elif cat in HOST_CATS:
                trace.host.append(item)
        trace.device.sort()
        trace.host.sort()
        return trace

    @classmethod
    def from_profile(cls, prof, start_name: str) -> "Trace":
        """From a stopped profiler whose window is the user range
        ``start_name``: the trace is written to a temporary file in
        ``TMPDIR``, read and deleted."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        window = [e for e in events if e.get("cat") == "user_annotation"
                  and e.get("name") == start_name and "dur" in e]
        if not window:
            raise RuntimeError(f"the trace holds no {start_name!r} range")
        start = float(window[0]["ts"])
        return cls.from_events(events, start, start + float(window[0]["dur"]))

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @cached_property
    def merged(self) -> list[tuple[float, float]]:
        """Device activity inside the window, merged."""
        return union([(max(s, self.start), min(e, self.end)) for s, e, _, _ in self.device
                      if e > self.start and s < self.end])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged) / 1e6

    @property
    def kernel_count(self) -> int:
        return sum(1 for s, e, _, cat in self.device
                   if cat == "kernel" and self.start <= s < self.end)

    def ranges(self, prefix: str) -> list[tuple[float, float]]:
        """Host ranges (``record_function``) whose name starts with ``prefix``."""
        return [(s, e) for s, e, name, cat in self.host
                if cat == "user_annotation" and name.startswith(prefix)]

    def busy_in(self, lo: float, hi: float) -> float:
        """Seconds of device activity inside ``[lo, hi]`` (microseconds)."""
        return covered(self.merged, lo, hi) / 1e6

    def top_device_ops(self, n: int = 10) -> list[list]:
        """The ``n`` device operations that took most time, summed by name."""
        total: dict[str, float] = defaultdict(float)
        for s, e, name, _ in self.device:
            if self.start <= s < self.end:
                total[name[:96]] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The ``n`` names under which the device sat idle longest: each gap
        between device activity is charged to the host range (stage) and
        the innermost host operation open at its middle."""
        merged = self.merged
        edges = [self.start] + [x for s, e in merged for x in (s, e)] + [self.end]
        starts = [h[0] for h in self.host]
        ranges = [h for h in self.host if h[3] == "user_annotation"]
        range_starts = [h[0] for h in ranges]
        total: dict[str, float] = defaultdict(float)
        for i in range(0, len(edges) - 1, 2):
            lo, hi = edges[i], edges[i + 1]
            if hi <= lo:
                continue
            mid = (lo + hi) / 2
            total[f"{_innermost(ranges, range_starts, mid)}/"
                  f"{_innermost(self.host, starts, mid, cat='cpu_op')}"] += (hi - lo) / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def _innermost(events, starts, t: float, cat: str | None = None, lookback: int = 4096) -> str:
    """Name of the latest-starting event open at ``t`` (host events nest,
    so that is the innermost), or ``host`` when none is."""
    i = bisect.bisect_right(starts, t) - 1
    stop = max(i - lookback, -1)
    while i > stop:
        s, e, name, c = events[i]
        if e >= t and (cat is None or c == cat):
            return name[:48]
        i -= 1
    return "host"
