"""The arithmetic of the metrics: a rate over the whole window, a tail over
every pair, a roofline counted from shapes, and the trace's reduction."""

from __future__ import annotations

import numpy as np
import pytest

from regbench import harness, roofline
from regbench.metrics import (
    descriptors_ms,
    device_idle_pct,
    icp_iters,
    launches_per_pair,
    match_roofline_pct,
    normals_ms,
)
from regbench.trace import Trace


def _pair(pair_s, **stages):
    return harness.PairRecord(pair_s=pair_s, normals_s=0.01, stages=stages, icp_iters=50,
                              accepted=True, shapes={"scan_nz": 1000, "ref_nz": 2000,
                                                     "dim": 352})


def test_rate_is_taken_over_the_whole_window_and_the_tail_over_every_pair():
    times = [0.1] * 9 + [1.0, 0.5, 0.2, 0.3]
    out = harness.end_to_end(times, window_s=4.0, setup_s=9.5)
    assert out["pairs_per_s"] == pytest.approx(13 / 4.0)       # not a mean of 1/t
    assert out["pair_p90_s"] == pytest.approx(np.percentile(times, 90))
    chunk_median = np.median([np.percentile(times[i:i + 4], 90) for i in range(0, 13, 4)])
    assert out["pair_p90_s"] != pytest.approx(chunk_median)
    assert out["setup_s"] == 9.5


def test_match_roofline_is_counted_from_shapes():
    ns, nr, d = 78_000, 77_500, 352
    ops = 2.0 * ns * nr * d
    n_bytes = (ns + nr) * d * 4 + ns * 16
    want = max(ops / 989e12, n_bytes / 3.35e12)
    assert roofline.match_least_seconds(ns, nr, d) == pytest.approx(want)
    # a thin product is bound by its bytes
    assert roofline.match_least_seconds(10, 10, 352) == pytest.approx(
        (20 * 352 * 4 + 160) / 3.35e12)


def _events():
    """A 10 ms window (µs): two kernels inside a matching range, one copy
    in the ICP range, host ops around them."""
    x = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name, "ts": ts,  # noqa: E731
                                    "dur": dur}
    return [
        x("user_annotation", "regbench.traced", 0, 10_000),
        x("user_annotation", "matching[simple]", 1_000, 3_000),
        x("cpu_op", "aten::mm", 1_100, 400),
        x("kernel", "top2_wgmma_kernel", 1_500, 1_000),
        x("kernel", "merge", 2_400, 400),        # overlaps the first: counted once
        x("user_annotation", "icp[point_to_plane]", 5_000, 4_000),
        x("cpu_op", "aten::mul", 5_000, 4_000),
        x("gpu_memcpy", "Memcpy HtoD", 6_000, 500),
        x("kernel", "after_window", 12_000, 100),
    ]


def test_trace_reduction():
    trace = Trace.from_events(_events(), 0, 10_000)
    assert trace.window_s == pytest.approx(0.01)
    assert trace.busy_s == pytest.approx(0.0018)       # 1.3 ms of kernels + 0.5 ms copy
    assert trace.kernel_count == 2
    assert trace.busy_in(1_000, 4_000) == pytest.approx(0.0013)
    gaps = dict(trace.idle_gaps())
    assert gaps == {"regbench.traced/host": pytest.approx(0.0047),
                    "icp[point_to_plane]/aten::mul": pytest.approx(0.0035)}
    assert sum(gaps.values()) == pytest.approx(0.01 - 0.0018)
    assert trace.top_device_ops()[0] == ["top2_wgmma_kernel", pytest.approx(0.001)]


def test_trace_readers():
    trace = Trace.from_events(_events(), 0, 10_000)
    run = harness.RunData(pairs=[_pair(0.5, descriptors=0.2), _pair(0.7, descriptors=0.4)],
                          config={}, traffic={}, trace=trace, traced=[_pair(0.5)])
    assert device_idle_pct.read(run) == pytest.approx(82.0)
    assert launches_per_pair.read(run) == 2
    least = roofline.match_least_seconds(1000, 2000, 352)
    assert match_roofline_pct.read(run) == pytest.approx(100 * least / 0.0013)
    assert descriptors_ms.read(run) == pytest.approx(300.0)
    assert normals_ms.read(run) == pytest.approx(10.0)
    assert icp_iters.read(run) == 50


def test_roofline_reads_nothing_without_one_matching_range_a_pair():
    trace = Trace.from_events(_events(), 0, 10_000)
    run = harness.RunData(pairs=[], config={}, traffic={}, trace=trace,
                          traced=[_pair(0.5), _pair(0.5)])
    assert match_roofline_pct.read(run) is None
