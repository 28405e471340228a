"""The descriptor stage's host-paced metrics on a synthetic trace: idle
time and kernel launches inside the ``descriptors[...]`` ranges only."""

from __future__ import annotations

import pytest

from regbench import harness
from regbench.metrics import descriptor_launches_per_pair, descriptors_idle_ms
from regbench.trace import Trace


def _run(events, n_pairs=2):
    trace = Trace.from_events(events, 0.0, 10_000.0)
    pair = harness.PairRecord(pair_s=1.0, normals_s=0.1, stages={}, icp_iters=50,
                              accepted=True)
    return harness.RunData(pairs=[pair] * n_pairs, config={}, traffic={}, trace=trace,
                           traced=[pair] * n_pairs)


def _events():
    """Two descriptor ranges (µs): kernels and a copy inside them, a
    kernel outside them."""
    x = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name, "ts": ts,  # noqa: E731
                                    "dur": dur}
    return [
        x("user_annotation", "regbench.traced", 0, 10_000),
        x("user_annotation", "descriptors[shot_bi_scale]", 1_000, 3_000),
        x("user_annotation", "shot.chunk", 1_200, 2_000),
        x("kernel", "fetch_windows_kernel", 1_500, 1_000),
        x("kernel", "shot_fused_kernel", 2_400, 400),     # overlaps: idle counted once
        x("gpu_memcpy", "Memcpy DtoH", 3_000, 200),       # busy, not a launch
        x("user_annotation", "descriptors[shot_bi_scale]", 6_000, 1_000),
        x("kernel", "shot_fused_kernel", 6_500, 100),
        x("user_annotation", "matching[simple]", 7_500, 2_000),
        x("kernel", "top2_wgmma_kernel", 8_000, 1_000),
    ]


def test_idle_inside_the_descriptor_ranges_a_pair():
    # range 1: 3,000 µs, busy 1,300 + 200; range 2: 1,000 µs, busy 100
    want_ms = ((3_000 - 1_500) + (1_000 - 100)) / 1e3 / 2
    assert descriptors_idle_ms.read(_run(_events())) == pytest.approx(want_ms)


def test_launches_inside_the_descriptor_ranges_a_pair():
    assert descriptor_launches_per_pair.read(_run(_events())) == 3 / 2


@pytest.mark.parametrize("reader", [descriptors_idle_ms, descriptor_launches_per_pair])
def test_nothing_to_read_without_a_descriptor_range(reader):
    events = [e for e in _events() if not e["name"].startswith("descriptors[")]
    assert reader.read(_run(events)) is None
    assert reader.read(harness.RunData(pairs=[], config={}, traffic={})) is None
