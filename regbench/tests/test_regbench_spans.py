"""The arithmetic of the readers of the program's spans: the normals stage,
the blocking reads a pair and the card's idle time after them, on
hand-built trace events."""

from __future__ import annotations

import pytest

from regbench import harness
from regbench.metrics import host_syncs_per_pair, normals_stage_ms, sync_idle_ms
from regbench.trace import Trace


def _pair():
    return harness.PairRecord(pair_s=0.5, normals_s=0.01, stages={}, icp_iters=50,
                              accepted=True)


def x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _events():
    """A 10 ms window (µs) of two pairs: each with two normals stages, and
    blocking reads around device work."""
    return [
        x("user_annotation", "regbench.traced", 0, 10_000),
        x("user_annotation", "normals", 0, 2_000),
        x("user_annotation", "normals[knn]", 100, 800),
        x("user_annotation", "normals[knn]", 1_000, 700),
        x("user_annotation", "normals", 5_000, 2_000),
        x("user_annotation", "normals[knn]", 5_100, 600),
        x("user_annotation", "normals[knn]", 5_800, 900),
        x("user_annotation", "normals.grid", 150, 100),        # a child: not a stage
        x("kernel", "k3", 200, 300),                           # busy 200..500
        x("user_annotation", "sync[normals.kth]", 300, 250),   # ends at 550: idle to 900
        x("kernel", "k3", 900, 100),                           # busy 900..1000
        x("user_annotation", "sync[grid.dims]", 600, 100),     # ends at 700: same gap
        x("user_annotation", "sync[stage]", 850, 100),         # ends at 950: busy
        x("gpu_memcpy", "Memcpy DtoH", 1_900, 200),            # busy 1900..2100
        x("user_annotation", "sync[icp.done]", 1_800, 300),    # ends at 2100: the end
        x("kernel", "icp", 2_500, 500),                        # idle 2100..2500
        x("user_annotation", "sync[icp.result]", 9_500, 100),  # ends at 9600: to 10000
        x("user_annotation", "sync[late]", 12_000, 10),        # outside the window
    ]


def _run(events=None, traced=2):
    trace = Trace.from_events(events if events is not None else _events(), 0, 10_000)
    return harness.RunData(pairs=[_pair()], config={}, traffic={}, trace=trace,
                           traced=[_pair() for _ in range(traced)])


def test_normals_stage_sums_its_ranges_over_the_pairs():
    assert normals_stage_ms.read(_run()) == pytest.approx((800 + 700 + 600 + 900) / 1e3 / 2)


def test_normals_stage_needs_two_ranges_a_pair():
    assert normals_stage_ms.read(_run(traced=3)) is None
    no_stage = [e for e in _events() if not e["name"].startswith("normals[")]
    assert normals_stage_ms.read(_run(no_stage)) is None


def test_host_syncs_count_the_ranges_that_start_in_the_window():
    assert host_syncs_per_pair.read(_run()) == 5 / 2


def test_sync_idle_runs_from_each_read_to_the_next_device_work():
    # 550..900 (the read ending at 700 falls in the same gap), none after 950
    # (busy), 2100..2500 (a read ending as a copy ends), 9600..10000
    want = (350 + 400 + 400) / 1e3 / 2
    assert sync_idle_ms.read(_run()) == pytest.approx(want)


def test_a_read_that_ends_while_the_card_works_costs_nothing():
    events = [x("user_annotation", "regbench.traced", 0, 1_000),
              x("kernel", "k", 0, 1_000),
              x("user_annotation", "sync[a]", 100, 100),
              x("user_annotation", "sync[b]", 500, 200)]
    run = harness.RunData(pairs=[], config={}, traffic={},
                          trace=Trace.from_events(events, 0, 1_000), traced=[_pair()])
    assert sync_idle_ms.read(run) == 0.0
    assert host_syncs_per_pair.read(run) == 2


def test_a_program_without_spans_reads_nothing():
    bare = [e for e in _events() if not e["name"].startswith(("sync[", "normals["))]
    run = _run(bare)
    assert host_syncs_per_pair.read(run) is None
    assert sync_idle_ms.read(run) is None
    assert normals_stage_ms.read(run) is None
    empty = harness.RunData(pairs=[], config={}, traffic={})
    for reader in (host_syncs_per_pair, sync_idle_ms, normals_stage_ms):
        assert reader.read(empty) is None
