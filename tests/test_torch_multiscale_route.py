"""SHOT's route rule and multiscale SHOT's spans and counters: on the card
every support takes the grid (SG, exact and uncapped) at any size, and CPU
tensors keep the ``AUTO_GRID_MIN_POINTS`` switch; each scale of a
multiscale stage is one ``shot.scale`` range around its support, grid and
pass, and the stage counts its ``scales`` and their ``support_points``, as
``--metrics_json`` writes them; the benchmark's ``shot_later_scales_ms``
reads the card's work of the later scales on a hand-built trace.

CPU only: the card is stood in for where the rule reads it."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_spans import _terrain  # noqa: E402

from regbench import harness  # noqa: E402
from regbench.metrics import shot_later_scales_ms  # noqa: E402
from regbench.trace import Trace  # noqa: E402
from shot_fpfh_tpu_torch.core.subsampling import grid_subsample  # noqa: E402
from shot_fpfh_tpu_torch.models import shot as t_shot  # noqa: E402
from shot_fpfh_tpu_torch.ops import grid_hash  # noqa: E402

torch.set_num_threads(1)


def _support(n, on_card):
    return SimpleNamespace(is_cuda=on_card, shape=(n, 3))


@pytest.mark.parametrize("n, on_card, threshold, grid", [
    (3_631, True, 20_000, True),       # multiscale's second scale at 10^6 points
    (1, True, 20_000, True),
    (32_440, True, 20_000, True),
    (3_631, False, 20_000, False),     # CPU tensors: the reference's switch
    (20_000, False, 20_000, True),
    (19_999, False, 20_000, False),
    (3_631, False, 2_000, True),       # read at call time
])
def test_route_rule(monkeypatch, n, on_card, threshold, grid):
    monkeypatch.setattr(grid_hash, "AUTO_GRID_MIN_POINTS", threshold)
    assert t_shot.takes_grid(_support(n, on_card)) is grid


@pytest.mark.parametrize("rule", [True, False])
def test_the_routed_shot_follows_the_rule(monkeypatch, rng, rule):
    """``_shot_routed`` builds the grid where the rule says so, and runs
    the capped brute search where it does not, whatever the size."""
    pts = torch.tensor(rng.uniform(-1, 1, (600, 3)), dtype=torch.float32)
    nrm = torch.nn.functional.normalize(torch.tensor(rng.normal(size=(600, 3)),
                                                     dtype=torch.float32), dim=1)
    seen, grids, searches = [], [], []
    build, search = t_shot.build_grid, t_shot.radius_search
    monkeypatch.setattr(t_shot, "takes_grid", lambda sup: seen.append(sup.shape[0]) or rule)
    monkeypatch.setattr(t_shot, "build_grid", lambda *a, **k: grids.append(1) or build(*a, **k))
    monkeypatch.setattr(t_shot, "radius_search",
                        lambda *a, **k: searches.append(1) or search(*a, **k))
    desc, frames = t_shot._shot_routed(pts[:40], pts, nrm, 0.5, k_max=64, normalize=True,
                                       min_neighborhood_size=5)
    assert seen == [600] and desc.shape == (40, 352) and frames.shape == (40, 3, 3)
    assert (len(grids), len(searches)) == ((1, 0) if rule else (0, 1))


@pytest.fixture(scope="module")
def traced_cli(tmp_path_factory):
    """Multiscale SHOT through the CLI on a 4,000-point pair under a
    profiler: ``(stage record as --metrics_json writes it, profiler
    ranges, support rows of both clouds at both scales)``."""
    from shot_fpfh_tpu_torch.cli import main
    from shot_fpfh_tpu_torch.io.ply import write_ply

    tmp = tmp_path_factory.mktemp("multiscale")
    scan, ref = _terrain(4000)
    for name, cloud in (("scan", scan), ("ref", ref)):
        write_ply(str(tmp / f"{name}.ply"), [cloud.astype(np.float32)], ["x", "y", "z"])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        main(["--device", "cpu", "--scan_file_path", str(tmp / "scan.ply"),
              "--ref_file_path", str(tmp / "ref.ply"), "--conf_file_path", "",
              "--neighborhood_size", "0.15", "--min_n_neighbors", "2",
              "--descriptor_choice", "shot_multiscale", "--radius", "0.3", "--phi", "3",
              "--n_scales", "2", "--rho", "10", "--min_neighborhood_size", "10",
              "--n_draws", "500", "--max_iter", "8", "--disable_ply_writing",
              "--metrics_json", str(tmp / "m.json")])
    stage = next(s for s in json.loads((tmp / "m.json").read_text())["stages"]
                 if s["stage"] == "descriptors[shot_multiscale]")
    ranges: dict[str, list] = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    rows = sum(len(grid_subsample(cloud.astype(np.float32), voxel, device="cpu"))
               for cloud in (scan, ref) for voxel in (0.03, 0.09))
    return stage, ranges, rows


def test_each_scale_is_a_range_in_the_stage(traced_cli):
    stage, ranges, _ = traced_cli
    assert stage["spans"]["shot.scale"]["count"] == 4
    (lo, hi), = ranges["descriptors[shot_multiscale]"]
    scales = sorted(ranges["shot.scale"])
    assert len(scales) == 4 and all(lo <= a and b <= hi for a, b in scales)
    # each scale's support (its voxel subsample) lies in it; the cloud's
    # copy, before the first scale, in none
    subsamples = [(c, d) for c, d in ranges["sync[voxel.indices]"] if lo <= c and d <= hi]
    assert len(subsamples) == 4
    assert all(any(a <= c and d <= b for a, b in scales) for c, d in subsamples)
    inside = [any(a <= c and d <= b for a, b in scales) for c, d in ranges["shot.support"]]
    assert sorted(inside) == [False, False, True, True, True, True]
    pads = sorted(ranges["shot.pad"])
    assert [sum(p[1] <= a for p in pads) for a, _ in scales] == [1, 1, 2, 2]


def test_the_stage_counts_scales_and_support_rows(traced_cli):
    stage, _, rows = traced_cli
    assert stage["scales"] == 4
    assert stage["support_points"] == rows
    assert stage["scales_per_sec"] == 4 / stage["seconds"]


def x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _stage(t0, cloud_starts):
    """A multiscale descriptor stage at ``t0`` (µs): per cloud a pad, a
    copy, then two scales, each with a blocking read; the later scale's
    work runs past its range, drained by the next read."""
    events = [x("user_annotation", "descriptors[shot_multiscale]", t0, 3_000)]
    for c in cloud_starts:
        events += [
            x("user_annotation", "shot.pad", t0 + c, 10),
            x("user_annotation", "sync[upload]", t0 + c + 20, 80),      # the cloud's copy
            x("gpu_memcpy", "Memcpy HtoD", t0 + c + 60, 40),
            x("user_annotation", "shot.scale", t0 + c + 100, 400),
            x("user_annotation", "sync[voxel.segments]", t0 + c + 110, 40),
            x("kernel", "shot_grid_kernel", t0 + c + 160, 300),          # scale 0's pass
            x("user_annotation", "shot.scale", t0 + c + 500, 300),
            x("kernel", "voxel_kernel", t0 + c + 510, 30),               # before its read
            x("user_annotation", "sync[voxel.segments]", t0 + c + 505, 55),  # ends at +560
            x("kernel", "grid_kernel", t0 + c + 600, 100),
            x("gpu_memset", "Memset", t0 + c + 720, 10),
            x("kernel", "shot_grid_kernel", t0 + c + 780, 200),         # runs to +980
            x("kernel", "cat_kernel", t0 + c + 990, 10),
        ]
    return events


def _trace_run(events, pairs=2, config=None):
    trace = Trace.from_events([x("user_annotation", "regbench.traced", 0, 20_000)] + events,
                              0, 20_000)
    pair = harness.PairRecord(pair_s=1.0, normals_s=0.1, stages={}, icp_iters=50, accepted=True)
    return harness.RunData(pairs=[pair], config=config or {}, traffic={}, trace=trace,
                           traced=[pair] * pairs)


def test_later_scales_read_from_the_first_read_to_the_next():
    """The scan's later scale ends at the ref's copy (the copy is left
    out), the ref's at the stage's closing read; work before the scale's
    first read is not its own."""
    events = []
    for t0 in (1_000, 10_000):
        events += _stage(t0, (0, 1_200))
        events.append(x("user_annotation", "sync[stage]", t0 + 2_900, 50))
    # per later scale: grid 100, fill 10, SG 200, cat 10 = 320 µs; 4 of them
    assert shot_later_scales_ms.read(_trace_run(events)) == pytest.approx(4 * 320 / 1e3 / 2)


def test_later_scales_need_a_second_scale_of_a_cloud():
    single = [e for e in _stage(1_000, (0, 1_200))
              if not (e["name"] == "shot.scale" and e["dur"] == 300)]
    assert shot_later_scales_ms.read(_trace_run(single)) is None
    bare = [e for e in _stage(1_000, (0,)) if e["name"] != "shot.scale"]
    assert shot_later_scales_ms.read(_trace_run(bare)) is None
    assert shot_later_scales_ms.read(harness.RunData(pairs=[], config={}, traffic={})) is None


@pytest.mark.parametrize("choice, n_scales, want", [
    ("shot_single_scale", 2, 0.0),     # shot1m.dense and shot1m.sparse
    ("shot_bi_scale", 2, 0.0),         # shot1m.biscale
    ("fpfh", 2, 0.0),                  # fpfh1m.dense
    ("shot_multiscale", 1, 0.0),
    ("shot_multiscale", 2, None),      # a program without the shot.scale ranges
])
def test_later_scales_read_zero_where_the_cell_runs_one_scale(choice, n_scales, want):
    """A cell whose descriptor runs one scale has no later scale: its
    descriptor stages read 0 ms of them; a multiscale cell whose stretch
    shows no second scale of a cloud reads nothing, and so does a stretch
    with no descriptor stage."""
    config = {"descriptor": {"descriptor_choice": choice, "n_scales": n_scales}}
    bare = [e for e in _stage(1_000, (0,)) if e["name"] != "shot.scale"]
    assert shot_later_scales_ms.read(_trace_run(bare, config=config)) == want
    assert shot_later_scales_ms.read(_trace_run([], config=config)) is None


def test_later_scales_are_read_in_every_cell():
    """The benchmark lists the metric in every cell: each cell's descriptor
    is one the reader reads 0 in, or multiscale SHOT with a later scale."""
    from regbench import cells

    bench = json.loads((Path(__file__).resolve().parents[1] / "BENCHMARK.json").read_text())
    entry = next(m for m in bench["per_layer"] if m["name"] == "shot_later_scales_ms")
    assert entry["workloads"] == [w["name"] for w in bench["workloads"]]
    for name in entry["workloads"]:
        desc = cells.load_cell(name).config["descriptor"]
        assert desc["descriptor_choice"] in ("shot_single_scale", "shot_bi_scale", "fpfh",
                                             "shot_multiscale")


@pytest.mark.parametrize("rule", [True, False])
def test_the_fused_shot_leg_takes_the_grid_by_the_rule(monkeypatch, rng, rule):
    """The single-program path gives its SHOT leg a grid where the staged
    path's rule says so, whatever the cloud's size, and none where not."""
    from shot_fpfh_tpu_torch.registration import fused

    pts = rng.uniform(-1, 1, (600, 3)).astype(np.float32)
    nrm = np.tile(np.float32([0.0, 0.0, 1.0]), (600, 1))
    seen, got = [], {}
    monkeypatch.setattr(fused, "takes_grid", lambda p: seen.append(p.shape[0]) or rule)
    monkeypatch.setattr(fused, "fused_registration",
                        lambda *a, **k: got.update(k) or SimpleNamespace(_replace=lambda **r: r))
    fused.register_pair(pts, nrm, pts, nrm, keypoint_voxel=0.2, icp_voxel=0.1, radius=0.5,
                        device="cpu")
    assert seen == [600, 600]
    assert ("scan_grid" in got, "ref_grid" in got) == (rule, rule)
