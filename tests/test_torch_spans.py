"""The port's spans (``utils.perf``): ``span`` and ``blocking`` cost no
dispatcher call and no synchronize while no profiler records; under
``torch.profiler`` every stage and child range appears, nested in its
stage; a stage's record counts its children and blocking reads without
changing its seconds; and the CLI's ``--metrics_json`` holds the normals
stage.  A terrain pair small enough for the CPU, with
``AUTO_GRID_MIN_POINTS`` lowered so every grid route runs."""

import json
import logging
import math

import numpy as np
import pytest
import torch

from shot_fpfh_tpu_torch import pipeline as t_pipeline
from shot_fpfh_tpu_torch.models import normals as t_normals
from shot_fpfh_tpu_torch.ops import grid_hash
from shot_fpfh_tpu_torch.registration import icp as t_icp
from shot_fpfh_tpu_torch.utils import perf

torch.set_num_threads(1)

N_DRAWS = 1000
MAX_ITER = 20
# the bi-scale descriptor stage's blocking reads on the 4,000-point pair:
# its two synchronizes and, a cloud, three of the voxel subsample and four
# of the grid; the chunk loop and its counters add none
BI_SCALE_HOST_SYNCS = 2 + 2 * (3 + 4)
# each stage's child ranges (``sync[...]`` ones: a site of a blocking read)
CHILDREN = {
    "normals[knn]": ("normals.grid", "normals.pass", "normals.net", "sync[normals.kth]",
                     "sync[normals.misses]", "sync[grid.dims]"),
    "keypoints[subsampling_with_density]": ("sync[voxel.segments]", "sync[keypoints.kept]",
                                            "sync[keypoints.indices]"),
    "descriptors[shot_single_scale]": ("shot.support", "shot.pad", "shot.grid",
                                       "shot.chunk", "sync[voxel.indices]"),
    "descriptors[fpfh]": ("spfh.grid", "spfh.pass", "fpfh.aggregate"),
    "matching[simple]": ("match.rows", "match.top2", "sync[match.nonzero]",
                         "sync[match.read]"),
    "ransac": ("ransac.draws", "ransac.search", "sync[kabsch.svd]", "sync[ransac.best]",
               "sync[ransac.ratio]"),
    "icp[point_to_plane]": ("icp.subsample", "icp.grid", "icp.block", "sync[icp.done]",
                            "sync[icp.result]"),
}


def _terrain(n=6000, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-3, 3, (n, 2))
    z = (0.8 * np.sin(0.9 * xy[:, 0]) * np.cos(0.7 * xy[:, 1])
         + 0.4 * np.sin(2.1 * xy[:, 0] + 1) * np.cos(1.7 * xy[:, 1] + 0.5))
    ref = np.column_stack([xy, z]) + rng.normal(scale=0.005, size=(n, 3))
    a = 0.3
    rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    return (ref - [0.2, 0.1, 0.0]) @ rot, ref


def _register(scan, ref, descriptor, metrics):
    """The staged path on the CPU, every stage recorded into ``metrics``."""
    sn = t_normals.compute_normals(scan, scan, k=30, device="cpu", metrics=metrics).numpy()
    rn = t_normals.compute_normals(ref, ref, k=30, device="cpu", metrics=metrics).numpy()
    p = t_pipeline.RegistrationPipeline(scan=scan, scan_normals=sn, ref=ref, ref_normals=rn,
                                        device="cpu", metrics=metrics)
    p.select_keypoints("subsampling_with_density", neighborhood_size=0.15, min_n_neighbors=5)
    p.compute_descriptors(radius=0.9, descriptor_choice=descriptor, rho=10.0,
                          min_neighborhood_size=10)
    p.find_descriptors_matches("simple")
    tf, _ = p.run_ransac(n_draws=N_DRAWS, draw_size=4, max_inliers_distance=0.2)
    tf, _, _ = p.run_icp("point_to_plane", tf, d_max=0.5, voxel_size=0.2, max_iter=MAX_ITER,
                         rms_threshold=1e-12)
    return p.compute_metrics_post_icp(tf, 0.1)


@pytest.fixture(scope="module", params=["shot_single_scale", "fpfh"])
def traced(request):
    """One pair through the grid routes under ``torch.profiler``:
    ``(descriptor, stage records, profiler events)``."""
    scan, ref = _terrain()
    metrics = perf.StageMetrics()
    with pytest.MonkeyPatch.context() as mp:
        for mod in (grid_hash, t_normals, t_icp, t_pipeline):
            mp.setattr(mod, "AUTO_GRID_MIN_POINTS", 2000)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _register(scan, ref, request.param, metrics)
    return request.param, metrics.stages, list(prof.events())


def test_spans_make_no_dispatcher_call_and_no_synchronize_without_a_profiler(monkeypatch):
    entered, synced = [], []
    enter = torch.ops.profiler._record_function_enter_new
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        lambda *a: (entered.append(a[0]), enter(*a))[1])
    monkeypatch.setattr(perf, "sync", lambda: synced.append(1))
    with perf.span("a"), perf.blocking("b"), perf.uploading(np.zeros(3), "cpu"):
        pass
    assert entered == [] and synced == []
    # a whole pair: the stages' own annotations and synchronizes, nothing more
    scan, ref = _terrain(3000)
    metrics = perf.StageMetrics()
    _register(scan, ref, "shot_single_scale", metrics)
    stages = [s["stage"] for s in metrics.stages]
    assert entered == stages
    assert len(synced) == 2 * len(stages)
    assert all(s["spans"]["sync[stage]"]["count"] == 2 for s in metrics.stages)


def test_every_stage_and_child_range_nests_in_its_stage(traced):
    descriptor, _, events = traced
    ranges: dict[str, list] = {}
    for e in events:
        ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    other = "descriptors[fpfh]" if descriptor != "fpfh" else "descriptors[shot_single_scale]"
    for stage, children in CHILDREN.items():
        if stage == other:
            assert stage not in ranges
            continue
        assert stage in ranges, stage
        for child in children:
            assert child in ranges, (stage, child)
            inside = [any(slo <= lo and hi <= shi for slo, shi in ranges[stage])
                      for lo, hi in ranges[child]]
            # a blocking site may serve other stages too (and the evaluation)
            assert all(inside) if not child.startswith("sync[") else any(inside), (stage, child)
    assert len(ranges["normals[knn]"]) == 2
    # the matching stage is the only range whose name starts with "matching["
    assert sum(len(v) for k, v in ranges.items() if k.startswith("matching[")) == 1
    for lo, hi in ranges["sync[icp.done]"]:
        assert any(blo <= lo and hi <= bhi for blo, bhi in ranges["icp.block"])


def test_host_syncs_count_each_stage_sites(traced):
    _, stages, _ = traced
    records = {s["stage"]: s for s in stages}
    for s in stages:
        counts = {name: v["count"] for name, v in s["spans"].items()}
        waits = sum(n * (2 if name == "sync[kabsch.svd]" else 1)
                    for name, n in counts.items() if name.startswith("sync["))
        assert s["host_syncs"] == waits, s["stage"]
        assert counts["sync[stage]"] == 2
        assert s["host_sync_s"] <= s["seconds"] + sum(
            v["host_s"] for k, v in s["spans"].items() if k == "sync[stage]")
    icp = records["icp[point_to_plane]"]
    assert icp["iterations"] == MAX_ITER
    assert icp["spans"]["sync[icp.done]"]["count"] == math.ceil(icp["iterations"] / 8)
    assert icp["spans"]["icp.block"]["count"] == math.ceil(MAX_ITER / 8)
    assert icp["spans"]["sync[icp.result]"]["count"] == 3
    chunks = math.ceil(N_DRAWS / 512)
    ransac = records["ransac"]["spans"]
    assert ransac["sync[ransac.best]"]["count"] == 4 * chunks
    assert ransac["sync[kabsch.svd]"]["count"] == chunks
    assert ransac["sync[ransac.ratio]"]["count"] == 1
    match = records["matching[simple]"]["spans"]
    assert match["sync[match.nonzero]"]["count"] == match["sync[match.indices]"]["count"] == 2
    assert match["sync[match.read]"]["count"] == 1
    kp = records["keypoints[subsampling_with_density]"]["spans"]
    assert kp["sync[keypoints.representatives]"]["count"] == 4
    assert kp["sync[keypoints.kept]"]["count"] == kp["sync[keypoints.indices]"]["count"] == 2
    for s in stages:
        if s["stage"] == "normals[knn]":
            assert s["spans"]["sync[normals.kth]"]["count"] == 1
            assert s["spans"]["sync[normals.misses]"]["count"] == 1
            assert s["queries"] == 6000


def test_child_spans_leave_the_stage_records_as_they_were(monkeypatch):
    clock = iter(range(100))
    monkeypatch.setattr(perf, "perf_counter", lambda: float(next(clock)))
    metrics = perf.StageMetrics()
    with perf.span("outside"), perf.blocking("outside"):
        pass
    metrics.start("first[a]")
    with perf.span("child"):
        with perf.blocking("read"):
            pass
        with perf.blocking("svd", waits=2):
            pass
    with perf.span("child"):
        pass
    record = metrics.stop(items=4)
    metrics.start("second")
    second = metrics.stop()
    assert [s["stage"] for s in metrics.stages] == ["first[a]", "second"]
    assert metrics.summary()["total_seconds"] == record["seconds"] + second["seconds"]
    assert set(record) == {"stage", "seconds", "items", "items_per_sec", "host_syncs",
                           "host_sync_s", "spans"}
    assert record["items_per_sec"] == 4 / record["seconds"]
    assert record["host_syncs"] == 2 + 1 + 2
    assert record["spans"]["child"]["count"] == 2
    assert set(record["spans"]) == {"sync[stage]", "child", "sync[read]", "sync[svd]"}
    assert record["host_sync_s"] == sum(record["spans"][k]["host_s"] for k in
                                        ("sync[stage]", "sync[read]", "sync[svd]"))
    assert second["host_syncs"] == 2 and set(second["spans"]) == {"sync[stage]"}
    assert "outside" not in record["spans"]


def test_uploading_counts_a_copy_from_the_host_to_a_card_alone():
    assert perf.uploading(np.zeros(3), None) is perf.uploading(np.zeros(3), "cpu")
    assert perf.uploading(torch.zeros(3), torch.device("cpu")) is perf.uploading(1.0, "cpu")
    assert perf.uploading(np.zeros(3), "cuda").name == "sync[upload]"
    assert perf.uploading(torch.zeros(3), "cuda:0").waits == 1


def test_cli_metrics_json_holds_the_normals_stage(tmp_path, caplog):
    from shot_fpfh_tpu_torch.cli import main
    from shot_fpfh_tpu_torch.io.ply import write_ply

    scan, ref = _terrain(4000)
    write_ply(str(tmp_path / "scan.ply"), [scan.astype(np.float32)], ["x", "y", "z"])
    write_ply(str(tmp_path / "ref.ply"), [ref.astype(np.float32)], ["x", "y", "z"])
    with caplog.at_level(logging.INFO):
        code = main(["--device", "cpu", "--scan_file_path", str(tmp_path / "scan.ply"),
                     "--ref_file_path", str(tmp_path / "ref.ply"), "--conf_file_path", "",
                     "--neighborhood_size", "0.15", "--min_n_neighbors", "2",
                     "--radius", "0.9", "--rho", "10", "--min_neighborhood_size", "10",
                     "--n_draws", "500", "--max_iter", "8", "--disable_ply_writing",
                     "--metrics_json", str(tmp_path / "m.json")])
    assert code in (0, 1)
    stages = json.loads((tmp_path / "m.json").read_text())["stages"]
    assert [s["stage"] for s in stages][:2] == ["normals[knn]", "normals[knn]"]
    assert stages[0]["queries"] == 4000 and stages[0]["spans"]["sync[stage]"]["count"] == 2
    assert stages[-1]["stage"] == "icp[point_to_plane]"
    timers = [r.getMessage() for r in caplog.records if r.name == "shot_fpfh_tpu_torch.utils.perf"
              and r.getMessage().endswith(" seconds")]
    assert any(t.startswith("Data loading + normals") for t in timers)
    assert not any(t.startswith(("Keypoint selection", "Descriptors", "Matching", "RANSAC",
                                 "ICP")) for t in timers), timers


def test_bi_scale_chunks_open_window_and_bins_and_count_their_slots(tmp_path, monkeypatch):
    """Bi-scale SHOT through the CLI on the grid window route, under a
    profiler, in chunks of 256 keypoints: each ``shot.chunk`` holds one
    ``shot.window`` (K8 and the two radius planes) and one ``shot.bins``
    (K1), and the descriptor stage's record, as ``--metrics_json`` writes
    it, counts the chunks (the padded keypoints of each cloud in 256s);
    the loop adds no blocking read."""
    from shot_fpfh_tpu_torch.cli import main
    from shot_fpfh_tpu_torch.io.ply import write_ply
    from shot_fpfh_tpu_torch.models import shot as t_shot

    scan, ref = _terrain(4000)
    write_ply(str(tmp_path / "scan.ply"), [scan.astype(np.float32)], ["x", "y", "z"])
    write_ply(str(tmp_path / "ref.ply"), [ref.astype(np.float32)], ["x", "y", "z"])
    for mod in (grid_hash, t_normals, t_icp, t_pipeline):
        monkeypatch.setattr(mod, "AUTO_GRID_MIN_POINTS", 2000)
    monkeypatch.setattr(t_shot, "window_chunk", lambda grid, features: 256)
    calls = []
    chunked = t_shot._shot_on_grid
    monkeypatch.setattr(t_shot, "_shot_on_grid",
                        lambda grid, kp, *a, **k: calls.append((kp.shape[0], grid.window_cap))
                        or chunked(grid, kp, *a, **k))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        main(["--device", "cpu", "--scan_file_path", str(tmp_path / "scan.ply"),
              "--ref_file_path", str(tmp_path / "ref.ply"), "--conf_file_path", "",
              "--neighborhood_size", "0.15", "--min_n_neighbors", "2",
              "--descriptor_choice", "shot_bi_scale", "--radius", "0.3", "--phi", "3",
              "--rho", "10", "--min_neighborhood_size", "10", "--n_draws", "500",
              "--max_iter", "8", "--disable_ply_writing",
              "--metrics_json", str(tmp_path / "m.json")])
    ranges: dict[str, list] = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    chunks = ranges["shot.chunk"]
    assert len(calls) == 2 and all(cap > 0 for _, cap in calls)
    n_chunks = sum(-(-n // 256) for n, _ in calls)
    assert n_chunks > 2 and len(chunks) == n_chunks
    for name in ("shot.window", "shot.bins"):
        assert len(ranges[name]) == n_chunks
        assert all(sum(clo <= lo and hi <= chi for clo, chi in chunks) == 1
                   for lo, hi in ranges[name]), name
    stage = next(s for s in json.loads((tmp_path / "m.json").read_text())["stages"]
                 if s["stage"] == "descriptors[shot_bi_scale]")
    assert stage["chunks"] == n_chunks
    assert stage["spans"]["shot.window"]["count"] == stage["spans"]["shot.bins"]["count"] \
        == n_chunks
    syncs = {k: v["count"] for k, v in stage["spans"].items() if k.startswith("sync[")}
    assert stage["host_syncs"] == sum(syncs.values()) == BI_SCALE_HOST_SYNCS, syncs
