#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``shot_fpfh_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero with no result line:

1. device: torch / CUDA versions, card name and power limit;
2. build: compile ``shot_fpfh_tpu_torch/csrc/*.cu`` for sm_90a;
3. kernel parity at main-path shapes, each kernel against its plain
   PyTorch version on the same card inputs, with CUDA-event timings:
   K1 SHOT frames + histogram (4096 keypoints on a 50k-point terrain),
   K2 top-2 matching (4096 x 4096 x 352, f32 and bf16),
   K3 radius covariance (100k queries, scalar and per-query radius);
4. main path: the port's ``cli.main`` on a ~100k-point terrain pair (scan =
   known rigid motion of ref + noise) with ``config/default.yaml``, run
   cold once and then measured; the registration must be accepted, within
   1e-2 rad / 1e-2 of the ground truth, and the measured run must have
   launched K1, K2 and K3.  ``--profile DIR`` adds a third run under
   ``torch.profiler`` (op table, chrome trace, device-busy share).

Then one JSON line of kernel results, the ``nvidia-smi`` name / power-limit
line, and the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# tolerances (bench.py:277-280, 309-341, 377)
K3_COV_ATOL = 1e-4
K1_FRAME_ATOL = 5e-4
K1_FLIP_ABS, K1_FLIP_REL, K1_FLIP_FRAC, K1_MAX_DIFF = 5e-3, 1e-2, 3e-3, 0.1
K2_D1_RTOL = {False: 1e-4, True: 2e-3}
K2_MIN_AGREE = {False: 1.0, True: 0.97}
MAIN_ROT_TOL, MAIN_T_TOL = 1e-2, 1e-2


def make_terrain(n: int, rng: np.random.Generator, scale: float = 10.0,
                 n_bumps: int = 40) -> np.ndarray:
    """Synthetic terrain: Gaussian bumps on a plane (the repo's bench cloud)."""
    xy = rng.uniform(-scale, scale, size=(n, 2))
    z = np.zeros(n)
    centers = rng.uniform(-scale, scale, size=(n_bumps, 2))
    heights = rng.uniform(-2.0, 2.0, size=n_bumps)
    widths = rng.uniform(0.5, 2.5, size=n_bumps) * (scale / 10.0) * (40 / n_bumps) ** 0.5
    for c, h, w in zip(centers, heights, widths):
        z += h * np.exp(-np.sum((xy - c) ** 2, axis=1) / (2 * w ** 2))
    pts = np.column_stack([xy, z]) + rng.normal(scale=0.01, size=(n, 3))
    return pts.astype(np.float32)


def rotation_about(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def cuda_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event milliseconds of ``fn`` after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check(cond: bool, message: str) -> None:
    if not cond:
        raise AssertionError(message)


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"phase 1 device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)
    return smi


def phase_build():
    from shot_fpfh_tpu_torch import _kernels

    t0 = time.perf_counter()
    _kernels.library()
    regs = [ln.split(":", 1)[1].strip() for ln in _kernels.build_info.get("ptxas", [])
            if "registers" in ln]
    nvcc = ("library already built" if _kernels.build_info.get("cached")
            else f"nvcc {_kernels.build_info['seconds']:.2f} s")
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s ({nvcc}); ptxas: {regs}",
          flush=True)


def parity_k3(dev, rng):
    import torch

    from shot_fpfh_tpu_torch.models.normals import _knn_target_radii
    from shot_fpfh_tpu_torch.ops.grid_hash import build_grid, kth_distance_bound, quantized_kth_radius
    from shot_fpfh_tpu_torch.ops.radius_pca import radius_pca, radius_pca_plain

    cloud = torch.tensor(make_terrain(100_000, rng), device=dev)
    sample = cloud[::cloud.shape[0] // 512][:512]
    kth = kth_distance_bound(sample, cloud, 30)
    grid = build_grid(cloud, quantized_kth_radius(kth.cpu().numpy()))
    r_q = _knn_target_radii(grid, cloud, 30, sample, kth)
    out = {}
    for label, radius in (("per-query", r_q), ("scalar", grid.cell_size)):
        cov_k, bary_k, cnt_k = radius_pca(grid, cloud, radius)
        cov_p, bary_p, cnt_p = radius_pca_plain(grid, cloud, radius)
        torch.cuda.synchronize()
        err = float((cov_k - cov_p).abs().max())
        check(bool((cnt_k == cnt_p).all()), f"K3 {label}: counts differ")
        check(err <= K3_COV_ATOL, f"K3 {label}: covariance error {err}")
        out[label] = err
    ms = cuda_ms(lambda: radius_pca(grid, cloud, r_q))
    plain_ms = cuda_ms(lambda: radius_pca_plain(grid, cloud, r_q))
    print(f"phase 3 K3 radius_pca: 100000 queries, window cap {grid.window_cap}: counts "
          f"exact, cov max err {out}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
    return dict(max_abs_err=max(out.values()), ms=ms, plain_ms=plain_ms)


def parity_k2(dev, rng):
    import torch

    from shot_fpfh_tpu_torch.ops.match import top2_match, top2_match_plain

    a = torch.tensor(rng.normal(size=(4096, 352)).astype(np.float32), device=dev)
    b = torch.tensor(rng.normal(size=(4096, 352)).astype(np.float32), device=dev)
    valid = torch.ones(4096, dtype=torch.bool, device=dev)
    valid[::97] = False
    res = {}
    for bf16 in (False, True):
        i_k, d1_k, d2_k = top2_match(a, b, valid, bf16)
        i_p, d1_p, d2_p = top2_match_plain(a, b, valid, bf16)
        torch.cuda.synchronize()
        agree = float((i_k == i_p).float().mean())
        rel = float(((d1_k - d1_p).abs() / d1_p.abs()).max())
        check(agree >= K2_MIN_AGREE[bf16], f"K2 bf16={bf16}: index agreement {agree}")
        check(rel <= K2_D1_RTOL[bf16], f"K2 bf16={bf16}: d1 relative error {rel}")
        check(not bool(valid.logical_not()[i_k].any()), "K2 picked an invalid ref")
        res[bf16] = dict(agree=agree, rel=rel,
                         max_abs_err=float((d1_k - d1_p).abs().max()),
                         ms=cuda_ms(lambda: top2_match(a, b, valid, bf16)),
                         plain_ms=cuda_ms(lambda: top2_match_plain(a, b, valid, bf16)))
    print("phase 3 K2 top2_match: 4096x4096x352: " + "; ".join(
        f"{'bf16' if k else 'f32'} agree {v['agree']:.4f} d1 rel err {v['rel']:.2e} "
        f"kernel {v['ms']:.3f} ms plain {v['plain_ms']:.3f} ms" for k, v in res.items()),
        flush=True)
    return res[True]


def parity_k1(dev, rng):
    import torch

    from shot_fpfh_tpu_torch.models.normals import compute_normals
    from shot_fpfh_tpu_torch.ops.grid_hash import build_grid, window_distances
    from shot_fpfh_tpu_torch.ops.shot_fused import (
        shot_binning_histogram,
        shot_binning_histogram_plain,
    )

    radius = 0.9
    cloud = torch.tensor(make_terrain(50_000, rng), device=dev)
    # the main path's normals (k=30, through K3), so the cosine bins carry
    # the skew of real SHOT inputs
    normals = compute_normals(cloud, cloud, k=30, device=dev)
    kp = cloud[torch.tensor(rng.choice(cloud.shape[0], 4096, replace=False), device=dev)]
    grid = build_grid(cloud, radius / 2, extras=normals, halo=2)
    vals, d, valid, _ = window_distances(grid, kp)
    dist_inf = torch.where(valid & (d <= radius), d, torch.full_like(d, float("inf")))
    hist_k, rfs_k = shot_binning_histogram(vals, dist_inf, kp, None, radius)
    hist_p, rfs_p = shot_binning_histogram_plain(vals, dist_inf, kp, None, radius)
    hist_g = shot_binning_histogram(vals, dist_inf, kp, rfs_p, radius)
    # SHOT's hard bins jump at their edges, so each histogram is held
    # against the plain binning under the same frames
    hist_pk = shot_binning_histogram_plain(vals, dist_inf, kp, rfs_k, radius)
    torch.cuda.synchronize()
    frame_err = float((rfs_k - rfs_p).abs().max())
    check(frame_err <= K1_FRAME_ATOL, f"K1 frames error {frame_err}")
    stats = {}
    for label, got, want in (("own frames", hist_k, hist_pk), ("given frames", hist_g, hist_p)):
        diff = (got - want).abs()
        flip = float((diff > K1_FLIP_ABS + K1_FLIP_REL * want.abs()).float().mean())
        stats[label] = (flip, float(diff.max()))
        check(flip <= K1_FLIP_FRAC and stats[label][1] <= K1_MAX_DIFF,
              f"K1 {label}: flip fraction {flip}, max diff {stats[label][1]}")
    ms = cuda_ms(lambda: shot_binning_histogram(vals, dist_inf, kp, None, radius))
    plain_ms = cuda_ms(lambda: shot_binning_histogram_plain(vals, dist_inf, kp, None, radius))
    print(f"phase 3 K1 shot_binning_histogram: 4096 keypoints x window {vals.shape[2]}: "
          f"frames max err {frame_err:.2e}, (flip fraction, max diff) {stats}; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
    return dict(max_abs_err=max(s[1] for s in stats.values()), ms=ms, plain_ms=plain_ms)


class _StageLog(logging.Handler):
    """Collects the CLI's stage timer lines (``utils.perf.checkpoint``)."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _profiled(fn, out_dir: Path):
    """Run ``fn`` under ``torch.profiler``; write the op table and a chrome
    trace to ``out_dir``; return (result, profiled wall seconds, device-busy
    seconds: the summed time of the kernels and copies run on the card)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    (out_dir / "main_path_ops.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    prof.export_chrome_trace(str(out_dir / "main_path_trace.json"))
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    return result, wall, busy_us / 1e6


def phase_main_path(profile_dir: Path | None = None):
    import torch

    from shot_fpfh_tpu_torch import _kernels, cli
    from shot_fpfh_tpu_torch.core.solvers import solve_point_to_point
    from shot_fpfh_tpu_torch.core.transform import rotation_angle
    from shot_fpfh_tpu_torch.io.ply import read_ply, write_ply

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    rng = np.random.default_rng(72)
    ref = make_terrain(100_000, rng, scale=10, n_bumps=40)
    rot = rotation_about([0.3, -0.2, 1.0], np.deg2rad(15.0))
    trans = np.array([0.4, -0.25, 0.15])
    scan = (ref @ rot.T + trans + rng.normal(scale=0.005, size=ref.shape)).astype(np.float32)
    write_ply(str(WORK / "scan.ply"), [scan], ["x", "y", "z"])
    write_ply(str(WORK / "ref.ply"), [ref], ["x", "y", "z"])
    metrics = WORK / "metrics.json"
    argv = ["--scan_file_path", str(WORK / "scan.ply"), "--ref_file_path", str(WORK / "ref.ply"),
            "--conf_file_path", "", "--output_dir", str(WORK / "out"),
            "--metrics_json", str(metrics), "--device", "cuda",
            # config/default.yaml leaves these null (unusable) or sized for
            # the bunny: keypoint voxel + density threshold, SHOT radius
            "--neighborhood_size", "0.15", "--min_n_neighbors", "5", "--radius", "0.9"]

    # a first, cold run pays one-time library set-up (cuSOLVER handles for
    # RANSAC's SVDs and ICP's solves, allocator growth); the second run is
    # the one measured and whose kernel launches are counted
    t0 = time.perf_counter()
    check(cli.main(argv) == 0, "main path (cold run): registration rejected")
    torch.cuda.synchronize()
    cold_wall = time.perf_counter() - t0
    stage_log = _StageLog()
    logging.getLogger("shot_fpfh_tpu_torch.utils.perf").addHandler(stage_log)
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launch_counts)
    logging.getLogger("shot_fpfh_tpu_torch.utils.perf").removeHandler(stage_log)
    check(rc == 0, f"main path: registration rejected (exit code {rc})")
    for name, count in launches.items():
        check(count > 0, f"main path never launched kernel {name}")

    # ground truth maps scan -> ref: the inverse of the motion applied
    gt_rot, gt_t = rot.T, -rot.T @ trans
    data = read_ply(str(WORK / "out" / "scan_on_ref_post_icp.ply"))
    is_scan = data["is_scan"] > 0
    moved = np.stack([data[c][is_scan] for c in "xyz"], axis=1)
    got = solve_point_to_point(torch.tensor(scan, dtype=torch.float64),
                               torch.tensor(moved, dtype=torch.float64))
    rot_err = float(rotation_angle(got.rotation, torch.tensor(gt_rot)))
    t_err = float(np.linalg.norm(got.translation.numpy() - gt_t))
    check(rot_err < MAIN_ROT_TOL and t_err < MAIN_T_TOL,
          f"main path: rotation error {rot_err}, translation error {t_err}")
    stages = json.loads(metrics.read_text())["stages"]
    timers = [ln for ln in stage_log.lines if ln.endswith(" seconds")]
    profiled = ""
    if profile_dir is not None:
        # a third run under the profiler, so its overhead stays out of the
        # measured run above
        rc, prof_wall, busy = _profiled(lambda: cli.main(argv), profile_dir)
        check(rc == 0, f"main path (profiled run): registration rejected (exit code {rc})")
        profiled = (f"; profiled run {prof_wall:.3f} s, device busy {busy:.3f} s "
                    f"(idle share {1.0 - busy / prof_wall:.3f})")
    print(f"phase 4 main path: 100000-point pair accepted, rotation error {rot_err:.2e} rad, "
          f"translation error {t_err:.2e}, wall {wall:.3f} s (cold run {cold_wall:.3f} s)"
          + profiled + f", launches {launches}, stages "
          + ", ".join(f"{s['stage']} {s['seconds']:.3f} s" for s in stages)
          + f"; CLI timers: {timers}", flush=True)
    return launches


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", type=Path, default=None, metavar="DIR",
                        help="profile the main path with torch.profiler; write the "
                             "op table and a chrome trace to DIR")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "shot_fpfh_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import shot_fpfh_tpu_torch  # noqa: F401  (sets TF32 off)

    smi = phase_device()
    phase_build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    results = {
        "shot_binning_histogram": ("shot_fpfh_tpu_torch/csrc/shot_fused.cu",
                                   "shot_fpfh_tpu/ops/pallas_shot_fused.py:408",
                                   parity_k1(dev, rng)),
        "top2_match": ("shot_fpfh_tpu_torch/csrc/match.cu",
                       "shot_fpfh_tpu/ops/pallas_match.py:139", parity_k2(dev, rng)),
        "radius_pca": ("shot_fpfh_tpu_torch/csrc/radius_pca.cu",
                       "shot_fpfh_tpu/ops/pallas_radius.py:247", parity_k3(dev, rng)),
    }
    launches = phase_main_path(args.profile)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"]}
        for name, (src, rep, r) in results.items()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
