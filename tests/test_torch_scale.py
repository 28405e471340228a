"""Port parity at the settings of ``chip_smoke.py`` phase 16 (the JAX
package's own scale: ``benchmarks/bench_1m.py``'s 10^6-point pair and
``bench.py``'s at-scale legs), cut to CPU size.

- ``kth_distance_bound`` runs in sample chunks of the brute search's tile
  (its one-piece ``(512, N)`` temporaries held ~6 GB of the card at 10^6
  points): each chunking equals the one-piece form (``torch.equal``) and
  JAX's bound (exact off a TPU) within 1e-4, with the same quantized grid
  radius; the k=30 normals through it
  equal the one-piece normals and hold JAX's rule (``|n·n'| > 0.999`` for
  at least 99.9% of points, ``tests/test_torch_grid.py``).
- A voxel of 20k and of 100k points: the sorted-order voxel sums equal the
  CPU's ``index_add_`` bit for bit, and ``grid_subsample`` picks JAX's
  representatives index for index.
- bench_1m.py's terrain on [-4, 4]² at the 10^6-point pair's density
  (~40k points), radius 0.6, keypoint voxel 0.9, through the port's
  ``cli.main --device cpu`` and the JAX CLI: the two ICP transforms within
  1e-3 of each other and of the ground truth (``test_torch_slice.py``'s
  bound), and the same verdict: both reject the pair, since keypoints 0.9
  apart leave ~5% of them within the evaluation's 0.1 of each other.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import make_terrain  # noqa: E402
from shot_fpfh_tpu.core.subsampling import grid_subsample as j_subsample
from shot_fpfh_tpu.models.normals import compute_normals as j_normals
from shot_fpfh_tpu.ops import grid_hash as j_grid
from shot_fpfh_tpu_torch.core.solvers import solve_point_to_point
from shot_fpfh_tpu_torch.core.subsampling import _segment_sums, _voxel_segments
from shot_fpfh_tpu_torch.core.subsampling import grid_subsample as t_subsample
from shot_fpfh_tpu_torch.core.transform import euler_xyz_to_matrix, rotation_angle
from shot_fpfh_tpu_torch.io.ply import read_ply, write_ply
from shot_fpfh_tpu_torch.models.normals import compute_normals as t_normals
from shot_fpfh_tpu_torch.ops import grid_hash as t_grid
from shot_fpfh_tpu_torch.ops import neighbors as t_neighbors

# The suite runs several pytest workers side by side on the CPU: one torch
# thread per worker keeps torch's OpenMP pool from oversubscribing the cores
# (it slowed every worker, JAX tests included, by up to 2x).
torch.set_num_threads(1)


def _scale_terrain(n: int, extent: float, seed: int = 7) -> np.ndarray:
    """benchmarks/bench_1m.py:52-59's ref on [-extent, extent]²."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-extent, extent, size=(n, 2)).astype(np.float32)
    z = (0.8 * np.sin(0.9 * xy[:, 0]) * np.cos(0.7 * xy[:, 1])
         + 0.4 * np.sin(2.1 * xy[:, 0] + 1.0) * np.cos(1.7 * xy[:, 1] + 0.5)
         + 0.15 * np.sin(4.3 * xy[:, 0] + 2.0) * np.cos(3.9 * xy[:, 1] + 1.5))
    ref = np.column_stack([xy, z]).astype(np.float32)
    ref += rng.normal(scale=0.005, size=ref.shape).astype(np.float32)
    return ref


@pytest.fixture(scope="module")
def terrain_22k():
    # the ref cloud of test_torch_slice's CLI pair and test_torch_grid's
    # normals test
    return make_terrain(22_000, np.random.default_rng(5), scale=5.0, n_bumps=10)


# sample rows a chunk: 7 and 64 (as at 10^6 points: 67), and one piece
@pytest.mark.parametrize("rows", [7, 64, 512])
def test_kth_distance_bound_chunks_equal_one_piece_and_jax(terrain_22k, monkeypatch, rows):
    pts = torch.tensor(terrain_22k)
    sample = pts[::pts.shape[0] // 512][:512]
    one_piece = t_grid.kth_distance_bound(sample, pts, 30)
    monkeypatch.setattr(t_neighbors, "_MAX_TILE_ELEMS", rows * pts.shape[0])
    assert t_neighbors._chunk(pts.shape[0]) == rows
    chunked = t_grid.kth_distance_bound(sample, pts, 30)
    assert torch.equal(chunked, one_piece)
    want = np.asarray(j_grid.kth_distance_bound(jnp.asarray(sample.numpy()),
                                                jnp.asarray(terrain_22k), 30))
    # both expand |q - p|² = |q|² + |p|² - 2 q·p in float32, summed in other
    # orders: at |p|² ~ 50 the cancellation moves a ~0.2 distance by ~2e-5
    np.testing.assert_allclose(chunked.numpy(), want, atol=1e-4)
    assert t_grid.quantized_kth_radius(chunked.numpy()) == j_grid.quantized_kth_radius(want)


def test_knn_normals_with_a_chunked_bound_match_reference(terrain_22k, monkeypatch):
    """The streaming k=30 normals (above AUTO_GRID_MIN_POINTS) with the
    sampled bound in 64-row chunks: equal to the one-piece run, and JAX's
    rule against the JAX normals."""
    pts = terrain_22k.astype(np.float64)
    one_piece = t_normals(pts, pts, k=30, device="cpu")
    monkeypatch.setattr(t_neighbors, "_MAX_TILE_ELEMS", 64 * pts.shape[0])
    chunked = t_normals(pts, pts, k=30, device="cpu")
    assert torch.equal(chunked, one_piece)
    jn = np.asarray(j_normals(pts, pts, k=30))
    assert np.mean(np.abs((jn * chunked.numpy()).sum(1)) > 0.999) >= 0.999


@pytest.mark.parametrize("cluster", [20_000, 100_000])
def test_one_dense_voxel_sums_and_representatives_match_reference(cluster):
    """chip_smoke.py's skewed cloud (phase 3: 20k points in one voxel;
    phase 16: 10^5 and 10^6) at CPU size: a 20k-point terrain plus
    ``cluster`` points within 1e-3 of one of its points, voxel 0.15."""
    rng = np.random.default_rng(cluster)
    base = make_terrain(20_000, rng)
    cloud = np.concatenate([
        base, base[0] + rng.uniform(0.0, 1e-3, size=(cluster, 3)).astype(np.float32)])
    pts = torch.tensor(cloud)
    order, seg, counts, _ = _voxel_segments(pts, 0.15)
    n_seg = int(seg[-1]) + 1
    lengths = counts[:n_seg].to(torch.int64)
    assert int(lengths.max()) >= cluster
    want = torch.zeros(n_seg, 3).index_add_(0, seg, pts[order])
    assert torch.equal(_segment_sums(pts[order], lengths), want)
    np.testing.assert_array_equal(t_subsample(cloud, 0.15, device="cpu"),
                                  np.asarray(j_subsample(cloud, 0.15)))


def _recovered(ply_path, scan):
    data = read_ply(str(ply_path))
    is_scan = data["is_scan"] > 0
    moved = np.stack([data[c][is_scan] for c in "xyz"], axis=1)
    return solve_point_to_point(torch.tensor(scan, dtype=torch.float64),
                                torch.tensor(moved, dtype=torch.float64))


def test_shot_cli_at_phase16_settings_matches_reference_cli(tmp_path):
    from shot_fpfh_tpu.cli import main as j_main
    from shot_fpfh_tpu_torch.cli import main as t_main

    # 40k points on [-4, 4]²: the 10^6-point pair's 625 points per unit area
    ref = _scale_terrain(40_000, 4.0)
    rot = euler_xyz_to_matrix(torch.tensor([0.2, -0.1, 0.4], dtype=torch.float64)).numpy()
    t = np.array([0.8, -0.5, 0.3])
    noise = np.random.default_rng(8).normal(scale=0.005, size=ref.shape)
    scan = ((ref - t) @ rot + noise).astype(np.float32)
    write_ply(str(tmp_path / "scan.ply"), [scan], ["x", "y", "z"])
    write_ply(str(tmp_path / "ref.ply"), [ref], ["x", "y", "z"])
    common = ["--scan_file_path", str(tmp_path / "scan.ply"),
              "--ref_file_path", str(tmp_path / "ref.ply"), "--conf_file_path", "",
              "--neighborhood_size", "0.9", "--min_n_neighbors", "5", "--radius", "0.6",
              # 8 ICP iterations land both within 4e-4 of the ground truth
              # here (50 take the port's CPU twins ~40 s)
              "--max_iter", "8"]
    rc_t = t_main(common + ["--device", "cpu", "--output_dir", str(tmp_path / "torch")])
    rc_j = j_main(common + ["--n_devices", "1", "--output_dir", str(tmp_path / "jax")])
    assert rc_t == rc_j == 1
    got_t = _recovered(tmp_path / "torch" / "scan_on_ref_post_icp.ply", scan)
    got_j = _recovered(tmp_path / "jax" / "scan_on_ref_post_icp.ply", scan)
    gt_rot, gt_t = torch.tensor(rot), torch.tensor(t)   # ref = R scan + t
    for a, b_rot, b_t in ((got_t, got_j.rotation, got_j.translation), (got_t, gt_rot, gt_t),
                          (got_j, gt_rot, gt_t)):
        assert float(rotation_angle(a.rotation, b_rot)) < 1e-3
        assert float(torch.linalg.norm(a.translation - b_t)) < 1e-3
