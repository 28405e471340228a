"""Port parity: keypoint selection — the greedy-coverage ``iterative``
strategy on both sides of ``AUTO_GRID_MIN_POINTS`` (index for index against
JAX), the random strategies, and the CLI with ``--selection_algorithm
iterative`` (transform within 1e-3 of the JAX CLI's).

The grid route is reached on small clouds by lowering
``AUTO_GRID_MIN_POINTS`` in both packages' ``ops.grid_hash`` (both read it
at call time).
"""

import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from conftest import make_cloud  # noqa: E402
from test_torch_fpfh import _bumpy  # noqa: E402

from shot_fpfh_tpu import keypoints as j_kp  # noqa: E402
from shot_fpfh_tpu.ops import grid_hash as j_grid  # noqa: E402
from shot_fpfh_tpu_torch import keypoints as t_kp  # noqa: E402
from shot_fpfh_tpu_torch.ops import grid_hash as t_grid  # noqa: E402

# The suite runs several pytest workers side by side on the CPU: one torch
# thread per worker keeps torch's OpenMP pool from oversubscribing the cores.
torch.set_num_threads(1)


def _grid_route(monkeypatch, threshold=1000):
    for mod in (j_grid, t_grid):
        monkeypatch.setattr(mod, "AUTO_GRID_MIN_POINTS", threshold)


@pytest.mark.parametrize("n,radius", [(500, 0.3), (1500, 0.12)])
def test_iterative_sequential_matches_reference(rng, n, radius):
    """Below the threshold: the sequential greedy, index for index."""
    pts = make_cloud(n, rng).astype(np.float32)
    want = j_kp.select_keypoints_iteratively(pts, radius)
    got = t_kp.select_keypoints_iteratively(pts, radius, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0


@pytest.mark.parametrize("n,radius,k_max,cap", [(3000, 0.15, 128, 128), (3000, 0.12, 16, 64)])
def test_iterative_grid_rounds_match_reference(rng, monkeypatch, caplog, n, radius, k_max,
                                               cap):
    """From the threshold up: the round-parallel greedy over halo-2 grid
    neighborhoods, index for index, and the sequential greedy's fixpoint
    while no ball fills the cap; at k_max 16 the balls (up to 54 points)
    fill it, and it doubles to 64, which holds them."""
    _grid_route(monkeypatch)
    pts = make_cloud(n, rng).astype(np.float32)
    want = j_kp.select_keypoints_iteratively(pts, radius, k_max=k_max)
    with caplog.at_level(logging.INFO, logger="shot_fpfh_tpu_torch.keypoints"):
        got = t_kp.select_keypoints_iteratively(pts, radius, k_max=k_max, device="cpu")
    np.testing.assert_array_equal(got, want)
    # the greedy fixpoint: the sequential selection on the same cloud
    np.testing.assert_array_equal(got, np.nonzero(t_kp._iterative_masked(
        torch.tensor(pts), radius).numpy())[0])
    (line,) = [r.getMessage() for r in caplog.records if "rounds" in r.getMessage()]
    assert f"{len(got)} keypoints of {n} points" in line
    assert f"neighbor cap {cap})" in line


def test_iterative_warns_when_the_cap_stays_full(rng, monkeypatch, caplog):
    """Balls of ~200 points against a cap that may only reach 8 × 4: the
    selection goes on, truncated to the nearest 32, with a warning — as the
    JAX package, index for index."""
    _grid_route(monkeypatch)
    pts = make_cloud(2000, rng).astype(np.float32)
    want = j_kp.select_keypoints_iteratively(pts, 0.6, k_max=4)
    with caplog.at_level(logging.WARNING, logger="shot_fpfh_tpu_torch.keypoints"):
        got = t_kp.select_keypoints_iteratively(pts, 0.6, k_max=4, device="cpu")
    assert any("32-neighbor cap" in r.getMessage() for r in caplog.records)
    np.testing.assert_array_equal(got, want)


def test_random_selection():
    idx = t_kp.select_query_indices_randomly(500, 100)
    assert len(np.unique(idx)) == 100 and idx.min() >= 0 and idx.max() < 500
    # the default generator is a CPU one seeded 0: the same draws every call
    np.testing.assert_array_equal(idx, t_kp.select_query_indices_randomly(500, 100))
    other = t_kp.select_query_indices_randomly(500, 100, torch.Generator().manual_seed(1))
    assert not np.array_equal(idx, other)
    pts = np.random.default_rng(0).normal(size=(500, 3)).astype(np.float32)
    kp = t_kp.select_keypoints_randomly(pts, 50)
    assert kp.shape == (50, 3)
    np.testing.assert_array_equal(kp, pts[t_kp.select_query_indices_randomly(
        500, 50, torch.Generator().manual_seed(1))])
    assert t_kp.select_keypoints_randomly(torch.tensor(pts), 50).shape == (50, 3)


def test_random_selection_takes_injected_indices():
    """``jax.random``'s draws cannot be reproduced in PyTorch: JAX's own
    indices go in as they are."""
    want = j_kp.select_query_indices_randomly(500, 100)
    np.testing.assert_array_equal(t_kp.select_query_indices_randomly(500, 100, indices=want),
                                  want)
    pts = np.random.default_rng(0).normal(size=(500, 3)).astype(np.float32)
    np.testing.assert_array_equal(t_kp.select_keypoints_randomly(pts, 100, indices=want),
                                  pts[want])
    for bad in (want[:-1], np.concatenate([want[:-1], want[:1]]), want + 500):
        with pytest.raises(ValueError, match="distinct indices"):
            t_kp.select_query_indices_randomly(500, 100, indices=bad)


def test_pipeline_random_keypoints():
    from shot_fpfh_tpu_torch.pipeline import RegistrationPipeline

    pts = np.random.default_rng(0).normal(size=(400, 3)).astype(np.float32)
    p = RegistrationPipeline(scan=pts, scan_normals=pts, ref=pts[:300], ref_normals=pts[:300],
                             device="cpu")
    p.select_keypoints("random", proportion_picked=0.25)
    assert (len(p.scan_keypoints), len(p.ref_keypoints)) == (100, 75)
    np.testing.assert_array_equal(p.scan_keypoints, t_kp.select_query_indices_randomly(400, 100))
    np.testing.assert_array_equal(p.ref_keypoints, t_kp.select_query_indices_randomly(
        300, 75, torch.Generator().manual_seed(1)))
    with pytest.raises(ValueError, match="proportion"):
        p.select_keypoints("random", proportion_picked=1.5, force_recompute=True)


def test_cli_iterative_matches_reference_cli(tmp_path, monkeypatch):
    """A 1500-point pair with greedy-coverage keypoints at radius 0.2 (the
    grid rounds: the threshold lowered to 1000 points in both packages)."""
    from shot_fpfh_tpu.cli import main as j_main
    from shot_fpfh_tpu_torch.cli import main as t_main
    from shot_fpfh_tpu_torch.core.transform import RigidTransform, rotation_angle
    from shot_fpfh_tpu_torch.io.ply import write_ply
    from test_torch_slice import _assert_close, _recovered, _rotation_about

    _grid_route(monkeypatch)
    rng = np.random.default_rng(7)
    ref = _bumpy(1500, rng).astype(np.float32)
    rot = _rotation_about([0.2, -0.4, 1.0], np.deg2rad(20.0))
    trans = np.array([0.3, -0.2, 0.1])
    scan = (ref @ rot.T + trans).astype(np.float32)
    write_ply(str(tmp_path / "scan.ply"), [scan], ["x", "y", "z"])
    write_ply(str(tmp_path / "ref.ply"), [ref], ["x", "y", "z"])
    common = ["--scan_file_path", str(tmp_path / "scan.ply"),
              "--ref_file_path", str(tmp_path / "ref.ply"), "--conf_file_path", "",
              "--normals_k", "20", "--selection_algorithm", "iterative",
              "--neighborhood_size", "0.2", "--descriptor_choice", "shot_single_scale",
              "--radius", "0.5", "--rho", "30", "--min_neighborhood_size", "10",
              "--k_max_descriptor", "256", "--matching_algorithm", "ratio",
              "--reject_threshold", "0.95", "--n_draws", "1500",
              "--max_inliers_distance", "0.1", "--d_max", "0.3", "--voxel_size", "0.1",
              "--max_iter", "40", "--rms_threshold", "1e-4"]
    assert t_main(common + ["--device", "cpu", "--output_dir", str(tmp_path / "torch"),
                            "--state_cache", str(tmp_path / "torch.npz")]) == 0
    assert j_main(common + ["--n_devices", "1", "--output_dir", str(tmp_path / "jax"),
                            "--state_cache", str(tmp_path / "jax.npz")]) == 0
    for side in ("scan_keypoints", "ref_keypoints"):
        np.testing.assert_array_equal(np.load(tmp_path / "torch.npz")[side],
                                      np.load(tmp_path / "jax.npz")[side])
    gt = RigidTransform.from_numpy(rot.T, -rot.T @ trans, dtype=torch.float64)
    got_t = _recovered(tmp_path / "torch" / "scan_on_ref_post_icp.ply", scan)
    got_j = _recovered(tmp_path / "jax" / "scan_on_ref_post_icp.ply", scan)
    _assert_close(got_t, got_j)
    assert float(rotation_angle(got_t.rotation, gt.rotation)) < 1e-2
