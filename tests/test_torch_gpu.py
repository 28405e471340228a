"""CUDA kernels against their plain PyTorch twins, on the card.

Marked ``gpu``: each test skips without a CUDA device (decided inside the
fixture, never at import).  Run them on a GPU machine with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`` (the suite's
``conftest.py`` imports JAX, which a GPU machine need not have; this file
needs only torch).  ``chip_smoke.py`` runs the same comparisons at the main
path's shapes.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from shot_fpfh_tpu_torch import _kernels
from shot_fpfh_tpu_torch.ops.grid_hash import build_grid, window_distances
from shot_fpfh_tpu_torch.ops.match import top2_match, top2_match_plain
from shot_fpfh_tpu_torch.ops.radius_pca import radius_pca, radius_pca_plain
from shot_fpfh_tpu_torch.ops.shot_fused import (
    shot_binning_histogram,
    shot_binning_histogram_plain,
)

pytestmark = pytest.mark.gpu

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _surface(rng, n, device):
    xy = rng.uniform(-3, 3, size=(n, 2))
    z = 0.4 * np.sin(xy[:, 0]) * np.cos(0.7 * xy[:, 1])
    pts = np.column_stack([xy, z]) + rng.normal(scale=0.01, size=(n, 3))
    return torch.tensor(pts.astype(np.float32), device=device)


def _counted(name, fn):
    before = _kernels.launch_counts[name]
    out = fn()
    torch.cuda.synchronize()
    assert _kernels.launch_counts[name] == before + 1
    return out


def test_k3_radius_pca_kernel(cuda, rng):
    pts = _surface(rng, 30_000, cuda)
    grid = build_grid(pts, 0.3)
    radius = torch.tensor(rng.uniform(0.1, 0.3, 5000).astype(np.float32), device=cuda)
    cov, bary, cnt = _counted("radius_pca", lambda: radius_pca(grid, pts[:5000], radius))
    cov_p, bary_p, cnt_p = radius_pca_plain(grid, pts[:5000], radius)
    assert torch.equal(cnt, cnt_p)
    torch.testing.assert_close(cov, cov_p, atol=1e-4, rtol=0)
    torch.testing.assert_close(bary, bary_p, atol=1e-5, rtol=0)


@pytest.mark.parametrize("use_bf16", [False, True])
def test_k2_top2_kernel(cuda, rng, use_bf16):
    a = torch.randn(1000, 352, device=cuda)
    b = torch.randn(1537, 352, device=cuda)
    valid = torch.rand(1537, device=cuda) > 0.05
    i1, d1, d2 = _counted("top2_match", lambda: top2_match(a, b, valid, use_bf16))
    j1, e1, e2 = top2_match_plain(a, b, valid, use_bf16)
    assert float((i1 == j1).float().mean()) >= (0.97 if use_bf16 else 1.0)
    rtol = 2e-3 if use_bf16 else 1e-4
    torch.testing.assert_close(d1, e1, rtol=rtol, atol=0)
    assert bool(valid[i1].all())


@pytest.mark.parametrize("own_frames", [True, False])
def test_k1_shot_kernel(cuda, rng, own_frames):
    pts = _surface(rng, 30_000, cuda)
    nrm = torch.nn.functional.normalize(torch.randn_like(pts), dim=1)
    grid = build_grid(pts, 0.25, extras=nrm, halo=2)
    kp = pts[::50]
    vals, d, valid, _ = window_distances(grid, kp)
    dist = torch.where(valid & (d <= 0.5), d, torch.full_like(d, float("inf")))
    hist_p, rfs_p = shot_binning_histogram_plain(vals, dist, kp, None, 0.5)
    if own_frames:
        hist, rfs = _counted("shot_binning_histogram",
                             lambda: shot_binning_histogram(vals, dist, kp, None, 0.5))
        torch.testing.assert_close(rfs, rfs_p, atol=5e-4, rtol=0)
        # SHOT's hard bins jump at their edges (a neighbor on the frame's
        # xy plane changes elevation cell with a 1e-7 frame change), so the
        # histograms are compared under the kernel's own frames
        hist_p = shot_binning_histogram_plain(vals, dist, kp, rfs, 0.5)
    else:
        hist = _counted("shot_binning_histogram",
                        lambda: shot_binning_histogram(vals, dist, kp, rfs_p, 0.5))
    diff = (hist - hist_p).abs()
    assert float((diff > 5e-3 + 1e-2 * hist_p.abs()).float().mean()) <= 3e-3
    assert float(diff.max()) <= 0.1


def test_golden_pair_on_card(cuda):
    """The golden pair (tests/test_reference_parity.py:31) through the port
    on the card: within the measured reference's accuracy envelope, with the
    matching kernel on (2,500 points take the brute normals / SHOT routes)."""
    from shot_fpfh_tpu_torch.core.transform import rotation_angle
    from shot_fpfh_tpu_torch.models.normals import compute_normals
    from shot_fpfh_tpu_torch.pipeline import RegistrationPipeline

    data = np.load(REPO / "benchmarks" / "golden_pair.npz")
    measured = json.loads((REPO / "BASELINE_measured.json").read_text())["golden_pipeline"]
    scan, ref = data["scan"], data["ref"]
    p = RegistrationPipeline(
        scan=scan, scan_normals=compute_normals(scan, scan, k=20, device=cuda).cpu().numpy(),
        ref=ref, ref_normals=compute_normals(ref, ref, k=20, device=cuda).cpu().numpy(),
        k_max_descriptor=256, device=cuda)
    p.select_keypoints("subsampling", neighborhood_size=0.25)
    p.compute_descriptors(radius=0.5, descriptor_choice="shot_single_scale",
                          subsample_support=False, min_neighborhood_size=10)
    before = _kernels.launch_counts["top2_match"]
    p.find_descriptors_matches("simple")
    assert _kernels.launch_counts["top2_match"] == before + 1
    tf_ransac, _ = p.run_ransac(n_draws=2000, draw_size=4, max_inliers_distance=0.1)
    tf_icp, _, _ = p.run_icp("point_to_plane", tf_ransac, d_max=0.3, voxel_size=0.1,
                             max_iter=40, rms_threshold=1e-5)
    rot = tf_icp.rotation.double().cpu().numpy()
    t = tf_icp.translation.double().cpu().numpy()
    ate = float(np.sqrt(np.mean(np.sum(
        (scan @ rot.T + t - (scan @ data["rot_gt"].T + data["t_gt"])) ** 2, axis=1))))
    assert float(rotation_angle(torch.tensor(rot),
                                torch.tensor(measured["rotation"], dtype=torch.float64))) < 1e-3
    assert np.linalg.norm(t - np.array(measured["translation"])) < 1e-3
    assert ate < 1e-3
