"""Bi-scale SHOT (``ShotComputer.compute_descriptor_bi_scale``) against the
benchmark's plain reference (``regbench/reference/shot_bi_scale.py``,
plain PyTorch, nothing of the port) on a 12,000-point terrain patch, on the
brute route and on the grid window route (``AUTO_GRID_MIN_POINTS``
lowered): frames at ``radius``, bins at ``radius · phi`` over the support
subsampled at ``radius / rho``, as ``shot-biscale-1m`` runs them.

Tolerance: the 90th percentile of the rows' relative L2 error under 1e-5,
the reference's float64 against the port's float32 (a bin edge crossed in
float32 moves a few rows by more, as for single-scale SHOT), and the same
count of all-zero rows.  Frames taken at the bin radius (single-scale SHOT
at ``radius · phi``) fail it."""

import json
from pathlib import Path

import pytest
import torch

from regbench import generator
from regbench.reference import shot_bi_scale
from shot_fpfh_tpu_torch.models import shot as t_shot
from shot_fpfh_tpu_torch.models.normals import compute_normals
from shot_fpfh_tpu_torch.ops import grid_hash

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "regbench"
# the configuration's descriptor at a tenth of its radius: r_f 0.3, r_s 0.9
# on a support at 0.03 (every neighbourhood under K_MAX, so the brute
# route's cap binds nowhere); 300 neighbours, so the patch's corners give
# all-zero rows
DESC = dict(json.loads((BENCH / "configs" / "shot-biscale-1m.json").read_text())["descriptor"],
            radius=0.3, min_neighborhood_size=300)
K_MAX = 2048


@pytest.fixture(scope="module")
def patch():
    traffic = json.loads((BENCH / "traffic" / "dense.json").read_text())
    traffic.update(points=12000, extent=3.0)
    cloud = torch.as_tensor(generator.make_pair(traffic, 2147483701, 0, "cpu").ref)
    normals = compute_normals(cloud, cloud, k=30, device="cpu")
    keypoints = torch.cat([torch.arange(0, len(cloud), 97),
                           torch.argsort(cloud[:, 0] + cloud[:, 1])[:4]])
    want = shot_bi_scale.descriptors(cloud, normals.double(), keypoints, {"descriptor": DESC},
                                     torch.float64)
    return cloud, normals, keypoints, want


def _bi_scale(patch, monkeypatch, route, rf_radius):
    cloud, normals, keypoints, _ = patch
    monkeypatch.setattr(grid_hash, "AUTO_GRID_MIN_POINTS", 2000 if route == "grid" else 20_000)
    grids = []
    build = t_shot.build_grid
    monkeypatch.setattr(t_shot, "build_grid", lambda *a, **k: grids.append(1) or build(*a, **k))
    computer = t_shot.ShotComputer(min_neighborhood_size=DESC["min_neighborhood_size"],
                                   k_max=K_MAX, device="cpu")
    r = DESC["radius"]
    pts = cloud.float()
    got = computer.compute_descriptor_bi_scale(
        pts, normals, pts[keypoints], local_rf_radius=rf_radius, shot_radius=r * DESC["phi"],
        subsampling_voxel_size=r / DESC["rho"])
    assert len(grids) == (route == "grid")
    return got.double()


def _p90_err(got, want):
    err = (got - want).norm(dim=1) / want.norm(dim=1).clamp(min=1e-12)
    return float(torch.quantile(err, 0.9))


@pytest.mark.parametrize("route", ["brute", "grid"])
def test_bi_scale_equals_the_plain_reference(patch, monkeypatch, route):
    want = patch[3]
    got = _bi_scale(patch, monkeypatch, route, DESC["radius"])
    zero_want = int((want.norm(dim=1) == 0).sum())
    assert 0 < zero_want < want.shape[0] // 4
    assert _p90_err(got, want) < 1e-5
    assert int((got.norm(dim=1) == 0).sum()) == zero_want


@pytest.mark.parametrize("route", ["brute", "grid"])
def test_frames_at_the_bin_radius_fail_the_comparison(patch, monkeypatch, route):
    got = _bi_scale(patch, monkeypatch, route, DESC["radius"] * DESC["phi"])
    assert _p90_err(got, patch[3]) > 1e-2
