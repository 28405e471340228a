"""Multiscale SHOT (``ShotComputer.compute_descriptor_multiscale``) against
the benchmark's plain reference (``regbench/reference/shot_multiscale.py``,
plain PyTorch, nothing of the port) on a 12,000-point terrain patch, on the
brute route and on the grid route (``AUTO_GRID_MIN_POINTS`` lowered): two
scales at ``radius · phi^s``, each on its own support subsampled at its
radius / ``rho``, both binned under the first scale's frames, as
``shot-multiscale-1m`` runs them.

Tolerance: per scale, the 90th percentile of the rows' relative L2 error
under 1e-5, the reference's float64 against the port's float32 (a sign
vote tied within one neighbour flips a few frames, as for single-scale
SHOT), and the same all-zero rows.  Scale 1 binned under its own frames
(the reference without ``share_local_rfs``) fails it."""

import json
from pathlib import Path

import pytest
import torch

from regbench import generator
from regbench.reference import shot_multiscale
from shot_fpfh_tpu_torch.models import shot as t_shot
from shot_fpfh_tpu_torch.models.normals import compute_normals
from shot_fpfh_tpu_torch.ops import grid_hash

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "regbench"
# the configuration's descriptor at a tenth of its radius: scales at 0.3
# and 0.9 on supports at 0.03 (10,911 points) and 0.09 (5,546), every
# neighbourhood under K_MAX, so the brute route's cap binds nowhere; at 60
# neighbours 40 of the 128 keypoints have an all-zero first scale and a
# whole second one
DESC = dict(json.loads((BENCH / "configs" / "shot-multiscale-1m.json").read_text())["descriptor"],
            radius=0.3, min_neighborhood_size=60)
RADII = [DESC["radius"] * DESC["phi"] ** s for s in range(DESC["n_scales"])]
K_MAX = 2048
DIM = 352


@pytest.fixture(scope="module")
def patch():
    traffic = json.loads((BENCH / "traffic" / "dense.json").read_text())
    traffic.update(points=12000, extent=3.0)
    cloud = torch.as_tensor(generator.make_pair(traffic, 2147483701, 0, "cpu").ref)
    normals = compute_normals(cloud, cloud, k=30, device="cpu")
    keypoints = torch.cat([torch.arange(0, len(cloud), 97),
                           torch.argsort(cloud[:, 0] + cloud[:, 1])[:4]])
    want = shot_multiscale.descriptors(cloud, normals.double(), keypoints, {"descriptor": DESC},
                                       torch.float64)
    return cloud, normals, keypoints, want


def _multiscale(patch, monkeypatch, route):
    """The port's rows and the frames each scale was given."""
    cloud, normals, keypoints, _ = patch
    monkeypatch.setattr(grid_hash, "AUTO_GRID_MIN_POINTS", 1000 if route == "grid" else 20_000)
    grids, given = [], []
    build, shot = t_shot.build_grid, t_shot.ShotComputer._shot
    monkeypatch.setattr(t_shot, "build_grid", lambda *a, **k: grids.append(1) or build(*a, **k))

    def recorded(self, kp, sup, nrm, radius, local_rfs=None, rf_radius=None):
        out = shot(self, kp, sup, nrm, radius, local_rfs=local_rfs, rf_radius=rf_radius)
        given.append((local_rfs, out[1]))
        return out

    monkeypatch.setattr(t_shot.ShotComputer, "_shot", recorded)
    computer = t_shot.ShotComputer(min_neighborhood_size=DESC["min_neighborhood_size"],
                                   k_max=K_MAX, device="cpu")
    pts = cloud.float()
    got = computer.compute_descriptor_multiscale(
        pts, normals, pts[keypoints], RADII, voxel_sizes=[r / DESC["rho"] for r in RADII])
    assert len(grids) == (2 if route == "grid" else 0)
    return got.double(), given


def _p90_err(got, want):
    err = (got - want).norm(dim=1) / want.norm(dim=1).clamp(min=1e-12)
    return float(torch.quantile(err, 0.9))


@pytest.mark.parametrize("route", ["brute", "grid"])
def test_multiscale_equals_the_plain_reference(patch, monkeypatch, route):
    want = patch[3]
    got, _ = _multiscale(patch, monkeypatch, route)
    assert got.shape == want.shape == (len(patch[2]), 2 * DIM)
    for s in range(2):
        g, w = got[:, s * DIM:(s + 1) * DIM], want[:, s * DIM:(s + 1) * DIM]
        assert _p90_err(g, w) < 1e-5, s
        assert torch.equal(g.norm(dim=1) == 0, w.norm(dim=1) == 0), s


@pytest.mark.parametrize("route", ["brute", "grid"])
def test_scale_one_takes_the_frames_of_scale_zero(patch, monkeypatch, route):
    got, given = _multiscale(patch, monkeypatch, route)
    (first_given, first_frames), (second_given, _) = given
    assert first_given is None and second_given is first_frames
    cloud, normals, keypoints, _ = patch
    own = shot_multiscale.descriptors(cloud, normals.double(), keypoints,
                                      {"descriptor": dict(DESC, share_local_rfs=False)},
                                      torch.float64)
    assert torch.equal(own[:, :DIM], patch[3][:, :DIM])
    assert _p90_err(got[:, DIM:], own[:, DIM:]) > 1e-2


def test_a_zero_row_at_one_scale_leaves_the_other(patch, monkeypatch):
    want = patch[3]
    got, _ = _multiscale(patch, monkeypatch, "grid")
    zero_first = want[:, :DIM].norm(dim=1) == 0
    assert 0 < int(zero_first.sum()) < len(want) // 2
    assert not bool(got[zero_first, :DIM].any())
    assert bool((got[zero_first, DIM:].norm(dim=1) > 0).all())
    assert _p90_err(got[zero_first, DIM:], want[zero_first, DIM:]) < 1e-5
