"""The plain reference against the program's CPU paths on small clouds,
where both state the same semantics: the reference imports nothing of the
program; these tests hold the two side by side."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from regbench import generator
from regbench.compare import normal_angles
from regbench.reference import common, fpfh, shot_single_scale
from regbench.tests._tiny import BENCH, TINY_TRAFFIC
from shot_fpfh_tpu_torch.core.subsampling import grid_subsample
from shot_fpfh_tpu_torch.core.transform import RigidTransform
from shot_fpfh_tpu_torch.keypoints import select_keypoints_with_density_threshold
from shot_fpfh_tpu_torch.models.fpfh import compute_fpfh_descriptor
from shot_fpfh_tpu_torch.models.normals import compute_normals
from shot_fpfh_tpu_torch.models.shot import compute_shot_descriptor
from shot_fpfh_tpu_torch.registration.icp import icp_point_to_plane
from shot_fpfh_tpu_torch.registration.ransac import ransac_on_matches, sample_draws

CFG = json.loads((BENCH / "configs" / "shot-1m.json").read_text())
F64 = torch.float64


@pytest.fixture(scope="module")
def pair():
    torch.set_num_threads(2)
    traffic = json.loads((BENCH / "traffic" / "dense.json").read_text())
    traffic.update(TINY_TRAFFIC)
    return generator.make_pair(traffic, 2147483701, 0, "cpu")


@pytest.fixture(scope="module")
def normals(pair):
    return compute_normals(pair.ref, pair.ref, k=30, device="cpu")


def test_pair_is_the_motion_it_states(pair):
    moved = pair.scan @ pair.rotation.T + pair.translation
    assert np.abs(moved - pair.ref).max() < 0.05          # the two clouds' noise
    angle = generator.rotation_angle(pair.rotation)
    assert angle == pytest.approx(generator.rotation_angle(
        generator.euler_xyz((0.2, -0.1, 0.4))))
    assert np.linalg.norm(pair.translation) == pytest.approx(np.linalg.norm((0.8, -0.5, 0.3)))


def test_voxel_rule_picks_the_programs_representatives(pair):
    pts = torch.as_tensor(pair.ref, dtype=torch.float32)
    for voxel in (0.06, 0.15, 0.2):
        reps, _ = common.voxel_representatives(pts, voxel, torch.float32)
        assert torch.equal(reps, torch.as_tensor(grid_subsample(pts, voxel)))
    want = select_keypoints_with_density_threshold(pts, 0.15, 5, device="cpu")
    got = common.density_keypoints(pts, 0.15, 5, torch.float32)
    assert torch.equal(got, torch.as_tensor(want))


def test_radius_pairs_are_exact_and_a_point_is_not_its_own_neighbour_at_d_above_0():
    """The expanded distance form cancels (a point ~1e-7 from itself, which
    FPFH's 1/d weight would blow up); the pairs' distances do not."""
    gen = torch.Generator().manual_seed(0)
    pts = (torch.rand((20000, 3), generator=gen, dtype=F64) * 40 - 20).float().double()
    pts[:, 2] *= 0.05
    idx = torch.arange(0, 20000, 7)
    count = 0
    for qi, j, d in common.radius_pairs(pts[idx], common.Strips(pts), 3.0):
        assert float(d[idx[qi] == j].abs().max()) == 0.0 and float(d.max()) <= 3.0
        count += qi.numel()
    assert count == int((torch.cdist(pts[idx], pts) <= 3.0).sum())


def test_knn_normals_equal_the_programs_below_its_grid(pair, normals):
    idx = torch.arange(0, len(pair.ref), 37)
    want = common.knn_normals(torch.as_tensor(pair.ref), idx, 30, F64)
    assert float(normal_angles(normals[idx], want).max()) < 1e-5


@pytest.mark.parametrize("radius", [0.6, CFG["descriptor"]["radius"]])
def test_shot_equals_the_programs(pair, normals, radius):
    cfg = dict(CFG, descriptor=dict(CFG["descriptor"], radius=radius))
    cloud = torch.as_tensor(pair.ref)
    kp = torch.arange(0, len(pair.ref), 151)
    pts = cloud.float()
    sup = torch.as_tensor(grid_subsample(pts, radius / CFG["descriptor"]["rho"]))
    want, _ = compute_shot_descriptor(pts[kp], pts[sup], normals[sup], radius, device="cpu")
    got = shot_single_scale.descriptors(cloud, normals.double(), kp, cfg, F64)
    err = (got - want.double()).norm(dim=1) / want.double().norm(dim=1).clamp(min=1e-12)
    assert float(torch.quantile(err, 0.9)) < 1e-5
    assert int((want.norm(dim=1) == 0).sum()) == int((got.norm(dim=1) == 0).sum())


def test_fpfh_equals_the_programs_where_no_cap_binds(pair, normals):
    # radius 0.3: every neighbourhood under the brute route's 128 cap, which
    # the program's grid route (the benchmark's size) does not have
    cfg = dict(CFG, descriptor=dict(CFG["descriptor"], radius=0.3))
    cloud = torch.as_tensor(pair.ref)
    kp = torch.arange(0, len(pair.ref), 151)
    want = compute_fpfh_descriptor(kp, cloud.float(), normals, 0.3, device="cpu")
    got = fpfh.descriptors(cloud, normals.double(), kp, cfg, F64)
    err = (got - want.double()).norm(dim=1) / want.double().norm(dim=1).clamp(min=1e-12)
    assert float(torch.quantile(err, 0.9)) < 1e-5


def test_ransac_draws_and_best_draw_equal_the_programs(pair):
    rng = np.random.default_rng(3)
    n = 400
    idx = rng.choice(len(pair.scan), n, replace=False)
    scan_m = torch.as_tensor(pair.scan[idx])
    ref_m = torch.as_tensor(pair.ref[idx])
    ref_m[: n // 2] = ref_m[torch.randperm(n // 2, generator=torch.Generator().manual_seed(0))]
    draws = common.ransac_draws(n, 2000, 4, 72)
    assert torch.equal(draws, sample_draws(n, 2000, 4, torch.Generator().manual_seed(72)))
    _, tf = ransac_on_matches(scan_m.float(), ref_m.float(), draws=draws, distance_threshold=1.0)
    rot, t = common.ransac(scan_m, ref_m, draws, 1.0, F64)
    assert common.angle_between(tf.rotation, rot) < 1e-5
    assert float((tf.translation.double() - t).norm()) < 1e-4


def test_icp_equals_the_programs(pair, normals):
    init = RigidTransform(torch.as_tensor(pair.rotation, dtype=torch.float32),
                          torch.as_tensor(pair.translation + 0.05, dtype=torch.float32))
    out = icp_point_to_plane(pair.scan, pair.ref, normals, init, d_max=0.5, voxel_size=0.2,
                             max_iter=50, rms_threshold=1e-3, device="cpu")
    rot, t, _ = common.icp_point_to_plane(
        torch.as_tensor(pair.scan), torch.as_tensor(pair.ref), normals.double(),
        init.rotation.double(), init.translation.double(), d_max=0.5, voxel=0.2,
        max_iter=50, rms_threshold=1e-3, dtype=F64)
    assert common.angle_between(out.transform.rotation, rot) < 1e-5
    assert float((out.transform.translation.double() - t).norm()) < 1e-4
