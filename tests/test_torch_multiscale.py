"""Port parity: bi-scale and multiscale SHOT — K1's bi-scale mode and K5
(SHOT over the grid's xy-row runs) through their plain twins,
``ShotComputer``'s bi-scale and multiscale drivers on the brute and grid
routes and K5 on their grid supports, the pipeline's per-scale methods with a 704-column state
``.npz``, and the CLI.

Tolerances: K1 bi-scale frames atol 2e-4 and histograms atol 5e-3 / rtol
1e-2 under the JAX kernel's frames (``tests/test_pallas_shot_fused.py:104-130``);
K5 by ``tests/test_pallas_shot_dma.py`` (frames atol 5e-4, at most 3e-3 of
descriptor elements off by > 5e-3 and none by > 0.1, given frames atol
5e-3); descriptors of whole drivers by the flip rule of
``tests/test_torch_shot.py``; CLI transforms within 1e-3 of JAX's.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _windows import window_case  # noqa: E402
from test_torch_fpfh import _bumpy, surface  # noqa: E402
from test_torch_shot import assert_flip_rule  # noqa: E402

from shot_fpfh_tpu.models import shot as j_shot  # noqa: E402
from shot_fpfh_tpu.ops import grid_hash as j_grid  # noqa: E402
from shot_fpfh_tpu.ops.pallas_shot_fused import shot_binning_histogram as j_kernel  # noqa: E402
from shot_fpfh_tpu_torch import _kernels  # noqa: E402
from shot_fpfh_tpu_torch.models import shot as t_shot  # noqa: E402
from shot_fpfh_tpu_torch.ops import grid_hash as t_grid  # noqa: E402
from shot_fpfh_tpu_torch.ops import shot_dma  # noqa: E402
from shot_fpfh_tpu_torch.ops.shot_fused import shot_binning_histogram  # noqa: E402

# The suite runs several pytest workers side by side on the CPU: one torch
# thread per worker keeps torch's OpenMP pool from oversubscribing the cores.
torch.set_num_threads(1)


def _assert_dma_rule(got, want, frac=3e-3, hard=0.1):
    dd = np.abs(np.asarray(got) - np.asarray(want))
    assert (dd > 5e-3).mean() <= frac and dd.max() <= hard, (dd.max(), (dd > 5e-3).mean())


def test_k1_bi_scale_plain_matches_reference_kernel(rng):
    """Frames from the rf plane, bins from the descriptor plane; a keypoint
    whose rf plane is empty but whose descriptor plane is not gets the
    identity frame."""
    kp, vals, dist_inf = window_case(rng, q=12, w=160, radius=1.2)
    radius, rf_radius = 1.2, 0.6
    rf_dist_inf = np.where(dist_inf <= rf_radius, dist_inf, np.inf).astype(np.float32)
    rf_dist_inf[3] = np.inf
    assert np.isfinite(dist_inf[3]).any()
    jargs = [jnp.asarray(a) for a in (vals, dist_inf, kp)]
    j_hist, j_rfs = j_kernel(*jargs, None, radius, rf_dist_inf=jnp.asarray(rf_dist_inf),
                             rf_radius=rf_radius, interpret=True)
    targs = [torch.tensor(a) for a in (vals, dist_inf, kp)]
    before = dict(_kernels.launch_counts)
    t_hist, t_rfs = shot_binning_histogram(*targs, None, radius,
                                           rf_dist_inf=torch.tensor(rf_dist_inf),
                                           rf_radius=rf_radius)
    assert _kernels.launch_counts == before        # CPU tensors: plain twin
    np.testing.assert_allclose(t_rfs.numpy(), np.asarray(j_rfs), atol=2e-4)
    np.testing.assert_array_equal(t_rfs[3].numpy(), np.eye(3, dtype=np.float32))
    # the port's frames are those of the JAX XLA path on the rf plane
    ok_rf = jnp.isfinite(jnp.asarray(rf_dist_inf))
    x_rfs = jax.jit(j_shot._local_rfs_ff, static_argnums=3)(
        jnp.where(ok_rf[:, None, :], jargs[0][:, :3] - jargs[2][:, :, None], 0.0),
        jnp.where(ok_rf, jnp.asarray(rf_dist_inf), 0.0), ok_rf, rf_radius)
    np.testing.assert_allclose(t_rfs.numpy(), np.asarray(x_rfs), atol=2e-4)
    # histograms under the JAX kernel's own frames
    t_given = shot_binning_histogram(*targs, torch.tensor(np.asarray(j_rfs)), radius)
    np.testing.assert_allclose(t_given.numpy(), np.asarray(j_hist), atol=5e-3, rtol=1e-2)
    assert float(t_hist.sum()) > 0


def _xla_reference(grid, q, radius, min_nb, rfs=None, rf_radius=None):
    """The JAX XLA window path (``tests/test_pallas_shot_dma.py:34-50``)."""
    vals, d, ok, _ = j_grid.window_distances(grid, q)
    dist_inf = jnp.where(ok & (d <= radius), d, jnp.inf)
    rf_dist_inf = None
    if rf_radius is not None:
        rf_dist_inf = jnp.where(ok & (d <= rf_radius), d, jnp.inf)
    return j_shot.shot_from_window_ff(q, vals, dist_inf, radius, normalize=True,
                                      min_neighborhood_size=min_nb, local_rfs=rfs,
                                      rf_dist_inf=rf_dist_inf, rf_radius=rf_radius)


@pytest.mark.parametrize("mode", ["own", "given", "bi_scale"])
def test_k5_plain_matches_reference_window_path(rng, mode):
    """K5's twin against the JAX XLA window path on one xy-row grid: 41
    surface keypoints, one lifted off the surface (its rf plane is empty in
    bi-scale mode, not its descriptor plane) and one far sentinel, 43 in
    all."""
    pts, nrm = surface(2600, rng, scale=3.0)
    radius = 0.9
    rf_radius = 0.3 if mode == "bi_scale" else None
    q = np.concatenate([pts[:41], pts[41:42] + np.float32([0, 0, 0.5]),
                        np.full((1, 3), 1e6, np.float32)])
    jg = j_grid.build_grid(pts, radius / 2, extras=nrm, halo=2)
    tg = t_grid.build_grid(pts, radius / 2, extras=nrm, halo=2, device="cpu")
    assert shot_dma._check_run_grid(tg, radius) > 0
    want, want_rfs = _xla_reference(jg, jnp.asarray(q), radius, 10, rf_radius=rf_radius)
    rfs = None
    if mode == "given":
        rfs = want_rfs
        want, _ = _xla_reference(jg, jnp.asarray(q), radius, 10, rfs=rfs)
    before = dict(_kernels.launch_counts)
    got, got_rfs = shot_dma.shot_descriptor_dma(
        tg, torch.tensor(q), radius, rfs=None if rfs is None else torch.tensor(np.asarray(rfs)),
        rf_radius=rf_radius, min_neighborhood_size=10)
    assert _kernels.launch_counts == before        # CPU tensors: plain twin
    assert got.shape == (43, 352) and got_rfs.shape == (43, 3, 3)
    if mode == "given":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3)
    else:
        np.testing.assert_allclose(got_rfs.numpy()[:42], np.asarray(want_rfs)[:42], atol=5e-4)
        _assert_dma_rule(got.numpy()[:42], np.asarray(want)[:42])
    assert bool(got[:41].any(dim=1).all())
    # far sentinel: empty runs, zero descriptor, identity frame
    assert not got[42].any()
    np.testing.assert_array_equal(got_rfs[42].numpy(), np.eye(3, dtype=np.float32))
    if mode == "bi_scale":
        np.testing.assert_array_equal(got_rfs[41].numpy(), np.eye(3, dtype=np.float32))
        assert got[41].any()


@pytest.fixture
def grid_route(monkeypatch):
    """Lower the auto-grid threshold in both packages to reach the grid
    routes on small clouds."""
    for mod in (j_grid, t_grid):
        monkeypatch.setattr(mod, "AUTO_GRID_MIN_POINTS", 2000)


@pytest.mark.parametrize("route", ["brute", "window"])
def test_shot_computer_bi_scale_and_multiscale(rng, grid_route, route, monkeypatch):
    pts, nrm = surface(2600, rng, scale=3.0)
    kp = pts[::37]
    if route == "brute":
        for mod in (j_grid, t_grid):
            monkeypatch.setattr(mod, "AUTO_GRID_MIN_POINTS", 20_000)
    j = j_shot.ShotComputer(min_neighborhood_size=10, k_max=256)
    t = t_shot.ShotComputer(min_neighborhood_size=10, k_max=256, device="cpu")
    bi_j = j.compute_descriptor_bi_scale(pts, nrm, kp, 0.3, 0.9, subsampling_voxel_size=0.03)
    bi_t = t.compute_descriptor_bi_scale(pts, nrm, kp, 0.3, 0.9, subsampling_voxel_size=0.03)
    assert bi_t.shape == (len(kp), 352)
    assert_flip_rule(bi_t.numpy(), bi_j)
    # the supports at voxel 0.03 (2544 points, above the lowered threshold)
    # take the grid route; multiscale's scale 2 (voxel 0.12, 1693 points)
    # the brute route with the first scale's frames
    ms_j = j.compute_descriptor_multiscale(pts, nrm, kp, [0.3, 0.9], voxel_sizes=[0.03, 0.12],
                                           weights=[1.0, 0.5])
    ms_t = t.compute_descriptor_multiscale(pts, nrm, kp, [0.3, 0.9], voxel_sizes=[0.03, 0.12],
                                           weights=[1.0, 0.5])
    assert ms_t.shape == (len(kp), 704)
    assert_flip_rule(ms_t.numpy(), ms_j)
    for half in (ms_t[:, :352], ms_t[:, 352:]):
        assert float(half.any(dim=1).float().mean()) > 0.9


@pytest.mark.parametrize("mode", ["bi_scale", "multiscale"])
def test_k5_on_shot_computer_supports(rng, grid_route, mode):
    """K5's wrapper (its twin on CPU tensors) on the grid ``ShotComputer``
    builds over its voxel-0.03 support (2,544 points, halo 2): bi-scale
    (frames at 0.3, bins at 0.9) against JAX's bi-scale driver, and the
    first scale of multiscale (radius 0.3, weight 1) against JAX's first
    352 columns, by the flip rule."""
    pts, nrm = surface(2600, rng, scale=3.0)
    kp = pts[::37]
    t = t_shot.ShotComputer(min_neighborhood_size=10, k_max=256, device="cpu")
    j = j_shot.ShotComputer(min_neighborhood_size=10, k_max=256)
    sup, sup_nrm = t._support(pts, nrm, 0.03)
    radius, rf_radius = (0.9, 0.3) if mode == "bi_scale" else (0.3, None)
    grid = t_grid.build_grid(sup, radius / 2, extras=sup_nrm, halo=2)
    got, _ = shot_dma.shot_descriptor_dma(grid, torch.tensor(kp), radius, rf_radius=rf_radius,
                                          min_neighborhood_size=10)
    if mode == "bi_scale":
        want = j.compute_descriptor_bi_scale(pts, nrm, kp, 0.3, 0.9,
                                             subsampling_voxel_size=0.03)
    else:
        want = j.compute_descriptor_multiscale(pts, nrm, kp, [0.3, 0.9],
                                               voxel_sizes=[0.03, 0.12],
                                               weights=[1.0, 0.5])[:, :352]
    assert got.shape == (len(kp), 352) and float(got.any(dim=1).float().mean()) > 0.9
    assert_flip_rule(got.numpy(), np.asarray(want))


def test_multiscale_unshared_frames(rng, grid_route):
    pts, nrm = surface(2600, rng, scale=3.0)
    kp = pts[::53]
    args = (pts, nrm, kp, [0.3, 0.6], [0.03, 0.03])
    j = j_shot.ShotComputer(share_local_rfs=False, min_neighborhood_size=10)
    t = t_shot.ShotComputer(share_local_rfs=False, min_neighborhood_size=10, device="cpu")
    got = t.compute_descriptor_multiscale(*args)
    assert_flip_rule(got.numpy(), j.compute_descriptor_multiscale(*args))
    # shared frames: scale 2 takes the grid route with given frames
    shared = t_shot.ShotComputer(min_neighborhood_size=10, device="cpu")
    shared_desc = shared.compute_descriptor_multiscale(*args)
    assert_flip_rule(shared_desc.numpy(),
                     j_shot.ShotComputer(min_neighborhood_size=10).compute_descriptor_multiscale(
                         *args))
    assert not torch.equal(got[:, 352:], shared_desc[:, 352:])


def test_per_scale_api_and_state_roundtrip(tmp_path, rng):
    """``tests/test_pipeline.py:183-216`` across the packages: JAX writes a
    704-column multiscale state that the port resumes, and the port's
    per-scale methods agree with JAX's."""
    from test_pipeline import make_pair

    from shot_fpfh_tpu.models.normals import compute_normals
    from shot_fpfh_tpu.pipeline import RegistrationPipeline as JPipeline
    from shot_fpfh_tpu_torch.pipeline import RegistrationPipeline

    scan, ref, _ = make_pair(rng, n=800)
    scan_n = np.asarray(compute_normals(scan, scan, k=15))
    ref_n = np.asarray(compute_normals(ref, ref, k=15))
    clouds = dict(scan=scan, scan_normals=scan_n, ref=ref, ref_normals=ref_n)
    j = JPipeline(**clouds, k_max_descriptor=128)
    t = RegistrationPipeline(**clouds, k_max_descriptor=128, device="cpu")
    for p in (j, t):
        p.select_keypoints("subsampling", neighborhood_size=0.5)
    np.testing.assert_array_equal(t.scan_keypoints, j.scan_keypoints)
    for method, kwargs, width in (
            ("compute_shot_descriptor_single_scale", dict(radius=0.6), 352),
            ("compute_shot_descriptor_bi_scale", dict(local_rf_radius=0.4, shot_radius=0.8), 352),
            ("compute_shot_descriptor_multiscale", dict(radii=[0.4, 0.8]), 704)):
        for p in (j, t):
            getattr(p, method)(force_recompute=True, min_neighborhood_size=5, **kwargs)
        assert t.scan_descriptors.shape == (len(t.scan_keypoints), width)
        for side in ("scan", "ref"):
            assert_flip_rule(getattr(t, f"{side}_descriptors").numpy(),
                             getattr(j, f"{side}_descriptors"))
    j.find_descriptors_matches("simple")
    j.save_state(str(tmp_path / "jax.npz"))
    back = RegistrationPipeline(**clouds, device="cpu")
    assert back.load_state(str(tmp_path / "jax.npz"))
    assert back.scan_descriptors.shape[1] == 704
    np.testing.assert_array_equal(back.ref_descriptors, np.asarray(j.ref_descriptors))
    np.testing.assert_array_equal(back.matches[0], j.matches[0])
    t.find_descriptors_matches("simple")
    t.save_state(str(tmp_path / "torch.npz"))
    again = JPipeline(**clouds)
    assert again.load_state(str(tmp_path / "torch.npz"))
    np.testing.assert_array_equal(again.scan_descriptors, t.scan_descriptors.numpy())


def test_cli_multiscale_flags_reach_the_config():
    from shot_fpfh_tpu_torch.cli import _DEFAULT_CONFIG, parse_args
    from shot_fpfh_tpu_torch.configuration import load_config_from_yaml

    desc = load_config_from_yaml(_DEFAULT_CONFIG, vars(parse_args(
        ["--phi", "2.5", "--n_scales", "3", "--no-share_local_rfs"])))["descriptor"]
    assert (desc.phi, desc.n_scales, desc.share_local_rfs) == (2.5, 3, False)
    desc = load_config_from_yaml(_DEFAULT_CONFIG, vars(parse_args([])))["descriptor"]
    assert (desc.phi, desc.n_scales, desc.share_local_rfs) == (3.0, 2, True)


@pytest.mark.parametrize("choice", ["shot_bi_scale", "shot_multiscale"])
def test_cli_matches_reference_cli(tmp_path, choice):
    from shot_fpfh_tpu.cli import main as j_main
    from shot_fpfh_tpu_torch.cli import main as t_main
    from shot_fpfh_tpu_torch.core.transform import RigidTransform, rotation_angle
    from shot_fpfh_tpu_torch.io.ply import write_ply
    from test_torch_slice import _assert_close, _recovered, _rotation_about

    rng = np.random.default_rng(7)
    ref = _bumpy(1500, rng).astype(np.float32)
    rot = _rotation_about([0.2, -0.4, 1.0], np.deg2rad(20.0))
    trans = np.array([0.3, -0.2, 0.1])
    scan = (ref @ rot.T + trans).astype(np.float32)
    write_ply(str(tmp_path / "scan.ply"), [scan], ["x", "y", "z"])
    write_ply(str(tmp_path / "ref.ply"), [ref], ["x", "y", "z"])
    common = ["--scan_file_path", str(tmp_path / "scan.ply"),
              "--ref_file_path", str(tmp_path / "ref.ply"), "--conf_file_path", "",
              "--normals_k", "20", "--selection_algorithm", "subsampling",
              "--neighborhood_size", "0.2", "--descriptor_choice", choice,
              "--radius", "0.3", "--phi", "2", "--n_scales", "2", "--rho", "30",
              "--min_neighborhood_size", "10", "--k_max_descriptor", "256",
              "--matching_algorithm", "ratio", "--reject_threshold", "0.95",
              "--n_draws", "1500", "--max_inliers_distance", "0.1", "--d_max", "0.3",
              "--voxel_size", "0.1", "--max_iter", "40", "--rms_threshold", "1e-4"]
    assert t_main(common + ["--device", "cpu", "--output_dir", str(tmp_path / "torch")]) == 0
    assert j_main(common + ["--n_devices", "1", "--output_dir", str(tmp_path / "jax")]) == 0
    gt = RigidTransform.from_numpy(rot.T, -rot.T @ trans, dtype=torch.float64)
    got_t = _recovered(tmp_path / "torch" / "scan_on_ref_post_icp.ply", scan)
    got_j = _recovered(tmp_path / "jax" / "scan_on_ref_post_icp.ply", scan)
    _assert_close(got_t, got_j)
    assert float(rotation_angle(got_t.rotation, gt.rotation)) < 1e-2
