"""Port parity: FPFH — binning, Darboux angles, K4 and K6 (plain twins),
FPFH descriptors on both routes, the FPFH CLI slice, and the device default
of every public entry point.

Tolerances: bins and histograms exact (counts of dyadic weights); angles
atol 1e-6; K4 atol 1e-5 (``tests/test_pallas_fpfh_fused.py:45``); K6 and
grid-route FPFH by the reference's rule for two SPFH routes
(``tests/test_pallas_shot_dma.py``): at most 1e-3 of elements off by more
than 1e-4 (one neighbor moving bin moves 1/count), row sums within 1e-3;
brute-route FPFH atol 5e-3 against the numpy oracle of
``tests/test_fpfh.py`` and 1e-5 against JAX; the CLI transforms within
1e-3 of each other and JAX's FPFH envelope (0.03 rad) of the ground truth.
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from _windows import window_case  # noqa: E402
from test_fpfh import make_test_cloud, numpy_fpfh  # noqa: E402

from shot_fpfh_tpu.models import fpfh as j_fpfh  # noqa: E402
from shot_fpfh_tpu.ops import descriptor_bins as j_bins  # noqa: E402
from shot_fpfh_tpu.ops import grid_hash as j_grid  # noqa: E402
from shot_fpfh_tpu.ops import histogram as j_hist  # noqa: E402
from shot_fpfh_tpu.ops.pallas_fpfh_fused import spfh_histogram as j_spfh_histogram  # noqa: E402
from shot_fpfh_tpu.ops.pallas_radius import tile_table  # noqa: E402
from shot_fpfh_tpu.ops.pallas_shot_dma import spfh_block_dma as j_spfh_block_dma  # noqa: E402
from shot_fpfh_tpu_torch import _device, _kernels  # noqa: E402
from shot_fpfh_tpu_torch.models import fpfh as t_fpfh  # noqa: E402
from shot_fpfh_tpu_torch.ops import descriptor_bins as t_bins  # noqa: E402
from shot_fpfh_tpu_torch.ops import grid_hash as t_grid  # noqa: E402
from shot_fpfh_tpu_torch.ops import histogram as t_hist  # noqa: E402
from shot_fpfh_tpu_torch.ops import shot_dma, spfh_fused  # noqa: E402
from shot_fpfh_tpu_torch.ops.spfh_fused import spfh_histogram  # noqa: E402

# The suite runs several pytest workers side by side on the CPU: one torch
# thread per worker keeps torch's OpenMP pool from oversubscribing the cores
# (it slowed every worker, JAX tests included, by up to 2x).
torch.set_num_threads(1)


def assert_route_rule(got, want):
    """Two SPFH routes agree up to a per-mille of bin flips (1/count each)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    dd = np.abs(got - want)
    assert (dd > 1e-4).mean() <= 1e-3, (dd.max(), (dd > 1e-4).mean())
    np.testing.assert_allclose(got.sum(axis=1), want.sum(axis=1), atol=1e-3)


def surface(n, rng, scale):
    """The wavy surface of tests/test_pallas_shot_dma.py with random unit
    normals."""
    xy = rng.uniform(-scale, scale, size=(n, 2))
    z = 0.4 * np.sin(1.2 * xy[:, 0]) * np.cos(xy[:, 1])
    pts = (np.column_stack([xy, z]) + rng.normal(scale=0.01, size=(n, 3))).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    return pts, (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)


def test_binning_matches_reference_exactly(rng):
    for lo, hi in ((-1.0, 1.0), (-np.pi / 2, np.pi / 2)):
        lo32, hi32 = np.float32(lo), np.float32(hi)
        width = np.float32((hi - lo) / 5)
        x = np.concatenate([
            rng.uniform(lo - 0.3, hi + 0.3, 2000),
            [lo32, hi32, np.nextafter(lo32, -2), np.nextafter(hi32, 2), 7.5, -7.5],
            lo32 + np.arange(6, dtype=np.float32) * width,      # the bin edges
        ]).astype(np.float32).reshape(4, -1)
        j_idx, j_in = j_hist.bin_index(jnp.asarray(x), lo, hi, 5)
        t_idx, t_in = t_hist.bin_index(torch.tensor(x), lo, hi, 5)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(t_in.numpy(), np.asarray(j_in))
        assert t_in.numpy()[0].any() and not t_in.numpy().all()
    # dyadic weights: every order of summation gives the same float
    idx = rng.integers(-2, 9, size=(6, 300))
    w = (rng.integers(0, 4, size=(6, 300)) / 4).astype(np.float32)
    np.testing.assert_array_equal(
        t_hist.batched_histogram(torch.tensor(idx), torch.tensor(w), 7).numpy(),
        np.asarray(j_hist.batched_histogram(jnp.asarray(idx, jnp.int32), jnp.asarray(w), 7)))
    hi_i, lo_i = rng.integers(-1, 6, size=(6, 300)), rng.integers(-1, 27, size=(6, 300))
    np.testing.assert_array_equal(
        t_hist.factored_histogram(torch.tensor(hi_i), torch.tensor(lo_i), torch.tensor(w),
                                  5, 25).numpy(),
        np.asarray(j_hist.factored_histogram(jnp.asarray(hi_i, jnp.int32),
                                             jnp.asarray(lo_i, jnp.int32), jnp.asarray(w),
                                             5, 25)))


def test_darboux_angles_match_reference(rng):
    d = (0.4 * rng.normal(size=(3, 9, 64))).astype(np.float32)   # neighborhood-sized
    n = rng.normal(size=(3, 9, 64))
    n = (n / np.linalg.norm(n, axis=0)).astype(np.float32)
    u = rng.normal(size=(3, 9, 1))
    u = (u / np.linalg.norm(u, axis=0)).astype(np.float32)
    d_safe = np.linalg.norm(d, axis=0).astype(np.float32)
    args = [*d, *n, *u, d_safe]
    # op by op: under jit XLA:CPU contracts the dot products into FMAs, which
    # moves an ill-conditioned theta (both atan2 arguments small) by ~2e-6
    want = j_bins.darboux_angles(*map(jnp.asarray, args))
    got = t_bins.darboux_angles(*map(torch.tensor, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    assert (np.abs(got[0].numpy()) > 1).any()    # v unnormalized: alpha leaves [-1, 1]


def one_bin_case(rng, q=11, w=160):
    """Every neighbor of a query at one offset with one normal, so all its
    counts fall into one joint bin; lane 0 is the query itself (d = 0), and
    the last query has a single neighbor."""
    kp = rng.normal(size=(q, 3))
    off = rng.normal(scale=0.2, size=(q, 3))
    unit = [rng.normal(size=(q, 3)) + np.array([0.0, 0.0, 3.0]) for _ in range(2)]
    nrm, qn = (u / np.linalg.norm(u, axis=1, keepdims=True) for u in unit)
    pts = np.repeat((kp + off)[:, :, None], w, 2)
    pts[:, :, 0] = kp
    vals = np.concatenate([pts, np.repeat(nrm[:, :, None], w, 2), np.zeros((q, 2, w))], axis=1)
    dist_inf = np.repeat(np.linalg.norm(off, axis=1)[:, None], w, 1)
    dist_inf[:, 0] = 0.0
    dist_inf[:, 1::5] = np.inf
    dist_inf[-1, 3:] = np.inf
    return tuple(a.astype(np.float32) for a in (kp, qn, vals, dist_inf))


@pytest.mark.parametrize("decorrelated,case", [
    pytest.param(False, "window", id="False"), pytest.param(True, "window", id="True"),
    pytest.param(False, "one_bin", id="one_bin-False"),
    pytest.param(True, "one_bin", id="one_bin-True")])
def test_k4_plain_matches_reference_kernel(rng, decorrelated, case):
    if case == "window":
        q, qn, vals, dist_inf = window_case(rng, q=11, w=160, query_normals=True)
        dist_inf[4] = np.inf                          # an empty window
        vals[1][:, ~np.isfinite(dist_inf[1])] = np.nan  # poisoned padding lanes
    else:
        q, qn, vals, dist_inf = one_bin_case(rng)
    want = np.asarray(j_spfh_histogram(
        jnp.asarray(vals), jnp.asarray(dist_inf), jnp.asarray(q), jnp.asarray(qn),
        n_bins=5, decorrelated=decorrelated, interpret=True))
    before = dict(_kernels.launch_counts)
    got = spfh_histogram(torch.tensor(vals), torch.tensor(dist_inf), torch.tensor(q),
                         torch.tensor(qn), 5, decorrelated)
    assert _kernels.launch_counts == before        # CPU tensors: plain twin
    assert got.shape == (11, 15 if decorrelated else 125)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if case == "window":
        assert not got[4].any() and float(got.sum()) > 0
    else:   # one bin a row (one per angle decorrelated), every neighbor counted
        assert int((got > 0).sum(1).max()) == (3 if decorrelated else 1)
        n = (np.isfinite(dist_inf) & (dist_inf > 0)).sum(1) * (3 if decorrelated else 1)
        np.testing.assert_array_equal(got.sum(1).numpy(), n.astype(np.float32))
        assert n[-1] == (3 if decorrelated else 1)


@pytest.mark.parametrize("kind", ["surface", "volume"])
def test_xyrow_mode_matches_reference(rng, kind):
    if kind == "surface":
        pts, nrm = surface(2600, rng, scale=3.0)
    else:
        pts = (rng.uniform(-2, 2, size=(2600, 3)) * [1, 1, 2]).astype(np.float32)
        nrm = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    jg = j_grid.build_grid(pts, 0.35, extras=nrm, halo=2)
    tg = t_grid.build_grid(pts, 0.35, extras=nrm, halo=2, device="cpu")
    xyrow, run_cap = shot_dma._xyrow_mode(tg)
    assert xyrow == jg.use_xyrow == (kind == "surface")
    assert run_cap == jg.xyrow_run_cap > 0
    q = np.concatenate([pts[::13], np.full((2, 3), 1e6, np.float32)])
    for t, j in zip(shot_dma._xyrow_runs(tg, torch.tensor(q)),
                    j_grid._xyrow_runs(jg, jnp.asarray(q))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("decorrelated", [False, True])
def test_k6_plain_matches_reference(rng, decorrelated):
    pts, nrm = surface(2600, rng, scale=3.0)
    radius = 0.7
    jg = j_grid.build_grid(pts, radius / 2, extras=nrm, halo=2)
    tg = t_grid.build_grid(pts, radius / 2, extras=nrm, halo=2, device="cpu")
    np.testing.assert_array_equal(tg.orig_idx.numpy(), np.asarray(jg.orig_idx))
    want = np.asarray(j_fpfh._spfh_window_sorted(jg, radius, 5, decorrelated, chunk=512))
    before = dict(_kernels.launch_counts)
    got = shot_dma.spfh_sorted_dma(tg, radius, 5, decorrelated).numpy()
    assert _kernels.launch_counts == before        # CPU tensors: plain twin
    assert_route_rule(got, want[:len(pts)])
    assert np.abs(got).sum() > 0
    if not decorrelated:
        # the interpreted TPU run kernel itself, on its first 32 sorted points
        table = tile_table(jg.packed_sorted[:, :6], 8)
        j_blk = j_spfh_block_dma(jg, table, jg.packed_sorted[:32, :3],
                                 jg.packed_sorted[:32, 3:6], radius, 5, False, interpret=True)
        t_blk = shot_dma.spfh_block_dma(tg, tg.packed_sorted[:32, :3],
                                        tg.packed_sorted[:32, 3:6], radius, 5, False)
        assert_route_rule(t_blk.numpy(), j_blk)


@pytest.mark.parametrize("route", ["brute", "streamed"])
def test_compute_spfh_matches_reference(rng, monkeypatch, route):
    """compute_spfh below the auto-grid threshold (brute search) and above
    it (grid search streamed in query chunks, threshold lowered)."""
    pts = (rng.normal(size=(300, 3)) * 1.5).astype(np.float32)
    nrm = rng.normal(size=(300, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    if route == "streamed":
        for mod in (j_grid, t_grid):
            monkeypatch.setattr(mod, "AUTO_GRID_MIN_POINTS", 10)
    j_spfh, j_nbr = j_fpfh.compute_spfh(pts, nrm, 0.8, 5, k_max=64)
    t_spfh, t_nbr = t_fpfh.compute_spfh(pts, nrm, 0.8, 5, k_max=64, device="cpu")
    np.testing.assert_array_equal(t_nbr.count.numpy(), np.asarray(j_nbr.mask).sum(1))
    np.testing.assert_allclose(t_spfh.numpy(), np.asarray(j_spfh), atol=1e-5)
    assert float(t_spfh.sum()) > 0


def test_compute_fpfh_descriptor_brute_route(rng):
    pts, normals = make_test_cloud(rng)
    kp = np.arange(0, 120, 7)
    got = t_fpfh.compute_fpfh_descriptor(kp, pts, normals, 1.2, 4, k_max=128, device="cpu")
    np.testing.assert_allclose(got.numpy(), numpy_fpfh(pts, normals, 1.2, 4, kp), atol=5e-3)
    want = j_fpfh.compute_fpfh_descriptor(kp.astype(np.int32), pts, normals, 1.2, 4, k_max=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    dec = t_fpfh.compute_fpfh_descriptor(kp[:10], pts, normals, 1.0, 5, decorrelated=True,
                                         k_max=128, device="cpu")
    assert dec.shape == (10, 15)
    np.testing.assert_allclose(dec.numpy(), np.asarray(j_fpfh.compute_fpfh_descriptor(
        kp[:10].astype(np.int32), pts, normals, 1.0, 5, decorrelated=True, k_max=128)),
        atol=1e-5)


def _grid_route_case(rng, monkeypatch):
    """A 1,500-point surface above the (lowered) auto-grid threshold of both
    packages, and every eleventh point as a keypoint."""
    pts, nrm = surface(1500, rng, scale=2.5)
    for mod in (j_grid, t_grid):
        monkeypatch.setattr(mod, "AUTO_GRID_MIN_POINTS", 1000)
    return pts, nrm, np.arange(0, 1500, 11)


@pytest.mark.parametrize("route,decorrelated", [("window", False), ("window", True)])
def test_compute_fpfh_descriptor_grid_route(rng, monkeypatch, route, decorrelated):
    """Above the (lowered) auto-grid threshold: the grid route (the SPFH
    pass's twin, once a cloud) against JAX's window route."""
    pts, nrm, kp = _grid_route_case(rng, monkeypatch)
    passes = []
    monkeypatch.setattr(t_fpfh, "spfh_grid",
                        lambda *a: passes.append(1) or spfh_fused.spfh_grid(*a))
    got = t_fpfh.compute_fpfh_descriptor(kp, pts, nrm, 0.5, 5, decorrelated=decorrelated,
                                         device="cpu")
    want = j_fpfh.compute_fpfh_descriptor(kp.astype(np.int32), pts, nrm, 0.5, 5,
                                          decorrelated=decorrelated)
    assert got.shape == (len(kp), 15 if decorrelated else 125)
    assert len(passes) == 1
    assert_route_rule(got.numpy(), want)


def test_compute_fpfh_descriptor_run_kernel(rng, monkeypatch):
    """K6's wrapper (``ops.shot_dma.spfh_sorted_dma``, its twin on CPU
    tensors) as the SPFH pass on the grid ``compute_fpfh_descriptor``
    builds (cell radius/2, halo 2), then the grid route's aggregation over
    the keypoints' sorted rows: against JAX's window route by the SPFH
    route rule."""
    pts, nrm, kp = _grid_route_case(rng, monkeypatch)
    grid = t_grid.build_grid(pts, 0.25, extras=nrm, halo=2, device="cpu")
    spfh = shot_dma.spfh_sorted_dma(grid, 0.5, 5, False)
    got = t_fpfh._fpfh_window_aggregate(grid, spfh, t_fpfh._sorted_rows(
        grid, torch.as_tensor(kp)), 0.5)
    want = j_fpfh.compute_fpfh_descriptor(kp.astype(np.int32), pts, nrm, 0.5, 5)
    assert got.shape == (len(kp), 125) and float(got.sum()) > 0
    assert_route_rule(got.numpy(), want)


def test_fpfh_ignores_the_old_run_route_variable(rng, monkeypatch):
    """``SHOT_FPFH_DMA=1`` in the environment selects nothing: on an
    xy-row grid FPFH's grid route still takes the SPFH pass, once, and
    neither K6 nor its twin runs."""
    pts, nrm, kp = _grid_route_case(rng, monkeypatch)
    monkeypatch.setenv("SHOT_FPFH_DMA", "1")
    grid = t_grid.build_grid(pts, 0.25, extras=nrm, halo=2, device="cpu")
    assert shot_dma._xyrow_mode(grid)[0]
    passes, runs = [], []
    monkeypatch.setattr(t_fpfh, "spfh_grid",
                        lambda *a: passes.append(1) or spfh_fused.spfh_grid(*a))
    check = shot_dma._check_run_grid
    monkeypatch.setattr(shot_dma, "_check_run_grid",
                        lambda *a: runs.append(1) or check(*a))
    t_fpfh.compute_fpfh_descriptor(kp, pts, nrm, 0.5, 5, device="cpu")
    assert passes == [1] and runs == []


def _bumpy(n, rng, scale=2.0, n_bumps=12):
    """tests/test_pipeline.py::bumpy_cloud: Gaussian bumps break the
    self-similarity that defeats descriptor matching."""
    xy = rng.uniform(-scale, scale, size=(n, 2))
    z = np.zeros(n)
    for c, h, w in zip(rng.uniform(-scale, scale, size=(n_bumps, 2)),
                       rng.uniform(-0.6, 0.6, size=n_bumps), rng.uniform(0.2, 0.7, size=n_bumps)):
        z += h * np.exp(-np.sum((xy - c) ** 2, axis=1) / (2 * w ** 2))
    return np.column_stack([xy, z]) + rng.normal(scale=0.003, size=(n, 3))


def test_cli_fpfh_matches_reference_cli(tmp_path):
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
    # the settings of tests/test_pipeline.py::test_fpfh_pipeline_end_to_end, with
    # denser keypoints and a wider radius: at voxel 0.3 under half of the scan's
    # keypoints lie within 0.1 of a ref keypoint, and the CLI rejects the pair
    common = ["--scan_file_path", str(tmp_path / "scan.ply"),
              "--ref_file_path", str(tmp_path / "ref.ply"), "--conf_file_path", "",
              "--normals_k", "20", "--selection_algorithm", "subsampling",
              "--neighborhood_size", "0.2", "--descriptor_choice", "fpfh", "--radius", "0.5",
              "--fpfh_n_bins", "5", "--k_max_fpfh", "96", "--matching_algorithm", "ratio",
              "--reject_threshold", "0.95", "--n_draws", "1500",
              "--max_inliers_distance", "0.1", "--d_max", "0.3", "--voxel_size", "0.1",
              "--max_iter", "40", "--rms_threshold", "1e-4"]
    assert t_main(common + ["--device", "cpu", "--output_dir", str(tmp_path / "torch"),
                            "--metrics_json", str(tmp_path / "m.json")]) == 0
    assert j_main(common + ["--n_devices", "1", "--output_dir", str(tmp_path / "jax")]) == 0

    gt = RigidTransform.from_numpy(rot.T, -rot.T @ trans, dtype=torch.float64)
    got_t = _recovered(tmp_path / "torch" / "scan_on_ref_post_icp.ply", scan)
    got_j = _recovered(tmp_path / "jax" / "scan_on_ref_post_icp.ply", scan)
    _assert_close(got_t, got_j)
    for got in (got_t, got_j):
        assert float(rotation_angle(got.rotation, gt.rotation)) < 0.03
    stages = [s["stage"] for s in json.loads((tmp_path / "m.json").read_text())["stages"]]
    assert "descriptors[fpfh]" in stages


def _entry_points():
    from shot_fpfh_tpu_torch.core.subsampling import grid_subsample
    from shot_fpfh_tpu_torch.core.transform import RigidTransform
    from shot_fpfh_tpu_torch.keypoints import (
        select_keypoints_subsampling,
        select_keypoints_with_density_threshold,
    )
    from shot_fpfh_tpu_torch.models import (
        ShotComputer,
        compute_fpfh_descriptor,
        compute_normals,
        compute_shot_descriptor,
        compute_spfh,
    )
    from shot_fpfh_tpu_torch.ops import neighbors
    from shot_fpfh_tpu_torch.ops.grid_hash import (
        build_grid,
        knn_auto,
        radius_search_auto,
        radius_search_with_values_auto,
    )
    from shot_fpfh_tpu_torch.pipeline import RegistrationPipeline
    from shot_fpfh_tpu_torch.registration.icp import icp_point_to_plane, icp_point_to_point
    from shot_fpfh_tpu_torch.registration.matching import basic_matching, lowe_matching
    from shot_fpfh_tpu_torch.registration.ransac import ransac_on_matches

    eye = RigidTransform(torch.eye(3), torch.zeros(3))
    return {
        "compute_normals": lambda a: compute_normals(a, a, k=8),
        "compute_shot_descriptor": lambda a: compute_shot_descriptor(a[:4], a, a, 0.5),
        "ShotComputer": lambda a: ShotComputer().compute_descriptor_single_scale(
            a, a, a[:4], 0.5),
        "select_keypoints_subsampling": lambda a: select_keypoints_subsampling(a, 0.2),
        "select_keypoints_with_density_threshold":
            lambda a: select_keypoints_with_density_threshold(a, 0.2, 1),
        "basic_matching": lambda a: basic_matching(a, a),
        "lowe_matching": lambda a: lowe_matching(a, a),
        "icp_point_to_point": lambda a: icp_point_to_point(a, a, eye, d_max=0.3),
        "icp_point_to_plane": lambda a: icp_point_to_plane(a, a, a, eye, d_max=0.3),
        "RegistrationPipeline": lambda a: RegistrationPipeline(
            scan=a, scan_normals=a, ref=a, ref_normals=a).select_keypoints(
                "subsampling", neighborhood_size=0.2),
        "compute_fpfh_descriptor": lambda a: compute_fpfh_descriptor([0, 1], a, a, 0.5),
        "compute_spfh": lambda a: compute_spfh(a, a, 0.5, 5),
        # bench.py's and bench_1m.py's own calls
        "build_grid": lambda a: build_grid(a, 0.3),
        "grid_subsample": lambda a: grid_subsample(a, 0.2),
        "ransac_on_matches": lambda a: ransac_on_matches(a, a, n_draws=8),
        # the brute searches and the auto searches (host arrays: the card)
        "knn": lambda a: neighbors.knn(a, a, 4),
        "approx_knn": lambda a: neighbors.approx_knn(a, a, 4),
        "radius_search": lambda a: neighbors.radius_search(a, a, 0.5, 8),
        "radius_count": lambda a: neighbors.radius_count(a, a, 0.5),
        "nearest_neighbor": lambda a: neighbors.nearest_neighbor(a, a),
        "knn_auto": lambda a: knn_auto(a, a, 4),
        "radius_search_with_values_auto":
            lambda a: radius_search_with_values_auto(a, a, a, 0.5, 8),
        # the last names of the JAX surface and the given frame neighborhoods
        "RigidTransform.identity": lambda a: RigidTransform.identity(),
        "radius_search_auto": lambda a: radius_search_auto(a, a, 0.5, 8),
        "compute_shot_descriptor(local_rf_neighborhoods)":
            lambda a: compute_shot_descriptor(a[:4], a, a, 0.5, local_rf_neighborhoods=(
                neighbors.radius_search(torch.as_tensor(a[:4]), torch.as_tensor(a), 0.5, 8))),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_point_defaults_to_cuda(name, monkeypatch):
    """Host arrays and no device resolve to ``cuda``: without a card the
    entry point raises, never running quietly on the CPU; with a card (here
    faked) the data goes to ``cuda``, which this CPU-only torch refuses."""
    a = np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32)
    call = _entry_points()[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(a)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert _device.resolve(None, a) == torch.device("cuda")
    assert _device.resolve(None, torch.tensor(a)).type == "cpu"
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        call(a)
