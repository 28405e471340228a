"""Port parity: radius-mode normals and the PCA features, and the filtered
matcher behind ``--matching_algorithm threshold``.

Both routes of every feature function: the brute radius search (capped at
``k_max``) below ``AUTO_GRID_MIN_POINTS`` cloud points, the grid routes (K3
over a grid of cell ``radius``; the K8 window of a halo-2 grid of cell
``radius/2`` for the moments) from it up, reached by lowering each
package's ``models.normals.AUTO_GRID_MIN_POINTS``.  Tolerances of
``tests/test_normals.py:124-131``: neighborhood sizes exact, eigenvalues and
sphericity atol 1e-4, moments atol 1e-3; normals ``|n·n'| > 0.999`` for at
least 99.9% of queries; every value finite.  ``match_descriptors`` keeps
exactly JAX's matches under each filter; the threshold CLI lands within
1e-3 of the JAX CLI.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_fpfh import _bumpy  # noqa: E402
from test_torch_match import _descriptors  # noqa: E402

from shot_fpfh_tpu.models import normals as j_nm  # noqa: E402
from shot_fpfh_tpu.registration import matching as j_match  # noqa: E402
from shot_fpfh_tpu_torch import _kernels  # noqa: E402
from shot_fpfh_tpu_torch.models import normals as t_nm  # noqa: E402
from shot_fpfh_tpu_torch.registration import matching as t_match  # noqa: E402

# The suite runs several pytest workers side by side on the CPU: one torch
# thread per worker keeps torch's OpenMP pool from oversubscribing the cores.
torch.set_num_threads(1)

RADIUS = 0.5


@pytest.fixture(params=["brute", "grid"])
def route(request, monkeypatch):
    if request.param == "grid":
        for mod in (j_nm, t_nm):
            monkeypatch.setattr(mod, "AUTO_GRID_MIN_POINTS", 1000)
    return request.param


@pytest.fixture
def sheet(rng):
    """A smooth sheet (well-conditioned normals), 3000 points; ~60
    neighbors within RADIUS, so the brute route's k_max 64 cuts a few balls
    (both packages alike) and the grid routes take them whole."""
    xy = rng.uniform(-3, 3, size=(3000, 2))
    z = 0.4 * np.sin(xy[:, 0]) * np.cos(1.3 * xy[:, 1])
    pts = np.column_stack([xy, z]).astype(np.float32)
    return pts[:200], pts


def _assert_normals(got, want):
    dots = np.abs((np.asarray(got) * np.asarray(want)).sum(1))
    assert np.mean(dots > 0.999) >= 0.999, np.sort(dots)[:5]


def test_radius_normals_and_sphericity_match_reference(sheet, route):
    q, pts = sheet
    before = dict(_kernels.launch_counts)
    got = t_nm.compute_normals(q, pts, radius=RADIUS, device="cpu")
    assert _kernels.launch_counts == before        # CPU tensors: plain twins
    assert got.shape == (len(q), 3)
    _assert_normals(got.numpy(), j_nm.compute_normals(q, pts, radius=RADIUS))
    pre = np.tile(np.float32([0, 0, 1]), (len(q), 1))
    flipped = t_nm.compute_normals(q, pts, radius=RADIUS, pre_computed_normals=pre, device="cpu")
    assert (flipped[:, 2] >= 0).all()
    np.testing.assert_allclose(
        t_nm.compute_sphericity(q, pts, RADIUS, device="cpu").numpy(),
        np.asarray(j_nm.compute_sphericity(q, pts, RADIUS)), atol=1e-4)


def test_local_pca_with_moments_matches_reference(sheet, route):
    q, pts = sheet
    w, v, mom, sizes = (x.numpy() for x in t_nm.local_pca_with_moments(q, pts, RADIUS,
                                                                        device="cpu"))
    j_w, j_v, j_mom, j_sizes = (np.asarray(x) for x in j_nm.local_pca_with_moments(q, pts,
                                                                                   RADIUS))
    np.testing.assert_array_equal(sizes, j_sizes)
    if route == "grid":     # every in-radius point, no cap
        assert sizes.max() > 64
    np.testing.assert_allclose(w, j_w, atol=1e-4)
    np.testing.assert_allclose(mom, j_mom, atol=1e-3)
    _assert_normals(v[..., :, 0], j_v[..., :, 0])


def test_pca_features_match_reference(sheet, route):
    q, pts = sheet
    basic = [x.numpy() for x in t_nm.compute_pca_based_basic_features(q, pts, RADIUS,
                                                                      device="cpu")]
    j_basic = [np.asarray(x) for x in j_nm.compute_pca_based_basic_features(q, pts, RADIUS)]
    for got, want in zip(basic, j_basic):
        assert got.shape == (len(q),) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=1e-4)
    feats = t_nm.compute_pca_based_features(q, pts, RADIUS, device="cpu").numpy()
    j_feats = np.asarray(j_nm.compute_pca_based_features(q, pts, RADIUS))
    assert feats.shape == (len(q), 21) and np.isfinite(feats).all()
    # eigenvalue columns and angles atol 1e-4, moments 1e-3, sizes exact
    np.testing.assert_allclose(feats[:, :12], j_feats[:, :12], atol=1e-4)
    np.testing.assert_allclose(feats[:, 12:20], j_feats[:, 12:20], atol=1e-3)
    np.testing.assert_array_equal(feats[:, 20], j_feats[:, 20])


def test_pca_features_verbose_is_not_ported(sheet, caplog, tmp_path, monkeypatch):
    """``verbose=True`` logs the neighborhood-size statistics, draws their
    histogram in the working directory and leaves the features as they are."""
    import logging

    q, pts = sheet
    monkeypatch.chdir(tmp_path)
    with caplog.at_level(logging.INFO, logger="shot_fpfh_tpu_torch.analysis"):
        feats = t_nm.compute_pca_based_features(q, pts, RADIUS, verbose=True, device="cpu")
    assert any("Average size of neighborhoods" in r.getMessage() for r in caplog.records)
    assert (tmp_path / "neighborhood_sizes.png").is_file()
    assert torch.equal(feats, t_nm.compute_pca_based_features(q, pts, RADIUS, device="cpu"))


def _match_case(rng):
    scan = _descriptors(rng, 300, [3, 50])
    ref = np.concatenate([scan[::-1][:250] + 0.01 * rng.normal(size=(250, 352)),
                          _descriptors(rng, 60, [7])]).astype(np.float32)
    return scan, ref


@pytest.mark.parametrize("name,kwargs", [
    ("threshold_filter", dict(threshold_multiplier=1.5)),
    ("quantile_filter", dict(quantiles=(0.1, 0.8))),
    ("left_median_filter", {}),
    (None, {}),
])
@pytest.mark.parametrize("reciprocal", [False, True])
def test_match_descriptors_matches_reference(rng, name, kwargs, reciprocal):
    scan, ref = _match_case(rng)
    j_filter = None if name is None else getattr(j_match, name)
    t_filter = None if name is None else getattr(t_match, name)
    # 120 reciprocal matches at most pass the filters: n_min_matches 100
    # keeps them on some cases and falls back to all matches on others
    js, jr = j_match.match_descriptors(scan, ref, j_filter, filter_nonreciprocal=reciprocal,
                                       **kwargs)
    ts, tr = t_match.match_descriptors(scan, ref, t_filter, filter_nonreciprocal=reciprocal,
                                       device="cpu", **kwargs)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tr, jr)
    assert 3 not in ts and 50 not in ts and len(ts) > 0


def test_filters_match_reference(rng):
    d = np.abs(rng.normal(size=500)).astype(np.float32)
    d[:7] = 0.0
    for name, kwargs in (("threshold_filter", dict(threshold_multiplier=20.0)),
                         ("quantile_filter", dict(quantiles=(0.25, 0.75))),
                         ("left_median_filter", {})):
        np.testing.assert_array_equal(getattr(t_match, name)(d, **kwargs),
                                      getattr(j_match, name)(d, **kwargs))


def test_cli_threshold_matching_matches_reference_cli(tmp_path):
    from shot_fpfh_tpu.cli import main as j_main
    from shot_fpfh_tpu_torch.cli import main as t_main
    from shot_fpfh_tpu_torch.core.transform import RigidTransform, rotation_angle
    from shot_fpfh_tpu_torch.io.ply import write_ply
    from test_torch_slice import _assert_close, _recovered, _rotation_about

    rng = np.random.default_rng(7)
    ref = _bumpy(1500, rng).astype(np.float32)
    rot = _rotation_about([0.2, -0.4, 1.0], np.deg2rad(20.0))
    trans = np.array([0.3, -0.2, 0.1])
    # noise keeps the nearest descriptor distances off zero: the threshold
    # filter's floor is the smallest nonzero one, and on an exact copy that
    # is the rounding noise of two near-identical descriptors
    scan = (ref @ rot.T + trans + rng.normal(scale=0.003, size=ref.shape)).astype(np.float32)
    write_ply(str(tmp_path / "scan.ply"), [scan], ["x", "y", "z"])
    write_ply(str(tmp_path / "ref.ply"), [ref], ["x", "y", "z"])
    common = ["--scan_file_path", str(tmp_path / "scan.ply"),
              "--ref_file_path", str(tmp_path / "ref.ply"), "--conf_file_path", "",
              "--normals_k", "20", "--selection_algorithm", "subsampling",
              "--neighborhood_size", "0.2", "--descriptor_choice", "shot_single_scale",
              "--radius", "0.5", "--rho", "30", "--min_neighborhood_size", "10",
              "--k_max_descriptor", "256", "--matching_algorithm", "threshold",
              "--threshold_multiplier", "3", "--n_draws", "1500",
              "--max_inliers_distance", "0.1", "--d_max", "0.3", "--voxel_size", "0.1",
              "--max_iter", "40", "--rms_threshold", "1e-4"]
    assert t_main(common + ["--device", "cpu", "--output_dir", str(tmp_path / "torch"),
                            "--metrics_json", str(tmp_path / "m.json")]) == 0
    assert j_main(common + ["--n_devices", "1", "--output_dir", str(tmp_path / "jax")]) == 0
    assert "matching[threshold]" in (tmp_path / "m.json").read_text()
    gt = RigidTransform.from_numpy(rot.T, -rot.T @ trans, dtype=torch.float64)
    got_t = _recovered(tmp_path / "torch" / "scan_on_ref_post_icp.ply", scan)
    got_j = _recovered(tmp_path / "jax" / "scan_on_ref_post_icp.ply", scan)
    _assert_close(got_t, got_j)
    assert float(rotation_angle(got_t.rotation, gt.rotation)) < 1e-2
