"""Port parity: the single-device library around the staged path.

- ``multiscale_top1`` and ``match_descriptors`` on ``(n_scales, K, D)``
  stacks against JAX: on real-valued stacks indices equal wherever JAX's
  two best combined distances are more than 1e-4 apart (the matmuls sum in
  other orders), distances within 1e-4; on whole-number stacks (exact
  arithmetic, repeated rows, more than one 1024-row chunk) indices and
  distances equal everywhere, in both reciprocal modes.
- ``icp_point_to_point_with_sampling`` with JAX's random subsets injected:
  points within 1e-4, RMS within 1e-5.
- The stats forms of the solvers within 1e-5 of JAX's, batched.
- The SHOT debug checks (``--debug_shot``) and the NaN check
  (``--debug_nans``): the counts, the warnings, the routes, and both CLIs.
- The perf helpers' log texts, ``block``, and the profiler trace.
- Every public name of the JAX package resolves in the port, but for the
  exclusions listed with their reasons.
"""

import importlib
import json
import logging
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_api_walk import EXCLUDED  # noqa: E402
from test_torch_shot import assert_flip_rule  # noqa: E402
from test_torch_slice import _assert_close, _recovered, _rotation_about  # noqa: E402

from bench import make_terrain  # noqa: E402
from shot_fpfh_tpu.core import solvers as j_sv  # noqa: E402
from shot_fpfh_tpu.models import shot as j_shot  # noqa: E402
from shot_fpfh_tpu.registration import icp as j_icp  # noqa: E402
from shot_fpfh_tpu.registration import matching as j_match  # noqa: E402
from shot_fpfh_tpu.utils import perf as j_perf  # noqa: E402
from shot_fpfh_tpu_torch import _kernels  # noqa: E402
from shot_fpfh_tpu_torch.core import solvers as t_sv  # noqa: E402
from shot_fpfh_tpu_torch.models import shot as t_shot  # noqa: E402
from shot_fpfh_tpu_torch.ops import grid_hash as t_grid  # noqa: E402
from shot_fpfh_tpu_torch.ops import shot_dma  # noqa: E402
from shot_fpfh_tpu_torch.ops import shot_fused as t_shot_fused  # noqa: E402
from shot_fpfh_tpu_torch.registration import icp as t_icp  # noqa: E402
from shot_fpfh_tpu_torch.registration import matching as t_match  # noqa: E402
from shot_fpfh_tpu_torch.utils import perf as t_perf  # noqa: E402
from shot_fpfh_tpu_torch.utils.debug_nans import NanCheck  # noqa: E402

# The suite runs several pytest workers side by side on the CPU: one torch
# thread per worker keeps torch's OpenMP pool from oversubscribing the cores.
torch.set_num_threads(1)

TIE_GAP = 1e-4


def _real_stacks(rng):
    """The case of ``tests/test_matching.py:128-156``: 3 scales of 150 x 170
    x 24, rows empty at single scales and at every scale."""
    scan = rng.normal(size=(3, 150, 24)).astype(np.float32)
    ref = rng.normal(size=(3, 170, 24)).astype(np.float32)
    scan[0, :10] = 0.0
    scan[1, 5:20] = 0.0
    scan[:, 30] = 0.0
    ref[2, 40:60] = 0.0
    ref[:, 3] = 0.0
    return scan, ref


def _whole_stacks(rng, n=2100, m=1900):
    """Whole numbers in -3..3 (every distance exact in f32) over three
    1024-row chunks, with repeated rows (ties at every level) and rows empty
    at one scale or at all."""
    scan = rng.integers(-3, 4, size=(3, n, 16)).astype(np.float32)
    ref = rng.integers(-3, 4, size=(3, m, 16)).astype(np.float32)
    ref[:, m // 2:m // 2 + 100] = ref[:, :100]
    scan[:, n - 300:n - 200] = scan[:, :100]
    scan[0, :40] = 0.0
    scan[:, 77] = 0.0
    ref[1, 200:260] = 0.0
    return scan, ref


def _jax_top2_gap(scan, ref, reciprocal):
    """JAX's gap between the two best combined distances of each row (+inf
    where the whole row is the sentinel: index 0 on both sides)."""
    s, r = jnp.asarray(scan), jnp.asarray(ref)
    s_ok, r_ok = jnp.any(s != 0, axis=2), jnp.any(r != 0, axis=2)
    row_ok = s_ok
    if reciprocal:
        recip = []
        for sc in range(s.shape[0]):
            row_i, _, col_i = j_match._ms_scale_pass(s[sc], r[sc], s_ok[sc], r_ok[sc])
            recip.append(col_i[row_i] == jnp.arange(s.shape[1]))
        row_ok = s_ok & jnp.stack(recip)
    run = jnp.full((s.shape[1], r.shape[1]), j_match.MS_MAX_VAL)
    for sc in range(s.shape[0]):
        run = jnp.minimum(run, j_match._ms_chunk_dists(s[sc], r[sc], row_ok[sc], r_ok[sc]))
    top = np.sort(np.asarray(run), axis=1)[:, :2]
    return np.where(top[:, 0] < j_match.MS_MAX_VAL, top[:, 1] - top[:, 0], np.inf)


@pytest.mark.parametrize("reciprocal", [False, True])
def test_multiscale_top1_matches_jax(rng, reciprocal):
    scan, ref = _real_stacks(rng)
    ji, jd = (np.asarray(x) for x in j_match.multiscale_top1(
        jnp.asarray(scan), jnp.asarray(ref), filter_nonreciprocal=reciprocal))
    ti, td = (x.numpy() for x in t_match.multiscale_top1(
        scan, ref, filter_nonreciprocal=reciprocal, device="cpu"))
    clear = _jax_top2_gap(scan, ref, reciprocal) > TIE_GAP
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(ti[clear], ji[clear])
    np.testing.assert_allclose(td, jd, atol=1e-4, rtol=0)
    assert td[30] >= t_match.MS_MAX_VAL and jd[30] >= j_match.MS_MAX_VAL


@pytest.mark.parametrize("reciprocal", [False, True])
def test_multiscale_top1_whole_numbers_equal_jax(rng, reciprocal):
    scan, ref = _whole_stacks(rng)
    ji, jd = (np.asarray(x) for x in j_match.multiscale_top1(
        jnp.asarray(scan), jnp.asarray(ref), filter_nonreciprocal=reciprocal))
    ti, td = (x.numpy() for x in t_match.multiscale_top1(
        torch.tensor(scan), torch.tensor(ref), filter_nonreciprocal=reciprocal))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    assert (td < t_match.MS_MAX_VAL).sum() > (0.2 if reciprocal else 0.9) * len(td)


def test_multiscale_column_ties_go_to_the_earlier_chunk():
    """Every scan row is the same: each column's nearest row ties across all
    three chunks, and the first row must win (the strict ``<``)."""
    scan = np.ones((1, 2100, 4), np.float32)
    ref = np.arange(1, 13, dtype=np.float32).reshape(1, 3, 4)
    for mod, make in ((j_match, jnp.asarray), (t_match, torch.tensor)):
        s, r = make(scan[0]), make(ref[0])
        ok_s, ok_r = make(np.ones(2100, bool)), make(np.ones(3, bool))
        row_i, _, col_i = mod._ms_scale_pass(s, r, ok_s, ok_r)
        np.testing.assert_array_equal(np.asarray(col_i), [0, 0, 0])
        np.testing.assert_array_equal(np.asarray(row_i), np.zeros(2100))


FILTERS = {"none": (None, {}),
           "threshold": (t_match.threshold_filter, dict(threshold_multiplier=1.5)),
           "quantile": (t_match.quantile_filter, dict(quantiles=(0.2, 0.8))),
           "left_median": (t_match.left_median_filter, {})}


@pytest.mark.parametrize("reciprocal", [False, True])
@pytest.mark.parametrize("name", list(FILTERS))
def test_match_descriptors_on_stacks_equals_jax(rng, name, reciprocal):
    scan, ref = _whole_stacks(rng, 400, 350)
    fn, kwargs = FILTERS[name]
    j_fn = None if fn is None else getattr(j_match, fn.__name__)
    want = j_match.match_descriptors(scan, ref, j_fn, filter_nonreciprocal=reciprocal,
                                     n_min_matches=10, **kwargs)
    got = t_match.match_descriptors(scan, ref, fn, filter_nonreciprocal=reciprocal,
                                    n_min_matches=10, device="cpu", **kwargs)
    assert len(got[0]) > 10
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_match_descriptors_on_stacks_falls_back_like_jax(rng, caplog):
    scan, ref = _whole_stacks(rng, 400, 350)
    caplog.set_level(logging.WARNING)
    want = j_match.match_descriptors(scan, ref, filter_nonreciprocal=True,
                                     n_min_matches=10 ** 6)
    got = t_match.match_descriptors(scan, ref, filter_nonreciprocal=True,
                                    n_min_matches=10 ** 6, device="cpu")
    plain = t_match.match_descriptors(scan, ref, device="cpu")
    for g, w, p in zip(got, want, plain):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)
    warned = [r for r in caplog.records
              if r.getMessage() == "Too few reciprocal matches, keeping non-reciprocal matches."]
    assert {r.name for r in warned} == {"shot_fpfh_tpu.registration.matching",
                                        "shot_fpfh_tpu_torch.registration.matching"}


def test_descriptor_sq_dists_matches_jax(rng):
    a = rng.normal(size=(70, 33)).astype(np.float32)
    b = rng.normal(size=(50, 33)).astype(np.float32)
    b[4] = a[9]
    got = t_match.descriptor_sq_dists(torch.tensor(a), torch.tensor(b)).numpy()
    want = np.asarray(j_match.descriptor_sq_dists(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert (got >= 0).all()
    assert t_match.double_matching_with_rejects is t_match.lowe_matching


def _icp_setup(rng, n=500):
    """``tests/test_ransac_icp.py::icp_setup``: a wavy cloud and the scan
    0.05 rad and ~0.05 away from it."""
    xy = rng.uniform(-2.0, 2.0, size=(n, 2))
    pts = np.column_stack([xy, 0.3 * np.sin(2.0 * xy[:, 0]) * np.cos(1.5 * xy[:, 1])])
    ref = (pts + rng.normal(scale=0.01, size=pts.shape)).astype(np.float32)
    rot = _rotation_about(rng.normal(size=3), 0.05)
    t = rng.normal(size=3) * 0.05
    return ((ref - t) @ rot).astype(np.float32), ref


def _jax_subsets(n, limit, iters):
    """The draws of JAX's ``icp_point_to_point_with_sampling`` (key 0)."""
    key, out = jax.random.key(0), []
    for _ in range(iters):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.choice(sub, n, shape=(limit,), replace=False)))
    return out


@pytest.mark.parametrize("limit,threshold", [(200, 1e-2), (100, 1e-3)])
def test_sampled_icp_matches_jax_with_its_draws(rng, limit, threshold):
    scan, ref = _icp_setup(rng)
    pts_j, rms_j, conv_j = j_icp.icp_point_to_point_with_sampling(
        scan, ref, d_max=0.5, max_iter=10, rms_threshold=threshold, sampling_limit=limit)
    pts, rms, conv = t_icp.icp_point_to_point_with_sampling(
        scan, ref, 0.5, max_iter=10, rms_threshold=threshold, sampling_limit=limit,
        subsets=_jax_subsets(len(scan), limit, 10), device="cpu")
    np.testing.assert_allclose(pts, pts_j, atol=1e-4, rtol=0)
    assert abs(rms - rms_j) <= 1e-5 and conv == conv_j
    assert pts.shape == scan.shape and np.isfinite(rms)


def test_sampled_icp_runs_with_its_own_draws(rng):
    """JAX's ``test_icp_with_sampling_runs``, on the port's seeded draws."""
    scan, ref = _icp_setup(rng)
    pts, rms, conv = t_icp.icp_point_to_point_with_sampling(
        scan, ref, d_max=0.5, max_iter=10, sampling_limit=200, device="cpu")
    again = t_icp.icp_point_to_point_with_sampling(
        scan, ref, d_max=0.5, max_iter=10, sampling_limit=200, device="cpu")
    assert pts.shape == scan.shape and np.isfinite(rms)
    np.testing.assert_array_equal(pts, again[0])
    assert np.abs(pts - scan).max() > 0


def _solver_batch(rng, batch=4, n=200):
    scan = rng.normal(size=(batch, n, 3)).astype(np.float32)
    ref = (scan @ _rotation_about([0.2, 1.0, -0.4], 0.3).T + [0.5, -1.0, 0.2]
           + rng.normal(scale=0.01, size=scan.shape)).astype(np.float32)
    normals = rng.normal(size=scan.shape)
    normals = (normals / np.linalg.norm(normals, axis=-1, keepdims=True)).astype(np.float32)
    weights = (rng.uniform(size=(batch, n)) > 0.3).astype(np.float32)
    return scan, ref, normals, weights


def _close(got, want, atol=1e-5):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol, rtol=0)


def test_point_to_point_stats_solver_matches_jax(rng):
    scan, ref, _, w = _solver_batch(rng)
    want_stats = j_sv.point_to_point_stats(jnp.asarray(scan), jnp.asarray(ref), jnp.asarray(w))
    stats = t_sv.point_to_point_stats(torch.tensor(scan), torch.tensor(ref), torch.tensor(w))
    _close(stats, want_stats, atol=1e-4)
    got = t_sv.solve_point_to_point_from_stats(*stats)
    want = j_sv.solve_point_to_point_from_stats(*want_stats)
    _close((got.rotation, got.translation), (want.rotation, want.translation))
    direct = t_sv.solve_point_to_point(torch.tensor(scan), torch.tensor(ref), torch.tensor(w))
    _close((got.rotation, got.translation), (direct.rotation, direct.translation))


def test_point_to_plane_normal_eq_solver_matches_jax(rng):
    scan, ref, nrm, w = _solver_batch(rng)
    scan = (scan * 0.1).astype(np.float32)      # small-angle regime
    ref = (scan + 0.01 * rng.normal(size=scan.shape)).astype(np.float32)
    j_args = [jnp.asarray(x) for x in (scan, ref, nrm, w)]
    t_args = [torch.tensor(x) for x in (scan, ref, nrm, w)]
    gtg, gth = t_sv.point_to_plane_normal_eq(*t_args)
    j_gtg, j_gth = j_sv.point_to_plane_normal_eq(*j_args)
    _close((gtg, gth), (j_gtg, j_gth), atol=1e-4)
    got = t_sv.solve_point_to_plane_from_normal_eq(gtg, gth)
    # JAX's Tikhonov term takes jnp.trace over the first two axes, so its
    # solve takes one system at a time
    for i in range(len(scan)):
        want = j_sv.solve_point_to_plane_from_normal_eq(j_gtg[i], j_gth[i])
        _close((got.rotation[i], got.translation[i]), (want.rotation, want.translation))
    direct = t_sv.solve_point_to_plane(*t_args)
    assert torch.equal(got.rotation, direct.rotation)
    assert torch.equal(got.translation, direct.translation)


def test_shot_debug_checks_clean_batch(rng):
    """A real descriptor batch under the checks reports zero violations
    (JAX ``tests/test_shot.py::test_shot_debug_checks_clean_batch``)."""
    pts = np.asarray(rng.normal(size=(300, 3)), np.float32)
    normals = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    t_shot.enable_debug_checks(True)
    try:
        desc, _ = t_shot.compute_shot_descriptor(pts[:32], pts, normals, 0.8,
                                                 min_neighborhood_size=1, device="cpu")
        assert t_shot.debug_violation_count() == 0
        assert torch.isfinite(desc).all()
    finally:
        t_shot.enable_debug_checks(False)


def _accumulate_with_bad_cosines(rng, caplog, bad_rows):
    """``_shot_accumulate`` in both packages, checks on, with a cosine of
    5.0 (past the public entry's clip) at half the neighbors of
    ``bad_rows``: ``({package: descriptors}, {package: count}, warnings)``."""
    q, k = 4, 16
    lx, ly, lz = (rng.normal(size=(q, k)).astype(np.float32) for _ in range(3))
    rho = (np.sqrt(lx ** 2 + ly ** 2 + lz ** 2) * 0.1).astype(np.float32)
    cosine = rng.uniform(-1.0, 1.0, size=(q, k)).astype(np.float32)
    cosine[bad_rows, ::2] = 5.0
    valid = np.ones((q, k), bool)
    caplog.set_level(logging.WARNING)
    descs, counts = {}, {}
    for name, mod, make in (("jax", j_shot, jnp.asarray), ("torch", t_shot, torch.tensor)):
        mod.enable_debug_checks(True)
        try:
            args = [make(x) for x in (lx, ly, lz, rho, cosine, valid)]
            descs[name] = np.asarray(mod._shot_accumulate(*args, 1.0, True, 1))
            counts[name] = mod.debug_violation_count()
        finally:
            mod.enable_debug_checks(False)
    warned = [r.getMessage() for r in caplog.records if r.name.endswith("models.shot")]
    return descs, counts, warned


def test_shot_debug_checks_catch_injected_bad_bin(rng, caplog):
    """Bad cosines in every row are counted in both packages, with the same
    warning and the same counts, and their out-of-range bins are dropped
    in both (JAX's one-hot adds nothing for them), so the descriptors
    agree."""
    descs, counts, warned = _accumulate_with_bad_cosines(rng, caplog, slice(None))
    assert counts["torch"] == counts["jax"] == 4 * 8
    assert len(warned) == 2 and warned[0] == warned[1]
    assert warned[0].startswith("SHOT debug checks: ")
    assert_flip_rule(descs["torch"], descs["jax"])


def test_shot_debug_checks_drop_a_bad_bin_in_an_inner_row(rng, caplog):
    """A bad cosine in a row that is not the last lands in no other row:
    the port drops it as JAX does, and every row agrees with JAX's."""
    descs, counts, warned = _accumulate_with_bad_cosines(rng, caplog, 1)
    assert counts["torch"] == counts["jax"] == 8
    assert len(warned) == 2 and warned[0] == warned[1]
    assert (descs["torch"] != 0).any(axis=1).all()
    assert_flip_rule(descs["torch"], descs["jax"])


def _grid_shot_under_checks(rng, monkeypatch):
    """Grid-route SHOT (``AUTO_GRID_MIN_POINTS`` lowered) without and with
    the checks, recording the counter each call of K1's wrapper (as
    ``ops.shot_fused`` calls it) is given: ``(without, with, counters)``."""
    monkeypatch.setattr(t_grid, "AUTO_GRID_MIN_POINTS", 1000)
    cloud = make_terrain(3000, rng, scale=3.0, n_bumps=6)
    normals = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (len(cloud), 1))
    kp = cloud[:200]
    want = t_shot.compute_shot_descriptor(kp, cloud, normals, 0.8,
                                          min_neighborhood_size=5, device="cpu")
    counters, real = [], t_shot_fused.shot_binning_histogram

    def spy(*a, violations=None, **k):
        counters.append(violations)
        return real(*a, violations=violations, **k)

    monkeypatch.setattr(t_shot_fused, "shot_binning_histogram", spy)
    t_shot.enable_debug_checks(True)
    try:
        got = t_shot.compute_shot_descriptor(kp, cloud, normals, 0.8,
                                             min_neighborhood_size=5, device="cpu")
        assert t_shot.debug_violation_count() == 0
    finally:
        t_shot.enable_debug_checks(False)
    return want, got, counters


def test_shot_debug_checks_leave_grid_descriptors_unchanged(rng, monkeypatch):
    """On the grid route the descriptors under the checks equal those
    without, no violation is counted, and K1's wrapper is called with a
    counter (the route does not change; on CPU tensors SG's route runs K1's
    wrapper in keypoint chunks)."""
    (want, want_rfs), (got, rfs), counters = _grid_shot_under_checks(rng, monkeypatch)
    assert counters and all(c is not None and c.tolist() == [0, 0] for c in counters)
    assert (want != 0).any()
    assert torch.equal(got, want) and torch.equal(rfs, want_rfs)


def test_shot_debug_checks_on_the_run_route(rng):
    """K5's wrapper (its twin on CPU tensors) called with a zeroed debug
    counter on the grid SHOT builds for the same terrain (cell r/2, halo 2,
    normals) counts no violation, and its descriptors and frames equal
    those of a call without a counter."""
    cloud = make_terrain(3000, rng, scale=3.0, n_bumps=6)
    normals = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (len(cloud), 1))
    grid = t_grid.build_grid(cloud, 0.4, extras=normals, halo=2, device="cpu")
    kp = torch.tensor(cloud[:200])
    counter = torch.zeros(2, dtype=torch.int32)
    want, want_rfs = shot_dma.shot_descriptor_dma(grid, kp, 0.8, min_neighborhood_size=5)
    got, rfs = shot_dma.shot_descriptor_dma(grid, kp, 0.8, min_neighborhood_size=5,
                                            violations=counter)
    assert counter.tolist() == [0, 0]
    assert (want != 0).any()
    assert torch.equal(got, want) and torch.equal(rfs, want_rfs)


def test_shot_debug_checks_count_neighbors_beyond_the_radius(rng, caplog):
    """Neighbors up to eight times the radius given (their husk weights
    drive the weight sum below 0) are counted as unsound weight sums, the
    same in both packages, with no bad bin."""
    q, k = 4, 32
    lx, ly, lz = (rng.normal(size=(q, k)).astype(np.float32) for _ in range(3))
    rho = np.sqrt(lx ** 2 + ly ** 2 + lz ** 2)
    lx, ly, lz = (x / rho * np.linspace(0.05, 0.8, k, dtype=np.float32) for x in (lx, ly, lz))
    rho = np.sqrt(lx ** 2 + ly ** 2 + lz ** 2).astype(np.float32)
    cosine = rng.uniform(-1.0, 1.0, size=(q, k)).astype(np.float32)
    valid = np.ones((q, k), bool)
    caplog.set_level(logging.WARNING)
    counts = {}
    for name, mod, make in (("jax", j_shot, jnp.asarray), ("torch", t_shot, torch.tensor)):
        mod.enable_debug_checks(True)
        try:
            args = [make(x) for x in (lx, ly, lz, rho, cosine, valid)]
            np.asarray(mod._shot_accumulate(*args, 0.1, True, 1))
            counts[name] = mod.debug_violation_count()
        finally:
            mod.enable_debug_checks(False)
    assert counts["torch"] == counts["jax"] > 0
    warned = [r.getMessage() for r in caplog.records if r.name.endswith("models.shot")]
    assert len(warned) == 2 and warned[0] == warned[1]
    assert " 0 out-of-range bin indices" in warned[0]


def _pair(tmp_path, n):
    """A terrain pair of ``n`` points (``tests/test_torch_slice.py``'s at
    22k) on disk, the ground truth, and the CLI arguments of both
    packages."""
    from shot_fpfh_tpu_torch.io.ply import write_ply

    rng = np.random.default_rng(5)
    ref = make_terrain(n, rng, scale=5.0, n_bumps=10)
    rot = _rotation_about([0.3, -0.2, 1.0], np.deg2rad(15.0))
    trans = np.array([0.4, -0.25, 0.15])
    scan = (ref @ rot.T + trans + rng.normal(scale=0.005, size=ref.shape)).astype(np.float32)
    write_ply(str(tmp_path / "scan.ply"), [scan], ["x", "y", "z"])
    write_ply(str(tmp_path / "ref.ply"), [ref], ["x", "y", "z"])
    common = ["--scan_file_path", str(tmp_path / "scan.ply"),
              "--ref_file_path", str(tmp_path / "ref.ply"), "--conf_file_path", "",
              "--neighborhood_size", "0.15", "--min_n_neighbors", "2",
              "--radius", "0.6", "--rho", "20", "--n_draws", "200", "--max_iter", "8"]
    truth = (torch.tensor(rot.T), torch.tensor(-rot.T @ trans))
    return scan, common, truth


def _run_clis(tmp_path, n, flag):
    """Both CLIs with ``flag`` and the port's without it; every run
    accepted, the three transforms within 1e-3 of each other and of the
    ground truth."""
    from shot_fpfh_tpu.cli import main as j_main
    from shot_fpfh_tpu_torch.cli import main as t_main
    from shot_fpfh_tpu_torch.core.transform import RigidTransform

    scan, common, (rot, trans) = _pair(tmp_path, n)
    runs = {"torch": (t_main, ["--device", "cpu", flag]), "plain": (t_main, ["--device", "cpu"]),
            "jax": (j_main, ["--n_devices", "1", flag])}
    got = {}
    for name, (main, extra) in runs.items():
        assert main(common + extra + ["--output_dir", str(tmp_path / name)]) == 0
        got[name] = _recovered(tmp_path / name / "scan_on_ref_post_icp.ply", scan)
    truth = RigidTransform(rot, trans)
    for a, b in (("torch", "jax"), ("torch", "plain"), ("jax", "plain")):
        _assert_close(got[a], got[b])
    _assert_close(got["torch"], truth)


def test_cli_debug_shot_matches_jax_cli(tmp_path, caplog):
    caplog.set_level(logging.INFO)
    try:
        _run_clis(tmp_path, 22_000, "--debug_shot")
    finally:
        j_shot.enable_debug_checks(False)
    messages = [r.getMessage() for r in caplog.records]
    assert "SHOT debug checks: 0 violations" in messages
    assert not t_shot._DEBUG["enabled"]
    assert not any(m.startswith("SHOT debug checks: ") and "out-of-range" in m for m in messages)


def test_cli_debug_nans_matches_jax_cli(tmp_path):
    try:
        _run_clis(tmp_path, 8_000, "--debug_nans")
    finally:
        jax.config.update("jax_debug_nans", False)
    # the mode is gone once main returns
    assert bool(torch.isnan(torch.zeros(1) / 0.0).all())


def test_nan_in_a_solve_raises_like_jax(rng):
    scan, ref, _, _ = _solver_batch(rng, batch=1)
    scan[0, 17, 1] = np.nan
    jax.config.update("jax_debug_nans", True)
    try:
        with pytest.raises(FloatingPointError, match="invalid value \\(nan\\)"):
            jax.block_until_ready(j_sv.solve_point_to_point(jnp.asarray(scan[0]),
                                                            jnp.asarray(ref[0])))
    finally:
        jax.config.update("jax_debug_nans", False)
    with pytest.raises(FloatingPointError, match="invalid value \\(nan\\) encountered in "):
        with NanCheck():
            t_sv.solve_point_to_point(torch.tensor(scan[0]), torch.tensor(ref[0]))
    with_nan = torch.tensor(scan[0])
    with pytest.raises(FloatingPointError, match="encountered in sum"):
        with NanCheck():
            with_nan.sum()
    assert bool(torch.tensor(scan[0]).sum().isnan())


def test_nan_check_skips_allocations_and_identities():
    x = torch.tensor([1.0, float("nan")])
    with NanCheck():
        torch.empty(3)
        x.new_empty(2)
        torch.empty_like(x)
        assert x.to(torch.float32) is x and x.contiguous() is x
        torch.ones(2).add_(1.0)
        with pytest.raises(FloatingPointError, match="encountered in add_"):
            torch.ones(2).add_(x)
        with pytest.raises(FloatingPointError, match="encountered in mul"):
            x * 2.0
    with NanCheck():
        _kernels.check_kernel("top2_match", (torch.ones(2), None))
        with pytest.raises(FloatingPointError, match="CUDA kernel radius_dist"):
            _kernels.check_kernel("radius_dist", (torch.ones(2), x))
    _kernels.check_kernel("radius_dist", (x,))     # no mode: no check


def test_perf_helpers_log_like_jax(caplog):
    caplog.set_level(logging.INFO)

    def work(x):
        return {"a": [x * 2, (x + 1,)]}

    for mod in (j_perf, t_perf):
        mod.timeit(work)(1.0)
        mod.runtime_alert(0.0)(work)(1.0)
        mod.Checkpoint()("stage")
    by_pkg = {}
    for r in caplog.records:
        text = re.sub(r"[0-9.e+-]+ seconds|: [0-9.e+-]+$", "#", r.getMessage())
        by_pkg.setdefault(r.name.split(".")[0], []).append((r.levelname, text))
    assert by_pkg["shot_fpfh_tpu"] == by_pkg["shot_fpfh_tpu_torch"]
    assert by_pkg["shot_fpfh_tpu"] == [("INFO", "Function work took #"),
                                       ("WARNING", "Function work took more than # (#)"),
                                       ("INFO", "stage#")]
    nested = {"x": [torch.ones(2), (torch.zeros(1), 3)], "y": "z"}
    assert t_perf.block(nested) is nested


def test_profiler_trace_holds_the_annotation(tmp_path):
    t_perf.start_profiler_trace(str(tmp_path))
    with t_perf.trace_annotation("library_test_span"):
        torch.ones(64).sum()
    path = Path(t_perf.stop_profiler_trace())
    assert path.parent == tmp_path
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "library_test_span" for e in events)


@pytest.mark.parametrize("module", ["", ".core", ".ops", ".models", ".io", ".registration",
                                    ".utils", ".parallel"])
def test_public_names_match_jax(module):
    jax_mod = importlib.import_module("shot_fpfh_tpu" + module)
    port = importlib.import_module("shot_fpfh_tpu_torch" + module)
    names = set(jax_mod.__all__) | set(getattr(jax_mod, "_LAZY", {}))
    excluded = EXCLUDED.get(module.lstrip("."), {})
    missing = sorted(n for n in names - set(excluded) if not hasattr(port, n))
    assert not missing
    assert set(excluded) <= names
    assert set(jax_mod.__all__) - set(excluded) <= set(port.__all__)
    if module == ".parallel":   # exactly JAX's names
        assert not excluded and set(port.__all__) == names
