"""Port parity: the single-program registration path
(``shot_fpfh_tpu_torch.registration.fused``, ``run_fused``, ``--fused``)
and the device ICP loop both ICPs share.

Each test holds the port against the JAX package on the same numpy inputs
(a ``make_pair`` terrain pair, normals computed once by JAX): the SHOT leg
in its single, bi-scale and shared-frame multiscale modes and the FPFH leg,
each on the brute route and the grid route (SG and the SPFH pass, on CPU
tensors their chunked twins), and K5's and K6's wrappers (``ops.shot_dma``)
on the grid legs' grids and keypoints, by the flip rule of
``tests/test_torch_shot.py`` (SHOT) and atol 1e-5 / the route rule of
``tests/test_torch_fpfh.py`` (FPFH); the matching
leg (``valid_match``, ``nn_idx``, ``n_matches`` equal, distances within
1e-5 relative); RANSAC with JAX's Gumbel noise injected (transform within
1e-5, inlier ratio equal); the whole program for the four descriptor
modes (``n_matches`` and convergence equal, RANSAC and ICP transforms
within 1e-4 rad / 1e-4); the shared ICP loop against JAX's ``_icp_loop``
stopped mid-way (``n_iters`` and convergence equal, transform within
1e-5); ``register_pair`` against the ground truth (2e-2 rad); and the CLI's
``--fused`` and its staging fallback.  The JAX references run under
``jax.jit``, once per leg (module-scoped fixtures).
"""

import functools
import json
import logging
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from shot_fpfh_tpu.core.subsampling import grid_subsample as j_subsample  # noqa: E402
from shot_fpfh_tpu.core.transform import RigidTransform as JTransform  # noqa: E402
from shot_fpfh_tpu.models.normals import compute_normals as j_normals  # noqa: E402
from shot_fpfh_tpu.ops import grid_hash as j_grid  # noqa: E402
from shot_fpfh_tpu.registration import fused as j_fused  # noqa: E402
from shot_fpfh_tpu.registration import icp as j_icp  # noqa: E402
from shot_fpfh_tpu.registration.matching import descriptor_sq_dists, top2_rows  # noqa: E402
from shot_fpfh_tpu_torch.core.transform import RigidTransform, rotation_angle  # noqa: E402
from shot_fpfh_tpu_torch.models import fpfh as t_fpfh  # noqa: E402
from shot_fpfh_tpu_torch.ops import grid_hash as t_grid  # noqa: E402
from shot_fpfh_tpu_torch.ops import shot_dma  # noqa: E402
from shot_fpfh_tpu_torch.ops.match import top2_match  # noqa: E402
from shot_fpfh_tpu_torch.registration import fused as t_fused  # noqa: E402
from shot_fpfh_tpu_torch.registration import icp as t_icp  # noqa: E402
from test_torch_fpfh import assert_route_rule  # noqa: E402
from test_torch_shot import assert_flip_rule  # noqa: E402
from test_torch_slice import _rotation_about  # noqa: E402

# The suite runs several pytest workers side by side on the CPU: one torch
# thread per worker keeps torch's OpenMP pool from oversubscribing the cores
# (it slowed every worker, JAX tests included, by up to 2x).
torch.set_num_threads(1)

KP_VOXEL, ICP_VOXEL, RADIUS, PAD = 0.25, 0.1, 0.5, 256
K_MAX, MIN_NB, N_DRAWS = 128, 10, 512
# bi-scale: frames at RADIUS, bins at RADIUS·PHI; multiscale radii
PHI = 1.5
MS_RADII = (RADIUS, RADIUS * PHI)
# the grid routes: the clouds' 1,800 points above a lowered threshold
GRID_MIN_POINTS = 1000
# the JAX program's ratio threshold.  JAX rounds SHOT's weights to bf16
# (the flip rule), so a distance ratio within ~1e-3 of the threshold can
# part the two packages' match sets by a row: at 0.95 one SHOT row of 213
# does on this pair; at 0.9 no row of any mode lies that close
FUSED_KW = dict(ratio_threshold=0.9, ransac_threshold=0.1, d_max=0.3, rms_threshold=1e-4,
                k_max=K_MAX, min_neighborhood_size=MIN_NB, n_draws=N_DRAWS, max_iter=40)
MODES = {"shot": dict(), "shot_bi_scale": dict(rf_radius=RADIUS),
         "shot_multiscale": dict(descriptor="shot_multiscale", ms_radii=MS_RADII),
         "fpfh": dict(descriptor="fpfh")}


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _pad(rows, mult=PAD):
    n = len(rows)
    out = np.zeros((-(-max(n, 1) // mult) * mult,) + rows.shape[1:], rows.dtype)
    out[:n] = rows
    return out, np.arange(len(out)) < n


class Pair:
    """The pair, its JAX normals, padded keypoints and ICP subsample."""

    def __init__(self):
        from test_pipeline import make_pair

        rng = np.random.default_rng(11)
        scan, ref, exact = make_pair(rng, n=1800)
        self.scan, self.ref = scan.astype(np.float32), ref.astype(np.float32)
        self.exact = exact
        self.sn = np.asarray(j_normals(self.scan, self.scan, k=20))
        self.rn = np.asarray(j_normals(self.ref, self.ref, k=20))
        self.scan_idx = np.asarray(j_subsample(self.scan, KP_VOXEL))
        self.ref_idx = np.asarray(j_subsample(self.ref, KP_VOXEL))
        self.scan_kp, self.scan_v = _pad(self.scan[self.scan_idx])
        self.ref_kp, self.ref_v = _pad(self.ref[self.ref_idx])
        self.sub, self.sub_v = _pad(self.scan[np.asarray(j_subsample(self.scan, ICP_VOXEL))])

    def gumbel(self):
        """JAX's noise of the fused program (``key(72)``), chunk by chunk."""
        keys = jax.random.split(jax.random.key(72), -(-N_DRAWS // t_fused.RANSAC_CHUNK))
        return np.stack([np.asarray(jax.random.gumbel(k, (t_fused.RANSAC_CHUNK,
                                                          len(self.scan_kp))))
                         for k in keys])


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture
def grid_routes(monkeypatch):
    for mod in (j_grid, t_grid):
        monkeypatch.setattr(mod, "AUTO_GRID_MIN_POINTS", GRID_MIN_POINTS)


# ---------------------------------------------------------------- descriptors --

def _j_shot_leg(kp, valid, sup, nrm, grid, mode):
    """JAX's SHOT leg of the fused program for ``mode`` (its multiscale
    stack, ``fused.py:210-219``, with shared first-scale frames)."""
    if mode == "shot_multiscale":
        descs, rfs = [], None
        for r in MS_RADII:
            d_s, rfs_s = j_fused._shot(kp, valid, sup, nrm, r, K_MAX, MIN_NB, grid=grid,
                                       local_rfs=rfs, return_rfs=True)
            rfs = rfs_s if rfs is None else rfs
            descs.append(d_s)
        return jnp.concatenate(descs, axis=1)
    radius, rf = (RADIUS * PHI, RADIUS) if mode == "shot_bi_scale" else (RADIUS, None)
    return j_fused._shot(kp, valid, sup, nrm, radius, K_MAX, MIN_NB, grid=grid, rf_radius=rf)


def _shot_cell(mode):
    return {"shot": RADIUS, "shot_bi_scale": RADIUS * PHI,
            "shot_multiscale": max(MS_RADII)}[mode]


@functools.lru_cache(maxsize=None)
def _j_shot(pair, mode, grid_route):
    """JAX's descriptors of both clouds, computed once per mode and route."""
    fn = jax.jit(functools.partial(_j_shot_leg, mode=mode))
    out = []
    for kp, v, sup, nrm in ((pair.scan_kp, pair.scan_v, pair.scan, pair.sn),
                            (pair.ref_kp, pair.ref_v, pair.ref, pair.rn)):
        grid = j_grid.build_grid(sup, _shot_cell(mode), extras=nrm) if grid_route else None
        out.append(np.asarray(fn(jnp.asarray(kp), jnp.asarray(v), jnp.asarray(sup),
                                 jnp.asarray(nrm), grid)))
    return out


def _t_descriptors(pair, opts, grids=(None, None), fpfh_grids=(None, None), kp_idx=(None, None)):
    return [t_fused._cloud_descriptors(
        _t(kp), _t(v, torch.bool), _t(sup), _t(nrm), idx, grid, fgrid, **opts)
        for (kp, v, sup, nrm), grid, fgrid, idx in zip(
            ((pair.scan_kp, pair.scan_v, pair.scan, pair.sn),
             (pair.ref_kp, pair.ref_v, pair.ref, pair.rn)), grids, fpfh_grids, kp_idx)]


def _leg_opts(mode):
    kw = MODES[mode]
    radius = RADIUS * PHI if mode == "shot_bi_scale" else RADIUS
    return dict(descriptor=kw.get("descriptor", "shot"), radius=radius, k_max=K_MAX,
                min_neighborhood_size=MIN_NB, rf_radius=kw.get("rf_radius"), fpfh_n_bins=5,
                fpfh_decorrelated=False, ms_radii=kw.get("ms_radii"))


def _shot_grids(pair, mode):
    return tuple(t_grid.build_grid(_t(sup), _shot_cell(mode), extras=_t(nrm))
                 for sup, nrm in ((pair.scan, pair.sn), (pair.ref, pair.rn)))


def _assert_shot_leg(pair, got, want, mode):
    """Both clouds' SHOT rows: padding rows zero, nine in ten valid rows
    non-empty, and the flip rule against JAX's."""
    width = 352 * (len(MS_RADII) if mode == "shot_multiscale" else 1)
    for g, w, v in zip(got, want, (pair.scan_v, pair.ref_v)):
        assert g.shape == (len(v), width)
        assert not g[~torch.as_tensor(v)].any()          # padding rows are zero
        assert float(g[torch.as_tensor(v)].any(dim=1).float().mean()) > 0.9
        assert_flip_rule(g.numpy(), w)


@pytest.mark.parametrize("route", ["brute", "window"])
@pytest.mark.parametrize("mode", ["shot", "shot_bi_scale", "shot_multiscale"])
def test_shot_leg_matches_jax(pair, mode, route):
    """The port's grid route (SG; on CPU tensors K8 + K1's twins) against
    JAX's grid window route; the brute route against JAX's."""
    grids = _shot_grids(pair, mode) if route != "brute" else (None, None)
    got = _t_descriptors(pair, _leg_opts(mode), grids)
    _assert_shot_leg(pair, got, _j_shot(pair, mode, route != "brute"), mode)


@pytest.mark.parametrize("mode", ["shot", "shot_bi_scale", "shot_multiscale"])
def test_shot_leg_run_kernel_matches_jax(pair, mode):
    """K5's wrapper (``ops.shot_dma.shot_descriptor_dma``, its twin on CPU
    tensors) called on the grid leg's grids and padded keypoints as the leg
    calls SG: own frames, bi-scale frames, and multiscale's two scales over
    one grid with the first scale's frames; padding rows zeroed as the leg
    zeroes them.  Held to JAX's grid window route by the flip rule."""
    opts = _leg_opts(mode)
    got = []
    for (kp, v), grid in zip(((pair.scan_kp, pair.scan_v), (pair.ref_kp, pair.ref_v)),
                             _shot_grids(pair, mode)):
        k5 = functools.partial(shot_dma.shot_descriptor_dma, grid, _t(kp),
                               min_neighborhood_size=MIN_NB)
        if mode == "shot_multiscale":
            first, rfs = k5(MS_RADII[0])
            desc = torch.cat([first] + [k5(r, rfs=rfs)[0] for r in MS_RADII[1:]], dim=1)
        else:
            desc, _ = k5(opts["radius"], rf_radius=opts["rf_radius"])
        got.append(torch.where(_t(v, torch.bool)[:, None], desc, 0.0))
    _assert_shot_leg(pair, got, _j_shot(pair, mode, True), mode)


@functools.lru_cache(maxsize=None)
def _j_fpfh(pair, grid_route):
    out = []
    for idx, v, sup, nrm in ((pair.scan_idx, pair.scan_v, pair.scan, pair.sn),
                             (pair.ref_idx, pair.ref_v, pair.ref, pair.rn)):
        grid = None
        if grid_route:
            grid = j_grid.build_grid(sup, RADIUS / 2, extras=nrm, halo=2)
            inv = np.zeros(len(sup), np.int32)
            inv[np.asarray(grid.orig_idx)] = np.arange(len(sup), dtype=np.int32)
            idx = inv[idx]
        fn = jax.jit(lambda i, v, s, n, g: j_fused._fpfh(i, v, s, n, RADIUS, K_MAX, 5, False,
                                                         grid=g))
        out.append(np.asarray(fn(jnp.asarray(_pad(idx.astype(np.int32))[0]), jnp.asarray(v),
                                 jnp.asarray(sup), jnp.asarray(nrm), grid)))
    return out


def _fpfh_grids(pair):
    return tuple(t_grid.build_grid(_t(sup), RADIUS / 2, extras=_t(nrm), halo=2)
                 for sup, nrm in ((pair.scan, pair.sn), (pair.ref, pair.rn)))


def _fpfh_kp_rows(pair, fgrids):
    """Each cloud's padded keypoints: rows of its grid's sorted table, or
    cloud indices without a grid."""
    out = []
    for g, idx in zip(fgrids, (pair.scan_idx, pair.ref_idx)):
        idx = torch.as_tensor(idx)
        out.append(t_fused._padded(idx if g is None else t_fpfh._sorted_rows(g, idx), PAD)[0])
    return out


@pytest.mark.parametrize("route", ["brute", "window"])
def test_fpfh_leg_matches_jax(pair, route):
    """Brute route atol 1e-5; the grid route (the SPFH pass's twin,
    sorted-order keypoints) by the SPFH route rule against JAX's."""
    fgrids = _fpfh_grids(pair) if route != "brute" else (None, None)
    got = _t_descriptors(pair, _leg_opts("fpfh"), fpfh_grids=fgrids,
                         kp_idx=_fpfh_kp_rows(pair, fgrids))
    for g, w, v in zip(got, _j_fpfh(pair, route != "brute"), (pair.scan_v, pair.ref_v)):
        assert g.shape == (len(v), 125) and not g[~torch.as_tensor(v)].any()
        if route == "brute":
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5)
        else:
            assert_route_rule(g.numpy(), w)


def test_fpfh_leg_run_kernel_matches_jax(pair):
    """K6's wrapper (``ops.shot_dma.spfh_sorted_dma``, its twin on CPU
    tensors) as the SPFH pass of the grid leg, on its grids, and the leg's
    aggregation over its sorted-order keypoints; padding rows zeroed.  Held
    to JAX's grid route by the SPFH route rule."""
    fgrids = _fpfh_grids(pair)
    for g, rows, v, w in zip(fgrids, _fpfh_kp_rows(pair, fgrids), (pair.scan_v, pair.ref_v),
                             _j_fpfh(pair, True)):
        spfh = shot_dma.spfh_sorted_dma(g, RADIUS, 5, False)
        desc = torch.where(_t(v, torch.bool)[:, None],
                           t_fpfh._fpfh_window_aggregate(g, spfh, rows, RADIUS), 0.0)
        assert desc.shape == (len(v), 125) and float(desc.sum()) > 0
        assert_route_rule(desc.numpy(), w)


# ------------------------------------------------------------------- matching --

def test_matching_leg_matches_jax(pair):
    """JAX's fused matching (``fused.py:234-243``) on JAX's SHOT
    descriptors, and the port's (K2's f32 twin) on the same descriptors."""
    scan_d, ref_d = _j_shot(pair, "shot", False)

    @jax.jit
    def j_match(scan_d, scan_v, ref_d, ref_v):
        ref_ok = jnp.any(ref_d != 0, axis=1) & ref_v
        d2 = jnp.where(ref_ok[None, :], descriptor_sq_dists(scan_d, ref_d), jnp.inf)
        nn_idx, d1_sq, d2_sq = top2_rows(d2)
        d1 = jnp.sqrt(jnp.maximum(d1_sq, 0.0))
        dsecond = jnp.sqrt(jnp.maximum(d2_sq, 0.0))
        scan_ok = jnp.any(scan_d != 0, axis=1) & scan_v
        ratio = d1 / jnp.where(dsecond > 0, dsecond, 1.0)
        return (nn_idx, d1_sq, d2_sq,
                scan_ok & (ratio <= FUSED_KW["ratio_threshold"]) & jnp.isfinite(d1))

    j_nn, j_d1, j_d2, j_valid = (np.asarray(x) for x in j_match(scan_d, pair.scan_v, ref_d,
                                                                pair.ref_v))
    sd, rd = _t(scan_d), _t(ref_d)
    sv, rv = _t(pair.scan_v, torch.bool), _t(pair.ref_v, torch.bool)
    nn_idx, valid = t_fused._ratio_match(sd, sv, rd, rv, FUSED_KW["ratio_threshold"])
    _, d1, d2 = top2_match(sd, rd, (rd != 0).any(dim=1) & rv, use_bf16=False)
    np.testing.assert_array_equal(valid.numpy(), j_valid)
    assert int(valid.sum()) == int(j_valid.sum()) > 20
    # every row that takes part (a zero row ties every ref of least norm)
    ok = pair.scan_v & np.any(scan_d != 0, axis=1)
    np.testing.assert_array_equal(nn_idx.numpy()[ok], j_nn[ok])
    np.testing.assert_allclose(d1.numpy()[ok], j_d1[ok], rtol=1e-5)
    np.testing.assert_allclose(d2.numpy()[ok], j_d2[ok], rtol=1e-5)


# ------------------------------------------------------- the whole program --

@functools.lru_cache(maxsize=None)
def _j_register(pair, mode):
    """JAX's ``register_pair`` on the grid routes (threshold lowered)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_grid, "AUTO_GRID_MIN_POINTS", GRID_MIN_POINTS)
        res = j_fused.register_pair(pair.scan, pair.sn, pair.ref, pair.rn,
                                    keypoint_voxel=KP_VOXEL, icp_voxel=ICP_VOXEL,
                                    radius=RADIUS * PHI if mode == "shot_bi_scale" else RADIUS,
                                    key=jax.random.key(72), **FUSED_KW, **MODES[mode])
        return jax.tree_util.tree_map(np.asarray, res._replace(scan_keypoint_idx=None,
                                                               ref_keypoint_idx=None))


def _t_register(pair, mode, **kw):
    return t_fused.register_pair(
        pair.scan, pair.sn, pair.ref, pair.rn, keypoint_voxel=KP_VOXEL, icp_voxel=ICP_VOXEL,
        radius=RADIUS * PHI if mode == "shot_bi_scale" else RADIUS, device="cpu",
        **FUSED_KW, **MODES[mode], **kw)


def _angle(a, b):
    return float(rotation_angle(torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))))


@pytest.mark.parametrize("mode", list(MODES))
def test_fused_registration_matches_jax(pair, grid_routes, mode):
    """``register_pair`` on the grid routes (SHOT window route, FPFH window
    route, ICP grid 1-NN) with JAX's Gumbel noise injected."""
    want = _j_register(pair, mode)
    got = _t_register(pair, mode, gumbel=torch.as_tensor(pair.gumbel()))
    np.testing.assert_array_equal(got.scan_keypoint_idx, pair.scan_idx)
    np.testing.assert_array_equal(got.ref_keypoint_idx, pair.ref_idx)
    assert int(got.n_matches) == int(want.n_matches) > 20
    assert bool(got.icp_converged) == bool(want.icp_converged)
    for name in ("ransac_transform", "icp_transform"):
        g, w = getattr(got, name), getattr(want, name)
        assert _angle(g.rotation, w.rotation) < 1e-4, name
        np.testing.assert_allclose(g.translation.numpy(), w.translation, atol=1e-4)
    assert float(got.ransac_inlier_ratio) == float(want.ransac_inlier_ratio)


def test_ransac_leg_with_jax_noise(pair, grid_routes):
    """The port's RANSAC on the port's matches (equal to JAX's, above) with
    JAX's noise: JAX's RANSAC transform within 1e-5 and its inlier ratio."""
    want = _j_register(pair, "shot")
    grids = tuple(t_grid.build_grid(_t(sup), RADIUS, extras=_t(nrm))
                  for sup, nrm in ((pair.scan, pair.sn), (pair.ref, pair.rn)))
    scan_d, ref_d = _t_descriptors(pair, _leg_opts("shot"), grids)
    sv, rv = _t(pair.scan_v, torch.bool), _t(pair.ref_v, torch.bool)
    nn_idx, valid = t_fused._ratio_match(scan_d, sv, ref_d, rv, FUSED_KW["ratio_threshold"])
    assert int(valid.sum()) == int(want.n_matches)
    tf, ratio = t_fused._ransac(_t(pair.scan_kp), _t(pair.ref_kp)[nn_idx], valid, valid.sum(),
                                FUSED_KW["ransac_threshold"], N_DRAWS, 4, None,
                                torch.as_tensor(pair.gumbel()))
    np.testing.assert_allclose(tf.rotation.numpy(), want.ransac_transform.rotation, atol=1e-5)
    np.testing.assert_allclose(tf.translation.numpy(), want.ransac_transform.translation,
                               atol=1e-5)
    assert float(ratio) == float(want.ransac_inlier_ratio)


def test_register_pair_recovers_ground_truth(pair):
    """Brute routes, the port's own seeded noise."""
    res = _t_register(pair, "shot")
    assert int(res.n_matches) > 20 and bool(res.icp_converged)
    assert _angle(res.icp_transform.rotation, pair.exact.rotation) < 2e-2
    assert float(torch.linalg.norm(res.icp_transform.translation
                                   - torch.as_tensor(np.asarray(pair.exact.translation)))) < 5e-2


# ------------------------------------------------------------ the ICP loop --

@pytest.mark.parametrize("point_to_plane", [True, False])
def test_icp_loop_matches_jax_stopped_midway(pair, point_to_plane):
    """From a perturbed start, an RMS threshold that stops JAX's loop after
    a few iterations (not on an ``ICP_BLOCK`` boundary): the port's device
    loop runs as many, converges alike and ends within 1e-5.  Point-to-plane
    through the ICP grid, point-to-point by brute force."""
    init_rot = (np.asarray(pair.exact.rotation)
                @ _rotation_about([0.8, -0.4, 0.6], 0.025)).astype(np.float32)
    init_t = np.asarray(pair.exact.translation) + np.float32([0.03, -0.02, 0.01])
    max_iter, thr = 30, (2e-3 if point_to_plane else 8e-3)
    nrm = pair.rn if point_to_plane else None
    j_grid_ = j_grid.build_grid(pair.ref, 0.3) if point_to_plane else None
    run = jax.jit(lambda s, r, n, rot, t, g: j_icp._icp_loop(
        s, r, n, JTransform(rot, t), 0.3, max_iter, thr, point_to_plane, grid=g))
    j = run(pair.sub[pair.sub_v], pair.ref, nrm, init_rot, init_t, j_grid_)
    assert 1 < int(j.n_iters) < max_iter and int(j.n_iters) % t_icp.ICP_BLOCK
    assert bool(j.has_converged)
    t_grid_ = t_grid.build_grid(_t(pair.ref), 0.3) if point_to_plane else None
    got = t_icp.icp_loop(_t(pair.sub[pair.sub_v]), _t(pair.ref),
                         None if nrm is None else _t(nrm),
                         RigidTransform(_t(init_rot), _t(init_t)), 0.3, max_iter, thr,
                         grid=t_grid_)
    assert int(got.n_iters) == int(j.n_iters)
    assert bool(got.has_converged) == bool(j.has_converged)
    np.testing.assert_allclose(got.transform.rotation.numpy(),
                               np.asarray(j.transform.rotation), atol=1e-5)
    np.testing.assert_allclose(got.transform.translation.numpy(),
                               np.asarray(j.transform.translation), atol=1e-5)


def test_icp_loop_padding_weights_change_nothing(pair):
    """Zero-weight padding rows (the fused program's padded scan) leave the
    loop's result as without them."""
    sub = _t(pair.sub[pair.sub_v])
    init = RigidTransform(_t(pair.exact.rotation), _t(pair.exact.translation))
    kw = dict(d_max=0.3, max_iter=5, rms_threshold=0.0)
    plain = t_icp.icp_loop(sub, _t(pair.ref), _t(pair.rn), init, **kw)
    padded = t_icp.icp_loop(_t(pair.sub), _t(pair.ref), _t(pair.rn), init,
                            weights=_t(pair.sub_v), **kw)
    assert int(plain.n_iters) == int(padded.n_iters) == 5
    np.testing.assert_allclose(padded.transform.rotation.numpy(),
                               plain.transform.rotation.numpy(), atol=1e-6)


# -------------------------------------------------------------------- the CLI --

@pytest.fixture(scope="module")
def ply_pair(pair, tmp_path_factory):
    from shot_fpfh_tpu_torch.io.ply import write_ply

    d = tmp_path_factory.mktemp("fused_cli")
    write_ply(str(d / "scan.ply"), [pair.scan], ["x", "y", "z"])
    write_ply(str(d / "ref.ply"), [pair.ref], ["x", "y", "z"])
    return d


def _cli(ply_pair, *extra):
    from shot_fpfh_tpu_torch.cli import main

    return main(["--device", "cpu", "--scan_file_path", str(ply_pair / "scan.ply"),
                 "--ref_file_path", str(ply_pair / "ref.ply"), "--conf_file_path", "",
                 "--output_dir", str(ply_pair / "out"), "--selection_algorithm", "subsampling",
                 "--neighborhood_size", str(KP_VOXEL), "--radius", str(RADIUS),
                 "--min_neighborhood_size", str(MIN_NB), "--k_max_descriptor", str(K_MAX),
                 "--matching_algorithm", "ratio", "--reject_threshold", "0.9",
                 "--n_draws", str(N_DRAWS), "--max_inliers_distance", "0.1",
                 "--d_max", "0.3", "--voxel_size", str(ICP_VOXEL), "--normals_k", "20",
                 "--metrics_json", str(ply_pair / "metrics.json"), *extra])


def test_cli_fused(ply_pair, caplog):
    """``--fused`` runs one ``fused`` stage after the two clouds' normals
    stages, accepted, with no staging warning; the aligned outputs are
    written."""
    with caplog.at_level(logging.INFO):
        assert _cli(ply_pair, "--fused") == 0
    assert not any("staging instead" in r.message for r in caplog.records)
    stages = json.loads((ply_pair / "metrics.json").read_text())["stages"]
    fused = [s for s in stages if s["stage"] == "fused"]
    assert len(fused) == 1 and fused[0]["matches"] > 20
    assert [s["stage"] for s in stages] == ["normals[knn]", "normals[knn]", "fused"]
    assert (ply_pair / "out" / "scan_on_ref_post_icp.ply").exists()


@pytest.mark.parametrize("extra,reason", [
    (("--matching_algorithm", "threshold"), "matching must be simple/ratio/double"),
    (("--descriptor_choice", "shot_multiscale", "--no-share_local_rfs"),
     "always shares first-scale local frames"),
])
def test_cli_fused_stages_what_it_does_not_cover(ply_pair, caplog, extra, reason):
    """JAX's fallback (``tests/test_pipeline.py:348-374``): warn, then stage."""
    with caplog.at_level(logging.WARNING):
        assert _cli(ply_pair, "--fused", "--disable_ply_writing", *extra) in (0, 1)
    warned = [r.message for r in caplog.records if "staging instead" in r.message]
    assert len(warned) == 1 and reason in warned[0]
    stages = [s["stage"] for s in json.loads((ply_pair / "metrics.json").read_text())["stages"]]
    assert "fused" not in stages and any(s.startswith("icp[") for s in stages)


def test_run_fused_records_keypoints_and_descriptor_mapping(pair, monkeypatch):
    """``run_fused`` maps ``descriptor_choice`` as JAX's does and records the
    program's keypoints for the post-ICP metrics."""
    from shot_fpfh_tpu_torch.pipeline import RegistrationPipeline

    seen = {}

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)

    real = t_fused.register_pair
    monkeypatch.setattr(t_fused, "register_pair", spy)
    p = RegistrationPipeline(scan=pair.scan, scan_normals=pair.sn, ref=pair.ref,
                             ref_normals=pair.rn, k_max_descriptor=K_MAX, device="cpu")
    res = p.run_fused(keypoint_voxel=KP_VOXEL, icp_voxel=ICP_VOXEL, radius=0.4,
                      descriptor_choice="shot_multi_scale", phi=1.5, n_scales=2, n_draws=256,
                      ratio_threshold=0.9, ransac_threshold=0.1, min_neighborhood_size=5)
    assert seen["descriptor"] == "shot_multiscale" and seen["radius"] == 0.4
    assert seen["ms_radii"] == pytest.approx((0.4, 0.6))
    np.testing.assert_array_equal(p.scan_keypoints, res.scan_keypoint_idx)
    assert [s["stage"] for s in p.metrics.stages] == ["fused"]
    overlap, inliers = p.compute_metrics_post_icp(res.icp_transform, 0.1)
    assert overlap > 0.9 and inliers > 0.5     # keypoints of two separate voxelings
    with pytest.raises(ValueError, match="does not cover"):
        p.run_fused(keypoint_voxel=KP_VOXEL, icp_voxel=ICP_VOXEL, radius=0.4,
                    descriptor_choice="bogus")
