"""Port parity: K8 (window fetch) and K7 (masked radius distances) through
their plain twins, and the grid functions that run them.

- ``window_distances`` (K8) against JAX ``grid_hash.window_distances`` and
  ``grid_radius_search`` / ``grid_nearest_neighbor`` (K7) against JAX's, on
  halo-1 and halo-2 grids, a grid without a cell table and far sentinel
  queries: each query's in-window (or in-radius) neighbor set exact, its
  distances atol 1e-6, gathered values exact.
- The twins against the interpreted TPU kernels ``fetch_windows_pallas``
  and ``grid_radius_search_pallas`` (8 queries in blocks of 2, as
  ``tests/test_torch_grid.py`` runs K3's), at the tolerances of
  ``tests/test_pallas_radius.py:54-61``: sorted distances atol 1e-5, counts
  exact, value sums atol 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shot_fpfh_tpu.ops import grid_hash as j_grid
from shot_fpfh_tpu.ops.pallas_radius import fetch_windows_pallas, grid_radius_search_pallas
from shot_fpfh_tpu_torch import _kernels
from shot_fpfh_tpu_torch.ops import grid_hash as t_grid
from shot_fpfh_tpu_torch.ops.radius_runs import fetch_windows_plain, radius_dist_plain

# The suite runs several pytest workers side by side on the CPU: one torch
# thread per worker keeps torch's OpenMP pool from oversubscribing the cores.
torch.set_num_threads(1)

FAR = 1.0e6  # the keypoint padding sentinel of ShotComputer._pad

# (halo, cell, radius, cell table)
GRIDS = [(1, 0.8, 0.8, True), (2, 0.4, 0.8, True), (1, 0.5, 0.5, False)]


def _case(rng, table: bool):
    cloud = (rng.normal(size=(2500, 3)) * 2.0).astype(np.float32)
    if not table:   # one far point: too many cells for a start table
        cloud = np.concatenate([cloud, [[5e3, 5e3, 5e3]]]).astype(np.float32)
    extras = rng.normal(size=(len(cloud), 3)).astype(np.float32)
    q = np.concatenate([cloud[:120] + 0.05 * rng.normal(size=(120, 3)),
                        np.full((2, 3), FAR)]).astype(np.float32)
    return cloud, extras, q


def _grids(cloud, extras, cell, halo, table):
    jg = j_grid.build_grid(cloud, cell, extras=extras, halo=halo)
    tg = t_grid.build_grid(cloud, cell, extras=extras, halo=halo, device="cpu")
    assert tg.has_table == table and jg.has_table == table
    return jg, tg


@pytest.mark.parametrize("halo,cell,radius,table", GRIDS)
def test_k8_window_matches_reference(rng, halo, cell, radius, table):
    cloud, extras, q = _case(rng, table)
    jg, tg = _grids(cloud, extras, cell, halo, table)
    j_vals, j_d, j_ok, j_rows = (np.asarray(x) for x in j_grid.window_distances(jg, jnp.asarray(q)))
    before = dict(_kernels.launch_counts)
    vals, d, ok, rows = t_grid.window_distances(tg, torch.tensor(q))
    assert _kernels.launch_counts == before        # CPU tensors: plain twin
    assert vals.shape == (len(q), 6, tg.window_cap) and d.shape == rows.shape == ok.shape
    vals, d, ok, rows = vals.numpy(), d.numpy(), ok.numpy(), rows.numpy()
    j_orig, t_orig = np.asarray(jg.orig_idx), tg.orig_idx.numpy()
    for i in range(len(q)):
        # JAX's window may be the xy-row superset of the z-column runs:
        # its in-radius set is the contract, the port's window a subset
        assert set(t_orig[rows[i][ok[i]]]) <= set(j_orig[j_rows[i][j_ok[i]]]), i
        j_in, t_in = j_ok[i] & (j_d[i] <= radius), ok[i] & (d[i] <= radius)
        want = dict(zip(j_orig[j_rows[i][j_in]], j_d[i][j_in]))
        got = dict(zip(t_orig[rows[i][t_in]], d[i][t_in]))
        assert got.keys() == want.keys(), i
        np.testing.assert_allclose([got[k] for k in want], list(want.values()), atol=1e-6)
        packed = np.concatenate([cloud, extras], 1)[t_orig[rows[i][ok[i]]]]
        np.testing.assert_array_equal(vals[i][:, ok[i]].T, packed)
    # padding slots hold row 0 and its distance; sentinels get no window
    pad = ~ok
    assert (rows[pad] == 0).all() and not ok[-2:].any()
    np.testing.assert_array_equal(vals.transpose(0, 2, 1)[pad],
                                  np.broadcast_to(tg.packed_sorted[0].numpy(), (pad.sum(), 6)))


@pytest.mark.parametrize("halo,cell,radius,table", GRIDS)
def test_k7_search_and_nearest_neighbor_match_reference(rng, halo, cell, radius, table):
    cloud, extras, q = _case(rng, table)
    jg, tg = _grids(cloud, extras, cell, halo, table)
    j_nbr, j_vals = j_grid.grid_radius_search(jg, jnp.asarray(q), radius, 96, with_values=True)
    before = dict(_kernels.launch_counts)
    nbr, vals = t_grid.grid_radius_search(tg, torch.tensor(q), radius, 96, with_values=True)
    assert _kernels.launch_counts == before
    j_idx, j_dist, j_mask = (np.asarray(x) for x in (j_nbr.idx, j_nbr.dist, j_nbr.mask))
    idx, dist, mask = nbr.idx.numpy(), nbr.dist.numpy(), nbr.mask.numpy()
    assert mask.sum(1).max() < 96                   # no ball reaches the cap
    packed = np.concatenate([cloud, extras], 1)
    for i in range(len(q)):
        assert set(idx[i][mask[i]]) == set(j_idx[i][j_mask[i]]), i
        np.testing.assert_allclose(dist[i][mask[i]], j_dist[i][j_mask[i]], atol=1e-6)
        np.testing.assert_array_equal(vals[i].numpy()[mask[i]], packed[idx[i][mask[i]]])
        np.testing.assert_allclose(np.asarray(j_vals)[i][j_mask[i]], packed[j_idx[i][j_mask[i]]])
    assert not mask[-2:].any() and np.isinf(dist[~mask]).all() and (idx[~mask] == 0).all()

    jd, ji = (np.asarray(x) for x in j_grid.grid_nearest_neighbor(jg, jnp.asarray(q)))
    td, ti = (x.numpy() for x in t_grid.grid_nearest_neighbor(tg, torch.tensor(q)))
    np.testing.assert_allclose(td, jd, atol=1e-6)
    np.testing.assert_array_equal(ti[np.isfinite(jd)], ji[np.isfinite(jd)])
    assert np.isinf(td[-2:]).all()


def test_k7_twin_is_the_masked_k8_twin(rng):
    """Given the same runs, K7's twin is K8's distance plane masked by the
    slot's validity and the radius (+inf keeps every valid slot)."""
    cloud, extras, q = _case(rng, True)
    tg = t_grid.build_grid(cloud, 0.4, extras=extras, halo=2, device="cpu")
    qt = torch.tensor(q)
    start, end = t_grid._zcolumn_runs(tg, qt)
    _, d, ok, rows = fetch_windows_plain(tg.packed_sorted, qt, start, end, tg.window_cap)
    inf = torch.full_like(d, float("inf"))
    for radius in (0.3, 0.8, float("inf")):
        k7_rows, k7_d = radius_dist_plain(tg.packed_sorted, qt, start, end, tg.window_cap, radius)
        assert torch.equal(k7_rows, rows)
        assert torch.equal(k7_d, torch.where(ok & (d <= radius), d, inf))


def test_window_without_rows_is_the_window(rng):
    """``with_rows=False`` (the window routes' call) returns the same
    values, distances and validity and no rows."""
    cloud, extras, q = _case(rng, True)
    tg = t_grid.build_grid(cloud, 0.4, extras=extras, halo=2, device="cpu")
    full = t_grid.window_distances(tg, torch.tensor(q))
    short = t_grid.window_distances(tg, torch.tensor(q), with_rows=False)
    assert short[3] is None and full[3] is not None
    for a, b in zip(short[:3], full[:3]):
        assert torch.equal(a, b)


def _reference_grid(rng):
    pts = (rng.normal(size=(350, 3)) * 2.0).astype(np.float32)
    extras = rng.normal(size=(350, 3)).astype(np.float32)
    return pts, extras, j_grid.build_grid(pts, 0.8, extras=extras)


def test_k8_twin_matches_interpreted_tpu_kernel(rng):
    pts, extras, jg = _reference_grid(rng)
    q, radius = pts[:8], 0.8
    p_vals, p_dist = (np.asarray(x) for x in fetch_windows_pallas(jg, jnp.asarray(q), radius,
                                                                  qb=2))
    tg = t_grid.build_grid(pts, 0.8, extras=extras, device="cpu")
    vals, d, ok, _ = (x.numpy() for x in t_grid.window_distances(tg, torch.tensor(q)))
    inside = ok & (d <= radius)
    finite = np.isfinite(p_dist)
    np.testing.assert_array_equal(inside.sum(1), finite.sum(1))
    for i in range(len(q)):
        np.testing.assert_allclose(np.sort(d[i][inside[i]]), np.sort(p_dist[i][finite[i]]),
                                   atol=1e-5)
        np.testing.assert_allclose(vals[i][:, inside[i]].sum(1),
                                   p_vals[i][:6, finite[i]].sum(1), atol=1e-3)


def test_k7_twin_matches_interpreted_tpu_kernel(rng):
    pts, extras, jg = _reference_grid(rng)
    q, radius = pts[:8], 0.8
    b, vb = grid_radius_search_pallas(jg, jnp.asarray(q), radius, 64, qb=2, with_values=True)
    tg = t_grid.build_grid(pts, 0.8, extras=extras, device="cpu")
    a, va = t_grid.grid_radius_search(tg, torch.tensor(q), radius, 64, with_values=True)
    da = np.sort(np.where(a.mask.numpy(), a.dist.numpy(), 1e9), axis=1)
    db = np.sort(np.where(np.asarray(b.mask), np.asarray(b.dist), 1e9), axis=1)
    np.testing.assert_allclose(da, db, atol=1e-5)
    np.testing.assert_array_equal(a.mask.numpy().sum(1), np.asarray(b.mask).sum(1))
    np.testing.assert_allclose(va.numpy().sum(axis=1), np.asarray(vb).sum(axis=1), atol=1e-3)
