"""Port parity: grid window, K3 radius covariance (plain twin), normals.

Tolerances: window contents exact against a brute-force radius set; K3
counts exact and covariance atol 1e-4 (bench.py:277-280) against both
``grid_radius_pca`` and ``radius_pca_pallas`` (interpreted off a TPU);
k=30 normals ``|n_port · n_jax| > 0.999`` for at least 99.9% of points.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import make_terrain  # noqa: E402
from shot_fpfh_tpu.models.normals import compute_normals as j_normals
from shot_fpfh_tpu.ops import grid_hash as j_grid
from shot_fpfh_tpu.ops.pallas_radius import radius_pca_pallas
from shot_fpfh_tpu_torch import _kernels
from shot_fpfh_tpu_torch.models.normals import compute_normals as t_normals
from shot_fpfh_tpu_torch.ops import grid_hash as t_grid
from shot_fpfh_tpu_torch.ops import shot_dma
from shot_fpfh_tpu_torch.ops.radius_pca import radius_pca, radius_pca_plain
from shot_fpfh_tpu_torch.utils.perf import StageMetrics

# The suite runs several pytest workers side by side on the CPU: one torch
# thread per worker keeps torch's OpenMP pool from oversubscribing the cores
# (it slowed every worker, JAX tests included, by up to 2x).
torch.set_num_threads(1)

FAR = 1.0e6  # the keypoint padding sentinel of ShotComputer._pad


@pytest.fixture
def cloud(rng):
    return (rng.normal(size=(2500, 3)) * 2.0).astype(np.float32)


@pytest.mark.parametrize("halo,cell,radius", [(1, 0.8, 0.8), (2, 0.4, 0.8), (1, 1.0, 0.6)])
def test_window_holds_exact_radius_neighborhood(cloud, halo, cell, radius):
    q = np.concatenate([cloud[:150], np.full((2, 3), FAR, np.float32)])
    grid = t_grid.build_grid(cloud, cell, halo=halo, device="cpu")
    vals, d, valid, rows = t_grid.window_distances(grid, torch.tensor(q))
    assert vals.shape == (len(q), 3, grid.window_cap)
    inside = (valid & (d <= radius)).numpy()
    idx = grid.orig_idx[rows].numpy()
    brute = np.linalg.norm(q[:, None] - cloud[None], axis=-1) <= radius
    for i in range(len(q)):
        assert set(idx[i][inside[i]]) == set(np.nonzero(brute[i])[0]), i
    assert not valid[-2:].any()   # sentinel queries get an empty window


def test_window_without_cell_table(cloud):
    """Sparse grids (too many cells for a start table) find the same runs
    by binary search."""
    sparse = np.concatenate([cloud, [[5e3, 5e3, 5e3]]]).astype(np.float32)
    grid = t_grid.build_grid(sparse, 0.5, device="cpu")
    assert not grid.has_table
    _, d, valid, rows = t_grid.window_distances(grid, torch.tensor(cloud[:50]))
    inside = (valid & (d <= 0.5)).numpy()
    brute = np.linalg.norm(cloud[:50, None] - sparse[None], axis=-1) <= 0.5
    np.testing.assert_array_equal(inside.sum(1), brute.sum(1))


GRID_READS = ("grid.dims", "grid.cells", "grid.cell_cap", "grid.window_cap")


@pytest.mark.parametrize("kind", ["surface", "volume", "no_table"])
def test_build_grid_blocking_reads(rng, kind):
    """``build_grid`` reads back the grid's dims, its occupied cells, the
    cell cap and, with a cell table, the window cap: four blocking reads on
    a surface cloud (one the run kernels would take in xy-row mode) and on
    a volume cloud, three on a grid without a table; no cap of the run
    kernels' xy-row mode is worked out."""
    if kind == "surface":
        xy = rng.uniform(-3, 3, size=(2600, 2))
        pts = np.column_stack([xy, 0.4 * np.sin(1.2 * xy[:, 0]) * np.cos(xy[:, 1])])
    else:
        pts = rng.uniform(-2, 2, size=(2600, 3)) * [1, 1, 2]
    if kind == "no_table":
        pts = np.concatenate([pts, [[5e3, 5e3, 5e3]]])
    metrics = StageMetrics()
    metrics.start("grid[test]")
    grid = t_grid.build_grid(torch.tensor(pts, dtype=torch.float32), 0.35, halo=2)
    stage = metrics.stop()
    assert grid.has_table == (kind != "no_table")
    if kind == "surface":
        assert shot_dma._xyrow_mode(grid)[0]
    want = GRID_READS if grid.has_table else GRID_READS[:3]
    # the stage's own two synchronizes, then the build's reads
    syncs = {k: v["count"] for k, v in stage["spans"].items() if k.startswith("sync[")}
    assert syncs == {"sync[stage]": 2, **{f"sync[{site}]": 1 for site in want}}
    assert stage["host_syncs"] == 2 + len(want)


@pytest.mark.parametrize("per_query", [False, True])
def test_radius_pca_plain_matches_reference(cloud, rng, per_query):
    q = cloud[:24]
    radius = rng.uniform(0.3, 0.8, 24).astype(np.float32) if per_query else 0.8
    jg = j_grid.build_grid(cloud, 0.8)
    j_cov, j_bary, j_cnt = j_grid.grid_radius_pca(jg, jnp.asarray(q), jnp.asarray(radius))
    # the interpreted TPU kernel is slow on CPU, and its compile grows with
    # the query block: its first 8 queries in blocks of 2 suffice
    p_cov, _, p_cnt = radius_pca_pallas(
        jg, jnp.asarray(q[:8]), jnp.asarray(radius if not per_query else radius[:8]), qb=2)
    tg = t_grid.build_grid(cloud, 0.8, device="cpu")
    before = dict(_kernels.launch_counts)
    t_cov, t_bary, t_cnt = radius_pca(tg, torch.tensor(q), torch.as_tensor(radius))
    assert _kernels.launch_counts == before        # CPU tensors: plain twin
    for cov, cnt in ((j_cov, j_cnt), (p_cov, p_cnt)):
        n = len(cnt)
        np.testing.assert_array_equal(t_cnt.numpy()[:n], np.asarray(cnt))
        np.testing.assert_allclose(t_cov.numpy()[:n], np.asarray(cov), atol=1e-4)
    np.testing.assert_allclose(t_bary.numpy(), np.asarray(j_bary), atol=1e-5)
    np.testing.assert_array_equal(
        radius_pca_plain(tg, torch.tensor(q), torch.as_tensor(radius))[2].numpy(),
        t_cnt.numpy())


@pytest.mark.parametrize("n,scale", [(22_000, 5.0), (2_000, 2.0)])
def test_knn_normals_match_reference(n, scale):
    """Both sides of AUTO_GRID_MIN_POINTS: streaming K3 route above it,
    exact k-NN below."""
    # the 22k cloud is the ref cloud of test_torch_slice's CLI pair, so a
    # run of both files in one process compiles the JAX normals once
    pts = make_terrain(n, np.random.default_rng(5 if n > 20_000 else n), scale=scale,
                       n_bumps=10).astype(np.float64)
    jn = np.asarray(j_normals(pts, pts, k=30))
    tn = t_normals(pts, pts, k=30, device="cpu").numpy()
    assert tn.shape == (n, 3)
    assert np.mean(np.abs((jn * tn).sum(1)) > 0.999) >= 0.999


def test_grid_nearest_neighbor_and_knn_auto(cloud, rng):
    q = (cloud[:300] + 0.05 * rng.normal(size=(300, 3))).astype(np.float32)
    jg, tg = j_grid.build_grid(cloud, 0.5), t_grid.build_grid(cloud, 0.5, device="cpu")
    jd, ji = (np.asarray(x) for x in j_grid.grid_nearest_neighbor(jg, jnp.asarray(q)))
    td, ti = (x.numpy() for x in t_grid.grid_nearest_neighbor(tg, torch.tensor(q)))
    np.testing.assert_allclose(td, jd, atol=1e-6)
    np.testing.assert_array_equal(ti[np.isfinite(jd)], ji[np.isfinite(jd)])
    big = make_terrain(21_000, rng, scale=5.0, n_bumps=10)
    nbr = t_grid.knn_auto(torch.tensor(big[:500]), torch.tensor(big), 12)
    d = np.linalg.norm(big[:500, None] - big[None], axis=-1)
    np.testing.assert_allclose(np.sort(nbr.dist.numpy(), 1), np.sort(d, 1)[:, :12], atol=1e-5)


@pytest.mark.parametrize("order", ["input", "random", "cell", "cluster", "no table"])
def test_k3_tile_plan_covers_every_run(cloud, rng, order):
    """K3's bookkeeping: the queries sorted by cell (a permutation that
    round-trips), their z-column runs, and per tile of TILE queries the
    union of the runs for each offset, which holds every non-empty run of
    the tile's queries; tiles with no run for an offset get (0, 0)."""
    from shot_fpfh_tpu_torch.ops.radius_pca import TILE, tile_plan

    pts = cloud
    if order == "cluster":   # one dense cell: unions past the kernel's staging buffer
        pts = np.concatenate([cloud, cloud[0] + rng.uniform(0, 1e-3, (3000, 3))]).astype(np.float32)
    if order == "no table":   # one far point: runs found by binary search
        pts = np.concatenate([cloud, [[5e3, 5e3, 5e3]]]).astype(np.float32)
    q = np.concatenate([pts[: 700], np.full((3, 3), FAR, np.float32)])
    if order == "random":
        q = q[rng.permutation(len(q))]
    grid = t_grid.build_grid(pts, 0.8, device="cpu")
    assert grid.has_table == (order != "no table")
    if order == "cell":
        q = grid.packed_sorted[:700, :3].numpy()
    qt = torch.tensor(q)
    plan = tile_plan(grid, qt)
    n = len(q)
    assert torch.equal(torch.sort(plan.order).values, torch.arange(n))
    assert torch.equal(plan.queries, qt[plan.order])
    back = torch.empty_like(plan.queries)
    back[plan.order] = plan.queries
    assert torch.equal(back, qt)
    start, end = t_grid._zcolumn_runs(grid, qt)
    assert torch.equal(plan.start, start[plan.order]) and torch.equal(plan.end, end[plan.order])
    cells = t_grid._query_cells(grid, plan.queries)
    ids = (cells[:, 0] * grid.dims[1] + cells[:, 1]) * grid.dims[2] + cells[:, 2]
    assert bool((ids[1:] >= ids[:-1]).all())                 # cell order
    tile = torch.arange(n) // TILE
    assert plan.lo.shape == plan.hi.shape == (-(-n // TILE), start.shape[1])
    nonempty = plan.end > plan.start
    assert bool((~nonempty | (plan.start >= plan.lo[tile])).all())
    assert bool((~nonempty | (plan.end <= plan.hi[tile])).all())
    # tight: each bound is some query's run end, or (0, 0) with no run
    for t in range(plan.lo.shape[0]):
        ne = nonempty[tile == t]
        for k in range(start.shape[1]):
            runs = ne[:, k]
            if runs.any():
                assert int(plan.lo[t, k]) == int(plan.start[tile == t][runs, k].min())
                assert int(plan.hi[t, k]) == int(plan.end[tile == t][runs, k].max())
            else:
                assert int(plan.lo[t, k]) == int(plan.hi[t, k]) == 0
    if order == "cluster":
        assert int((plan.hi - plan.lo).sum(1).max()) > 2048
