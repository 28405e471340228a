"""CUDA kernels against their plain PyTorch twins, on the card.

Marked ``gpu``: each test skips without a CUDA device (decided inside the
fixture, never at import).  Run them on a GPU machine with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`` (the suite's
``conftest.py`` imports JAX, which a GPU machine need not have; this file
needs only torch).  ``chip_smoke.py`` runs the same comparisons at the main
path's shapes.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import (  # noqa: E402
    aggregate_rule,
    make_terrain,
    rotation_about,
    rotation_gap,
    run_kernels_in_place,
    scale_terrain,
    twin_icp,
)
from shot_fpfh_tpu_torch import _kernels  # noqa: E402
from shot_fpfh_tpu_torch.ops import shot_dma  # noqa: E402
from shot_fpfh_tpu_torch.ops.grid_hash import build_grid, window_distances  # noqa: E402
from shot_fpfh_tpu_torch.ops.match import top2_match, top2_match_plain  # noqa: E402
from shot_fpfh_tpu_torch.ops.radius_pca import radius_pca, radius_pca_plain  # noqa: E402
from shot_fpfh_tpu_torch.ops.radius_runs import (  # noqa: E402
    _aggregate_launch,
    fetch_windows,
    fetch_windows_plain,
    fpfh_aggregate,
    fpfh_aggregate_plain,
    nearest,
    nearest_plain,
    radius_dist,
    radius_dist_plain,
)
from shot_fpfh_tpu_torch.ops.shot_fused import (  # noqa: E402
    shot_binning_histogram,
    shot_binning_histogram_plain,
    shot_grid,
    shot_window_chunked,
)
from shot_fpfh_tpu_torch.ops.spfh_fused import (  # noqa: E402
    spfh_grid,
    spfh_histogram,
    spfh_histogram_plain,
    spfh_window_chunked,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _surface(rng, n, device):
    xy = rng.uniform(-3, 3, size=(n, 2))
    z = 0.4 * np.sin(xy[:, 0]) * np.cos(0.7 * xy[:, 1])
    pts = np.column_stack([xy, z]) + rng.normal(scale=0.01, size=(n, 3))
    return torch.tensor(pts.astype(np.float32), device=device)


def _counted(name, fn):
    before = _kernels.launch_counts[name]
    out = fn()
    torch.cuda.synchronize()
    assert _kernels.launch_counts[name] == before + 1
    return out


def test_k3_radius_pca_kernel(cuda, rng):
    pts = _surface(rng, 30_000, cuda)
    grid = build_grid(pts, 0.3)
    radius = torch.tensor(rng.uniform(0.1, 0.3, 5000).astype(np.float32), device=cuda)
    cov, bary, cnt = _counted("radius_pca", lambda: radius_pca(grid, pts[:5000], radius))
    cov_p, bary_p, cnt_p = radius_pca_plain(grid, pts[:5000], radius)
    assert torch.equal(cnt, cnt_p)
    torch.testing.assert_close(cov, cov_p, atol=1e-4, rtol=0)
    torch.testing.assert_close(bary, bary_p, atol=1e-5, rtol=0)


@pytest.mark.parametrize("use_bf16", [False, True])
def test_k2_top2_kernel(cuda, rng, use_bf16, dim=352):
    a = torch.randn(1000, dim, device=cuda)
    b = torch.randn(1537, dim, device=cuda)
    valid = torch.rand(1537, device=cuda) > 0.05
    i1, d1, d2 = _counted("top2_match", lambda: top2_match(a, b, valid, use_bf16))
    j1, e1, e2 = top2_match_plain(a, b, valid, use_bf16)
    assert float((i1 == j1).float().mean()) >= (0.97 if use_bf16 else 1.0)
    rtol = 2e-3 if use_bf16 else 1e-4
    torch.testing.assert_close(d1, e1, rtol=rtol, atol=0)
    assert bool(valid[i1].all())


def test_k2_top2_kernel_fpfh_width(cuda, rng):
    """FPFH's 125 bins: not a multiple of the 32 features K2 stages a step."""
    test_k2_top2_kernel(cuda, rng, True, dim=125)


def test_k2_top2_kernel_multiscale_width(cuda, rng):
    """Two-scale SHOT's 704 columns."""
    test_k2_top2_kernel(cuda, rng, True, dim=704)


def _exact_refs(rng, n, m, dim, device):
    """Whole numbers in [-2, 2] (every product and sum exact in f32, so the
    kernel's and the twin's distances are equal) with ref rows repeated and
    scan rows copied into the refs: exact ties at first and second place."""
    a = rng.integers(-2, 3, size=(n, dim)).astype(np.float32)
    b = rng.integers(-2, 3, size=(m, dim)).astype(np.float32)
    b[m // 3: 2 * (m // 3)] = b[: m // 3]
    k = min(n // 2, m // 3)
    b[m - k:] = a[:k]
    return torch.tensor(a, device=device), torch.tensor(b, device=device)


@pytest.mark.parametrize("use_bf16", [False, True])
@pytest.mark.parametrize("n,m", [(1, 5), (1, 300), (200, 77), (129, 257), (257, 129), (1000, 1),
                                 (50, 0)])
def test_k2_top2_kernel_ragged(cuda, rng, use_bf16, n, m):
    """Ragged n and m (one row, under one 128-ref tile, one over a tile
    multiple) are masked inside the kernel: indices and distances equal the
    twin's on exact inputs."""
    a, b = _exact_refs(rng, n, m, 352, cuda)
    valid = torch.tensor(rng.uniform(size=m) > 0.1, device=cuda)
    valid[:1] = True
    got = _counted("top2_match", lambda: top2_match(a, b, valid, use_bf16))
    for g, w in zip(got, top2_match_plain(a, b, valid, use_bf16)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("use_bf16", [False, True])
def test_k2_top2_kernel_every_ref_invalid(cuda, rng, use_bf16):
    a, b = torch.randn(300, 352, device=cuda), torch.randn(500, 352, device=cuda)
    valid = torch.zeros(500, dtype=torch.bool, device=cuda)
    i1, d1, d2 = _counted("top2_match", lambda: top2_match(a, b, valid, use_bf16))
    j1, _, _ = top2_match_plain(a, b, valid, use_bf16)
    assert torch.isinf(d1).all() and torch.isinf(d2).all()
    assert torch.equal(i1, j1)


@pytest.mark.parametrize("use_bf16", [False, True])
@pytest.mark.parametrize("dim", [352, 125, 704])
def test_k2_top2_kernel_duplicate_refs(cuda, rng, use_bf16, dim):
    """Duplicated ref rows tie exactly: the lower index wins and the tie
    goes into d2, as in the twin, on every row."""
    a, b = _exact_refs(rng, 1000, 3000, dim, cuda)
    valid = torch.tensor(rng.uniform(size=3000) > 0.05, device=cuda)
    i1, d1, d2 = _counted("top2_match", lambda: top2_match(a, b, valid, use_bf16))
    j1, e1, e2 = top2_match_plain(a, b, valid, use_bf16)
    assert torch.equal(i1, j1) and torch.equal(d1, e1) and torch.equal(d2, e2)
    assert bool((d1 == 0).any()) and bool((d2 == d1).any())


@pytest.mark.parametrize("splits", [1, 3, 5, 7, 19])
def test_k2_top2_kernel_split_counts(cuda, rng, monkeypatch, splits):
    """Column splits that do not divide the ref tiles (19 of 20 tiles, 7 of
    20, ...) merge in split order to the twin's result, in both modes."""
    from shot_fpfh_tpu_torch.ops import match as match_ops

    monkeypatch.setattr(match_ops, "column_splits", lambda n, m, sms: splits)
    a, b = _exact_refs(rng, 300, 2500, 352, cuda)
    valid = torch.tensor(rng.uniform(size=2500) > 0.05, device=cuda)
    for use_bf16 in (False, True):
        got = _counted("top2_match", lambda: top2_match(a, b, valid, use_bf16))
        for g, w in zip(got, top2_match_plain(a, b, valid, use_bf16)):
            assert torch.equal(g, w)


def _k3_sums(grid, queries, radius):
    cov, bary, cnt = _counted("radius_pca", lambda: radius_pca(grid, queries, radius))
    return cov, bary, cnt


def test_k3_radius_pca_kernel_query_order(cuda, rng):
    """The same queries in cell order and in a random order give equal
    outputs: each thread adds its own runs' rows in one fixed order, whatever
    tile it lands in."""
    pts = _surface(rng, 30_000, cuda)
    grid = build_grid(pts, 0.3)
    cell_order = grid.packed_sorted[:, :3]
    radius = torch.tensor(rng.uniform(0.1, 0.3, 30_000).astype(np.float32), device=cuda)
    perm = torch.tensor(rng.permutation(30_000), device=cuda)
    got = _k3_sums(grid, cell_order[perm], radius[perm])
    want = _k3_sums(grid, cell_order, radius)
    for g, w in zip(got, want):
        assert torch.equal(g, w[perm])
    cov_p, _, cnt_p = radius_pca_plain(grid, cell_order, radius)
    assert torch.equal(want[2], cnt_p)
    torch.testing.assert_close(want[0], cov_p, atol=1e-4, rtol=0)


@pytest.mark.parametrize("cluster", [6_000, 40_000])
def test_k3_radius_pca_kernel_dense_cluster(cuda, rng, cluster):
    """One dense cell beside a surface: its tiles' unions exceed the staging
    buffer (2,048 rows: staged in chunks) or, at 40,000 points, the staged
    route's limit (each thread then reads its runs from device memory);
    counts stay exact."""
    pts = _surface(rng, 20_000, cuda)
    blob = pts[0] + 0.01 * torch.rand(cluster, 3, device=cuda)
    cloud = torch.cat([pts, blob])
    grid = build_grid(cloud, 0.3)
    q = torch.cat([cloud[::9], blob[:500]])
    for radius in (0.3, 0.05):
        cov, bary, cnt = _k3_sums(grid, q, radius)
        cov_p, bary_p, cnt_p = radius_pca_plain(grid, q, radius)
        assert torch.equal(cnt, cnt_p)
        assert int(cnt.max()) >= cluster
        torch.testing.assert_close(cov, cov_p, atol=1e-4, rtol=0)
        torch.testing.assert_close(bary, bary_p, atol=1e-5, rtol=0)


@pytest.mark.parametrize("table", [True, False])
@pytest.mark.parametrize("halo", [1, 2])
def test_k3_radius_pca_kernel_bookkeeping_equals_tile_plan(cuda, rng, table, halo):
    """The kernel finds its queries' runs and its tiles' unions itself,
    from the cell-start table or, on a grid too sparse for one, by binary
    search over the cell ids: its cell order and unions equal ``tile_plan``'s
    and its counts the twin's."""
    from shot_fpfh_tpu_torch.ops.grid_hash import radius_sq
    from shot_fpfh_tpu_torch.ops.radius_pca import cell_moments, cell_order, tile_plan

    pts = _surface(rng, 20_000, cuda)
    if not table:   # one far point: more cells than the table may hold
        pts = torch.cat([pts, torch.full((1, 3), 1e4, device=cuda)])
    grid = build_grid(pts, 0.3, halo=halo)
    assert grid.has_table == table
    q = pts[torch.tensor(rng.permutation(pts.shape[0])[:5000], device=cuda)].contiguous()
    radius = torch.tensor(rng.uniform(0.1, 0.3, 5000).astype(np.float32), device=cuda)
    plan = tile_plan(grid, q)
    order = _counted("radius_pca_keys", lambda: cell_order(grid, q))
    unions = (torch.empty_like(plan.lo), torch.empty_like(plan.hi))
    sums = _counted("radius_pca", lambda: cell_moments(grid, q, radius_sq(radius, 5000, cuda),
                                                       order, unions))
    assert torch.equal(order, plan.order)
    assert torch.equal(unions[0], plan.lo) and torch.equal(unions[1], plan.hi)
    assert torch.equal(sums[:, 0], radius_pca_plain(grid, q, radius)[2])


def test_k3_radius_pca_kernel_empty_windows(cuda, rng):
    """Queries whose runs are all empty (far off the grid, below and above
    its z range, in an empty corner) get all-zero sums: count 0, covariance
    0, barycenter the query."""
    pts = _surface(rng, 30_000, cuda)
    grid = build_grid(pts, 0.3)
    far = torch.tensor([[1e6, 1e6, 1e6], [0.0, 0.0, -50.0], [0.0, 0.0, 50.0],
                        [-1e3, 0.0, 0.0]], device=cuda)
    q = torch.cat([far, pts[:1000]])
    cov, bary, cnt = _k3_sums(grid, q, 0.3)
    assert not cnt[:4].any() and not cov[:4].any() and torch.equal(bary[:4], far)
    assert bool((cnt[4:] >= 1).all())
    assert torch.equal(cnt, radius_pca_plain(grid, q, 0.3)[2])


@pytest.mark.parametrize("own_frames", [True, False])
def test_k1_shot_kernel(cuda, rng, own_frames):
    pts = _surface(rng, 30_000, cuda)
    nrm = torch.nn.functional.normalize(torch.randn_like(pts), dim=1)
    grid = build_grid(pts, 0.25, extras=nrm, halo=2)
    kp = pts[::50]
    vals, d, valid, _ = window_distances(grid, kp)
    dist = torch.where(valid & (d <= 0.5), d, torch.full_like(d, float("inf")))
    hist_p, rfs_p = shot_binning_histogram_plain(vals, dist, kp, None, 0.5)
    if own_frames:
        hist, rfs = _counted("shot_binning_histogram",
                             lambda: shot_binning_histogram(vals, dist, kp, None, 0.5))
        torch.testing.assert_close(rfs, rfs_p, atol=5e-4, rtol=0)
        # SHOT's hard bins jump at their edges (a neighbor on the frame's
        # xy plane changes elevation cell with a 1e-7 frame change), so the
        # histograms are compared under the kernel's own frames
        hist_p = shot_binning_histogram_plain(vals, dist, kp, rfs, 0.5)
    else:
        hist = _counted("shot_binning_histogram",
                        lambda: shot_binning_histogram(vals, dist, kp, rfs_p, 0.5))
    _assert_shot_flip_rule(hist, hist_p)


def _assert_shot_flip_rule(got, want):
    diff = (got - want).abs()
    assert float((diff > 5e-3 + 1e-2 * want.abs()).float().mean()) <= 3e-3
    assert float(diff.max()) <= 0.1


def test_k1_shot_kernel_bi_scale(cuda, rng):
    """Frames from the rf plane (one keypoint's rf plane emptied: identity),
    bins from the descriptor plane, as the twin."""
    pts = _surface(rng, 30_000, cuda)
    nrm = torch.nn.functional.normalize(torch.randn_like(pts), dim=1)
    grid = build_grid(pts, 0.6, extras=nrm, halo=2)
    kp = pts[::50]
    vals, d, valid, _ = window_distances(grid, kp)
    inf = torch.full_like(d, float("inf"))
    dist = torch.where(valid & (d <= 1.2), d, inf)
    rf_dist = torch.where(valid & (d <= 0.4), d, inf)
    rf_dist[7] = float("inf")
    hist, rfs = _counted("shot_binning_histogram", lambda: shot_binning_histogram(
        vals, dist, kp, None, 1.2, rf_dist_inf=rf_dist, rf_radius=0.4))
    hist_p, rfs_p = shot_binning_histogram_plain(vals, dist, kp, None, 1.2, rf_dist, 0.4)
    torch.testing.assert_close(rfs, rfs_p, atol=5e-4, rtol=0)
    assert torch.equal(rfs[7].cpu(), torch.eye(3))
    _assert_shot_flip_rule(hist, shot_binning_histogram_plain(vals, dist, kp, rfs, 1.2))


def _k1_window(rng, q, w, fill, device, radius=1.0):
    """A synthetic K1 input: q keypoints, each with a window of w lanes
    around it, each lane finite with probability ``fill`` (d is the lane's
    distance to the keypoint, within ``radius``); unit normals."""
    pts = rng.normal(scale=0.3, size=(q, 3, w)) * np.array([1.0, 0.6, 0.2])[None, :, None]
    pts *= np.minimum(1.0, 0.95 * radius / np.linalg.norm(pts, axis=1, keepdims=True))
    kp = rng.normal(size=(q, 3))
    nrm = rng.normal(size=(q, 3, w)) + np.array([0.0, 0.0, 3.0])[None, :, None]
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    vals = np.concatenate([pts + kp[:, :, None], nrm], axis=1).astype(np.float32)
    dist = np.linalg.norm(pts, axis=1).astype(np.float32)
    dist[rng.uniform(size=(q, w)) >= fill] = np.inf
    return tuple(torch.tensor(a, device=device) for a in (vals, dist, kp.astype(np.float32)))


def _check_k1(vals, dist, kp, radius, rf_dist=None, rf_radius=None):
    """K1 in its three modes against the twin: frames within 5e-4, the
    histograms by the flip rule under the same frames."""
    rf = dict(rf_dist_inf=rf_dist, rf_radius=rf_radius)
    hist, rfs = _counted("shot_binning_histogram",
                         lambda: shot_binning_histogram(vals, dist, kp, None, radius, **rf))
    _, rfs_p = shot_binning_histogram_plain(vals, dist, kp, None, radius, rf_dist, rf_radius)
    torch.testing.assert_close(rfs, rfs_p, atol=5e-4, rtol=0)
    _assert_shot_flip_rule(hist, shot_binning_histogram_plain(vals, dist, kp, rfs, radius))
    given = _counted("shot_binning_histogram",
                     lambda: shot_binning_histogram(vals, dist, kp, rfs_p, radius))
    _assert_shot_flip_rule(given, shot_binning_histogram_plain(vals, dist, kp, rfs_p, radius))
    return hist, rfs


# (keypoints, window width, finite fraction): Q under and not a multiple of
# the 8 keypoints a block, W under 32 and not a multiple of 4, windows with
# every lane finite, W past K1's 128-lane load step
K1_SHAPES = [(1, 5, 0.6), (13, 31, 1.0), (9, 37, 0.5), (40, 721, 0.45), (17, 1000, 1.0),
             (8, 130, 0.0)]


@pytest.mark.parametrize("q,w,fill", K1_SHAPES)
@pytest.mark.parametrize("bi_scale", [False, True])
def test_k1_shot_kernel_edge_shapes(cuda, rng, q, w, fill, bi_scale):
    """Own, given and bi-scale frames on synthetic windows; a window with no
    finite lane gets the identity frame and a zero histogram."""
    vals, dist, kp = _k1_window(rng, q, w, fill, cuda)
    dist[0] = float("inf")
    rf = {}
    if bi_scale:   # the frame plane: the lanes within 0.6 of the keypoint
        rf = dict(rf_dist=torch.where(dist <= 0.6, dist, torch.full_like(dist, float("inf"))),
                  rf_radius=0.6)
    hist, rfs = _check_k1(vals, dist, kp, 1.0, **rf)
    assert not hist[0].any() and torch.equal(rfs[0].cpu(), torch.eye(3))
    assert (float(hist.sum()) > 0) == (fill > 0 and q > 1)


def test_k1_shot_kernel_tied_sign_votes(cuda, rng):
    """Neighbors in ± pairs about the keypoint (at the origin): each
    projection splits the votes evenly, so a tie keeps the Jacobi's signs in
    both packages; one window also holds its keypoint (d = 0: in the frame
    plane, not binned)."""
    half = rng.normal(size=(6, 3, 40)) * np.array([0.5, 0.3, 0.05])[None, :, None]
    pts = np.concatenate([half, -half], axis=2)
    pts[1, :, 0] = 0.0
    nrm = np.broadcast_to(np.array([0.0, 0.0, 1.0])[None, :, None], pts.shape)
    vals = torch.tensor(np.concatenate([pts, nrm], axis=1).astype(np.float32), device=cuda)
    dist = torch.tensor(np.linalg.norm(pts, axis=1).astype(np.float32), device=cuda)
    kp = torch.zeros((6, 3), device=cuda)
    _check_k1(vals, dist, kp, float(dist.max()) * 1.01)


def _synthetic_runs(rng, q, n_runs, n, device, longest=80):
    """Runs of sorted rows: lengths 0..longest (a third of them empty, many
    past 32 rows), starts anywhere in an n-row table."""
    lengths = rng.integers(0, longest + 1, size=(q, n_runs))
    lengths[rng.uniform(size=(q, n_runs)) < 1 / 3] = 0
    start = rng.integers(0, n - longest, size=(q, n_runs))
    return (torch.tensor(start, device=device), torch.tensor(start + lengths, device=device),
            int(lengths.sum(1).max()))


@pytest.mark.parametrize("features", [3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("n_runs", [9, 25, 40])
def test_k8_fetch_windows_kernel_synthetic_runs(cuda, rng, features, n_runs):
    """K8 equals its twin bit for bit, with and without the rows plane, on
    synthetic runs (empty ones, runs past 32 rows, more runs than a warp
    has lanes) at windows wider than the runs, of every width mod 4, and
    narrower (the runs cut at W)."""
    n, q = 5000, 45
    table = torch.tensor(rng.normal(size=(n, features)).astype(np.float32), device=cuda)
    queries = torch.tensor(rng.normal(size=(q, 3)).astype(np.float32), device=cuda)
    start, end, total = _synthetic_runs(rng, q, n_runs, n, cuda)
    for w in (total + 3, total + 4, total + 5, total + 6, total // 3, 1, 2, 3, 33):
        want = fetch_windows_plain(table, queries, start, end, w)
        got = _counted("fetch_windows", lambda: fetch_windows(table, queries, start, end, w))
        for g, x in zip(got, want):
            assert torch.equal(g, x), w
        got = fetch_windows(table, queries, start, end, w, with_rows=False)
        assert got[3] is None
        for g, x in zip(got[:3], want[:3]):
            assert torch.equal(g, x), w


@pytest.mark.parametrize("features", [3, 6, 8])
@pytest.mark.parametrize("n_runs", [9, 25, 40])
def test_k7_radius_dist_kernel_synthetic_runs(cuda, rng, features, n_runs):
    """K7 on the same synthetic runs: bit-identical to its twin at every
    window width mod 4 and at a width that cuts the runs, on tables of 3 to
    8 columns."""
    n, q = 5000, 45
    table = torch.tensor(rng.normal(size=(n, features)).astype(np.float32), device=cuda)
    queries = torch.tensor(rng.normal(size=(q, 3)).astype(np.float32), device=cuda)
    start, end, total = _synthetic_runs(rng, q, n_runs, n, cuda)
    for w in (total + 3, total + 4, total + 5, total + 6, total // 3, 1, 3):
        for radius in (1.5, float("inf")):
            got = _counted("radius_dist",
                           lambda: radius_dist(table, queries, start, end, w, radius))
            want = radius_dist_plain(table, queries, start, end, w, radius)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (w, radius)


@pytest.mark.parametrize("mode", ["own", "given", "bi_scale"])
def test_k5_shot_runs_kernel(cuda, rng, mode):
    """K5 against its twin: frames atol 5e-4, histograms (min-neighborhood
    rule off, not normalized) by the flip rule under the same frames; a far
    keypoint gets a zero row and the identity frame."""
    pts = _surface(rng, 30_000, cuda)
    nrm = torch.nn.functional.normalize(torch.randn_like(pts), dim=1)
    radius, rf_radius = (1.2, 0.4) if mode == "bi_scale" else (0.5, None)
    grid = build_grid(pts, radius / 2, extras=nrm, halo=2)
    assert shot_dma._xyrow_mode(grid)[0]
    kp = torch.cat([pts[::41], torch.full((1, 3), 1e6, device=cuda)])
    raw = dict(normalize=False, min_neighborhood_size=-1)
    _, rfs_p = shot_dma.shot_descriptor_dma_plain(grid, kp, radius, rf_radius=rf_radius, **raw)
    rfs_in = rfs_p if mode == "given" else None
    hist, rfs = _counted("shot_runs", lambda: shot_dma.shot_descriptor_dma(
        grid, kp, radius, rfs=rfs_in, rf_radius=rf_radius, **raw))
    torch.testing.assert_close(rfs, rfs_p, atol=5e-4, rtol=0)
    hist_p, _ = shot_dma.shot_descriptor_dma_plain(grid, kp, radius, rfs=rfs, **raw)
    _assert_shot_flip_rule(hist, hist_p)
    assert not hist[-1].any() and torch.equal(rfs[-1].cpu(), torch.eye(3))
    assert float(hist.sum()) > 0


# K5 lists a warp's frame-plane rows in shared memory (kFrameSlots in
# csrc/shot_runs.cu); a larger frame plane walks the runs again
K5_FRAME_SLOTS = 1024


def _k5_cloud(rng):
    """``(points, normals, special keypoints)``: a 20k-point surface on
    [-3, 3]² with random unit normals, a cluster of 3,000 points within 0.06
    of one surface point, and 40 ± pairs (whole multiples of 1/64, so each
    pair is exactly symmetric) about a point 2 above the surface.  The
    special keypoints: the cluster's surface point, the pairs' center (tied
    sign votes), a point 0.6 above the surface far from both (no neighbor
    within 0.5, some within 1.2) and a far point."""
    xy = rng.uniform(-3, 3, size=(20_000, 2))
    z = 0.4 * np.sin(xy[:, 0]) * np.cos(0.7 * xy[:, 1])
    surface = np.column_stack([xy, z]) + rng.normal(scale=0.01, size=(20_000, 3))
    hub = surface[0]
    cluster = hub + rng.uniform(-0.03, 0.03, size=(3000, 3))
    center = np.array([0.5, -0.25, 2.0])
    v = np.stack([rng.integers(-20, 21, 40), rng.integers(-12, 13, 40),
                  rng.integers(-2, 3, 40)], axis=1) / 64.0
    v[(v == 0).all(axis=1)] = [1 / 64.0, 0.0, 0.0]
    pts = np.concatenate([surface, cluster, center + v, center - v]).astype(np.float32)
    nrm = rng.normal(size=pts.shape)
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    away = np.minimum(np.linalg.norm(xy - hub[:2], axis=1), np.linalg.norm(xy - center[:2], axis=1))
    above = surface[int(np.argmax(away))] + np.array([0.0, 0.0, 0.6])
    special = np.stack([hub, center, above, np.full(3, 1e6)]).astype(np.float32)
    return pts, nrm, special


def _check_k5(grid, kp, radius, rf_radius=None):
    """K5 with its own (or bi-scale) frames and with given frames against the
    twin: frames within 5e-4, the histograms by the flip rule under the same
    frames, and the same neighborhoods kept by the min-neighborhood rule
    (which reads the kernel's neighbor count) at several thresholds."""
    raw = dict(normalize=False, min_neighborhood_size=-1)
    hist, rfs = _counted("shot_runs", lambda: shot_dma.shot_descriptor_dma(
        grid, kp, radius, rf_radius=rf_radius, **raw))
    _, rfs_p = shot_dma.shot_descriptor_dma_plain(grid, kp, radius, rf_radius=rf_radius, **raw)
    torch.testing.assert_close(rfs, rfs_p, atol=5e-4, rtol=0)
    _assert_shot_flip_rule(hist, shot_dma.shot_descriptor_dma_plain(grid, kp, radius, rfs=rfs,
                                                                    **raw)[0])
    given = _counted("shot_runs", lambda: shot_dma.shot_descriptor_dma(grid, kp, radius,
                                                                       rfs=rfs_p, **raw))[0]
    _assert_shot_flip_rule(given, shot_dma.shot_descriptor_dma_plain(grid, kp, radius, rfs=rfs_p,
                                                                     **raw)[0])
    for m in (0, 100, 1000):
        for rf in (dict(rf_radius=rf_radius), dict(rfs=rfs_p)):
            kept = shot_dma.shot_descriptor_dma(grid, kp, radius, normalize=False,
                                                min_neighborhood_size=m, **rf)[0].any(1)
            kept_p = shot_dma.shot_descriptor_dma_plain(grid, kp, radius, normalize=False,
                                                        min_neighborhood_size=m, **rf)[0].any(1)
            assert torch.equal(kept, kept_p), (m, rf.keys())
    return hist, rfs


@pytest.mark.parametrize("n_surface", [1, 13, 61])
@pytest.mark.parametrize("bi_scale", [False, True])
def test_k5_shot_runs_kernel_edge_cases(cuda, rng, n_surface, bi_scale):
    """K5 on keypoint counts off the 8 a block (5, 17, 65), runs past 32 rows
    and empty runs (the cloud's edge, the far point), a frame plane past the
    shared list (the cluster: passes 2 and 3 walk the runs again), tied sign
    votes, and a keypoint whose frame plane is empty: the identity frame,
    with bins in bi-scale mode (descriptor plane at 1.2) and none with own
    frames (nothing within 0.5).  The far keypoint: zero row, identity."""
    from shot_fpfh_tpu_torch.ops.shot_dma import _xyrow_runs

    pts, nrm, special = _k5_cloud(rng)
    radius, rf_radius = (1.2, 0.4) if bi_scale else (0.5, None)
    grid = build_grid(torch.tensor(pts, device=cuda), radius / 2,
                      extras=torch.tensor(nrm, device=cuda), halo=2)
    assert shot_dma._xyrow_mode(grid)[0]
    edge = int(np.argmin(pts[:20_000, 0]))
    surf = np.concatenate([[edge], rng.choice(20_000, n_surface - 1, replace=False)])
    kp = torch.tensor(np.concatenate([pts[surf], special]), device=cuda)
    start, end = _xyrow_runs(grid, kp)
    assert int((end - start).max()) > 32 and bool((end == start)[0].any())
    frame_r = radius if rf_radius is None else rf_radius
    assert int((np.linalg.norm(pts - special[0], axis=1) <= frame_r).sum()) > K5_FRAME_SLOTS
    hist, rfs = _check_k5(grid, kp, radius, rf_radius)
    eye = torch.eye(3)
    assert not hist[-1].any() and torch.equal(rfs[-1].cpu(), eye)
    assert torch.equal(rfs[-2].cpu(), eye) and bool(hist[-2].any()) == bi_scale
    assert bool(hist[-4].any()) and bool(hist[-3].any())


def test_golden_pair_on_card(cuda):
    """The golden pair (tests/test_reference_parity.py:31) through the port
    on the card: within the measured reference's accuracy envelope, with the
    matching kernel on (2,500 points take the brute normals route; SHOT takes
    its grid, SG, at any support size on the card)."""
    from shot_fpfh_tpu_torch.core.transform import rotation_angle
    from shot_fpfh_tpu_torch.models.normals import compute_normals
    from shot_fpfh_tpu_torch.pipeline import RegistrationPipeline

    data = np.load(REPO / "benchmarks" / "golden_pair.npz")
    measured = json.loads((REPO / "BASELINE_measured.json").read_text())["golden_pipeline"]
    scan, ref = data["scan"], data["ref"]
    p = RegistrationPipeline(
        scan=scan, scan_normals=compute_normals(scan, scan, k=20, device=cuda).cpu().numpy(),
        ref=ref, ref_normals=compute_normals(ref, ref, k=20, device=cuda).cpu().numpy(),
        k_max_descriptor=256, device=cuda)
    p.select_keypoints("subsampling", neighborhood_size=0.25)
    p.compute_descriptors(radius=0.5, descriptor_choice="shot_single_scale",
                          subsample_support=False, min_neighborhood_size=10)
    before = _kernels.launch_counts["top2_match"]
    p.find_descriptors_matches("simple")
    assert _kernels.launch_counts["top2_match"] == before + 1
    tf_ransac, _ = p.run_ransac(n_draws=2000, draw_size=4, max_inliers_distance=0.1)
    tf_icp, _, _ = p.run_icp("point_to_plane", tf_ransac, d_max=0.3, voxel_size=0.1,
                             max_iter=40, rms_threshold=1e-5)
    rot = tf_icp.rotation.double().cpu().numpy()
    t = tf_icp.translation.double().cpu().numpy()
    ate = float(np.sqrt(np.mean(np.sum(
        (scan @ rot.T + t - (scan @ data["rot_gt"].T + data["t_gt"])) ** 2, axis=1))))
    assert float(rotation_angle(torch.tensor(rot),
                                torch.tensor(measured["rotation"], dtype=torch.float64))) < 1e-3
    assert np.linalg.norm(t - np.array(measured["translation"])) < 1e-3
    assert ate < 1e-3


def _face_points(rng):
    """Points on cell faces (integer multiples of 0.45), many duplicated."""
    faces = rng.integers(0, 40, size=(20_000, 3)).astype(np.float32) * np.float32(0.45)
    return np.concatenate([np.zeros((1, 3), np.float32), faces, faces[:5000] + np.float32(0.01)])


def test_cells_and_bins_match_the_cpu_on_card(cuda, rng):
    """Points on cell faces fall in the same grid cells, voxels and
    histogram bins on the card as on the CPU: every index comes from a true
    float32 division (``_fp.div``), not PyTorch's CUDA multiply by the
    reciprocal of a Python scalar."""
    from shot_fpfh_tpu_torch.core.subsampling import _voxel_segments
    from shot_fpfh_tpu_torch.ops.histogram import bin_index

    pts = _face_points(rng)
    on_card = build_grid(torch.tensor(pts, device=cuda), 0.45)
    on_cpu = build_grid(pts, 0.45, device="cpu")
    assert on_card.dims == on_cpu.dims
    assert torch.equal(on_card.cell_ids_sorted.cpu(), on_cpu.cell_ids_sorted)
    assert torch.equal(on_card.orig_idx.cpu(), on_cpu.orig_idx)
    for card, cpu in zip(_voxel_segments(torch.tensor(pts, device=cuda), 0.45)[:2],
                         _voxel_segments(torch.tensor(pts), 0.45)[:2]):
        assert torch.equal(card.cpu(), cpu)      # voxel order and segment ids
    edges = np.float32(-1.0) + np.arange(6, dtype=np.float32) * np.float32(0.4)
    x = np.concatenate([edges, np.nextafter(edges, -2), np.nextafter(edges, 2)])
    card, cpu = (bin_index(torch.tensor(x, device=dev), -1.0, 1.0, 5) for dev in (cuda, "cpu"))
    assert torch.equal(card[0].cpu(), cpu[0]) and torch.equal(card[1].cpu(), cpu[1])


def test_voxel_representatives_match_the_cpu_on_card(cuda, rng):
    """Duplicated points make exact distance ties to the voxel barycenter:
    each voxel is summed in sorted order on both devices, so the card picks
    the CPU's representatives."""
    from shot_fpfh_tpu_torch.core.subsampling import grid_subsample

    pts = _face_points(rng)
    for voxel in (0.45, 0.9, 2.0):
        on_card = grid_subsample(torch.tensor(pts, device=cuda), voxel)
        np.testing.assert_array_equal(on_card, grid_subsample(pts, voxel, device="cpu"))


def test_voxel_sums_match_the_cpu_on_card_in_a_dense_voxel(cuda, rng):
    """A skewed cloud (20,000 points in one voxel beside a sparse terrain):
    the card's voxel sums are bit-identical to the CPU's ``index_add_``."""
    from shot_fpfh_tpu_torch.core.subsampling import _segment_sums

    lengths = torch.tensor(rng.integers(1, 40, size=3000))
    lengths[1234] = 20_000
    pts = torch.tensor(rng.normal(100.0, 3.0, size=(int(lengths.sum()), 3)).astype(np.float32))
    seg = torch.repeat_interleave(torch.arange(lengths.numel()), lengths)
    want = torch.zeros(lengths.numel(), 3).index_add_(0, seg, pts)
    assert torch.equal(_segment_sums(pts, lengths), want)
    assert torch.equal(_segment_sums(pts.to(cuda), lengths.to(cuda)).cpu(), want)


def _spfh_grid(rng, cuda, radius):
    pts = _surface(rng, 30_000, cuda)
    nrm = torch.nn.functional.normalize(torch.randn_like(pts), dim=1)
    return build_grid(pts, radius / 2, extras=nrm, halo=2)


@pytest.mark.parametrize("decorrelated", [False, True])
def test_k4_spfh_kernel(cuda, rng, decorrelated):
    grid = _spfh_grid(rng, cuda, 0.5)
    qc, qn = grid.packed_sorted[:3000, :3], grid.packed_sorted[:3000, 3:6]
    vals, d, valid, _ = window_distances(grid, qc)
    dist = torch.where(valid & (d <= 0.5), d, torch.full_like(d, float("inf")))
    got = _counted("spfh_histogram",
                   lambda: spfh_histogram(vals, dist, qc, qn, 5, decorrelated))
    want = spfh_histogram_plain(vals, dist, qc, qn, 5, decorrelated)
    diff = (got - want).abs()
    # whole counts: a difference is a neighbor moved by a last-bit angle change
    assert float((diff > 0).float().mean()) <= 1e-3 and float(diff.max()) <= 2.0
    assert float(want.sum()) > 0


def _k4_window(rng, q, w, fill, device):
    """K1's synthetic window (``_k1_window``) with query normals near +z,
    like the lanes' normals, so most theta fall in range."""
    vals, dist, qc = _k1_window(rng, q, w, fill, device)
    qn = rng.normal(size=(q, 3)) + np.array([0.0, 0.0, 3.0])
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    return vals, dist, qc, torch.tensor(qn.astype(np.float32), device=device)


def _k4_counts(vals, dist, qc, qn, decorrelated):
    got = _counted("spfh_histogram",
                   lambda: spfh_histogram(vals, dist, qc, qn, 5, decorrelated))
    return got, spfh_histogram_plain(vals, dist, qc, qn, 5, decorrelated)


# (queries, window width, finite fraction): query counts off the 8 a block,
# W under 32 and not a multiple of 4, windows with every lane finite, and
# the FPFH chunk's width
K4_SHAPES = [(1, 5, 0.6), (13, 31, 1.0), (9, 37, 0.5), (17, 1000, 1.0), (8, 130, 0.0),
             (40, 1372, 0.45)]


@pytest.mark.parametrize("q,w,fill", K4_SHAPES)
@pytest.mark.parametrize("decorrelated", [False, True])
def test_k4_spfh_kernel_edge_shapes(cuda, rng, q, w, fill, decorrelated):
    """Whole counts against the twin: a difference is a neighbor moved by a
    last-bit angle change, at most one such move (two elements) or a
    per-mille of the elements; an all-invalid window gets a zero row, and a
    window holding its query (d = 0) does not bin it."""
    vals, dist, qc, qn = _k4_window(rng, q, w, fill, cuda)
    dist[0] = float("inf")
    if q > 1:
        vals[1, :3, 0] = qc[1]
        dist[1, 0] = 0.0
    got, want = _k4_counts(vals, dist, qc, qn, decorrelated)
    diff = (got - want).abs()
    assert float((diff > 0).sum()) <= max(2.0, 1e-3 * diff.numel()) and float(diff.max()) <= 2.0
    assert not got[0].any()
    assert (float(want.sum()) > 0) == (fill > 0 and q > 1)


@pytest.mark.parametrize("decorrelated", [False, True])
def test_k4_spfh_kernel_one_bin(cuda, rng, decorrelated):
    """Every neighbor of a window at the same offset with the same normal:
    all of a window's counts land in one joint bin (one per angle
    decorrelated), the kernel's aggregated adds equal the twin's counts
    exactly; one window has a single neighbor."""
    q, w = 19, 1372
    qc = rng.normal(size=(q, 3))
    off = rng.normal(scale=0.2, size=(q, 3))
    off *= np.minimum(1.0, 0.8 / np.linalg.norm(off, axis=1, keepdims=True))
    unit = [rng.normal(size=(q, 3)) + np.array([0.0, 0.0, 3.0]) for _ in range(2)]
    nrm, qn = (u / np.linalg.norm(u, axis=1, keepdims=True) for u in unit)
    vals = np.concatenate([np.repeat((qc + off)[:, :, None], w, 2),
                           np.repeat(nrm[:, :, None], w, 2)], axis=1)
    dist = np.repeat(np.linalg.norm(off, axis=1)[:, None], w, 1)
    dist[:, ::7] = np.inf
    dist[3, :] = np.inf
    dist[3, 5] = np.linalg.norm(off[3])
    args = [torch.tensor(a.astype(np.float32), device=cuda) for a in (vals, dist, qc, qn)]
    got, want = _k4_counts(*args, decorrelated)
    assert torch.equal(got, want)
    per_row = (torch.isfinite(args[1]) & (args[1] > 0)).sum(1).float()
    assert torch.equal(got.sum(1), per_row * (3 if decorrelated else 1))
    assert int((got > 0).sum(1).max()) <= (3 if decorrelated else 1)


@pytest.mark.parametrize("decorrelated", [False, True])
def test_k6_spfh_runs_kernel(cuda, rng, decorrelated):
    """Whole counts over K4's angles: the count-normalized rows equal the
    twin's, bit for bit, on every point of a cloud (grid-sorted queries,
    read from the table's own rows)."""
    grid = _spfh_grid(rng, cuda, 0.5)
    assert shot_dma._xyrow_mode(grid)[0]
    got = _counted("spfh_runs", lambda: shot_dma.spfh_sorted_dma(grid, 0.5, 5, decorrelated))
    want = shot_dma.spfh_sorted_dma_plain(grid, 0.5, 5, decorrelated)
    assert torch.equal(got, want)
    assert float(want.sum()) > 0


@pytest.mark.parametrize("halo", [1, 2, 3])
@pytest.mark.parametrize("decorrelated", [False, True])
def test_k6_spfh_runs_kernel_edge_cases(cuda, rng, halo, decorrelated):
    """K6 equal to its twin at halo 1, 2 and 3 on 67 queries (off the 8 a
    block): 40 cloud points in random order, 24 consecutive grid-sorted
    points (blocks that straddle cell columns), the point of least x (empty
    runs), a point off the grid at 1e6 (every run empty: a zero row) and a
    point 5 above the surface (runs full of rows, none in radius: a zero
    row); runs longer than one walk step of 128 rows."""
    from shot_fpfh_tpu_torch.ops.shot_dma import _xyrow_runs

    radius = 0.5
    pts = _surface(rng, 30_000, cuda)
    nrm = torch.nn.functional.normalize(torch.randn_like(pts), dim=1)
    grid = build_grid(pts, radius / halo, extras=nrm, halo=halo)
    assert shot_dma._xyrow_mode(grid)[0] and grid.halo == halo
    table = grid.packed_sorted
    edge = int(torch.argmin(pts[:, 0]))
    idx = torch.tensor(rng.choice(pts.shape[0], 40, replace=False), device=cuda)
    far = torch.tensor([[1e6, 1e6, 1e6], [0.0, 0.0, 5.0]], device=cuda)
    qc = torch.cat([pts[idx], table[5000:5024, :3], pts[edge:edge + 1], far])
    qn = torch.cat([nrm[idx], table[5000:5024, 3:6], nrm[edge:edge + 1],
                    torch.tensor([[0.0, 0.0, 1.0]] * 2, device=cuda)])
    start, end = _xyrow_runs(grid, qc)
    assert int((end - start).max()) > 128 and bool((end == start)[-3].any())
    assert bool((end == start)[-2].all()) and bool((end > start)[-1].any())
    got = _counted("spfh_runs", lambda: shot_dma.spfh_block_dma(grid, qc, qn, radius, 5,
                                                                decorrelated))
    want = shot_dma.spfh_block_dma_plain(grid, qc, qn, radius, 5, decorrelated)
    assert torch.equal(got, want)
    assert not got[-2:].any() and bool(got[:-2].any(1).all())


# phi and theta bin edges of 5 bins (away from 0, where the angles of a
# flat patch sit)
K6_PHI_EDGES, K6_THETA_EDGES = (-0.6, -0.2, 0.2, 0.6), (-0.6 * np.pi / 2, -0.2 * np.pi / 2,
                                                     0.2 * np.pi / 2, 0.6 * np.pi / 2)


def _k6_edge_cloud(rng, sites=8, per_edge=120):
    """``(points, normals, queries)``: the 30k-point surface with random
    unit normals, plus, around each of ``sites`` surface points, points on
    the cones whose phi (query normal +z) is a bin edge of 5 bins, with
    normals that put their theta on a bin edge too; the queries are the
    sites.  The angles then land within a few ulps of the edges, where a
    last-bit difference from the twin would move a count."""
    xy = rng.uniform(-3, 3, size=(30_000, 2))
    z = 0.4 * np.sin(xy[:, 0]) * np.cos(0.7 * xy[:, 1])
    surface = np.column_stack([xy, z]) + rng.normal(scale=0.01, size=(30_000, 3))
    nrm = rng.normal(size=surface.shape)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    centers = surface[rng.choice(30_000, sites, replace=False)]
    pts, nms = [surface], [nrm]
    for q in centers:
        for c in K6_PHI_EDGES:
            rho = rng.uniform(0.05, 0.45, per_edge)
            az = rng.uniform(0, 2 * np.pi, per_edge)
            rxy = rho * np.sqrt(1 - c * c)
            d = np.column_stack([rxy * np.cos(az), rxy * np.sin(az), rho * c])
            tau = rng.choice(K6_THETA_EDGES, per_edge)
            beta = np.arctan(np.tan(tau) / rxy)
            pts.append(q + d)
            nms.append(np.column_stack([np.sin(beta) * np.cos(az), np.sin(beta) * np.sin(az),
                                        np.cos(beta)]))
    return (np.concatenate(pts).astype(np.float32), np.concatenate(nms).astype(np.float32),
            centers.astype(np.float32))


@pytest.mark.parametrize("decorrelated", [False, True])
def test_k6_spfh_runs_kernel_bin_edges(cuda, rng, decorrelated):
    """Neighbors whose phi and theta lie on bin edges (up to float32
    rounding): the rows still equal the twin's bit for bit."""
    pts, nrm, sites = _k6_edge_cloud(rng)
    grid = build_grid(torch.tensor(pts, device=cuda), 0.25, extras=torch.tensor(nrm, device=cuda),
                      halo=2)
    assert shot_dma._xyrow_mode(grid)[0]
    qc = torch.tensor(sites, device=cuda)
    qn = torch.tensor([[0.0, 0.0, 1.0]] * len(sites), device=cuda)
    # the edge points' phi within 2e-5 of an edge
    d = pts[30_000:].reshape(len(sites), -1, 3) - sites[:, None, :]
    phi = d[..., 2] / np.linalg.norm(d, axis=-1)
    near = np.abs(phi[..., None] - np.array(K6_PHI_EDGES)).min(-1) < 2e-5
    assert near.sum() > 1000
    got = _counted("spfh_runs", lambda: shot_dma.spfh_block_dma(grid, qc, qn, 0.5, 5,
                                                                decorrelated))
    want = shot_dma.spfh_block_dma_plain(grid, qc, qn, 0.5, 5, decorrelated)
    assert torch.equal(got, want)
    assert float(want.sum()) > 0


@pytest.mark.parametrize("n_bins", [1, 11])
def test_k6_spfh_runs_kernel_bin_counts(cuda, rng, n_bins):
    """One bin, and 11^3 joint bins, whose per-warp histograms need more
    than 48 KB of shared memory a block: equal to the twin in both modes,
    on transposed (non-unit-stride) query arrays."""
    grid = _spfh_grid(rng, cuda, 0.5)
    qc = grid.packed_sorted[:1000, :3].t().contiguous().t()
    qn = grid.packed_sorted[:1000, 3:6].t().contiguous().t()
    assert qc.stride(1) != 1
    for dec in (False, True):
        got = _counted("spfh_runs", lambda: shot_dma.spfh_block_dma(grid, qc, qn, 0.5, n_bins,
                                                                    dec))
        want = shot_dma.spfh_block_dma_plain(grid, qc, qn, 0.5, n_bins, dec)
        assert torch.equal(got, want)
        assert float(want.sum()) > 0


# FPFH's SPFH pass as the benchmark's FPFH cell runs it: radius 3.0 on
# bench_1m.py's terrain (625 points a square metre), cell 1.5, halo 2
SPFH_PASS_RADIUS, FAR = 3.0, 1.0e6


def _spfh_pass_terrain(cuda, extent=6.33):
    """The FPFH cell's terrain (``chip_smoke.scale_terrain``) cut to its
    central square at the cell's density (~10^5 points at 6.33), its k=30
    normals and the SPFH pass's grid."""
    from shot_fpfh_tpu_torch.models.normals import compute_normals

    pts = scale_terrain(np.random.default_rng(21), 1_000_000)
    pts = torch.tensor(pts[(np.abs(pts[:, 0]) <= extent) & (np.abs(pts[:, 1]) <= extent)],
                       device=cuda)
    return build_grid(pts, SPFH_PASS_RADIUS / 2, extras=compute_normals(pts, pts, k=30),
                      halo=2)


def _spfh_pass_launch(grid, qc, qn, radius, n_bins, decorrelated):
    """The SPFH pass kernel's rows of ``qc``: one launch, and no K8 or K4."""
    before = dict(_kernels.launch_counts)
    got = spfh_grid(grid, qc, qn, radius, n_bins, decorrelated)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["spfh_grid"] == before["spfh_grid"] + 1
    for name in ("fetch_windows", "spfh_histogram"):
        assert _kernels.launch_counts[name] == before[name]
    return got


@pytest.mark.parametrize("decorrelated", [False, True])
def test_spfh_pass_kernel_equals_chunked_route(cuda, decorrelated):
    """The SPFH pass kernel over every point of ~10^5 of the FPFH cell's
    terrain at radius 3.0 (~17k neighbors a point; the table's own rows as
    queries) equals the chunked route it replaced (K8 + K4) bit for bit;
    a block padded at the far sentinel with zero normals, as the sharded
    pass pads it, gets zero pad rows; an empty block launches nothing."""
    grid = _spfh_pass_terrain(cuda)
    table = grid.packed_sorted
    assert grid.has_table and table.shape[0] >= 100_000
    qc, qn = table[:, :3], table[:, 3:6]
    got = _spfh_pass_launch(grid, qc, qn, SPFH_PASS_RADIUS, 5, decorrelated)
    want = spfh_window_chunked(grid, qc, qn, SPFH_PASS_RADIUS, 5, decorrelated)
    assert torch.equal(got, want)
    assert float(got.sum()) > 0
    pad_qc = torch.cat([qc[:5000], torch.full((3, 3), FAR, device=cuda)])
    pad_qn = torch.cat([qn[:5000], torch.zeros((3, 3), device=cuda)])
    padded = _spfh_pass_launch(grid, pad_qc, pad_qn, SPFH_PASS_RADIUS, 5, decorrelated)
    assert torch.equal(padded[:-3], want[:5000]) and not padded[-3:].any()
    before = _kernels.launch_counts["spfh_grid"]
    empty = spfh_grid(grid, pad_qc[:0], pad_qn[:0], SPFH_PASS_RADIUS, 5, decorrelated)
    assert empty.shape == (0, want.shape[1]) and _kernels.launch_counts["spfh_grid"] == before


@pytest.mark.parametrize("halo", [1, 2, 3])
@pytest.mark.parametrize("decorrelated", [False, True])
def test_spfh_pass_kernel_edge_cases(cuda, rng, halo, decorrelated):
    """Equal to the chunked route at halo 1, 2 and 3 (49 runs: more than a
    warp's lanes) on 67 queries: 40 cloud points in random order, 24
    consecutive sorted rows, the point of least x (empty runs), a point off
    the grid at the far sentinel and one 5 above the surface (runs full of
    rows, none in radius); then with the window cap cut below the longest
    window, where both routes walk only the first slots."""
    import dataclasses

    radius = 0.5
    pts = _surface(rng, 30_000, cuda)
    nrm = torch.nn.functional.normalize(torch.randn_like(pts), dim=1)
    grid = build_grid(pts, radius / halo, extras=nrm, halo=halo)
    assert grid.has_table and grid.halo == halo
    table = grid.packed_sorted
    edge = int(torch.argmin(pts[:, 0]))
    idx = torch.tensor(rng.choice(pts.shape[0], 40, replace=False), device=cuda)
    far = torch.tensor([[FAR, FAR, FAR], [0.0, 0.0, 5.0]], device=cuda)
    qc = torch.cat([pts[idx], table[5000:5024, :3], pts[edge:edge + 1], far])
    qn = torch.cat([nrm[idx], table[5000:5024, 3:6], nrm[edge:edge + 1],
                    torch.tensor([[0.0, 0.0, 1.0]] * 2, device=cuda)])
    got = _spfh_pass_launch(grid, qc, qn, radius, 5, decorrelated)
    assert torch.equal(got, spfh_window_chunked(grid, qc, qn, radius, 5, decorrelated))
    assert not got[-2:].any() and bool(got[:-2].any(1).all())
    cut = dataclasses.replace(grid, window_cap=grid.window_cap // 3)
    got = _spfh_pass_launch(cut, qc, qn, radius, 5, decorrelated)
    assert torch.equal(got, spfh_window_chunked(cut, qc, qn, radius, 5, decorrelated))


@pytest.mark.parametrize("decorrelated", [False, True])
def test_spfh_pass_kernel_bin_edges(cuda, rng, decorrelated):
    """Neighbors whose phi and theta lie on bin edges (K6's edge cloud):
    the rows equal the chunked route's bit for bit."""
    pts, nrm, sites = _k6_edge_cloud(rng)
    grid = build_grid(torch.tensor(pts, device=cuda), 0.25, extras=torch.tensor(nrm, device=cuda),
                      halo=2)
    qc = torch.tensor(sites, device=cuda)
    qn = torch.tensor([[0.0, 0.0, 1.0]] * len(sites), device=cuda)
    got = _spfh_pass_launch(grid, qc, qn, 0.5, 5, decorrelated)
    assert torch.equal(got, spfh_window_chunked(grid, qc, qn, 0.5, 5, decorrelated))
    assert float(got.sum()) > 0


@pytest.mark.parametrize("n_bins", [1, 11])
def test_spfh_pass_kernel_bin_counts(cuda, rng, n_bins):
    """One bin, and 11^3 joint bins, whose per-warp histograms need more
    than 48 KB of shared memory a block: equal to the chunked route in both
    modes, on transposed (non-unit-stride) query arrays."""
    grid = _spfh_grid(rng, cuda, 0.5)
    qc = grid.packed_sorted[:1000, :3].t().contiguous().t()
    qn = grid.packed_sorted[:1000, 3:6].t().contiguous().t()
    assert qc.stride(1) != 1
    for dec in (False, True):
        got = _spfh_pass_launch(grid, qc, qn, 0.5, n_bins, dec)
        assert torch.equal(got, spfh_window_chunked(grid, qc, qn, 0.5, n_bins, dec))
        assert float(got.sum()) > 0


def test_spfh_pass_without_cell_table(cuda, rng):
    """A grid without a cell-start table (one far point: too many cells)
    takes the chunked route (K8 and K4 launched, the pass kernel not); its
    rows of the cloud equal the kernel's on the grid with a table, whose
    sorted order is the same."""
    pts = _surface(rng, 30_000, cuda)
    nrm = torch.nn.functional.normalize(torch.randn_like(pts), dim=1)
    with_table = build_grid(pts, 0.25, extras=nrm, halo=2)
    grid = build_grid(torch.cat([pts, torch.full((1, 3), 5e3, device=cuda)]), 0.25,
                      extras=torch.cat([nrm, nrm[:1]]), halo=2)
    assert with_table.has_table and not grid.has_table
    table = grid.packed_sorted
    assert torch.equal(table[:-1], with_table.packed_sorted)
    before = dict(_kernels.launch_counts)
    got = spfh_grid(grid, table[:, :3], table[:, 3:6], 0.5, 5, False)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["spfh_grid"] == before["spfh_grid"]
    for name in ("fetch_windows", "spfh_histogram"):
        assert _kernels.launch_counts[name] > before[name]
    want = _spfh_pass_launch(with_table, table[:-1, :3], table[:-1, 3:6], 0.5, 5, False)
    assert torch.equal(got[:-1], want) and bool(want.any(1).all())


# SHOT's grid kernel (SG): SHOT's window route in one launch a cloud
SG_MODES = ["own", "given", "bi_scale"]


def _sg_launch(grid, kp, radius, **kw):
    """SG's ``(hist, frames, count)`` of ``kp``: one launch, and no K8 or
    K1."""
    before = dict(_kernels.launch_counts)
    out = shot_grid(grid, kp, radius, **kw)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["shot_grid"] == before["shot_grid"] + 1
    for name in ("fetch_windows", "shot_binning_histogram"):
        assert _kernels.launch_counts[name] == before[name]
    return out


def _sg_equal(got, want):
    """Rows, frames and counts equal bit for bit (NaN where the other has
    NaN)."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert bool(((g == w) | (g.isnan() & w.isnan())).all())


def _sg_terrain(rng, cuda, cell):
    """chip_smoke's terrain (30k points) with k=30 normals on the card, a
    halo-2 grid with a cell table, and 1,500 keypoints then 3 far pads."""
    from shot_fpfh_tpu_torch.models.normals import compute_normals

    cloud = torch.tensor(make_terrain(30_000, rng, scale=5.0, n_bumps=10), device=cuda)
    grid = build_grid(cloud, cell, extras=compute_normals(cloud, cloud, k=30, device=cuda),
                      halo=2)
    assert grid.has_table
    idx = torch.tensor(rng.choice(30_000, 1500, replace=False), device=cuda)
    return grid, torch.cat([cloud[idx], torch.full((3, 3), FAR, device=cuda)])


@pytest.mark.parametrize("mode", SG_MODES)
def test_shot_grid_kernel_equals_window_route(cuda, rng, mode):
    """On a terrain grid with a cell table, SG's rows, frames and counts
    equal the K8 + K1 route's (``shot_window_chunked``) bit for bit, in
    one chunk and in chunks of 100 keypoints; the far pads get zero rows,
    count 0 and (with frames computed) the identity; an empty keypoint set
    launches nothing."""
    radius, rf_radius = (0.9, 0.3) if mode == "bi_scale" else (0.6, None)
    grid, kp = _sg_terrain(rng, cuda, radius / 2)
    rfs = shot_grid(grid, kp, radius)[1] if mode == "given" else None
    got = _sg_launch(grid, kp, radius, rfs=rfs, rf_radius=rf_radius)
    _sg_equal(got, shot_window_chunked(grid, kp, radius, rfs=rfs, rf_radius=rf_radius))
    _sg_equal(got, shot_window_chunked(grid, kp, radius, rfs=rfs, rf_radius=rf_radius,
                                       chunk=100))
    hist, frames, count = got
    assert not hist[-3:].any() and not count[-3:].any() and bool((count[:-3] > 0).all())
    if mode != "given":
        assert torch.equal(frames[-3:].cpu(), torch.eye(3).expand(3, 3, 3))
    before = _kernels.launch_counts["shot_grid"]
    empty = shot_grid(grid, kp[:0], radius, rfs=None if rfs is None else rfs[:0],
                      rf_radius=rf_radius)
    assert [tuple(t.shape) for t in empty] == [(0, 352), (0, 3, 3), (0,)]
    assert _kernels.launch_counts["shot_grid"] == before


@pytest.mark.parametrize("halo", [1, 3])
@pytest.mark.parametrize("mode", SG_MODES)
def test_shot_grid_kernel_edge_cases(cuda, rng, halo, mode):
    """Equal to the K8 + K1 route at halo 1 and 3 (49 runs: more than a
    warp's lanes) on K5's edge cloud: keypoint counts off the 8 a block, the
    cloud's edge (empty runs), a frame plane past the shared list (the
    cluster: passes 2 and 3 walk the runs again), tied sign votes, a
    keypoint with an empty frame plane and the far point; then with the
    window cap cut below the longest window, where both routes take only
    the first slots."""
    import dataclasses

    pts, nrm, special = _k5_cloud(rng)
    radius, rf_radius = (1.2, 0.4) if mode == "bi_scale" else (0.5, None)
    grid = build_grid(torch.tensor(pts, device=cuda), radius / halo,
                      extras=torch.tensor(nrm, device=cuda), halo=halo)
    assert grid.has_table and grid.halo == halo
    edge = int(np.argmin(pts[:20_000, 0]))
    surf = np.concatenate([[edge], rng.choice(20_000, 60, replace=False)])
    kp = torch.tensor(np.concatenate([pts[surf], special]), device=cuda)
    frame_r = radius if rf_radius is None else rf_radius
    assert int((np.linalg.norm(pts - special[0], axis=1) <= frame_r).sum()) > K5_FRAME_SLOTS
    rfs = shot_grid(grid, kp, radius)[1] if mode == "given" else None
    for g in (grid, dataclasses.replace(grid, window_cap=grid.window_cap // 3)):
        got = _sg_launch(g, kp, radius, rfs=rfs, rf_radius=rf_radius)
        _sg_equal(got, shot_window_chunked(g, kp, radius, rfs=rfs, rf_radius=rf_radius))
    assert not got[0][-1].any() and bool(got[0][-4].any())


def test_shot_grid_debug_counter_reads_k1s(cuda, rng):
    """``--debug_shot``'s counter on SG reads K1's on the K8 + K1 route:
    none under the computed frames; under given frames with a planted NaN
    (whole frames, and one z-axis component) the same counts of unsound
    weight sums, NaN in the same histogram entries, the rest equal."""
    grid, kp = _sg_terrain(rng, cuda, 0.3)
    counters = [torch.zeros(2, dtype=torch.int32, device=cuda) for _ in range(2)]
    got = _sg_launch(grid, kp, 0.6, violations=counters[0])
    _sg_equal(got, shot_window_chunked(grid, kp, 0.6, violations=counters[1]))
    assert counters[0].tolist() == counters[1].tolist() == [0, 0]
    planted = got[1].clone()
    planted[::13] = float("nan")
    planted[6::13, 0, 2] = float("nan")
    counters = [torch.zeros(2, dtype=torch.int32, device=cuda) for _ in range(2)]
    got = _sg_launch(grid, kp, 0.6, rfs=planted, violations=counters[0])
    _sg_equal(got, shot_window_chunked(grid, kp, 0.6, rfs=planted, violations=counters[1]))
    k, p = (c.tolist() for c in counters)
    assert k == p and k[1] > 0
    assert bool(got[0][:-3:13].isnan().any(1).all())


@pytest.mark.parametrize("choice", ["shot_single_scale", "shot_bi_scale"])
def test_shot_grid_on_the_staged_path(cuda, tmp_path, monkeypatch, choice):
    """A 30k-point terrain pair registered through the CLI on the card (the
    grid route): SHOT launches SG once a cloud and neither K8 nor K1; its
    descriptor stage counts 2 ``grid_passes`` and no ``chunks`` a pair, and
    makes as many blocking reads as the K8 + K1 loop it replaced (forced by
    the route's predicate)."""
    from shot_fpfh_tpu_torch import cli
    from shot_fpfh_tpu_torch.io.ply import write_ply
    from shot_fpfh_tpu_torch.ops import shot_fused

    rng = np.random.default_rng(72)
    ref = make_terrain(30_000, rng, scale=10 * 0.3 ** 0.5, n_bumps=12)
    rot = rotation_about([0.3, -0.2, 1.0], np.deg2rad(15.0))
    scan = (ref @ rot.T + [0.4, -0.25, 0.15]).astype(np.float32)
    write_ply(str(tmp_path / "scan.ply"), [scan], ["x", "y", "z"])
    write_ply(str(tmp_path / "ref.ply"), [ref], ["x", "y", "z"])
    takes_kernel = shot_fused._takes_kernel
    runs = {}
    for sg in (True, False):
        monkeypatch.setattr(shot_fused, "_takes_kernel",
                            takes_kernel if sg else lambda grid, kp: False)
        _kernels.reset_launch_counts()
        out = tmp_path / f"m{int(sg)}.json"
        assert cli.main(["--scan_file_path", str(tmp_path / "scan.ply"),
                         "--ref_file_path", str(tmp_path / "ref.ply"), "--conf_file_path", "",
                         "--output_dir", str(tmp_path / "out"), "--neighborhood_size", "0.15",
                         "--min_n_neighbors", "5", "--descriptor_choice", choice,
                         "--radius", "0.9", "--rho", "20", "--phi", "3",
                         "--disable_ply_writing", "--metrics_json", str(out)]) == 0
        stage = next(s for s in json.loads(out.read_text())["stages"]
                     if s["stage"] == f"descriptors[{choice}]")
        runs[sg] = dict(_kernels.launch_counts), stage
    (counts, stage), (loop_counts, loop) = runs[True], runs[False]
    assert counts["shot_grid"] == 2
    assert counts["fetch_windows"] == 0 and counts["shot_binning_histogram"] == 0
    assert loop_counts["shot_grid"] == 0 and loop_counts["shot_binning_histogram"] >= 2
    assert stage["grid_passes"] == 2 and stage["chunks"] == 0 and loop["chunks"] >= 2
    assert stage["spans"]["shot.pass"]["count"] == 2 and "shot.chunk" not in stage["spans"]
    assert stage["host_syncs"] == loop["host_syncs"]


@pytest.mark.parametrize("run_route", [False, True])
def test_fpfh_cli_on_card(cuda, tmp_path, monkeypatch, run_route):
    """A 30k-point terrain pair (the smoke terrain's density) registered
    with FPFH through the CLI on the card, ``SHOT_FPFH_DMA=1`` in the
    environment (it selects nothing): the grid route launches the SPFH pass
    kernel once a cloud and neither K8, K4 nor K6; with K6 called in the
    pass kernel's place (``chip_smoke.run_kernels_in_place``), K6 and not
    the pass kernel."""
    from shot_fpfh_tpu_torch import cli
    from shot_fpfh_tpu_torch.io.ply import write_ply

    rng = np.random.default_rng(72)
    ref = make_terrain(30_000, rng, scale=10 * 0.3 ** 0.5, n_bumps=12)
    rot = rotation_about([0.3, -0.2, 1.0], np.deg2rad(15.0))
    scan = (ref @ rot.T + [0.4, -0.25, 0.15]).astype(np.float32)
    write_ply(str(tmp_path / "scan.ply"), [scan], ["x", "y", "z"])
    write_ply(str(tmp_path / "ref.ply"), [ref], ["x", "y", "z"])
    monkeypatch.setenv("SHOT_FPFH_DMA", "1")
    _kernels.reset_launch_counts()
    with run_kernels_in_place(run_route):
        assert cli.main(["--scan_file_path", str(tmp_path / "scan.ply"),
                         "--ref_file_path", str(tmp_path / "ref.ply"), "--conf_file_path", "",
                         "--output_dir", str(tmp_path / "out"), "--neighborhood_size", "0.15",
                         "--min_n_neighbors", "5", "--descriptor_choice", "fpfh",
                         "--radius", "0.9"]) == 0
    counts = _kernels.launch_counts
    assert counts["top2_match"] > 0 and counts["radius_pca"] > 0
    assert (counts["spfh_runs"] > 0) == run_route
    assert counts["spfh_grid"] == (0 if run_route else 2)
    assert counts["spfh_histogram"] == 0 and counts["fetch_windows"] == 0
    # the aggregation: one kernel launch a cloud, no K7 window
    assert counts["fpfh_aggregate"] == 2 and counts["radius_dist"] == 0


@pytest.mark.parametrize("choice,run_route", [("shot_bi_scale", False), ("shot_bi_scale", True),
                                              ("shot_multiscale", False),
                                              ("shot_multiscale", True)])
def test_multiscale_cli_on_card(cuda, tmp_path, monkeypatch, choice, run_route):
    """A 30k-point terrain pair (the smoke terrain's density) registered
    with bi-scale and multiscale SHOT through the CLI on the card (radius
    0.9, phi 3, 2 scales; rho 20 keeps the first scale's support above
    20k points, so it takes the grid routes), ``SHOT_FPFH_DMA=1`` in the
    environment (it selects nothing): the grid route launches SG (no K8, no
    K1, no K5); with K5 called in SG's place
    (``chip_smoke.run_kernels_in_place``), K5 and no SG."""
    from shot_fpfh_tpu_torch import cli
    from shot_fpfh_tpu_torch.io.ply import write_ply

    rng = np.random.default_rng(72)
    ref = make_terrain(30_000, rng, scale=10 * 0.3 ** 0.5, n_bumps=12)
    rot = rotation_about([0.3, -0.2, 1.0], np.deg2rad(15.0))
    scan = (ref @ rot.T + [0.4, -0.25, 0.15]).astype(np.float32)
    write_ply(str(tmp_path / "scan.ply"), [scan], ["x", "y", "z"])
    write_ply(str(tmp_path / "ref.ply"), [ref], ["x", "y", "z"])
    monkeypatch.setenv("SHOT_FPFH_DMA", "1")
    _kernels.reset_launch_counts()
    with run_kernels_in_place(run_route):
        assert cli.main(["--scan_file_path", str(tmp_path / "scan.ply"),
                         "--ref_file_path", str(tmp_path / "ref.ply"), "--conf_file_path", "",
                         "--output_dir", str(tmp_path / "out"), "--neighborhood_size", "0.15",
                         "--min_n_neighbors", "5", "--descriptor_choice", choice,
                         "--radius", "0.9", "--rho", "20", "--phi", "3", "--n_scales",
                         "2"]) == 0
    counts = _kernels.launch_counts
    assert counts["top2_match"] > 0 and counts["radius_pca"] > 0
    assert (counts["shot_runs"] > 0) == run_route
    assert (counts["shot_grid"] > 0) == (not run_route)
    assert counts["shot_binning_histogram"] == 0 and counts["fetch_windows"] == 0


def test_entry_points_default_to_the_card(cuda):
    from shot_fpfh_tpu_torch.models import compute_fpfh_descriptor, compute_normals
    from shot_fpfh_tpu_torch.pipeline import RegistrationPipeline

    pts = np.random.default_rng(0).normal(size=(500, 3)).astype(np.float32)
    assert compute_normals(pts, pts, k=10).device.type == "cuda"
    assert compute_fpfh_descriptor([0, 5], pts, pts, 1.0).device.type == "cuda"
    assert RegistrationPipeline(scan=pts, scan_normals=pts, ref=pts,
                                ref_normals=pts).device.type == "cuda"
    assert compute_normals(pts, pts, k=10, device="cpu").device.type == "cpu"


# (halo, cell, cell table, normals as extras): K1's and K3's halo-1 grids,
# the FPFH halo-2 grid, a grid whose runs come from a binary search, and
# the iterative and moments halo-2 grid of three columns
RUN_GRIDS = [(1, 0.3, True, True), (2, 0.15, True, True), (1, 0.3, False, True),
             (2, 0.15, True, False)]


def _runs_case(rng, cuda, halo, cell, table, normals):
    """The K7 / K8 inputs on a 30k-point surface: every seventh point and
    two far sentinels as queries."""
    from shot_fpfh_tpu_torch.ops.grid_hash import _zcolumn_runs

    pts = _surface(rng, 30_000, cuda)
    if not table:   # one far point: too many cells for a start table
        pts = torch.cat([pts, torch.full((1, 3), 5e3, device=cuda)])
    nrm = torch.nn.functional.normalize(torch.randn_like(pts), dim=1) if normals else None
    grid = build_grid(pts, cell, extras=nrm, halo=halo)
    assert grid.has_table == table
    assert grid.packed_sorted.shape[1] == (6 if normals else 3)
    q = torch.cat([pts[::7], torch.full((2, 3), 1e6, device=cuda)])
    start, end = _zcolumn_runs(grid, q)
    return grid.packed_sorted, q, start, end, grid.window_cap


@pytest.mark.parametrize("halo,cell,table,normals", RUN_GRIDS)
def test_k8_fetch_windows_kernel(cuda, rng, halo, cell, table, normals):
    """K8 equals its twin bit for bit on all four outputs; far sentinels get
    an all-padding window."""
    args = _runs_case(rng, cuda, halo, cell, table, normals)
    got = _counted("fetch_windows", lambda: fetch_windows(*args))
    want = fetch_windows_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[2].any(dim=1)[:-2].all() and not got[2][-2:].any()


@pytest.mark.parametrize("halo,cell,table,normals", RUN_GRIDS)
def test_k7_radius_dist_kernel(cuda, rng, halo, cell, table, normals):
    """K7 equals its twin bit for bit at a radius inside the window, at the
    window's coverage and at +inf (the 1-NN's radius)."""
    args = _runs_case(rng, cuda, halo, cell, table, normals)
    for radius in (0.6 * cell * halo, cell * halo, float("inf")):
        got = _counted("radius_dist", lambda: radius_dist(*args, radius))
        want = radius_dist_plain(*args, radius)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.isfinite(got[1]).any() and not torch.isfinite(got[1][-2:]).any()


NEAREST_CASES = ["near", "ties", "off grid", "nan"]


def _nearest_case(rng, cuda, case, halo):
    """A 30k-point surface whose last 1,000 points repeat its first 1,000
    (exact ties) and its grid at halo ``halo`` (cell 0.3 / halo); queries:
    every seventh point moved by 0.02, then by case the repeated points,
    points off the grid (empty windows) or NaN queries."""
    pts = _surface(rng, 30_000, cuda)
    pts[29_000:] = pts[:1000]
    grid = build_grid(pts, 0.3 / halo, halo=halo)
    assert grid.has_table
    q = pts[::7] + 0.02 * torch.randn(pts[::7].shape, generator=torch.Generator().manual_seed(1)
                                      ).to(cuda)
    extra = {"near": pts[:0],
             "ties": pts[:1000],
             "off grid": torch.tensor([[1e6, 1e6, 1e6], [-10.0, 0.0, 0.0], [0.0, 0.0, 9.0]],
                                      device=cuda),
             "nan": torch.tensor([[float("nan"), 0.0, 0.0], [0.0, float("nan"), 0.0],
                                  [float("inf"), 0.0, 0.0]], device=cuda)}[case]
    return grid, torch.cat([q, extra]).contiguous()


@pytest.mark.parametrize("case", NEAREST_CASES)
@pytest.mark.parametrize("halo", [1, 2])
def test_k7_nearest_kernel(cuda, rng, halo, case):
    """K7's 1-NN mode equals its twin (``torch.equal``, distance and index)
    at both lanes-a-query variants: exact ties go to the first window slot,
    empty windows and NaN queries give +inf and slot 0's row, as the twin."""
    grid, q = _nearest_case(rng, cuda, case, halo)
    want = nearest_plain(grid, q)
    for lanes in (32, 8):
        got = _counted("nearest", lambda: nearest(grid, q, lanes=lanes))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), lanes
    if case == "ties":
        n = q.shape[0] - 1000
        assert bool((want[0][n:] == 0).all())
        assert torch.equal(want[1][n:], torch.arange(1000, device=cuda))
    if case in ("off grid", "nan"):
        assert not torch.isfinite(want[0][-3:]).any()


def _aggregate_case(rng, cuda, halo, dim):
    """FPFH's aggregation inputs on a 30k-point surface with a dense
    cluster (2,000 points within 0.05: windows and in-radius lists past the
    kernel's 512-entry list), its first 200 points repeated (d = 0
    neighbors) and one point alone, on the grid of cell 0.3 / halo carrying
    normals; one table row moved to the far sentinel after the build (its
    window off the grid).  SPFH-like rows (non-negative, summing to 1);
    keypoints: every fifth row, the cluster, the repeats, the lone and the
    far row, shuffled."""
    import dataclasses

    pts = _surface(rng, 30_000, cuda)
    cluster = torch.tensor(rng.normal(scale=0.02, size=(2000, 3)).astype(np.float32),
                           device=cuda)
    pts = torch.cat([pts, cluster, pts[:200], torch.tensor([[4.5, 0.0, 0.0]], device=cuda)])
    nrm = torch.nn.functional.normalize(torch.randn_like(pts), dim=1)
    grid = build_grid(pts, 0.3 / halo, extras=nrm, halo=halo)
    assert grid.has_table and grid.window_cap > 512
    n = pts.shape[0]
    inv = torch.empty_like(grid.orig_idx)
    inv[grid.orig_idx] = torch.arange(n, device=cuda)
    far = int(inv[100])
    table = grid.packed_sorted.clone()
    table[far, :3] = 1.0e6
    grid = dataclasses.replace(grid, packed_sorted=table)
    h = torch.rand((n, dim), device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(dim)) ** 4
    spfh = (h / h.sum(1, keepdim=True)).contiguous()
    kp = torch.cat([torch.arange(0, n, 5, device=cuda), inv[30_000:32_000], inv[32_000:],
                    torch.tensor([far], device=cuda)])
    kp = kp[torch.randperm(kp.shape[0], generator=torch.Generator().manual_seed(3)).to(cuda)]
    return grid, spfh, kp.contiguous(), 0.3


@pytest.mark.parametrize("dim", [15, 125, 343])
@pytest.mark.parametrize("halo", [1, 2])
def test_k7_fpfh_aggregate_kernel(cuda, rng, halo, dim):
    """K7's aggregation mode against its twin by ``chip_smoke``'s rule
    (counts and rows with no neighbor exact, each row within 1e-5 of its
    largest entry) with the keypoints launched in the caller's order and
    in sorted-row order: one launch a call; the lone point and the
    duplicates' counts as the twin's, the far row its own SPFH row."""
    grid, spfh, kp, radius = _aggregate_case(rng, cuda, halo, dim)
    want, counts_p = fpfh_aggregate_plain(grid, spfh, kp, radius, return_counts=True)
    assert int(counts_p.max()) > 512 and int((counts_p == 0).sum()) == 1
    for sort in (False, True):
        got, counts = _counted("fpfh_aggregate",
                               lambda: _aggregate_launch(grid, spfh, kp, radius, True, sort))
        aggregate_rule(got, want, counts, counts_p, spfh, kp, f"halo {halo} D {dim}")
    got = _counted("fpfh_aggregate", lambda: fpfh_aggregate(grid, spfh, kp, radius))
    aggregate_rule(got, want, counts_p, counts_p, spfh, kp, "the wrapper")
    before = _kernels.launch_counts["fpfh_aggregate"]
    empty = fpfh_aggregate(grid, spfh, kp[:0], radius)
    assert empty.shape == (0, dim) and _kernels.launch_counts["fpfh_aggregate"] == before


def test_k7_fpfh_aggregate_without_cell_table(cuda, rng):
    """A grid without a cell-start table keeps the chunked route (K7, the
    gather, the einsum): no aggregation launch, K7 launched, the twin's
    result within the rule."""
    pts = _surface(rng, 30_000, cuda)
    pts = torch.cat([pts, torch.full((1, 3), 5e3, device=cuda)])
    grid = build_grid(pts, 0.15, halo=2)
    assert not grid.has_table
    spfh = torch.rand((pts.shape[0], 125), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(0))
    kp = torch.arange(0, pts.shape[0], 9, device=cuda)
    before = dict(_kernels.launch_counts)
    got, counts = fpfh_aggregate(grid, spfh, kp, 0.3, return_counts=True)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["fpfh_aggregate"] == before["fpfh_aggregate"]
    assert _kernels.launch_counts["radius_dist"] > before["radius_dist"]
    want, counts_p = fpfh_aggregate_plain(grid, spfh, kp, 0.3, return_counts=True)
    aggregate_rule(got, want, counts, counts_p, spfh, kp, "no cell table")


def test_window_functions_launch_k7_and_k8(cuda, rng):
    """On CUDA tensors the grid's window functions run the kernels: K8,
    K7 for the radius search, K7's 1-NN mode (one launch) for the 1-NN."""
    from shot_fpfh_tpu_torch.ops.grid_hash import grid_nearest_neighbor, grid_radius_search

    pts = _surface(rng, 30_000, cuda)
    grid = build_grid(pts, 0.15, halo=2)
    _counted("fetch_windows", lambda: window_distances(grid, pts[:5000]))
    nbr = _counted("radius_dist", lambda: grid_radius_search(grid, pts[:5000], 0.3, 128))
    assert bool((nbr.count >= 1).all())
    dist, idx = _counted("nearest", lambda: grid_nearest_neighbor(grid, pts[:5000]))
    assert bool((dist == 0).all()) and torch.equal(idx, torch.arange(5000, device=cuda))


def test_iterative_keypoints_on_card_equal_cpu(cuda, rng):
    """The greedy on both sides of the 20k-point switch: the grid rounds
    (30k points, balls well under the cap) and the sequential greedy (3k
    points) select the CPU's keypoints, index for index."""
    from shot_fpfh_tpu_torch.keypoints import select_keypoints_iteratively

    pts = _surface(rng, 30_000, cuda)
    for cloud, radius in ((pts, 0.1), (pts[:3000], 0.2)):
        card = select_keypoints_iteratively(cloud, radius)
        np.testing.assert_array_equal(card, select_keypoints_iteratively(cloud.cpu(), radius))
        assert len(card) > 0


def test_surface_paths_on_card_equal_cpu(cuda, rng):
    """chip_smoke.py phase 17's two paths on a 30k-point terrain:
    ``radius_search_auto`` on both sides of the 20k-point switch (sets
    equal to the CPU's, and on the grid to the brute search's), and
    ``compute_shot_descriptor(local_rf_neighborhoods=)`` for 1024 keypoints
    (K7 and K1 launched; frames within 5e-4 of the CPU's but for near-tied
    sign votes, histograms by the flip rule under the card's frames)."""
    from chip_smoke import given_frames_check, radius_auto_check
    from shot_fpfh_tpu_torch.models.normals import compute_normals

    ref = make_terrain(30_000, rng, scale=5.5)
    for n, radius in ((3_000, 0.9), (30_000, 0.3)):
        queries = ref[:n][rng.choice(n, 1024, replace=False)]
        radius_auto_check(ref[:n], queries, radius, cuda, f"radius_search_auto {n}")
    pts = torch.tensor(ref, device=cuda)
    normals = compute_normals(pts, pts, k=30, device=cuda)
    kp = pts[torch.tensor(rng.choice(len(ref), 1024, replace=False), device=cuda)]
    r = given_frames_check(pts, normals, kp, 0.9, "given frame neighborhoods")
    assert r["launches"]["shot_binning_histogram"] >= 1 and r["launches"]["radius_dist"] >= 1


def test_pca_features_on_card_match_cpu(cuda, rng):
    """Radius normals, sphericity, moments and the 21 feature columns on the
    grid routes (K3, K8) against the CPU: within 1e-6, the angle columns
    (steep arcsin at |x| = 1) within 1e-4 (chip_smoke.py phase 10's limits;
    the moments and λ_min are ~1e-4)."""
    from shot_fpfh_tpu_torch.models import normals as nm

    pts = _surface(rng, 30_000, cuda)
    q = pts[::15]
    w, v, mom, sizes = nm.local_pca_with_moments(q, pts, 0.2)
    w_c, v_c, mom_c, sizes_c = nm.local_pca_with_moments(q.cpu(), pts.cpu(), 0.2)
    assert torch.equal(sizes.cpu(), sizes_c)
    torch.testing.assert_close(w.cpu(), w_c, atol=1e-6, rtol=0)
    torch.testing.assert_close(mom.cpu(), mom_c, atol=1e-6, rtol=0)
    n = nm.compute_normals(q, pts, radius=0.2)
    n_c = nm.compute_normals(q.cpu(), pts.cpu(), radius=0.2)
    assert float(((n.cpu() * n_c).sum(1).abs() > 0.999).float().mean()) >= 0.999
    torch.testing.assert_close(nm.compute_sphericity(q, pts, 0.2).cpu(),
                               nm.compute_sphericity(q.cpu(), pts.cpu(), 0.2), atol=1e-6, rtol=0)
    feats = nm.compute_pca_based_features(q, pts, 0.2).cpu()
    feats_c = nm.compute_pca_based_features(q.cpu(), pts.cpu(), 0.2)
    assert feats.shape == (q.shape[0], 21) and bool(torch.isfinite(feats).all())
    angle = torch.zeros(21, dtype=torch.bool)
    angle[8:12] = True
    torch.testing.assert_close(feats[:, ~angle], feats_c[:, ~angle], atol=1e-6, rtol=0)
    torch.testing.assert_close(feats[:, angle], feats_c[:, angle], atol=1e-4, rtol=0)


def _fused_pair(rng, n=25_000):
    """A terrain pair (scan = exact rigid motion of ref) above the grid
    threshold, with CPU k=20 normals shared by both devices."""
    from shot_fpfh_tpu_torch.models.normals import compute_normals

    ref = make_terrain(n, rng, scale=5.0, n_bumps=12)
    rot = rotation_about([0.3, -0.2, 1.0], np.deg2rad(12.0))
    trans = np.array([0.3, -0.2, 0.1])
    scan = (ref @ rot.T + trans).astype(np.float32)
    normals = [compute_normals(c, c, k=20, device="cpu").numpy() for c in (scan, ref)]
    return scan, normals[0], ref, normals[1], rot, trans


def test_fused_registration_on_card_matches_cpu(cuda, rng):
    """``register_pair`` on the card (SG, K2 in f32, ICP's IS) against the
    CPU with the same injected Gumbel noise: the same keypoints, matches
    within the flip rule's reach (1%), ICP transforms within 1e-3 and both
    within 1e-2 of the ground truth."""
    from shot_fpfh_tpu_torch.core.subsampling import grid_subsample
    from shot_fpfh_tpu_torch.core.transform import rotation_angle
    from shot_fpfh_tpu_torch.registration import fused

    scan, sn, ref, rn, rot, trans = _fused_pair(rng)
    kw = dict(keypoint_voxel=0.3, icp_voxel=0.2, radius=0.9, n_draws=1024, ratio_threshold=0.9,
              ransac_threshold=0.3, d_max=0.3, min_neighborhood_size=10)
    q = -(-len(grid_subsample(scan, kw["keypoint_voxel"], device="cpu")) // 256) * 256
    u = torch.rand((1024 // fused.RANSAC_CHUNK, fused.RANSAC_CHUNK, q),
                   generator=torch.Generator().manual_seed(5))
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    before = dict(_kernels.launch_counts)
    card = fused.register_pair(scan, sn, ref, rn, device=cuda, gumbel=gumbel, **kw)
    torch.cuda.synchronize()
    ran = {k: _kernels.launch_counts[k] - before[k] for k in before}
    assert ran["top2_match"] == 1
    assert all(ran[k] > 0 for k in ("shot_grid", "icp_step"))
    assert ran["shot_binning_histogram"] == 0 and ran["fetch_windows"] == 0
    cpu = fused.register_pair(scan, sn, ref, rn, device="cpu", gumbel=gumbel, **kw)
    np.testing.assert_array_equal(card.scan_keypoint_idx, cpu.scan_keypoint_idx)
    np.testing.assert_array_equal(card.ref_keypoint_idx, cpu.ref_keypoint_idx)
    n_card, n_cpu = int(card.n_matches), int(cpu.n_matches)
    assert n_cpu > 50 and abs(n_card - n_cpu) <= max(2, n_cpu // 100)
    assert bool(card.icp_converged) == bool(cpu.icp_converged)
    tf_card, tf_cpu = card.icp_transform.to("cpu"), cpu.icp_transform
    assert float(rotation_angle(tf_card.rotation, tf_cpu.rotation)) < 1e-3
    assert float(torch.linalg.norm(tf_card.translation - tf_cpu.translation)) < 1e-3
    exact = torch.tensor(rot.T, dtype=torch.float32)
    for tf in (tf_card, tf_cpu):
        assert float(rotation_angle(tf.rotation, exact)) < 1e-2


def _icp_case(rng, cuda):
    from shot_fpfh_tpu_torch.core.subsampling import grid_subsample
    from shot_fpfh_tpu_torch.core.transform import RigidTransform
    from shot_fpfh_tpu_torch.ops.grid_hash import build_grid

    scan, _, ref, rn, rot, trans = _fused_pair(rng)
    sub = torch.tensor(scan[grid_subsample(scan, 0.2, device="cpu")], device=cuda)
    ref_t, rn_t = torch.tensor(ref, device=cuda), torch.tensor(rn, device=cuda)
    # a start 0.02 rad and 0.03 off the exact scan -> ref transform
    start_rot = rotation_about([0.5, 0.1, -0.8], 0.02) @ rot.T
    init = RigidTransform.from_numpy(start_rot, -rot.T @ trans + 0.03, device=cuda)
    return sub, ref_t, rn_t, init, build_grid(ref_t, 0.3)


@pytest.mark.parametrize("point_to_plane", [True, False])
def test_icp_device_loop_equals_host_read_loop(cuda, rng, monkeypatch, point_to_plane):
    """The device loop (``done`` read once an ``ICP_BLOCK``) against the same
    loop reading ``done`` after every iteration (the former host loop),
    stopped mid-way and run to ``max_iter``: equal iteration counts and
    convergence, the same transform and RMS bit for bit."""
    from shot_fpfh_tpu_torch.registration import icp

    sub, ref, rn, init, grid = _icp_case(rng, cuda)
    nrm = rn if point_to_plane else None
    args = (sub, ref, nrm, init, 0.3)
    rms3 = float(icp.icp_loop(*args, 3, 0.0, grid=grid).rms)
    for max_iter, thr in ((30, rms3 * 1.0001), (30, 0.0)):
        blocked = icp.icp_loop(*args, max_iter, thr, grid=grid)
        with monkeypatch.context() as mp:
            mp.setattr(icp, "ICP_BLOCK", 1)
            host = icp.icp_loop(*args, max_iter, thr, grid=grid)
        assert int(blocked.n_iters) == int(host.n_iters)
        assert bool(blocked.has_converged) == bool(host.has_converged) == (thr > 0)
        assert int(blocked.n_iters) == (max_iter if thr == 0 else int(host.n_iters))
        for a, b in ((blocked.transform.rotation, host.transform.rotation),
                     (blocked.transform.translation, host.transform.translation),
                     (blocked.rms, host.rms)):
            assert torch.equal(a, b)
    assert int(blocked.n_iters) == 30


def test_point_to_plane_solve_ex_equals_solve_on_card(cuda, rng, monkeypatch):
    """``solve_point_to_plane`` takes ``torch.linalg.solve_ex`` (no status
    read): on ICP's normal equations it equals ``torch.linalg.solve`` bit
    for bit."""
    from shot_fpfh_tpu_torch.core.solvers import solve_point_to_plane

    sub, ref, rn, init, _ = _icp_case(rng, cuda)
    n = sub.shape[0]
    systems, solve_ex = [], torch.linalg.solve_ex
    monkeypatch.setattr(torch.linalg, "solve_ex",
                        lambda a, b: systems.append((a, b)) or solve_ex(a, b))
    solve_point_to_plane(init.apply(sub), ref[:n], rn[:n], torch.ones(n, device=cuda))
    (a, b), = systems
    assert torch.equal(solve_ex(a, b).result, torch.linalg.solve(a, b))


def test_icp_loop_reads_the_card_once_a_block(cuda, rng):
    """Point-to-plane ICP on the grid 1-NN: the only host syncs of the loop
    are its reads of ``done``, one every ``ICP_BLOCK`` iterations
    (``torch.cuda.set_sync_debug_mode("warn")``), and each iteration is one
    launch of IS (``icp_step``), with no 1-NN launch (K7's 1-NN mode) and
    no K7 window."""
    import warnings

    from shot_fpfh_tpu_torch.registration import icp

    sub, ref, rn, init, grid = _icp_case(rng, cuda)
    icp.icp_loop(sub, ref, rn, init, 0.3, 2, 0.0, grid=grid)     # warm-up
    torch.cuda.synchronize()
    before = dict(_kernels.launch_counts)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = icp.icp_loop(sub, ref, rn, init, 0.3, 20, 0.0, grid=grid)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    assert int(out.n_iters) == 20
    # one IS launch an iteration, and no 1-NN or K7 window launch
    assert _kernels.launch_counts["icp_step"] - before["icp_step"] == 20
    assert _kernels.launch_counts["nearest"] == before["nearest"]
    assert _kernels.launch_counts["radius_dist"] == before["radius_dist"]
    assert len(syncs) == -(-20 // icp.ICP_BLOCK), [str(w.message) for w in syncs]


def _icp_terrain_case(cuda):
    """ICP's shape in the benchmark's cells: a 10^6-point terrain
    (``chip_smoke.scale_terrain``) with k=30 normals on the card, its grid
    of cell 0.5, and the scan (the ref moved 0.01 rad and 0.05, with noise
    of its own at 0.005, so the RMS floor lies above 1e-3 as in the cells)
    subsampled at voxel 0.2, started at the identity."""
    from shot_fpfh_tpu_torch.core.subsampling import grid_subsample
    from shot_fpfh_tpu_torch.core.transform import RigidTransform
    from shot_fpfh_tpu_torch.models.normals import compute_normals
    from shot_fpfh_tpu_torch.registration.icp import nn_grid

    ref_np = scale_terrain(np.random.default_rng(11), 1_000_000)
    ref = torch.tensor(ref_np, device=cuda)
    rn = compute_normals(ref, ref, k=30)
    rot = rotation_about([0.2, -0.4, 1.0], 0.01)
    noise = np.random.default_rng(12).normal(scale=0.005, size=ref_np.shape)
    scan = torch.tensor(((ref_np - 0.05) @ rot + noise).astype(np.float32), device=cuda)
    sub = scan[torch.as_tensor(grid_subsample(scan, 0.2), device=cuda)]
    return sub, ref, rn, RigidTransform.identity(device=cuda), nn_grid(ref, 0.5), 0.5


@pytest.mark.parametrize("shape", ["smoke", "terrain_1m"])
def test_icp_kernel_matches_its_plain_twin(cuda, rng, shape):
    """IS (``icp_step``: the whole iteration in one launch) against ``_step``
    on the same card inputs, at the smoke ICP shape and at the cells' 10^6
    shape: the RMS after each of iterations 1–4 within 1e-5 relative, and
    after 30 iterations the same count, the rotation within 1e-6 rad and
    the translation within 1e-5.  The smoke scan gets noise of its own at
    0.005, as the cells' scans have: an exact motion drives the RMS to the
    float32 floor of the residuals (~1e-7) by iteration 4, where neither
    loop's rounding means anything."""
    from shot_fpfh_tpu_torch.registration import icp

    if shape == "smoke":
        sub, ref, rn, init, grid = _icp_case(rng, cuda)
        sub = sub + torch.tensor(rng.normal(scale=0.005, size=tuple(sub.shape)),
                                 dtype=torch.float32, device=cuda)
        d_max = 0.3
    else:
        sub, ref, rn, init, grid, d_max = _icp_terrain_case(cuda)
    for k in range(1, 5):
        got = icp.icp_loop(sub, ref, rn, init, d_max, k, 0.0, grid=grid)
        want = twin_icp(grid, sub, ref, rn, init, d_max, k)
        assert int(got.n_iters) == int(want[0]) == k
        assert abs(float(got.rms) - float(want[3])) <= 1e-5 * float(want[3]), (k, float(got.rms),
                                                                              float(want[3]))
    got = icp.icp_loop(sub, ref, rn, init, d_max, 30, 1e-3, grid=grid)
    want = twin_icp(grid, sub, ref, rn, init, d_max, 30, 1e-3)
    assert int(got.n_iters) == int(want[0])
    assert bool(got.has_converged) == bool(want[4])
    assert rotation_gap(got.transform.rotation, want[1]) <= 1e-6
    assert float((got.transform.translation - want[2]).abs().max()) <= 1e-5


def test_icp_kernel_stops_mid_block_and_repeats_its_bits(cuda, rng):
    """A threshold crossed inside a block of ``ICP_BLOCK`` launches: the
    later launches of the block leave the state as a loop stopped there
    (``max_iter`` at the crossing) leaves it, bit for bit; two runs give
    the same bits."""
    from shot_fpfh_tpu_torch.registration import icp

    sub, ref, rn, init, grid = _icp_case(rng, cuda)
    args = (sub, ref, rn, init, 0.3)
    stopped = icp.icp_loop(*args, 3, 0.0, grid=grid)
    again = icp.icp_loop(*args, 3, 0.0, grid=grid)
    crossed = icp.icp_loop(*args, 30, float(stopped.rms) * 1.0001, grid=grid)
    assert int(crossed.n_iters) == 3 and bool(crossed.has_converged)
    for out in (again, crossed):
        for a, b in ((out.transform.rotation, stopped.transform.rotation),
                     (out.transform.translation, stopped.transform.translation),
                     (out.rms, stopped.rms)):
            assert torch.equal(a, b)


def test_icp_kernel_padding_rows_change_nothing(cuda, rng):
    """Zero-weight rows appended to the scan (the fused program's padding:
    far points and repeats of real ones) change no bit of IS's result."""
    from shot_fpfh_tpu_torch.registration import icp

    sub, ref, rn, init, grid = _icp_case(rng, cuda)
    pad = torch.cat([torch.full((100, 3), 1.0e6, device=cuda), sub[:156]])
    weights = torch.cat([torch.ones(sub.shape[0], device=cuda),
                         torch.zeros(pad.shape[0], device=cuda)])
    plain = icp.icp_loop(sub, ref, rn, init, 0.3, 12, 0.0, grid=grid)
    padded = icp.icp_loop(torch.cat([sub, pad]), ref, rn, init, 0.3, 12, 0.0, grid=grid,
                          weights=weights)
    assert int(plain.n_iters) == int(padded.n_iters) == 12
    for a, b in ((plain.transform.rotation, padded.transform.rotation),
                 (plain.transform.translation, padded.transform.translation),
                 (plain.rms, padded.rms)):
        assert torch.equal(a, b)


def test_icp_kernel_all_outliers_match_the_twin(cuda, rng):
    """No point within ``d_max`` of the ref (the start 50 units off): the
    sums are all 0, the RMS 0 (no NaN) and the loop done after one
    iteration, as the twin's; the singular solve gives the twin's
    transform, NaN where it is NaN."""
    from shot_fpfh_tpu_torch.core.transform import RigidTransform
    from shot_fpfh_tpu_torch.registration import icp

    sub, ref, rn, init, grid = _icp_case(rng, cuda)
    far = RigidTransform(init.rotation, init.translation + 50.0)
    got = icp.icp_loop(sub, ref, rn, far, 0.3, 10, 1e-3, grid=grid)
    want = twin_icp(grid, sub, ref, rn, far, 0.3, 10, 1e-3)
    assert int(got.n_iters) == int(want[0]) == 1
    assert bool(got.has_converged) and bool(want[4])
    assert float(got.rms) == float(want[3]) == 0.0
    for a, b in ((got.transform.rotation, want[1]), (got.transform.translation, want[2])):
        torch.testing.assert_close(a, b, equal_nan=True, rtol=0, atol=1e-6)


def _whole_number_stacks(rng, device=None):
    """Three 16-column scales of 2,100 x 1,900 rows with values in -3..3
    (exact distances), repeated rows, and rows empty at one or every scale:
    ties must resolve to the lowest index on every device."""
    scan = rng.integers(-3, 4, size=(3, 2100, 16)).astype(np.float32)
    ref = rng.integers(-3, 4, size=(3, 1900, 16)).astype(np.float32)
    ref[:, 1000:1100] = ref[:, :100]
    scan[:, 1500:1600] = scan[:, :100]
    scan[0, :40] = 0.0
    scan[:, 77] = 0.0
    ref[1, 200:260] = 0.0
    return (torch.tensor(scan, device=device), torch.tensor(ref, device=device))


@pytest.mark.parametrize("reciprocal", [False, True])
def test_multiscale_top1_on_card_equals_cpu(cuda, rng, reciprocal):
    from shot_fpfh_tpu_torch.registration.matching import multiscale_top1

    scan, ref = _whole_number_stacks(rng)
    idx, dist = multiscale_top1(scan.to(cuda), ref.to(cuda), filter_nonreciprocal=reciprocal)
    assert idx.device.type == "cuda"
    idx_c, dist_c = multiscale_top1(scan, ref, filter_nonreciprocal=reciprocal, device="cpu")
    assert torch.equal(idx.cpu(), idx_c)
    assert torch.equal(dist.cpu(), dist_c)


def test_debug_nans_raises_in_the_kernel_wrapper(cuda, rng):
    """Under ``NanCheck`` a NaN in a K2 operand raises from the kernel
    wrapper, naming the kernel (K2 itself drops a NaN distance, so its
    outputs alone would not show it); the same call without the NaN
    passes."""
    from shot_fpfh_tpu_torch.registration.matching import nearest_descriptor
    from shot_fpfh_tpu_torch.utils.debug_nans import NanCheck

    a = torch.tensor(rng.normal(size=(300, 352)).astype(np.float32), device=cuda)
    b = torch.tensor(rng.normal(size=(400, 352)).astype(np.float32), device=cuda)
    valid = torch.ones(400, dtype=torch.bool, device=cuda)
    with NanCheck():
        nearest_descriptor(a, b, valid)
    a[7, 3] = float("nan")
    before = _kernels.launch_counts["top2_match"]
    with pytest.raises(FloatingPointError, match="CUDA kernel top2_match"):
        with NanCheck():
            nearest_descriptor(a, b, valid)
    assert _kernels.launch_counts["top2_match"] == before + 1


def test_debug_shot_on_card_counts_in_k1(cuda, rng):
    """With the SHOT debug checks on, grid-route SHOT on the card still runs
    SG (no K5 by default, no K8 + K1), which counts the checks itself: no
    violation, and the descriptors within K1's flip rule of those without
    the checks (the histogram's float atomics may add in another order)."""
    from chip_smoke import flip_rule
    from shot_fpfh_tpu_torch.models.normals import compute_normals
    from shot_fpfh_tpu_torch.models.shot import (
        compute_shot_descriptor,
        debug_violation_count,
        enable_debug_checks,
    )

    cloud = torch.tensor(make_terrain(30_000, rng, scale=5.0, n_bumps=10), device=cuda)
    normals = compute_normals(cloud, cloud, k=30, device=cuda)
    kp = cloud[:500]
    want, _ = compute_shot_descriptor(kp, cloud, normals, 0.6)
    _kernels.reset_launch_counts()
    enable_debug_checks(True)
    try:
        got, _ = compute_shot_descriptor(kp, cloud, normals, 0.6)
        assert debug_violation_count() == 0
    finally:
        enable_debug_checks(False)
    assert _kernels.launch_counts["shot_grid"] > 0
    assert _kernels.launch_counts["shot_runs"] == 0
    assert _kernels.launch_counts["shot_binning_histogram"] == 0
    assert _kernels.launch_counts["fetch_windows"] == 0
    assert bool(torch.isfinite(got).all())
    flip_rule(got, want, "SG with the checks vs without")


@pytest.mark.parametrize("kernel", ["shot_binning_histogram", "shot_runs"])
def test_debug_counter_matches_twin(cuda, rng, kernel):
    """K1's and K5's debug counters against their twins': none at the real
    radius, with the histograms those without a counter give; K1 told an
    eighth of its window's radius bins neighbors whose husk weights drive
    their weight sums below 0, and counts them as its twin does (K5 bins
    only the rows its radius holds, so it has nothing to count there).
    Under given frames with a planted NaN (whole frames, and one z-axis
    component, which leaves the azimuth finite) both kernels keep the NaN
    as their twins' clamps do: the same counts, NaN in the same histogram
    entries, the rest by the flip rule."""
    from shot_fpfh_tpu_torch.ops.shot_fused import shot_binning_histogram_plain

    pts = _surface(rng, 20_000, cuda)
    nrm = torch.nn.functional.normalize(torch.randn_like(pts), dim=1)
    grid = build_grid(pts, 0.3, extras=nrm, halo=2)
    kp = pts[::79]
    raw = dict(normalize=False, min_neighborhood_size=-1)
    if kernel == "shot_runs":
        assert shot_dma._xyrow_mode(grid)[0]
        _, rfs = shot_dma.shot_descriptor_dma_plain(grid, kp, 0.6, **raw)

        def run(fn, r, counter, frames=rfs):
            return fn(grid, kp, r, rfs=frames, violations=counter, **raw)[0]

        calls, radii = (shot_dma.shot_descriptor_dma, shot_dma.shot_descriptor_dma_plain), (0.6,)
    else:
        vals, d, valid, _ = window_distances(grid, kp, with_rows=False)
        dist = torch.where(valid & (d <= 0.6), d, torch.full_like(d, float("inf")))
        _, rfs = shot_binning_histogram_plain(vals, dist, kp, None, 0.6)

        def run(fn, r, counter, frames=rfs):
            return fn(vals, dist, kp, frames, r, violations=counter)

        calls, radii = (shot_binning_histogram, shot_binning_histogram_plain), (0.6, 0.075)
    without = run(calls[0], 0.6, None)
    for r in radii:
        counters = [torch.zeros(2, dtype=torch.int32, device=cuda) for _ in calls]
        hist = [run(fn, r, c) for fn, c in zip(calls, counters)]
        k, p = (c.tolist() for c in counters)
        if r == 0.6:
            assert k == p == [0, 0]
            torch.testing.assert_close(hist[0], without, atol=1e-4, rtol=1e-5)
        else:
            assert k == p and k[1] > 0
    planted = rfs.clone()
    planted[::13] = float("nan")
    planted[6::13, 0, 2] = float("nan")
    counters = [torch.zeros(2, dtype=torch.int32, device=cuda) for _ in calls]
    hist = [run(fn, 0.6, c, planted) for fn, c in zip(calls, counters)]
    k, p = (c.tolist() for c in counters)
    assert k == p and k[1] > 0
    nan = torch.isnan(hist[0])
    assert torch.equal(nan, torch.isnan(hist[1]))
    if kernel == "shot_runs":   # K5 finalizes: a row of NaN norm is zeroed, as in its twin
        assert not bool(nan.any()) and not bool(hist[0][::13].any())
    else:
        assert bool(nan[::13].any(dim=1).all()) and not bool(nan[1::13].any())
    _assert_shot_flip_rule(hist[0].nan_to_num(), hist[1].nan_to_num())


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A 1-rank NCCL group in this process (destroyed after the test)."""
    import torch.distributed as dist

    from shot_fpfh_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device="cuda", init_method=f"file://{tmp_path / 'store'}", rank=0,
                     world_size=1, timeout=120)
    try:
        assert dist.get_backend() == "nccl" and mesh.backend == "nccl"
        yield mesh
    finally:
        dist.destroy_process_group()


def test_one_rank_nccl_mesh_equals_one_device(nccl_mesh, rng):
    """``sharded_shot_descriptors`` (the grid route, SG, and K5 called in
    its place: ``chip_smoke.run_kernels_in_place``) and ``ring_match`` (K2
    on the one tile) over a 1-rank NCCL group equal the single-device path,
    and launch its kernels."""
    from shot_fpfh_tpu_torch.models.shot import compute_shot_descriptor
    from shot_fpfh_tpu_torch.parallel import ring_match, sharded_shot_descriptors
    from shot_fpfh_tpu_torch.registration.matching import top2_descriptor

    dev = nccl_mesh.device
    pts = _surface(rng, 30_000, dev)
    nrm = torch.nn.functional.normalize(torch.randn_like(pts), dim=1)
    kp = pts[::41]
    descs = []
    for run_route in (False, True):
        kernel = "shot_runs" if run_route else "shot_grid"
        before = _kernels.launch_counts[kernel]
        with run_kernels_in_place(run_route):
            got = sharded_shot_descriptors(kp, pts, nrm, 0.5, nccl_mesh, return_rfs=True,
                                           min_neighborhood_size=10)
            assert _kernels.launch_counts[kernel] > before
            want = compute_shot_descriptor(kp, pts, nrm, 0.5, min_neighborhood_size=10)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        descs.append(got[0])
    a, b = descs[0][::2], descs[1][1::2][:-1]      # an odd ref count pads the tile
    before = _kernels.launch_counts["top2_match"]
    got = ring_match(a, b, nccl_mesh)
    assert _kernels.launch_counts["top2_match"] == before + 1
    want = top2_descriptor(a, b, torch.ones(b.shape[0], dtype=torch.bool, device=dev))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_fused_mesh_on_one_rank_nccl_equals_one_device(nccl_mesh, rng):
    """``fused_registration_mesh`` over a 1-rank NCCL group (SG, K2
    in f32, K7 under its collectives) against ``fused_registration`` on
    the same inputs: the same match count and launches (but ICP's: IS an
    iteration on one device, the plain step's 1-NN an iteration under the
    mesh's sums), RANSAC and ICP within 1e-5."""
    from shot_fpfh_tpu_torch.registration import fused

    scan, sn, ref, rn, _, _ = _fused_pair(rng)
    captured = {}
    real = fused.fused_registration

    def capture(*args, **kwargs):
        captured["call"] = (args, kwargs)
        return real(*args, **kwargs)

    fused.fused_registration = capture
    try:
        fused.register_pair(scan, sn, ref, rn, device=nccl_mesh.device, keypoint_voxel=0.3,
                            icp_voxel=0.2, radius=0.9, n_draws=1024, ratio_threshold=0.9,
                            ransac_threshold=0.3, d_max=0.3, min_neighborhood_size=10)
    finally:
        fused.fused_registration = real
    args, kwargs = captured["call"]
    counts = []
    for run in (lambda: real(*args, **kwargs),
                lambda: fused.fused_registration_mesh(nccl_mesh, *args, **kwargs)):
        before = dict(_kernels.launch_counts)
        counts.append((run(), {k: _kernels.launch_counts[k] - before[k] for k in before}))
        torch.cuda.synchronize()
    (one, one_launches), (mesh, mesh_launches) = counts
    assert one_launches["icp_step"] == mesh_launches["nearest"] > 0
    assert one_launches["nearest"] == mesh_launches["icp_step"] == 0
    for c in (one_launches, mesh_launches):
        del c["icp_step"], c["nearest"]
    assert mesh_launches == one_launches and mesh_launches["top2_match"] == 1
    assert int(mesh.n_matches) == int(one.n_matches) > 50
    assert bool(mesh.icp_converged) == bool(one.icp_converged)
    for got, want in ((mesh.ransac_transform, one.ransac_transform),
                      (mesh.icp_transform, one.icp_transform)):
        torch.testing.assert_close(got.rotation, want.rotation, atol=1e-5, rtol=0)
        torch.testing.assert_close(got.translation, want.translation, atol=1e-5, rtol=0)


EFFICIENCY_WORKER = r"""
import json, sys
rank, coord, root, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
sys.path.insert(0, root)
from shot_fpfh_tpu_torch.parallel import initialize_distributed, scaling_report
initialize_distributed(coord, 2, rank, device="cuda", timeout=300)
res = scaling_report(n_keypoints=8192, n_support=50000, radius=0.9, k_max=128,
                     device_counts=(1, 0), stage="shot", device="cuda")
with open(out, "w") as f:
    json.dump({str(k): v for k, v in res.items()}, f)
"""


def test_scaling_efficiency_target_on_two_cards(cuda, tmp_path):
    """JAX's north-star target (``tests/test_sharded.py``): sharded SHOT
    over two ranks, a card each (NCCL), at least 80% efficient against one
    card.  Two ranks sharing one card measure nothing, so it needs two."""
    import os
    import socket
    import subprocess

    if torch.cuda.device_count() < 2:
        pytest.skip("scaling efficiency needs two cards or more")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", EFFICIENCY_WORKER, str(r), coord,
                               str(REPO), str(outs[r])], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    res = json.loads(outs[0].read_text())
    assert res["efficiency"] >= 0.8, f"scaling efficiency {res['efficiency']:.0%}"
