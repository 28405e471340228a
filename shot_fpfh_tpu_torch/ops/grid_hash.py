"""Grid-hash neighbor engine: voxel bucketing + contiguous candidate runs.

Port of the parts of ``shot_fpfh_tpu.ops.grid_hash`` that the staged
registration path runs.  Points are bucketed into cells of edge
``cell_size``, sorted by linear cell id (z minor) on the device, and a dense
cell-start table maps a cell id to its first sorted row.  A query's
``(2h+1)^3`` cell window is then ``(2h+1)^2`` *contiguous* z-column runs of
the sorted cloud (:func:`_zcolumn_runs`), and :func:`window_distances`
concatenates them into a fixed-width ``(Q, W)`` candidate window, ``W`` being
the largest window occupancy of the grid (computed at build) — every radius
neighborhood of radius ≤ ``halo·cell_size`` is inside it, uncapped.

The reference's *xy-row* mode (``2h+1`` runs a query, one per x offset,
each spanning the ``y-h .. y+h`` columns at full z extent) and its caps
belong to the run kernels that read it (``ops.shot_dma``), which work them
out from the cell table.

The window functions run the kernels of ``ops.radius_runs`` over the runs:
:func:`window_distances` K8 (the window's values and distances),
:func:`grid_radius_search` K7 (masked distances, then ``topk`` in PyTorch)
and :func:`grid_nearest_neighbor` K7's 1-NN mode (the minimum taken in the
kernel); on CPU tensors their plain twins.

Not ported: the content-keyed grid LRU (on an H100 a 10^6-point grid
builds from host arrays in less time than hashing them takes:
``chip_smoke.py`` phase 16) and the G=8/16 grouped feature-planar gather
(an index-bound gather workaround of the TPU); the compacted ``(Q, W)``
window over the runs gives the same window contract.  Nor is the
``query_chunk`` of :func:`grid_nearest_neighbor` and
:func:`grid_radius_pca`: on a grid with a cell table each is one kernel
launch, with no query loop to bound.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve
from .._fp import div, sqnorm3, sqrt
from ..utils.perf import blocking
from .neighbors import Neighborhoods, _chunk, _sq_dists, as_f32, knn, radius_search
from .radius_runs import fetch_windows, nearest, radius_dist, window_slots

logger = logging.getLogger(__name__)

# below this cloud size brute force wins (one matmul beats build + gather)
AUTO_GRID_MIN_POINTS = 20_000

# window rows x features gathered per chunk: bounds a chunk's temporaries
_CHUNK_ELEMS = 1 << 24


@dataclass(frozen=True)
class HashGrid:
    """Cell-sorted cloud plus the host-side caps that set window shapes."""

    packed_sorted: torch.Tensor    # (N, 3+F) [points | extras], cell order
    orig_idx: torch.Tensor         # (N,) sorted position -> original index
    cell_ids_sorted: torch.Tensor  # (N,) int64 linear cell ids, ascending
    origin: torch.Tensor           # (3,) float32
    dims: tuple[int, int, int]     # cells per axis
    cell_size: float
    cell_starts: torch.Tensor | None  # (n_cells+1,) first row per cell id
    cell_cap: int                  # max points in one cell
    window_cap: int                # max points in any (2h+1)^3 window
    halo: int = 1

    @property
    def has_table(self) -> bool:
        return self.cell_starts is not None

    @property
    def points_sorted(self) -> torch.Tensor:
        return self.packed_sorted[:, :3]

    @property
    def device(self) -> torch.device:
        return self.packed_sorted.device


def _box_max(counts: torch.Tensor, halo: int) -> int:
    """Max (2h+1)^3 box sum over every in-grid center of a dense
    ``(d0, d1, d2)`` count volume."""
    box = counts
    w = 2 * halo + 1
    for ax in (2, 1, 0):
        pad = [0, 0, 0, 0, 0, 0]
        pad[2 * (2 - ax)] = pad[2 * (2 - ax) + 1] = halo
        p = F.pad(box, pad)
        box = sum(p.narrow(ax, s, box.shape[ax]) for s in range(w))
    with blocking("grid.window_cap"):
        return int(box.max())


def build_grid(points, cell_size: float, extras=None, halo: int = 1,
               device=None) -> HashGrid:
    """Bucket ``points`` into cells of edge ``cell_size`` on ``device``
    (default: the points tensor's device, ``cuda`` for host arrays).

    ``extras``: optional ``(N, F)`` per-point values (e.g. normals) carried
    in cell order beside the points.  The dense cell-start table is built
    when the cell count is at most ``max(8N, 2^24)``; sparser grids find
    their runs by binary search over the sorted ids instead."""
    pts = as_f32(points, resolve(device, points))
    n = pts.shape[0]
    origin = pts.min(dim=0).values
    cell = torch.floor(div(pts - origin, cell_size)).to(torch.int64)
    dims_t = cell.max(dim=0).values + 1
    with blocking("grid.dims"):
        dims = tuple(int(v) for v in dims_t.tolist())
    linear = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    ids_sorted, orig_idx = torch.sort(linear, stable=True)
    with blocking("grid.cells"):
        _, occ = torch.unique_consecutive(ids_sorted, return_counts=True)
    with blocking("grid.cell_cap"):
        cell_cap = int(occ.max())
    n_cells = dims[0] * dims[1] * dims[2]
    if 0 < n_cells <= max(8 * n, 1 << 24):
        cell_starts = torch.searchsorted(
            ids_sorted, torch.arange(n_cells + 1, device=pts.device), right=False)
        counts = (cell_starts[1:] - cell_starts[:-1]).reshape(dims)
        window_cap = min(_box_max(counts, halo), n)
    else:
        cell_starts = None
        window_cap = min((2 * halo + 1) ** 3 * cell_cap, n)
    packed = pts[orig_idx]
    if extras is not None:
        packed = torch.cat([packed, as_f32(extras, pts.device)[orig_idx]], dim=1)
    return HashGrid(packed.contiguous(), orig_idx, ids_sorted, origin, dims,
                    float(cell_size), cell_starts, cell_cap, max(window_cap, 1), halo)


def _query_cells(grid: HashGrid, queries: torch.Tensor) -> torch.Tensor:
    return torch.floor(div(queries - grid.origin, grid.cell_size)).to(torch.int64)


def _zcolumn_runs(grid: HashGrid, queries: torch.Tensor, qcell: torch.Tensor | None = None):
    """``(start, end)`` sorted rows ``(Q, (2h+1)^2)`` of each query's
    z-column runs: for each (dx, dy) offset, the cells (x+dx, y+dy,
    max(z-h, 0) .. min(z+h, d2-1)) are consecutive in the z-minor id, so they
    form one contiguous run.  Off-grid columns give empty runs.  ``qcell``:
    the queries' cells (``_query_cells``), when the caller has them."""
    h = grid.halo
    d0, d1, d2 = grid.dims
    if qcell is None:
        qcell = _query_cells(grid, queries)
    r = torch.arange(-h, h + 1, device=queries.device)
    off = torch.stack(torch.meshgrid(r, r, indexing="ij"), -1).reshape(-1, 2)
    xy = qcell[:, None, :2] + off[None]                       # (Q, R, 2)
    in_grid = ((xy[..., 0] >= 0) & (xy[..., 0] < d0)
               & (xy[..., 1] >= 0) & (xy[..., 1] < d1))
    z_lo = torch.clamp(qcell[:, 2:3], min=h) - h              # (Q, 1)
    z_hi = torch.clamp(qcell[:, 2:3] + h, max=d2 - 1)
    in_grid = (in_grid & (qcell[:, 2:3] >= -h)
               & (qcell[:, 2:3] <= d2 + h - 1) & (z_hi >= z_lo))
    base = (xy[..., 0] * d1 + xy[..., 1]) * d2
    zero = torch.zeros_like(base)
    if grid.has_table:
        last = grid.cell_starts.shape[0] - 1
        lo = torch.clamp(base + z_lo, 0, last)
        hi = torch.clamp(base + z_hi + 1, 0, last)
        start = torch.where(in_grid, grid.cell_starts[lo], zero)
        end = torch.where(in_grid, grid.cell_starts[hi], zero)
    else:
        neg = torch.full_like(base, -1)
        lo_id = torch.where(in_grid, base + z_lo, neg)
        hi_id = torch.where(in_grid, base + z_hi, neg)
        ids = grid.cell_ids_sorted
        start = torch.searchsorted(ids, lo_id.reshape(-1)).reshape(lo_id.shape)
        end = torch.searchsorted(ids, hi_id.reshape(-1), right=True).reshape(hi_id.shape)
        end = torch.where(in_grid, end, start)
    return start, torch.maximum(end, start)


def window_rows(grid: HashGrid, queries: torch.Tensor):
    """``(rows (Q, W), valid (Q, W))``: each query's z-column runs
    concatenated into ``W = grid.window_cap`` sorted-row slots."""
    start, end = _zcolumn_runs(grid, queries)
    return window_slots(start, end, grid.window_cap, grid.packed_sorted.shape[0])


def window_distances(grid: HashGrid, queries: torch.Tensor, with_rows: bool = True):
    """The window fetch of every window consumer (K8, ``ops.radius_runs``):
    returns ``(vals (Q, F, W), dist (Q, W), valid (Q, W), rows (Q, W))``
    with feature-first gathered ``[points | extras]`` rows, the distance of
    each candidate, ``valid`` marking true window rows (callers apply their
    own radius mask on ``dist``) and each slot's sorted row, or None for
    ``rows`` when ``with_rows`` is False (not written on the card)."""
    start, end = _zcolumn_runs(grid, queries)
    return fetch_windows(grid.packed_sorted, queries, start, end, grid.window_cap, with_rows)


def window_radius_dist(grid: HashGrid, queries: torch.Tensor, radius):
    """``(rows (Q, W), d or +inf (Q, W))`` over each query's window, finite
    where the slot is valid and ``d <= radius`` (K7, ``ops.radius_runs``)."""
    start, end = _zcolumn_runs(grid, queries)
    return radius_dist(grid.packed_sorted, queries, start, end, grid.window_cap, radius)


def window_chunk(grid: HashGrid, features: int = 8) -> int:
    """Queries per window chunk, bounded by ``_CHUNK_ELEMS`` window values."""
    return max(1, _CHUNK_ELEMS // (grid.window_cap * features))


def check_radius_contract(grid: HashGrid, radius) -> None:
    """Raise if ``radius`` exceeds what the window covers (``halo·cell``)."""
    if isinstance(radius, torch.Tensor):
        with blocking("grid.radius"):
            radius = float(radius.max()) if radius.numel() else 0.0
    if grid.halo * grid.cell_size < float(radius) * (1.0 - 1e-6):
        raise ValueError(
            f"grid with cell_size={grid.cell_size} and halo={grid.halo} covers "
            f"radius <= {grid.halo * grid.cell_size:.6g}, but the search asked "
            f"for radius={float(radius):.6g}; rebuild the grid with "
            f"cell_size >= radius / halo")


def window_moments(grid: HashGrid, queries: torch.Tensor, r2: torch.Tensor):
    """``(Q, 10)`` raw sums over each query's in-radius window points, with
    ``d = p − q``: ``[count, Σdx, Σdy, Σdz, Σdx², Σdy², Σdz², Σdxdy, Σdxdz,
    Σdydz]`` — the plain form of the streaming covariance reduction."""
    out = []
    step = window_chunk(grid, 4)
    for s in range(0, queries.shape[0], step):
        qc = queries[s:s + step]
        rows, valid = window_rows(grid, qc)
        cand = grid.points_sorted[rows]                       # (C, W, 3)
        dx = cand[..., 0] - qc[:, 0:1]
        dy = cand[..., 1] - qc[:, 1:2]
        dz = cand[..., 2] - qc[:, 2:3]
        m = (valid & (sqnorm3(dx, dy, dz) <= r2[s:s + step, None])).to(torch.float32)
        mx, my, mz = m * dx, m * dy, m * dz
        out.append(torch.stack([
            m.sum(-1), mx.sum(-1), my.sum(-1), mz.sum(-1),
            (mx * dx).sum(-1), (my * dy).sum(-1), (mz * dz).sum(-1),
            (mx * dy).sum(-1), (mx * dz).sum(-1), (my * dz).sum(-1)], dim=1))
    return torch.cat(out) if out else queries.new_zeros((0, 10))


def moments_to_pca(sums: torch.Tensor, queries: torch.Tensor):
    """``(cov (Q,3,3), barycenter (Q,3), count (Q,))`` from the 10 raw sums
    (covariance centered and divided by the count, as the reference)."""
    count = sums[:, 0]
    # E[p - q], then E[xx yy zz xy xz yz]: one division for all nine
    moments = sums[:, 1:] / torch.clamp(count, min=1.0)[:, None]
    mean = moments[:, :3]
    xx, yy, zz, xy, xz, yz = moments[:, 3:].unbind(1)
    second = torch.stack([xx, xy, xz, xy, yy, yz, xz, yz, zz], 1).reshape(-1, 3, 3)
    cov = second - mean[:, :, None] * mean[:, None, :]
    return cov, mean + queries, count


def radius_sq(radius, q: int, device) -> torch.Tensor:
    """Per-query squared radius ``(Q,)`` from a scalar or ``(Q,)`` radius,
    squared in float32."""
    r = torch.as_tensor(radius, dtype=torch.float32, device=device)
    return torch.broadcast_to(r * r, (q,)).contiguous()


def grid_radius_pca(grid: HashGrid, queries, radius):
    """Radius-neighborhood PCA over the window: every in-radius point
    contributes (no k cap).  ``radius`` is a scalar or a per-query ``(Q,)``
    tensor within the grid's coverage.  Returns ``(cov, barycenter, count)``."""
    check_radius_contract(grid, radius)
    queries = as_f32(queries, grid.device)
    sums = window_moments(grid, queries, radius_sq(radius, queries.shape[0], grid.device))
    return moments_to_pca(sums, queries)


def grid_nearest_neighbor(grid: HashGrid, queries):
    """1-NN through the grid: exact when the true nearest neighbor lies
    within ``halo·cell_size``; queries with an empty window get inf.  A grid
    with a cell-start table takes K7's 1-NN mode (``radius_runs.nearest``),
    one launch for every query; a grid without one (too many cells) finds
    its runs by binary search here and keeps the window route: K7 at radius
    +inf and the row minimum, in chunks of ``window_chunk`` queries."""
    queries = as_f32(queries, grid.device)
    if grid.has_table:
        return nearest(grid, queries)
    dist_out, idx_out = [], []
    step = window_chunk(grid, 4)
    for s in range(0, queries.shape[0], step):
        rows, masked = window_radius_dist(grid, queries[s:s + step], float("inf"))
        best, pos = masked.min(dim=1)
        row = torch.gather(rows, 1, pos[:, None])[:, 0]
        dist_out.append(best)
        idx_out.append(grid.orig_idx[row])
    return torch.cat(dist_out), torch.cat(idx_out)


def kth_distance_bound(sample, points, k: int) -> torch.Tensor:
    """Per-sample distance of the k-th nearest point (exact ``topk``; the
    reference uses ``approx_max_k``, which only ever biases it up), in
    sample chunks of the brute search's tile (``neighbors._chunk``), so a
    chunk's ``(rows, N)`` temporaries stay under 2^26 elements: 67 of a
    512-point sample's rows at 10^6 points, all of them up to ~131k."""
    step = _chunk(points.shape[0])
    kth = torch.cat([
        torch.topk(torch.clamp(_sq_dists(sample[s:s + step], points), min=0.0), k, dim=1,
                   largest=False, sorted=True).values[:, -1]
        for s in range(0, sample.shape[0], step)])
    return sqrt(torch.clamp(kth, min=0.0))


def quantized_kth_radius(kth) -> float:
    """1.5x the 99th percentile of sampled k-th distances, rounded up onto a
    1.25-geometric grid."""
    raw = 1.5 * float(np.quantile(np.asarray(kth), 0.99))
    return float(1.25 ** np.ceil(np.log(max(raw, 1e-12)) / np.log(1.25)))


def grid_radius_search(grid: HashGrid, queries, radius, k_max: int,
                       query_chunk: int | None = None, with_values: bool = False):
    """The ``k_max`` nearest neighbors within ``radius`` through the grid
    window (same contract as ``neighbors.radius_search``).  With
    ``with_values`` returns ``(Neighborhoods, values (Q, k_max, 3+F))``:
    the neighbors' ``[points | extras]`` rows, zeros where masked.  The
    queries go through K7 in chunks of :func:`window_chunk` rows, or of
    ``query_chunk`` when it is smaller; each query's row is the same under
    any chunking."""
    check_radius_contract(grid, radius)
    queries = as_f32(queries, grid.device)
    k_eff = min(k_max, grid.window_cap)
    idx_out, dist_out, val_out = [], [], []
    inf = float("inf")
    step = window_chunk(grid, 4)
    if query_chunk is not None:
        step = max(1, min(step, int(query_chunk)))
    for s in range(0, queries.shape[0], step):
        rows, masked = window_radius_dist(grid, queries[s:s + step], radius)
        dist, pos = torch.topk(masked, k_eff, dim=1, largest=False, sorted=True)
        sel = torch.gather(rows, 1, pos)
        idx_out.append(grid.orig_idx[sel])
        dist_out.append(dist)
        if with_values:
            val_out.append(torch.where(torch.isfinite(dist)[..., None],
                                       grid.packed_sorted[sel], 0.0))
    idx, dist = torch.cat(idx_out), torch.cat(dist_out)
    vals = torch.cat(val_out) if with_values else None
    if k_eff < k_max:
        pad = k_max - k_eff
        idx = torch.cat([idx, idx.new_zeros((idx.shape[0], pad))], 1)
        dist = torch.cat([dist, dist.new_full((dist.shape[0], pad), inf)], 1)
        if with_values:
            vals = torch.cat([vals, vals.new_zeros((vals.shape[0], pad, vals.shape[2]))], 1)
    mask = torch.isfinite(dist)
    nbr = Neighborhoods(torch.where(mask, idx, torch.zeros_like(idx)), dist, mask)
    return (nbr, vals) if with_values else nbr


def radius_search_auto(queries, points, radius, k_max: int) -> Neighborhoods:
    """Radius search by cloud size, one exact contract: brute force below
    ``AUTO_GRID_MIN_POINTS`` points, else a halo-1 grid of cell ``radius``
    and :func:`grid_radius_search`.  Runs where the ``points`` tensor is
    (host arrays: ``cuda``)."""
    points = as_f32(points, resolve(None, points))
    queries = as_f32(queries, points.device)
    if points.shape[0] < AUTO_GRID_MIN_POINTS:
        return radius_search(queries, points, radius, k_max)
    return grid_radius_search(build_grid(points, float(radius)), queries, radius, k_max)


def radius_search_with_values_auto(queries, points, extras, radius, k_max: int,
                                   halo: int = 2):
    """Radius search returning ``(Neighborhoods, values (Q, k_max, 3+F))``
    with the neighbors' ``[points | extras]`` rows: brute force below
    ``AUTO_GRID_MIN_POINTS`` points, a ``halo`` grid (cell radius/halo)
    above it.  Runs where the ``points`` tensor is (host arrays: ``cuda``)."""
    points = as_f32(points, resolve(None, points))
    queries = as_f32(queries, points.device)
    extras = as_f32(extras, points.device)
    if points.shape[0] < AUTO_GRID_MIN_POINTS:
        nbr = radius_search(queries, points, radius, k_max)
        packed = torch.cat([points, extras], dim=1)
        return nbr, torch.where(nbr.mask[..., None], packed[nbr.idx], 0.0)
    grid = build_grid(points, float(radius) / halo, extras=extras, halo=halo)
    return grid_radius_search(grid, queries, radius, k_max, with_values=True)


def knn_auto(queries, points, k: int, sample_size: int = 512) -> Neighborhoods:
    """k-NN that scales to large clouds: a sampled bound on the k-th
    neighbor distance sets a grid search radius; queries whose k-th neighbor
    fell outside it get an exact brute-force pass.  Runs where the
    ``points`` tensor is (host arrays: ``cuda``)."""
    points = as_f32(points, resolve(None, points))
    queries = as_f32(queries, points.device)
    n = points.shape[0]
    if n < AUTO_GRID_MIN_POINTS:
        return knn(queries, points, k)
    stride = max(1, n // sample_size)
    sample = points[::stride][:sample_size]
    kth = kth_distance_bound(sample, points, k)
    with blocking("knn.kth"):
        kth = kth.cpu().numpy()
    radius = quantized_kth_radius(kth)
    grid = build_grid(points, radius)
    nbr = grid_radius_search(grid, queries, radius, k)
    with blocking("knn.misses"):
        missing = torch.nonzero(nbr.count < min(k, n))[:, 0]
    if missing.numel():
        frac = missing.numel() / queries.shape[0]
        if frac > 0.05:
            logger.warning(
                "knn_auto exactness net caught %.1f%% of %d queries (sampled "
                "radius bound %.3g undercovers)", 100.0 * frac,
                queries.shape[0], radius)
        fix = knn(queries[missing], points, k)
        idx, dist, mask = nbr.idx.clone(), nbr.dist.clone(), nbr.mask.clone()
        idx[missing], dist[missing], mask[missing] = fix.idx, fix.dist, fix.mask
        nbr = Neighborhoods(idx, dist, mask)
    return nbr
