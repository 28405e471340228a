"""K3: streaming radius covariance over the grid's z-column runs.

Counterpart of ``shot_fpfh_tpu/ops/pallas_radius.py::radius_pca_pallas``:
per query, the count, barycenter and covariance (centered, divided by the
count) of every point within a scalar or per-query radius — no k cap.

:func:`radius_pca` runs the CUDA kernel (``csrc/radius_pca.cu``) on CUDA
tensors and :func:`radius_pca_plain`, the PyTorch window reduction, on CPU
tensors.  Both produce the same 10 raw sums, finalized by
``grid_hash.moments_to_pca``.  On the card, :func:`cell_order` sorts the
queries by cell and :func:`cell_moments` launches the kernel, which finds
each query's runs and each tile's union of them itself; :func:`tile_plan`
is that bookkeeping in plain PyTorch, the twin the kernel's unions are held
to.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import _kernels
from .grid_hash import (
    HashGrid,
    _query_cells,
    _zcolumn_runs,
    check_radius_contract,
    grid_radius_pca,
    moments_to_pca,
    radius_sq,
)
from .neighbors import as_f32

radius_pca_plain = grid_radius_pca

TILE = 128       # queries per block of the kernel, one a thread
MAX_RUNS = 49    # runs per query the kernel takes (halo <= 3)


@dataclass(frozen=True)
class TilePlan:
    """The queries in cell order and, per tile of ``TILE`` of them, the
    union of their runs for each (dx, dy) offset."""

    order: torch.Tensor     # (Q,) int64: sorted position -> query index
    queries: torch.Tensor   # (Q, 3) the queries in that order
    start: torch.Tensor     # (Q, R) int64 their z-column runs
    end: torch.Tensor
    lo: torch.Tensor        # (ceil(Q / TILE), R) int64: smallest start and
    hi: torch.Tensor        # largest end of the tile's non-empty runs (0, 0: none)


def tile_plan(grid: HashGrid, queries: torch.Tensor) -> TilePlan:
    """Sort ``queries`` by linear cell id (stable) and cut them into tiles
    of ``TILE``; every non-empty run of a tile's queries lies inside the
    tile's ``[lo, hi)`` for its offset.  The plain twin of the kernel's
    own bookkeeping (:func:`cell_order`, then the kernel's unions)."""
    qcell = _query_cells(grid, queries)
    _, d1, d2 = grid.dims
    order = torch.argsort((qcell[:, 0] * d1 + qcell[:, 1]) * d2 + qcell[:, 2], stable=True)
    sorted_q = queries[order].contiguous()
    start, end = _zcolumn_runs(grid, sorted_q, qcell[order])
    q, n_runs = start.shape
    n_tiles = -(-q // TILE)
    pad = n_tiles * TILE - q
    nonempty = end > start
    top = torch.iinfo(torch.int64).max

    def per_tile(x: torch.Tensor, fill: int) -> torch.Tensor:
        return torch.cat([x, x.new_full((pad, n_runs), fill)]).reshape(n_tiles, TILE, n_runs)

    lo = per_tile(torch.where(nonempty, start, top), top).amin(1)
    hi = per_tile(torch.where(nonempty, end, 0), 0).amax(1)
    empty = hi <= lo
    return TilePlan(order, sorted_q, start, end, torch.where(empty, 0, lo), torch.where(empty, 0, hi))


def radius_pca(grid: HashGrid, queries, radius):
    """``(cov (Q,3,3), barycenter (Q,3), count (Q,))`` of each query's
    radius neighborhood in ``grid``; ``radius`` is a scalar or ``(Q,)``."""
    queries = as_f32(queries, grid.device)
    if queries.device.type == "cpu":
        return radius_pca_plain(grid, queries, radius)
    check_radius_contract(grid, radius)
    queries = queries.contiguous()
    r2 = radius_sq(radius, queries.shape[0], queries.device)
    return moments_to_pca(cell_moments(grid, queries, r2, cell_order(grid, queries)), queries)


def _grid_args(grid: HashGrid) -> tuple:
    """The grid as the kernel's C entry points take it."""
    table = grid.packed_sorted
    if table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError("grid table must be contiguous float32")
    if table.shape[0] >= 2 ** 31:
        raise ValueError(f"K3 indexes rows with int32, got {table.shape[0]} rows")
    if (2 * grid.halo + 1) ** 2 > MAX_RUNS:
        raise ValueError(f"K3 takes at most {MAX_RUNS} runs a query (halo <= 3), "
                         f"got halo {grid.halo}")
    return (table.data_ptr(), table.shape[1], table.shape[0], _kernels.ptr(grid.cell_starts),
            grid.cell_ids_sorted.data_ptr(), grid.origin.data_ptr(), grid.cell_size,
            *grid.dims, grid.halo)


def cell_order(grid: HashGrid, queries: torch.Tensor) -> torch.Tensor:
    """``(Q,)`` sorted position -> query index: the queries by linear cell
    id, stable (the kernel writes the ids, ``torch.argsort`` sorts them)."""
    device = _kernels.require_cuda(queries, grid.packed_sorted)
    keys = torch.empty(queries.shape[0], dtype=torch.int64, device=device)
    _kernels.launch("radius_pca_keys", device, *_grid_args(grid), queries.data_ptr(),
                    queries.shape[0], keys.data_ptr(), checked=(queries, grid.packed_sorted))
    return torch.argsort(keys, stable=True)


def cell_moments(grid: HashGrid, queries: torch.Tensor, r2: torch.Tensor,
                 order: torch.Tensor, unions: tuple[torch.Tensor, torch.Tensor] | None = None
                 ) -> torch.Tensor:
    """The kernel alone: ``(Q, 10)`` raw sums of the contiguous ``queries``
    with squared radii ``r2``, in their own order, served in ``order`` (a
    :func:`cell_order`).  ``unions``: two int64 ``(ceil(Q / TILE), R)``
    tensors that receive each tile's ``lo`` and ``hi``, as in
    :func:`tile_plan`."""
    device = _kernels.require_cuda(queries, r2, order, grid.packed_sorted)
    q = queries.shape[0]
    for name, t, shape, dtype in (("queries", queries, (q, 3), torch.float32),
                                  ("r2", r2, (q,), torch.float32),
                                  ("order", order, (q,), torch.int64)):
        if t.shape != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {shape}")
    lo = hi = None
    if unions is not None:
        lo, hi = unions
        shape = (-(-q // TILE), (2 * grid.halo + 1) ** 2)
        if any(t.shape != shape or t.dtype != torch.int64 or not t.is_contiguous()
               for t in unions):
            raise ValueError(f"unions must be two contiguous int64 tensors of shape {shape}")
    sums = torch.empty((q, 10), dtype=torch.float32, device=device)
    _kernels.launch("radius_pca", device, *_grid_args(grid), queries.data_ptr(), r2.data_ptr(),
                    order.data_ptr(), q, sums.data_ptr(), _kernels.ptr(lo), _kernels.ptr(hi),
                    checked=(queries, r2, grid.packed_sorted, sums))
    return sums
