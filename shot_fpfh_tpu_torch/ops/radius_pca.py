"""K3: streaming radius covariance over the grid's z-column runs.

Counterpart of ``shot_fpfh_tpu/ops/pallas_radius.py::radius_pca_pallas``:
per query, the count, barycenter and covariance (centered, divided by the
count) of every point within a scalar or per-query radius — no k cap.

:func:`radius_pca` runs the CUDA kernel (``csrc/radius_pca.cu``) on CUDA
tensors and :func:`radius_pca_plain`, the PyTorch window reduction, on CPU
tensors.  Both produce the same 10 raw sums, finalized by
``grid_hash.moments_to_pca``.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .grid_hash import (
    HashGrid,
    _zcolumn_runs,
    check_radius_contract,
    grid_radius_pca,
    moments_to_pca,
    radius_sq,
)
from .neighbors import as_f32

radius_pca_plain = grid_radius_pca


def radius_pca(grid: HashGrid, queries, radius):
    """``(cov (Q,3,3), barycenter (Q,3), count (Q,))`` of each query's
    radius neighborhood in ``grid``; ``radius`` is a scalar or ``(Q,)``."""
    queries = as_f32(queries, grid.device)
    if queries.device.type == "cpu":
        return radius_pca_plain(grid, queries, radius)
    check_radius_contract(grid, radius)
    device = _kernels.require_cuda(queries, grid.packed_sorted)
    q = queries.shape[0]
    queries = queries.contiguous()
    r2 = radius_sq(radius, q, queries.device)
    start, end = _zcolumn_runs(grid, queries)
    start, end = start.contiguous(), end.contiguous()
    table = grid.packed_sorted
    if table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError("grid table must be contiguous float32")
    sums = torch.empty((q, 10), dtype=torch.float32, device=queries.device)
    _kernels.launch(
        "radius_pca", device, table.data_ptr(), table.shape[1], queries.data_ptr(),
        r2.data_ptr(), start.data_ptr(), end.data_ptr(), start.shape[1], q,
        sums.data_ptr())
    return moments_to_pca(sums, queries)
