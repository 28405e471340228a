"""K6: count-normalized SPFH read straight from the grid's xy-row runs.

Counterpart of ``shot_fpfh_tpu/ops/pallas_shot_dma.py::spfh_block_dma`` and
``spfh_sorted_dma``: on an xy-row grid (``HashGrid.use_xyrow``) carrying
normals, each query's neighborhood is its ``2h+1`` contiguous xy-row runs of
the sorted table, so the kernel streams them with no ``(Q, W)`` window
gather.  A row is a neighbor when its squared distance (the reference's
contracted ``fma`` chain, ``_fp.sqnorm3``) is ≤ r·r; the SPFH is divided by
the neighborhood count, self included.  This radius rule differs from the
window route's ``sqrt(...) ≤ r`` (``models.fpfh._spfh_window_block``): each
route keeps its reference's rule.

:func:`spfh_block_dma` launches the CUDA kernel (``csrc/spfh_runs.cu``) on
CUDA tensors and runs :func:`spfh_block_dma_plain` on CPU tensors.

The route is off by default, as in the reference: :func:`dma_kernel_enabled`
reads ``SHOT_FPFH_DMA`` (``1`` turns it on) and :func:`set_dma_kernel`
overrides it (``pallas_radius.py:86-110``).  The SHOT run kernel (K5) is not
ported yet (ROADMAP.md, Queue 1, item 12).
"""

from __future__ import annotations

import os

import torch

from .. import _kernels
from .._fp import sqnorm3
from .descriptor_bins import darboux_angles
from .grid_hash import _CHUNK_ELEMS, HashGrid, _xyrow_runs, check_radius_contract
from .spfh_fused import spfh_dim, spfh_from_angles

_DMA = {"enabled": None}  # None: resolve from SHOT_FPFH_DMA on first use

# the kernel keeps one histogram per warp, 8 warps a block, in shared memory
_MAX_SMEM_FLOATS = 48 * 1024 // 4 // 8


def dma_kernel_enabled() -> bool:
    """Whether FPFH's SPFH pass takes the run route (K6) on qualifying
    grids; ``SHOT_FPFH_DMA=1`` turns it on, default off."""
    if _DMA["enabled"] is None:
        _DMA["enabled"] = os.environ.get("SHOT_FPFH_DMA", "0") != "0"
    return _DMA["enabled"]


def set_dma_kernel(enabled: bool) -> None:
    """Turn the run route on or off for this process."""
    _DMA["enabled"] = bool(enabled)


def _check_run_grid(grid: HashGrid, radius) -> None:
    if not (grid.use_xyrow and grid.xyrow_run_cap > 0):
        raise ValueError("the run route needs an xy-row grid (surface-like cloud, "
                         "build_grid with a cell table)")
    if grid.packed_sorted.shape[1] < 6:
        raise ValueError("the run route needs a grid built with extras=normals")
    check_radius_contract(grid, radius)


def spfh_block_dma_plain(grid: HashGrid, qc, qn, radius, n_bins: int, decorrelated: bool):
    """PyTorch twin of the kernel: each query's runs padded to
    ``xyrow_run_cap`` rows, the same radius rule, angles and bins."""
    _check_run_grid(grid, radius)
    n_runs, cap = 2 * grid.halo + 1, grid.xyrow_run_cap
    r = torch.tensor(float(radius), dtype=torch.float32, device=qc.device)
    rr = r * r
    j = torch.arange(cap, device=qc.device)
    out = []
    step = max(1, _CHUNK_ELEMS // (n_runs * cap * 8))
    for s in range(0, qc.shape[0], step):
        q, u = qc[s:s + step], qn[s:s + step]
        start, end = _xyrow_runs(grid, q)                          # (C, R)
        rows = start[:, :, None] + j                                # (C, R, cap)
        seg = (rows < end[:, :, None]).reshape(q.shape[0], -1)
        vals = grid.packed_sorted[torch.where(seg, rows.reshape(q.shape[0], -1), 0)]
        diff = [vals[..., i] - q[:, i:i + 1] for i in range(3)]
        rho2 = sqnorm3(*diff)
        ok = seg & (rho2 <= rr)
        valid = ok & (rho2 > 0)
        dx, dy, dz = (torch.where(ok, d, 0.0) for d in diff)
        nx, ny, nz = (torch.where(ok, vals[..., i], 0.0) for i in range(3, 6))
        ux, uy, uz = (u[:, i:i + 1] for i in range(3))
        alpha, phi, theta = darboux_angles(dx, dy, dz, nx, ny, nz, ux, uy, uz,
                                           torch.where(valid, torch.sqrt(rho2), 1.0))
        hist = spfh_from_angles(alpha, phi, theta, valid, n_bins, decorrelated)
        out.append(hist / torch.clamp(ok.sum(-1).to(torch.float32), min=1.0)[:, None])
    if not out:
        return qc.new_zeros((0, spfh_dim(n_bins, decorrelated)))
    return torch.cat(out)


def spfh_block_dma(grid: HashGrid, qc: torch.Tensor, qn: torch.Tensor, radius,
                   n_bins: int, decorrelated: bool):
    """Count-normalized ``(C, D)`` SPFH of the queries ``qc`` with normals
    ``qn`` over ``grid``'s xy-row runs."""
    if qc.device.type == "cpu":
        return spfh_block_dma_plain(grid, qc, qn, radius, n_bins, decorrelated)
    _check_run_grid(grid, radius)
    device = _kernels.require_cuda(qc, qn, grid.packed_sorted)
    c = qc.shape[0]
    if qc.shape != (c, 3) or qn.shape != (c, 3):
        raise ValueError(f"bad query shapes {tuple(qc.shape)}, {tuple(qn.shape)}")
    table = grid.packed_sorted
    if any(t.dtype != torch.float32 for t in (qc, qn, table)) or not table.is_contiguous():
        raise ValueError("run kernel inputs must be float32 (table contiguous)")
    d_out = spfh_dim(n_bins, decorrelated)
    if not 0 < d_out <= _MAX_SMEM_FLOATS:
        raise ValueError(f"n_bins={n_bins} gives {d_out} bins; the kernel holds at most "
                         f"{_MAX_SMEM_FLOATS} per warp in shared memory")
    qc, qn = qc.contiguous(), qn.contiguous()
    start, end = (t.contiguous() for t in _xyrow_runs(grid, qc))
    out = torch.empty((c, d_out), dtype=torch.float32, device=qc.device)
    _kernels.launch("spfh_runs", device, table.data_ptr(), table.shape[1], qc.data_ptr(),
                    qn.data_ptr(), start.data_ptr(), end.data_ptr(), start.shape[1], c,
                    float(radius), n_bins, int(decorrelated), out.data_ptr())
    return out


def _sorted_queries(grid: HashGrid):
    return (grid.packed_sorted[:, :3].contiguous(), grid.packed_sorted[:, 3:6].contiguous())


def spfh_sorted_dma(grid: HashGrid, radius, n_bins: int, decorrelated: bool):
    """SPFH of every cloud point in grid-sorted order over the run route:
    the contract of ``models.fpfh._spfh_window_sorted`` (count-normalized
    ``(N, D)``, queries and normals from the sorted table)."""
    return spfh_block_dma(grid, *_sorted_queries(grid), radius, n_bins, decorrelated)


def spfh_sorted_dma_plain(grid: HashGrid, radius, n_bins: int, decorrelated: bool):
    """The plain twin of :func:`spfh_sorted_dma`, on the grid's device."""
    return spfh_block_dma_plain(grid, *_sorted_queries(grid), radius, n_bins, decorrelated)
