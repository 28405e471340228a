"""K5 and K6: SHOT and SPFH read straight from the grid's xy-row runs.

Counterpart of ``shot_fpfh_tpu/ops/pallas_shot_dma.py``: on a grid in
xy-row mode (:func:`_xyrow_mode`, the reference's build rule, worked out
here from the grid's cell table) carrying normals, each query's
neighborhood is its ``2h+1`` contiguous xy-row runs of the sorted table
(:func:`_xyrow_runs`), so the kernels stream them with no ``(Q, W)`` window
gather.  A row is a neighbor when its squared distance (the reference's
contracted ``fma`` chain, ``_fp.sqnorm3``) is ≤ r·r.  This radius rule
differs from the window routes' ``sqrt(...) ≤ r`` (``ops.shot_fused.shot_grid``,
``ops.spfh_fused.spfh_grid``): each route keeps its reference's rule.

- K5, :func:`shot_descriptor_dma` (``shot_descriptor_dma``): SHOT frames,
  soft bins and the 352-bin histogram in one kernel (``csrc/shot_runs.cu``,
  running K1's warp body in ``csrc/shot.cuh``), in K1's three modes (own,
  given and bi-scale frames); the kernel finds each keypoint's runs from the
  grid's cell-start table, and the caller's finalization (count rule, L2
  norm) stays in PyTorch.
- K6, :func:`spfh_block_dma` (``spfh_block_dma``, ``spfh_sorted_dma``): the
  SPFH divided by the neighborhood count, self included
  (``csrc/spfh_runs.cu``).

Each wrapper launches its CUDA kernel on CUDA tensors and runs its
``*_plain`` twin on CPU tensors, and works out the grid's xy-row caps once
a call (three blocking reads).  No route of the models selects them: SHOT's
and FPFH's grid routes take SG and the SPFH pass kernel; a caller that
wants the run kernels calls them by name.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import _kernels
from .._fp import sqnorm3, sqrt
from ..utils.perf import blocking
from .descriptor_bins import darboux_angles
from .grid_hash import _CHUNK_ELEMS, HashGrid, _query_cells, check_radius_contract
from .shot_fused import SHOT_DIM, _check_counter, shot_binning_histogram_plain, shot_finalize
from .spfh_fused import spfh_dim, spfh_from_angles

# K6 keeps one histogram of ints and a 256-row ring per warp, 8 warps a
# block, in the 227 KB of shared memory a block can have on the H100
_MAX_SMEM_BINS = 232_448 // 4 // 8 - 256


def _round_up(v: int, m: int) -> int:
    return -(-max(v, 1) // m) * m


def _group_cap(cell_starts: torch.Tensor, dims, halo: int, group: int = 8) -> int:
    """Exact max number of ``group``-aligned row groups any (2h+1)^2
    z-column window needs (reference ``grid_hash._group_cap``)."""
    d0, d1, d2 = dims
    dev = cell_starts.device
    zc = torch.arange(d2, device=dev)
    zlo = torch.clamp(zc - halo, min=0)
    zhi = torch.clamp(zc + halo, max=d2 - 1) + 1
    base = torch.arange(d0 * d1, device=dev)[:, None] * d2
    start = cell_starts[base + zlo[None, :]]
    ln = cell_starts[base + zhi[None, :]] - start
    g = torch.where(ln > 0, (start % group + ln + group - 1) // group, 0).reshape(d0, d1, d2)
    p = F.pad(g, (0, 0, halo, halo, halo, halo))
    w = 2 * halo + 1
    acc = sum(p[dx:dx + d0, dy:dy + d1, :] for dx in range(w) for dy in range(w))
    with blocking("grid.group_cap"):
        return int(acc.max())


def _xyrow_caps(cell_starts: torch.Tensor, dims, halo: int, group: int = 8):
    """``(exact max group count, longest single run)`` of the xy-row mode
    (reference ``grid_hash._xyrow_caps``, less the window occupancy no port
    caller reads): per query 2h+1 runs, one per x offset, each spanning the
    y-h .. y+h columns at full z extent — consecutive in the z-minor id, so
    one contiguous run of the sorted cloud."""
    d0, d1, d2 = dims
    dev = cell_starts.device
    ys = torch.arange(d1, device=dev)
    ylo = torch.clamp(ys - halo, min=0)
    yhi = torch.clamp(ys + halo, max=d1 - 1) + 1
    xbase = torch.arange(d0, device=dev)[:, None] * (d1 * d2)
    start = cell_starts[xbase + ylo[None, :] * d2]             # (d0, d1)
    ln = cell_starts[xbase + yhi[None, :] * d2] - start
    g_p = F.pad(torch.where(ln > 0, (start % group + ln + group - 1) // group, 0),
                (0, 0, halo, halo))
    g_acc = sum(g_p[dx:dx + d0] for dx in range(2 * halo + 1))
    with blocking("grid.xyrow_groups"):
        groups = int(g_acc.max())
    with blocking("grid.xyrow_run"):
        return groups, int(ln.max())


def _xyrow_mode(grid: HashGrid) -> tuple[bool, int]:
    """``(xy-row mode, longest xy-row run)`` of ``grid`` by the reference's
    build rule (``grid_hash.py:438-476``): the xy-row mode when its 8-row
    group cap is at most a small margin above the z-column window's; both
    caps rounded up to 16 first.  Grids without a cell table or of more than
    2^22 cells get neither."""
    dims, halo = grid.dims, grid.halo
    if not grid.has_table or dims[0] * dims[1] * dims[2] > 1 << 22:
        return False, 0
    group_cap = _round_up(_group_cap(grid.cell_starts, dims, halo, 8), 16)
    xy_groups, run_cap = _xyrow_caps(grid.cell_starts, dims, halo, 8)
    use = _round_up(xy_groups, 16) <= group_cap + max(16, group_cap // 5)
    return use, run_cap


def _xyrow_runs(grid: HashGrid, queries: torch.Tensor):
    """``(start, end)`` sorted rows ``(Q, 2h+1)`` of each query's xy-row
    runs: for each dx, the cells (x+dx, y-h .. y+h, all z) are consecutive
    in the z-minor id.  A superset of the z-column window, exact for any
    radius ≤ ``halo·cell_size``.  Needs the cell-start table."""
    if not grid.has_table:
        raise ValueError("xy-row runs need a grid with a cell-start table")
    h = grid.halo
    d0, d1, d2 = grid.dims
    qcell = _query_cells(grid, queries)
    x = qcell[:, 0:1] + torch.arange(-h, h + 1, device=queries.device)[None, :]
    y_lo = torch.clamp(qcell[:, 1:2] - h, min=0)
    y_hi = torch.clamp(qcell[:, 1:2] + h, max=d1 - 1)
    ok = ((x >= 0) & (x < d0) & (y_hi >= y_lo)
          & (qcell[:, 1:2] >= -h) & (qcell[:, 1:2] <= d1 + h - 1))
    last = grid.cell_starts.shape[0] - 1
    lo = torch.clamp((x * d1 + y_lo) * d2, 0, last)
    hi = torch.clamp((x * d1 + y_hi + 1) * d2, 0, last)
    zero = torch.zeros_like(lo)
    start = torch.where(ok, grid.cell_starts[lo], zero)
    end = torch.where(ok, grid.cell_starts[hi], zero)
    return start, torch.maximum(end, start)


def _check_run_grid(grid: HashGrid, radius) -> int:
    """The grid's longest xy-row run, worked out from its cell table; raises
    unless the grid is in xy-row mode, carries normals and covers
    ``radius``."""
    xyrow, run_cap = _xyrow_mode(grid)
    if not (xyrow and run_cap > 0):
        raise ValueError("the run route needs an xy-row grid (surface-like cloud, "
                         "build_grid with a cell table)")
    if grid.packed_sorted.shape[1] < 6:
        raise ValueError("the run route needs a grid built with extras=normals")
    check_radius_contract(grid, radius)
    return run_cap


def _run_rows(grid: HashGrid, queries, cap: int):
    """Each query's runs padded to ``cap`` rows (the longest run):
    ``(rows (C, W), in_run (C, W))`` with ``W = (2h+1)·cap``, rows clamped
    to 0 where out of the run."""
    start, end = _xyrow_runs(grid, queries)                       # (C, R)
    j = torch.arange(cap, device=queries.device)
    rows = start[:, :, None] + j                                   # (C, R, cap)
    in_run = (rows < end[:, :, None]).reshape(queries.shape[0], -1)
    return torch.where(in_run, rows.reshape(queries.shape[0], -1), 0), in_run


def _frame_halo(grid: HashGrid, rf_radius: float) -> int:
    """The smallest halo whose xy-row runs hold every point within
    ``rf_radius`` of a keypoint, at most the grid's: the cells' float32
    rounding (a few ulps of the grid's extent in cells) is added first."""
    margin = 1e-6 * (max(grid.dims) + 1)
    return min(grid.halo, math.ceil(rf_radius / grid.cell_size + margin))


def _shot_chunk_plain(grid: HashGrid, q, cap, radius, rfs, rf_radius, violations):
    """``(hist, frames, count)`` of one keypoint chunk by the K1 twin over
    the runs padded to ``cap`` rows, the planes set by the run route's
    radius rule."""
    rows, in_run = _run_rows(grid, q, cap)
    vals = grid.packed_sorted[rows]                                # (C, W, F)
    rho2 = sqnorm3(*(vals[..., i] - q[:, i:i + 1] for i in range(3)))
    d = sqrt(rho2)
    inf = torch.full_like(d, float("inf"))

    def plane(r):
        r = torch.tensor(float(r), dtype=torch.float32, device=q.device)
        return torch.where(in_run & (rho2 <= r * r), d, inf)

    dist_inf = plane(radius)
    rf_dist_inf = None if rf_radius is None else plane(rf_radius)
    out = shot_binning_histogram_plain(vals[..., :6].permute(0, 2, 1), dist_inf, q, rfs,
                                       radius, rf_dist_inf, rf_radius, violations)
    hist, frames = out if rfs is None else (out, rfs)
    return hist, frames, (torch.isfinite(dist_inf) & (dist_inf > 0)).sum(-1)


def shot_descriptor_dma_plain(grid: HashGrid, keypoints, radius, rfs=None, rf_radius=None,
                              normalize: bool = True, min_neighborhood_size: int = 100,
                              violations=None):
    """PyTorch twin of :func:`shot_descriptor_dma`: each keypoint's runs
    padded to the longest run, the same radius rule, K1's twin on them,
    chunked by ``_CHUNK_ELEMS``."""
    rf_radius = None if rfs is not None else rf_radius
    cap = _check_run_grid(grid, radius if rf_radius is None else max(radius, rf_radius))
    step = max(1, _CHUNK_ELEMS // ((2 * grid.halo + 1) * cap * 8))
    hists, frames, counts = [], [], []
    for s in range(0, keypoints.shape[0], step):
        h, f, c = _shot_chunk_plain(grid, keypoints[s:s + step], cap, radius,
                                    None if rfs is None else rfs[s:s + step], rf_radius,
                                    violations)
        hists.append(h)
        frames.append(f)
        counts.append(c)
    if not hists:
        return keypoints.new_zeros((0, SHOT_DIM)), keypoints.new_zeros((0, 3, 3))
    return (shot_finalize(torch.cat(hists), torch.cat(counts), normalize,
                          min_neighborhood_size), torch.cat(frames))


def shot_descriptor_dma(grid: HashGrid, keypoints: torch.Tensor, radius, rfs=None,
                        rf_radius=None, normalize: bool = True,
                        min_neighborhood_size: int = 100, violations=None):
    """``(desc (Q, 352) finalized, rfs (Q, 3, 3))`` of the keypoints over
    ``grid``'s xy-row runs: frames from the descriptor neighborhood, given
    ``rfs`` (multiscale sharing), or, with ``rf_radius``, from the neighbors
    within ``rf_radius`` (bi-scale); the SHOT debug checks count into
    ``violations`` (``ops.shot_fused``) when it is given."""
    if keypoints.device.type == "cpu":
        return shot_descriptor_dma_plain(grid, keypoints, radius, rfs, rf_radius,
                                         normalize, min_neighborhood_size, violations)
    rf_radius = None if rfs is not None else rf_radius
    _check_run_grid(grid, radius if rf_radius is None else max(radius, rf_radius))
    table = grid.packed_sorted
    tensors = [keypoints, table] + ([] if rfs is None else [rfs])
    device = _kernels.require_cuda(*tensors)
    q = keypoints.shape[0]
    if keypoints.shape != (q, 3) or (rfs is not None and rfs.shape != (q, 3, 3)):
        raise ValueError(f"bad keypoint or frame shapes {tuple(keypoints.shape)}")
    if any(t.dtype != torch.float32 for t in tensors) or not table.is_contiguous():
        raise ValueError("run kernel inputs must be float32 (table contiguous)")
    _check_counter(violations, keypoints.device)
    if table.shape[0] >= 2 ** 31 or 2 * grid.halo + 1 > 32:
        raise ValueError("the SHOT run kernel lists table rows as 32-bit ints and holds "
                         "one run a lane (halo <= 15)")
    kp = keypoints.contiguous()
    rfs_in = None if rfs is None else rfs.reshape(q, 9).contiguous()
    hist = torch.empty((q, SHOT_DIM), dtype=torch.float32, device=kp.device)
    rfs_out = (torch.empty((q, 3, 3), dtype=torch.float32, device=kp.device)
               if rfs is None else None)
    count = torch.empty(q, dtype=torch.float32, device=kp.device)
    rf = float(radius if rf_radius is None else rf_radius)
    # the kernel finds each keypoint's xy-row runs (_xyrow_runs) itself, and
    # walks the frame plane over the runs of the halo that covers rf
    _kernels.launch("shot_runs", device, table.data_ptr(), table.shape[1],
                    grid.cell_starts.data_ptr(), grid.origin.data_ptr(), grid.cell_size,
                    *grid.dims, grid.halo, _frame_halo(grid, rf), kp.data_ptr(), q,
                    _kernels.ptr(rfs_in), float(radius), rf, hist.data_ptr(),
                    _kernels.ptr(rfs_out), count.data_ptr(), _kernels.ptr(violations),
                    checked=(table, kp, rfs_in, hist, rfs_out, count))
    return (shot_finalize(hist, count, normalize, min_neighborhood_size),
            rfs if rfs_out is None else rfs_out)


def spfh_block_dma_plain(grid: HashGrid, qc, qn, radius, n_bins: int, decorrelated: bool):
    """PyTorch twin of the kernel: each query's runs padded to the longest
    run, the same radius rule, angles and bins."""
    cap = _check_run_grid(grid, radius)
    n_runs = 2 * grid.halo + 1
    r = torch.tensor(float(radius), dtype=torch.float32, device=qc.device)
    rr = r * r
    out = []
    step = max(1, _CHUNK_ELEMS // (n_runs * cap * 8))
    for s in range(0, qc.shape[0], step):
        q, u = qc[s:s + step], qn[s:s + step]
        rows, seg = _run_rows(grid, q, cap)
        vals = grid.packed_sorted[rows]
        diff = [vals[..., i] - q[:, i:i + 1] for i in range(3)]
        rho2 = sqnorm3(*diff)
        ok = seg & (rho2 <= rr)
        valid = ok & (rho2 > 0)
        dx, dy, dz = (torch.where(ok, d, 0.0) for d in diff)
        nx, ny, nz = (torch.where(ok, vals[..., i], 0.0) for i in range(3, 6))
        ux, uy, uz = (u[:, i:i + 1] for i in range(3))
        alpha, phi, theta = darboux_angles(dx, dy, dz, nx, ny, nz, ux, uy, uz,
                                           torch.where(valid, sqrt(rho2), 1.0))
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
    table = grid.packed_sorted
    device = _kernels.require_cuda(qc, qn, table)
    c = qc.shape[0]
    if qc.shape != (c, 3) or qn.shape != (c, 3):
        raise ValueError(f"bad query shapes {tuple(qc.shape)}, {tuple(qn.shape)}")
    if any(t.dtype != torch.float32 for t in (qc, qn, table)) or not table.is_contiguous():
        raise ValueError("run kernel inputs must be float32 (table contiguous)")
    if table.shape[0] >= 2 ** 30 or 2 * grid.halo + 1 > 32:
        raise ValueError("the SPFH run kernel walks table rows as 32-bit ints (at most 2^30 "
                         "rows) and holds one run a lane (halo <= 15)")
    d_out = spfh_dim(n_bins, decorrelated)
    if not 0 < d_out <= _MAX_SMEM_BINS:
        raise ValueError(f"n_bins={n_bins} gives {d_out} bins; the kernel holds at most "
                         f"{_MAX_SMEM_BINS} per warp in shared memory")
    # the kernel reads query i at i * stride(0) from each base: the rows of
    # two (C, 3) arrays, or of the table itself (spfh_sorted_dma)
    if qc.stride(1) != 1 or qn.stride(1) != 1 or qc.stride(0) != qn.stride(0):
        qc, qn = qc.contiguous(), qn.contiguous()
    out = torch.empty((c, d_out), dtype=torch.float32, device=qc.device)
    # the kernel finds each query's xy-row runs (_xyrow_runs) itself
    _kernels.launch("spfh_runs", device, table.data_ptr(), table.shape[1],
                    grid.cell_starts.data_ptr(), grid.origin.data_ptr(), grid.cell_size,
                    *grid.dims, grid.halo, qc.data_ptr(), qn.data_ptr(), qc.stride(0), c,
                    float(radius), n_bins, int(decorrelated), out.data_ptr(),
                    checked=(table, qc, qn, out))
    return out


def _sorted_queries(grid: HashGrid):
    return grid.packed_sorted[:, :3], grid.packed_sorted[:, 3:6]


def spfh_sorted_dma(grid: HashGrid, radius, n_bins: int, decorrelated: bool):
    """SPFH of every cloud point in grid-sorted order over the run route:
    the contract of ``models.fpfh._spfh_window_sorted`` (count-normalized
    ``(N, D)``, queries and normals the sorted table's own rows)."""
    return spfh_block_dma(grid, *_sorted_queries(grid), radius, n_bins, decorrelated)


def spfh_sorted_dma_plain(grid: HashGrid, radius, n_bins: int, decorrelated: bool):
    """The plain twin of :func:`spfh_sorted_dma`, on the grid's device."""
    return spfh_block_dma_plain(grid, *_sorted_queries(grid), radius, n_bins, decorrelated)
