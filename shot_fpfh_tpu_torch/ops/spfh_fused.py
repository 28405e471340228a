"""K4 and FPFH's SPFH pass on the grid window route.

K4: SPFH Darboux angles + binning + histogram on a candidate window.

Counterpart of ``shot_fpfh_tpu/ops/pallas_fpfh_fused.py::spfh_histogram``:
from a feature-first window (``vals (C, F≥6, W)`` rows ``[x y z nx ny nz
...]``, ``dist_inf (C, W)`` with +inf on out-of-radius/invalid lanes) and
the queries' points and normals, the UNNORMALIZED SPFH histograms —
``(C, n_bins³)`` joint, or ``(C, 3·n_bins)`` decorrelated in the reference's
interleaved layout (bin k: α, φ, θ).  The query itself (d == 0) gets no bin;
the caller divides by the neighborhood count, self included.

:func:`spfh_histogram` launches the CUDA kernel (``csrc/spfh_fused.cu``) on
CUDA tensors and runs :func:`spfh_histogram_plain` on CPU tensors.  Counts
are whole numbers, so the two agree exactly unless an angle's last bit moves
it across a bin edge.

:func:`spfh_grid` is the SPFH pass of FPFH's window route: the
count-normalized ``(C, D)`` SPFH of queries over their z-column windows of a
grid (``ops.grid_hash``) carrying normals.  On a grid with a cell-start
table it launches one kernel for every query (``csrc/spfh_grid.cu``: the
runs, the radius test, the count and the bins inside it, no window in
device memory); a grid without a table keeps the chunked route it
replaced (:func:`spfh_window_chunked`: K8's window fetch, the radius mask
and count, K4, in query chunks), and CPU tensors take the plain twin
(:func:`spfh_grid_plain`: that route over K8's and K4's twins).  The
kernel's rows equal the chunked route's bit for bit on the card.
"""

from __future__ import annotations

import math

import torch

from .. import _kernels
from .descriptor_bins import darboux_angles
from .grid_hash import HashGrid, _zcolumn_runs
from .histogram import batched_histogram, bin_index, factored_histogram
from .radius_runs import fetch_windows, fetch_windows_plain

# a warp's histogram and its 64-slot lane list live in shared memory (48 KB
# without opt-in)
_MAX_SMEM_FLOATS = 48 * 1024 // 4 - 64
# the SPFH pass kernel keeps one histogram of ints and a 256-row ring per
# warp, 8 warps a block, in the 227 KB of shared memory a block can have
_MAX_GRID_BINS = 232_448 // 4 // 8 - 256
# queries a chunk of the chunked route: bounds its (chunk, F + 2, W) window
_WINDOW_CHUNK = 8192


def spfh_dim(n_bins: int, decorrelated: bool) -> int:
    return 3 * n_bins if decorrelated else n_bins ** 3


def spfh_from_angles(alpha, phi, theta, valid, n_bins: int, decorrelated: bool):
    """Unnormalized ``(Q, D)`` SPFH from per-neighbor ``(Q, K)`` angles and
    validity, with ``histogramdd`` range semantics (out-of-range dropped)."""
    a_bin, a_in = bin_index(alpha, -1.0, 1.0, n_bins)
    p_bin, p_in = bin_index(phi, -1.0, 1.0, n_bins)
    t_bin, t_in = bin_index(theta, -math.pi / 2, math.pi / 2, n_bins)
    if decorrelated:
        parts = [batched_histogram(b, (valid & in_r).to(torch.float32), n_bins)
                 for b, in_r in ((a_bin, a_in), (p_bin, p_in), (t_bin, t_in))]
        return torch.stack(parts, dim=-1).reshape(alpha.shape[0], 3 * n_bins)
    wgt = (valid & a_in & p_in & t_in).to(torch.float32)
    return factored_histogram(a_bin, p_bin * n_bins + t_bin, wgt, n_bins, n_bins ** 2)


def spfh_histogram_plain(vals, dist_inf, queries, query_normals, n_bins: int,
                         decorrelated: bool):
    """PyTorch twin of the kernel: invalid lanes are selected to zero before
    the arithmetic, so a non-finite padding value never reaches a bin."""
    finite = dist_inf < float("inf")
    rho = torch.where(finite, dist_inf, 0.0)
    valid = finite & (rho > 0)
    dx, dy, dz = (torch.where(finite, vals[:, i, :] - queries[:, i:i + 1], 0.0)
                  for i in range(3))
    nx, ny, nz = (torch.where(finite, vals[:, i, :], 0.0) for i in range(3, 6))
    ux, uy, uz = (query_normals[:, i:i + 1] for i in range(3))
    alpha, phi, theta = darboux_angles(dx, dy, dz, nx, ny, nz, ux, uy, uz,
                                       torch.where(valid, rho, 1.0))
    return spfh_from_angles(alpha, phi, theta, valid, n_bins, decorrelated)


def spfh_histogram(vals: torch.Tensor, dist_inf: torch.Tensor, queries: torch.Tensor,
                   query_normals: torch.Tensor, n_bins: int, decorrelated: bool):
    """Unnormalized SPFH histograms of a window: ``(C, n_bins³)`` joint or
    ``(C, 3·n_bins)`` decorrelated (interleaved)."""
    if vals.device.type == "cpu":
        return spfh_histogram_plain(vals, dist_inf, queries, query_normals, n_bins,
                                    decorrelated)
    tensors = [vals, dist_inf, queries, query_normals]
    device = _kernels.require_cuda(*tensors)
    c, nf, w = vals.shape
    if (nf < 6 or dist_inf.shape != (c, w) or queries.shape != (c, 3)
            or query_normals.shape != (c, 3)):
        raise ValueError(f"bad window shapes {tuple(vals.shape)}, {tuple(dist_inf.shape)}, "
                         f"{tuple(queries.shape)}, {tuple(query_normals.shape)}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("SPFH kernel inputs must be float32")
    d_out = spfh_dim(n_bins, decorrelated)
    if not 0 < d_out <= _MAX_SMEM_FLOATS:
        raise ValueError(f"n_bins={n_bins} gives {d_out} bins; the kernel holds at most "
                         f"{_MAX_SMEM_FLOATS} in shared memory")
    vals, dist_inf, queries, query_normals = (t.contiguous() for t in tensors)
    out = torch.empty((c, d_out), dtype=torch.float32, device=vals.device)
    _kernels.launch("spfh_histogram", device, vals.data_ptr(), dist_inf.data_ptr(),
                    queries.data_ptr(), query_normals.data_ptr(), out.data_ptr(), c, nf, w,
                    n_bins, int(decorrelated),
                    checked=(vals, dist_inf, queries, query_normals, out))
    return out


def _spfh_chunks(grid: HashGrid, qc, qn, radius, n_bins: int, decorrelated: bool, fetch,
                 histogram, chunk: int):
    """Count-normalized ``(C, D)`` SPFH over each query's grid window, in
    chunks of ``chunk`` queries: the window (``fetch``: K8 or its twin), the
    slots with ``d <= radius`` counted (self included), their histogram
    (``histogram``: K4 or its twin), divided by the count."""
    # contiguous once, so each chunk goes to the kernels without a copy
    qc, qn = qc.contiguous(), qn.contiguous()
    parts = []
    for s in range(0, qc.shape[0], chunk):
        q, u = qc[s:s + chunk], qn[s:s + chunk]
        start, end = _zcolumn_runs(grid, q)
        vals, d, win_ok, _ = fetch(grid.packed_sorted, q, start, end, grid.window_cap)
        ok = win_ok & (d <= radius)
        count = torch.clamp(ok.sum(-1), min=1).to(torch.float32)
        dist_inf = torch.where(ok, d, torch.full_like(d, float("inf")))
        parts.append(histogram(vals, dist_inf, q, u, n_bins, decorrelated) / count[:, None])
    if not parts:
        return qc.new_zeros((0, spfh_dim(n_bins, decorrelated)))
    return torch.cat(parts)


def spfh_grid_plain(grid: HashGrid, qc, qn, radius, n_bins: int, decorrelated: bool,
                    chunk: int = _WINDOW_CHUNK):
    """PyTorch twin of the SPFH pass kernel: the chunked route over K8's
    and K4's twins (:func:`_spfh_chunks`), on any device."""
    return _spfh_chunks(grid, qc, qn, radius, n_bins, decorrelated, fetch_windows_plain,
                        spfh_histogram_plain, chunk)


def spfh_window_chunked(grid: HashGrid, qc, qn, radius, n_bins: int, decorrelated: bool,
                        chunk: int = _WINDOW_CHUNK):
    """The SPFH pass as the port ran it before its kernel, and as a grid
    without a cell-start table still runs it: K8 (no rows plane) over each
    chunk's windows, the radius mask and count, K4 (on CPU tensors their
    twins, so :func:`spfh_grid_plain`'s arithmetic)."""
    def fetch(*args):
        return fetch_windows(*args, with_rows=False)

    return _spfh_chunks(grid, qc, qn, radius, n_bins, decorrelated, fetch, spfh_histogram,
                        chunk)


def spfh_grid(grid: HashGrid, qc: torch.Tensor, qn: torch.Tensor, radius, n_bins: int,
              decorrelated: bool):
    """Count-normalized ``(C, D)`` SPFH of the queries ``qc`` with normals
    ``qn`` (``(C, 3)`` float32 each) over their z-column windows of ``grid``
    (a grid built with ``extras=normals``): the slots with ``sqrt(ρ²) <=
    radius`` counted, the query's own row and duplicates included, the ones
    with ``d > 0`` binned, the histogram divided by ``max(count, 1)``; a
    query off the grid (the far sentinel of padded queries) gets a zero row.
    A grid with a cell-start table takes the kernel on CUDA tensors, one
    launch for every query, and :func:`spfh_grid_plain` on CPU tensors; a
    grid without one takes :func:`spfh_window_chunked` (see the module
    docstring)."""
    c = qc.shape[0]
    if qc.shape != (c, 3) or qn.shape != (c, 3):
        raise ValueError(f"bad query shapes {tuple(qc.shape)}, {tuple(qn.shape)}")
    if not grid.has_table:
        return spfh_window_chunked(grid, qc, qn, radius, n_bins, decorrelated)
    if qc.device.type == "cpu":
        return spfh_grid_plain(grid, qc, qn, radius, n_bins, decorrelated)
    table = grid.packed_sorted
    device = _kernels.require_cuda(qc, qn, table, grid.cell_starts, grid.origin)
    if (any(t.dtype != torch.float32 for t in (qc, qn, table)) or not table.is_contiguous()
            or table.dim() != 2 or table.shape[1] < 6):
        raise ValueError("the SPFH pass kernel takes float32 queries and a contiguous float32 "
                         f"(N, >=6) table with normals, got {tuple(table.shape)} {table.dtype}")
    if table.shape[0] >= 2 ** 30:
        raise ValueError("the SPFH pass kernel walks table rows as 32-bit ints (at most 2^30)")
    d_out = spfh_dim(n_bins, decorrelated)
    if not 0 < d_out <= _MAX_GRID_BINS:
        raise ValueError(f"n_bins={n_bins} gives {d_out} bins; the kernel holds at most "
                         f"{_MAX_GRID_BINS} per warp in shared memory")
    # the kernel reads query i at i * stride(0) from each base: the rows of
    # two (C, 3) arrays, or of the table itself
    if qc.stride(1) != 1 or qn.stride(1) != 1 or qc.stride(0) != qn.stride(0):
        qc, qn = qc.contiguous(), qn.contiguous()
    out = torch.empty((c, d_out), dtype=torch.float32, device=device)
    if c:
        # the walk's copy of the points, 16 B a row: one load a window slot
        xyz = torch.nn.functional.pad(table[:, :3], (0, 1))
        _kernels.launch("spfh_grid", device, table.data_ptr(), table.shape[1], xyz.data_ptr(),
                        grid.cell_starts.data_ptr(), grid.origin.data_ptr(), grid.cell_size,
                        *grid.dims, grid.halo, grid.window_cap, qc.data_ptr(), qn.data_ptr(),
                        qc.stride(0), c, float(radius), n_bins, int(decorrelated),
                        out.data_ptr(), checked=(table, qc, qn, out))
    return out
