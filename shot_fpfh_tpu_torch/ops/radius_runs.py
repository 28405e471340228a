"""K7 and K8: a query's grid runs written out as its compacted window.

Counterparts of ``shot_fpfh_tpu/ops/pallas_radius.py``:

- K8, ``fetch_windows_pallas`` (``_fetch_kernel``): the dense window fetch —
  each candidate's table row, feature first, and its distance (and, unless
  the caller drops it, its row);
- K7, ``grid_radius_search_pallas`` (``_dist_kernel``): the masked candidate
  distances a radius search selects from (``d`` where ``d <= radius``, else
  +inf); top-k and the value gather stay outside, as there.

Both take the cell-sorted table (``HashGrid.packed_sorted``, ``F`` columns),
the queries and each query's runs ``(start, end)`` ``(Q, R)`` of sorted rows
(``grid_hash._zcolumn_runs``: ``(2h+1)²`` runs, from the cell table or from
a binary search), and write the port's compacted window of width ``W``
(``grid.window_cap``): the runs concatenated in order, rows ascending within
a run, then padding slots that hold row 0 (not valid).  The distance of a
slot is ``sqrt(fma(dz, dz, fma(dy, dy, dx·dx)))`` (``_fp.sqnorm3``).

:func:`fetch_windows` and :func:`radius_dist` launch the CUDA kernels
(``csrc/radius_runs.cu``) on CUDA tensors and run their plain PyTorch twins
(:func:`fetch_windows_plain`, :func:`radius_dist_plain`) on CPU tensors.

K7's 1-NN mode, :func:`nearest` (``csrc/nearest.cu``), is the grid 1-NN of
``grid_nearest_neighbor`` (JAX ``grid_hash.py:834-864``) on a grid with a
cell-start table: one launch for every query finds each query's cell and
z-column runs, walks them in window order and keeps the nearest row, the
lowest window slot winning a tie, and writes ``(dist, orig_idx of the
row)``; no ``(Q, W)`` window is written.  Its twin,
:func:`nearest_plain`, is that window (K7's twin at radius +inf) and an
explicit first-index argmin.

K7's FPFH aggregation mode, :func:`fpfh_aggregate`
(``csrc/fpfh_aggregate.cu``), is FPFH's second pass (JAX
``models/fpfh.py:242-284``, ``_fpfh_window_aggregate``) on a grid with a
cell-start table: one launch for every keypoint finds each keypoint's cell
and z-column runs, walks them in window order, and sums the 1/d weighted
SPFH rows of its in-radius neighbours; no ``(Q, W)`` window and no gathered
``(C, W, D)`` block are written.  Its twin, :func:`fpfh_aggregate_plain`,
is that window (K7's twin), the gather and an einsum, in chunks of
``_AGG_ELEMS`` gathered elements.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .._fp import sqnorm3, sqrt

# gathered neighbor-SPFH elements a chunk of the chunked aggregation, (C, W, D)
_AGG_ELEMS = 1 << 26


def window_slots(start: torch.Tensor, end: torch.Tensor, w: int, n: int):
    """``(rows (Q, w), valid (Q, w))``: the runs ``[start, end)`` of each
    query concatenated into ``w`` slots of sorted rows (row 0 past the end)."""
    cum = torch.cumsum(end - start, dim=1)                    # inclusive
    excl = cum - (end - start)
    j = torch.arange(w, device=start.device).expand(start.shape[0], w)
    run = torch.clamp(torch.searchsorted(cum, j.contiguous(), right=True),
                      max=start.shape[1] - 1)
    rows = torch.gather(start, 1, run) + j - torch.gather(excl, 1, run)
    valid = j < cum[:, -1:]
    rows = torch.where(valid, torch.clamp(rows, max=n - 1), torch.zeros_like(rows))
    return rows, valid


def _distances(cand, queries):
    """``(Q, W)`` distances of gathered ``(Q, W, >=3)`` rows to the queries."""
    return sqrt(sqnorm3(*(cand[..., i] - queries[:, i:i + 1] for i in range(3))))


def fetch_windows_plain(table, queries, start, end, w: int):
    """PyTorch twin of K8: ``(vals (Q, F, W), dist (Q, W), valid (Q, W),
    rows (Q, W))``; padding slots hold row 0's values and distance."""
    rows, valid = window_slots(start, end, w, table.shape[0])
    cand = table[rows]                                        # (Q, W, F)
    return cand.permute(0, 2, 1).contiguous(), _distances(cand, queries), valid, rows


def radius_dist_plain(table, queries, start, end, w: int, radius: float):
    """PyTorch twin of K7: ``(rows (Q, W), d or +inf (Q, W))``, finite where
    the slot is valid and ``d <= radius`` (float32; ``inf`` keeps every
    valid slot)."""
    rows, valid = window_slots(start, end, w, table.shape[0])
    dist = _distances(table[:, :3][rows], queries)
    r = torch.tensor(float(radius), dtype=torch.float32)
    return rows, torch.where(valid & (dist <= r), dist, torch.full_like(dist, float("inf")))


def _checked(table, queries, start, end):
    """The kernels' inputs, on one CUDA device, in the types and layouts
    they take; raises on anything else."""
    device = _kernels.require_cuda(table, queries, start, end)
    if table.dtype != torch.float32 or table.dim() != 2 or not 3 <= table.shape[1] <= 8:
        raise ValueError(f"table must be (N, 3..8) float32, got {tuple(table.shape)} "
                         f"{table.dtype}")
    q = queries.shape[0]
    if queries.dtype != torch.float32 or queries.shape != (q, 3):
        raise ValueError(f"queries must be (Q, 3) float32, got {tuple(queries.shape)}")
    if (start.dtype != torch.int64 or end.dtype != torch.int64
            or start.shape != end.shape or start.shape[0] != q):
        raise ValueError(f"runs must be two int64 (Q, R) tensors, got {tuple(start.shape)} "
                         f"{start.dtype} and {tuple(end.shape)} {end.dtype}")
    return (device, table.contiguous(), queries.contiguous(), start.contiguous(),
            end.contiguous())


def fetch_windows(table, queries, start, end, w: int, with_rows: bool = True):
    """K8: ``(vals (Q, F, W), dist (Q, W), valid (Q, W), rows (Q, W))`` of
    each query's window (see the module docstring); ``rows`` is None when
    ``with_rows`` is False, and the kernel then does not write it."""
    if queries.device.type == "cpu":
        vals, dist, valid, rows = fetch_windows_plain(table, queries, start, end, w)
        return vals, dist, valid, rows if with_rows else None
    device, table, queries, start, end = _checked(table, queries, start, end)
    q, f = queries.shape[0], table.shape[1]
    vals = torch.empty((q, f, w), dtype=torch.float32, device=device)
    dist = torch.empty((q, w), dtype=torch.float32, device=device)
    valid = torch.empty((q, w), dtype=torch.bool, device=device)
    rows = torch.empty((q, w), dtype=torch.int64, device=device) if with_rows else None
    if q and w:
        _kernels.launch("fetch_windows", device, table.data_ptr(), f, queries.data_ptr(),
                        start.data_ptr(), end.data_ptr(), start.shape[1], q, w,
                        vals.data_ptr(), dist.data_ptr(), valid.data_ptr(), _kernels.ptr(rows),
                        checked=(table, queries, vals, dist))
    return vals, dist, valid, rows


def radius_dist(table, queries, start, end, w: int, radius: float):
    """K7: ``(rows (Q, W), d or +inf (Q, W))`` of each query's window, the
    distance kept where the slot is valid and within ``radius``."""
    if queries.device.type == "cpu":
        return radius_dist_plain(table, queries, start, end, w, radius)
    device, table, queries, start, end = _checked(table, queries, start, end)
    q = queries.shape[0]
    rows = torch.empty((q, w), dtype=torch.int64, device=device)
    dist = torch.empty((q, w), dtype=torch.float32, device=device)
    if q and w:
        _kernels.launch("radius_dist", device, table.data_ptr(), table.shape[1],
                        queries.data_ptr(), start.data_ptr(), end.data_ptr(), start.shape[1],
                        q, w, float(radius), rows.data_ptr(), dist.data_ptr(),
                        checked=(table, queries, dist))
    return rows, dist


def nearest_lanes(window_cap: int) -> int:
    """Lanes a query in the 1-NN kernel for a grid's window cap: a group of
    lanes walks a window in ceil(rows / lanes) steps, so a narrow window
    leaves most of a 32-lane group idle, while a wide one wants every lane
    (on an H100: ICP's cap 626, 527 rows a query, 32 lanes 0.0289 ms alone,
    8 lanes 0.0326; a halo-2 cap 186, 137 rows a query, 0.1102 and 0.0797;
    16 lanes won at neither)."""
    return 32 if window_cap > 384 else 8


def first_argmin(x: torch.Tensor):
    """``(min, first index of it)`` of each row of ``x`` (Q, W) holding no
    NaN; a row of +inf gives index 0."""
    best = x.min(dim=1).values
    slots = torch.arange(x.shape[1], device=x.device).expand_as(x)
    pos = torch.where(x == best[:, None], slots, x.shape[1]).min(dim=1).values
    return best, pos


def nearest_plain(grid, queries):
    """PyTorch twin of the 1-NN kernel: ``(dist (Q,), idx (Q,))``, each
    query's z-column window (K7's twin at radius +inf), its first minimal
    slot (+inf and slot 0 where no distance is finite) and that slot's row
    in ``grid.orig_idx``; in chunks of ``window_chunk(grid, 4)`` queries,
    which bound the window's temporaries."""
    from .grid_hash import _zcolumn_runs, window_chunk   # grid_hash imports this module

    dist_out, idx_out = [], []
    step = window_chunk(grid, 4)
    for s in range(0, queries.shape[0], step):
        qc = queries[s:s + step]
        start, end = _zcolumn_runs(grid, qc)
        rows, masked = radius_dist_plain(grid.packed_sorted, qc, start, end, grid.window_cap,
                                         float("inf"))
        best, pos = first_argmin(masked)
        dist_out.append(best)
        idx_out.append(grid.orig_idx[torch.gather(rows, 1, pos[:, None])[:, 0]])
    if not dist_out:
        return queries.new_zeros((0,)), grid.orig_idx.new_zeros((0,))
    return torch.cat(dist_out), torch.cat(idx_out)


def nearest(grid, queries, lanes: int | None = None):
    """K7's 1-NN mode: ``(dist (Q,), idx (Q,))`` of each query's nearest row
    of its z-column window on ``grid`` (a grid with a cell-start table), in
    one launch; see the module docstring.  ``lanes``: lanes a query (8 or
    32; default :func:`nearest_lanes` of the window cap)."""
    if queries.device.type == "cpu":
        return nearest_plain(grid, queries)
    if not grid.has_table:
        raise ValueError("the 1-NN kernel needs a grid with a cell-start table")
    table = grid.packed_sorted
    device = _kernels.require_cuda(table, grid.orig_idx, grid.cell_starts, grid.origin, queries)
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[1] < 3:
        raise ValueError(f"table must be (N, >=3) float32, got {tuple(table.shape)} "
                         f"{table.dtype}")
    q = queries.shape[0]
    if queries.dtype != torch.float32 or queries.shape != (q, 3):
        raise ValueError(f"queries must be (Q, 3) float32, got {tuple(queries.shape)}")
    lanes = nearest_lanes(grid.window_cap) if lanes is None else lanes
    if lanes not in (8, 32):
        raise ValueError(f"lanes must be 8 or 32, got {lanes}")
    table, queries = table.contiguous(), queries.contiguous()
    dist = torch.empty(q, dtype=torch.float32, device=device)
    idx = torch.empty(q, dtype=torch.int64, device=device)
    if q:
        _kernels.launch("nearest", device, table.data_ptr(), table.shape[1],
                        grid.orig_idx.data_ptr(), grid.cell_starts.data_ptr(),
                        grid.origin.data_ptr(), grid.cell_size, *grid.dims, grid.halo,
                        grid.window_cap, queries.data_ptr(), q, lanes, dist.data_ptr(),
                        idx.data_ptr(), checked=(table, queries, dist))
    return dist, idx


def _aggregate_chunks(grid, spfh_sorted, kp_rows, radius, search, return_counts: bool):
    """FPFH's second pass over each keypoint's window, in chunks of
    ``_AGG_ELEMS`` gathered elements: the in-radius distances (``search``:
    K7 or its twin), the neighbors' SPFH rows gathered, their 1/d weighted
    sum (``einsum``) over the count of in-radius slots."""
    from .grid_hash import _zcolumn_runs   # grid_hash imports this module

    step = max(1, _AGG_ELEMS // (grid.window_cap * spfh_sorted.shape[1]))
    out, counts = [], []
    for s in range(0, kp_rows.shape[0], step):
        kp_c = kp_rows[s:s + step]
        queries = grid.packed_sorted[kp_c, :3]
        start, end = _zcolumn_runs(grid, queries)
        rows, d = search(grid.packed_sorted, queries, start, end, grid.window_cap, radius)
        ok = torch.isfinite(d)
        m = ok & (d > 0)
        wt = torch.where(m, 1.0 / torch.where(m, d, 1.0), 0.0)
        acc = torch.einsum("cwd,cw->cd", spfh_sorted[rows], wt)
        count = ok.sum(-1)
        counts.append(count.to(torch.int32))
        out.append(spfh_sorted[kp_c] + acc / torch.clamp(count, min=1).to(torch.float32)[:, None])
    if out:
        out, counts = torch.cat(out), torch.cat(counts)
    else:
        out = spfh_sorted.new_zeros((0, spfh_sorted.shape[1]))
        counts = torch.zeros(0, dtype=torch.int32, device=spfh_sorted.device)
    return (out, counts) if return_counts else out


def fpfh_aggregate_plain(grid, spfh_sorted, kp_rows, radius, return_counts: bool = False):
    """PyTorch twin of K7's FPFH aggregation mode: ``(Q, D)`` FPFH rows
    (and, with ``return_counts``, the ``(Q,)`` int32 counts of in-radius
    slots) of the keypoints ``kp_rows`` (rows of ``grid``'s sorted table)
    from ``spfh_sorted`` (``(N, D)``, the SPFH in that order): K7's twin over
    each keypoint's window, the gather and an einsum (see
    :func:`fpfh_aggregate`)."""
    return _aggregate_chunks(grid, spfh_sorted, kp_rows, radius, radius_dist_plain,
                             return_counts)


def fpfh_aggregate_chunked(grid, spfh_sorted, kp_rows, radius, return_counts: bool = False):
    """The aggregation as the port ran it before the aggregation kernel,
    and as a grid without a cell-start table still runs it: K7
    (:func:`radius_dist`) over the windows, the gather and an einsum, in
    chunks of ``_AGG_ELEMS`` gathered elements."""
    return _aggregate_chunks(grid, spfh_sorted, kp_rows, radius, radius_dist, return_counts)


def _aggregate_checked(grid, spfh_sorted, kp_rows):
    """The aggregation's inputs in the types and shapes every route takes;
    raises on anything else."""
    table = grid.packed_sorted
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[1] < 3:
        raise ValueError(f"table must be (N, >=3) float32, got {tuple(table.shape)} "
                         f"{table.dtype}")
    if (spfh_sorted.dtype != torch.float32 or spfh_sorted.dim() != 2
            or spfh_sorted.shape[0] != table.shape[0] or spfh_sorted.shape[1] < 1):
        raise ValueError(f"spfh_sorted must be (N = {table.shape[0]}, D) float32, got "
                         f"{tuple(spfh_sorted.shape)} {spfh_sorted.dtype}")
    if kp_rows.dtype != torch.int64 or kp_rows.dim() != 1:
        raise ValueError(f"kp_rows must be (Q,) int64, got {tuple(kp_rows.shape)} "
                         f"{kp_rows.dtype}")


def _aggregate_launch(grid, spfh_sorted, kp_rows, radius, return_counts: bool, sort: bool):
    """Launch the aggregation kernel on every keypoint, in ascending
    sorted-row order when ``sort`` (one ``argsort``; each output row still
    lands at its keypoint's position), else in the caller's order.  The
    wrapper sorts: warps in flight then share their neighbors' SPFH rows in
    L2 (on an H100, alone: 4.32 ms against 11.22 in the caller's order on
    the 78,259 keypoints of a 10^6-point cloud, 0.557 against 0.899 on
    6,531 keypoints of 100k points; ``chip_smoke.py``)."""
    _aggregate_checked(grid, spfh_sorted, kp_rows)
    if not grid.has_table:
        raise ValueError("the aggregation kernel needs a grid with a cell-start table")
    table = grid.packed_sorted
    device = _kernels.require_cuda(table, grid.cell_starts, grid.origin, spfh_sorted, kp_rows)
    table, spfh_sorted, kp_rows = table.contiguous(), spfh_sorted.contiguous(), kp_rows.contiguous()
    q, dim = kp_rows.shape[0], spfh_sorted.shape[1]
    out = torch.empty((q, dim), dtype=torch.float32, device=device)
    counts = torch.empty(q, dtype=torch.int32, device=device) if return_counts else None
    if q:
        order = torch.argsort(kp_rows) if sort else None
        _kernels.launch("fpfh_aggregate", device, table.data_ptr(), table.shape[1],
                        grid.cell_starts.data_ptr(), grid.origin.data_ptr(), grid.cell_size,
                        *grid.dims, grid.halo, grid.window_cap, spfh_sorted.data_ptr(), dim,
                        kp_rows.data_ptr(), _kernels.ptr(order), q, float(radius),
                        out.data_ptr(), _kernels.ptr(counts),
                        checked=(table, spfh_sorted, out))
    return (out, counts) if return_counts else out


def fpfh_aggregate(grid, spfh_sorted, kp_rows, radius, return_counts: bool = False):
    """K7's FPFH aggregation mode: ``(Q, D)`` float32 FPFH rows of the
    keypoints ``kp_rows`` (``(Q,)`` int64 rows of ``grid``'s sorted table)
    from ``spfh_sorted`` (``(N, D)`` float32, the SPFH in that order)::

        out[q] = spfh_sorted[kp_rows[q]]
                 + (Σ_{valid slot, d <= r, d > 0} spfh_sorted[row] / d)
                   / max(1, #{valid slot, d <= r})

    over the z-column window of ``grid.packed_sorted[kp_rows[q], :3]``, under
    the window routes' radius rule ``sqrt(ρ²) <= r``; the keypoint's own row
    counts toward the count but not the sum.  With ``return_counts`` also
    the ``(Q,)`` int32 counts.  A grid with a cell-start table takes the
    kernel (``csrc/fpfh_aggregate.cu``), one launch for every keypoint; a
    grid without one (too many cells, ``build_grid``) finds its runs by
    binary search and keeps the chunked route
    (:func:`fpfh_aggregate_chunked`: K7, a gather, an einsum; on CPU tensors
    K7's twin, so the twin's arithmetic).  Otherwise CPU tensors take the
    plain twin."""
    _aggregate_checked(grid, spfh_sorted, kp_rows)
    if not grid.has_table:
        return fpfh_aggregate_chunked(grid, spfh_sorted, kp_rows, radius, return_counts)
    if spfh_sorted.device.type == "cpu":
        return fpfh_aggregate_plain(grid, spfh_sorted, kp_rows, radius, return_counts)
    return _aggregate_launch(grid, spfh_sorted, kp_rows, radius, return_counts, sort=True)
