"""K1: SHOT local reference frames + soft binning + histogram on a window.

Counterpart of ``shot_fpfh_tpu/ops/pallas_shot_fused.py::shot_binning_histogram``
in its three modes: from a feature-first candidate window (``vals (Q, F≥6,
W)`` rows ``[x y z nx ny nz ...]``, ``dist (Q, W)`` with +inf on invalid
lanes) it returns the unnormalized ``(Q, 352)`` histograms and, when the
frames are computed, the ``(Q, 3, 3)`` frames (columns x, y, z).  The frames
come from the window's own neighbors, are given (multiscale sharing), or, in
bi-scale mode, come from a second validity plane ``rf_dist_inf`` over the
same window with weights ``max(rf_radius − d, 0)``.

:func:`shot_binning_histogram` launches the CUDA kernel
(``csrc/shot_fused.cu``) on CUDA tensors and runs
:func:`shot_binning_histogram_plain` on CPU tensors.  The plain version
accumulates the five weighted contributions in float32 with ``index_add_``;
the JAX reference rounds its weights to bf16 on the way into a one-hot
matmul (``models/shot.py:195-203``), so the two agree to ~0.4%, not bitwise.

SG, :func:`shot_grid`, is SHOT's grid window route and its one routing
point: on a grid (``ops.grid_hash``) carrying normals, the same three modes
over each keypoint's exact z-column window.  On CUDA tensors and a grid with
a cell-start table it launches one kernel for every keypoint
(``csrc/shot_grid.cu``: the runs, both radius tests, the frames and the bins
inside it, no window in device memory); CPU tensors and a grid without a
table take the chunked route it replaced (:func:`shot_window_chunked`: K8's
window fetch, the radius planes, K1, in keypoint chunks; on CPU tensors
those wrappers run their twins).  Its plain twin, :func:`shot_grid_plain`,
is that route over K8's and K1's twins on any device.  The kernel's rows,
frames and counts equal the chunked route's bit for bit on the card.

All of them take an optional ``violations`` counter (a zeroed ``(2,)`` int32
tensor on the inputs' device) for the SHOT debug checks
(``models.shot.enable_debug_checks``): the kernel, or the twin, adds to it
the valid neighbors with an out-of-range bin and those with an unsound
weight sum (:func:`binning_violations`), and drops every contribution whose
bin is out of range, as the reference's one-hot does.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .._fp import acos, atan2
from ..utils.perf import add_counts, span
from .descriptor_bins import N_AZ, N_COS, N_ELEV, N_LO, N_RAD, SHOT_DIM, shot_soft_bins
from .eigh3 import eigh3x3
from .grid_hash import HashGrid, _zcolumn_runs, window_chunk
from .radius_runs import fetch_windows, fetch_windows_plain


def _project(centered: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """``(Q, W)`` projections of ``(Q, 3, W)`` offsets on ``(Q, 3)`` axes,
    summed left to right with every product rounded, as the kernel does: a
    neighbor on a hard bin edge then lands in the same bin on both sides."""
    return (centered[:, 0] * axis[:, 0, None] + centered[:, 1] * axis[:, 1, None]
            + centered[:, 2] * axis[:, 2, None])


def local_frames(centered: torch.Tensor, rho: torch.Tensor, ok: torch.Tensor,
                 radius) -> torch.Tensor:
    """SHOT local reference frames on ``(Q, 3, W)`` centered offsets: the
    eigenvectors of the (radius − d)-weighted covariance, x/z signs by
    majority vote of the neighbors' projections (a tie keeps the sign),
    y = z × x, the identity for an empty window.  Columns are [x, y, z]."""
    w = torch.clamp(radius - rho, min=0.0) * ok.to(torch.float32)
    wsum = w.sum(-1)
    cov = torch.einsum("qiw,qjw->qij", centered * w[:, None, :], centered) / (
        torch.clamp(wsum, min=1e-12)[:, None, None])
    _, v = eigh3x3(cov)
    axes = []
    for axis in (v[..., :, 2], v[..., :, 0]):
        proj = _project(centered, axis)
        neg = ((proj < 0) & ok).sum(-1)
        nonneg = ((proj >= 0) & ok).sum(-1)
        axes.append(torch.where((neg > nonneg)[:, None], -axis, axis))
    x_axis, z_axis = axes
    y_axis = torch.linalg.cross(z_axis, x_axis, dim=-1)
    rfs = torch.stack([x_axis, y_axis, z_axis], dim=-1)
    empty = ok.sum(-1) == 0
    eye = torch.eye(3, dtype=rfs.dtype, device=rfs.device)
    return torch.where(empty[:, None, None], eye, rfs)


def binning_violations(cos_bin, cos_nb, az_bin, elev_bin, rad_bin, total_w, valid):
    """``(bad-bin count, bad-weight count)`` over valid neighbors: a bin
    index out of its range, or a summed soft-bin weight outside
    ``(0, 4 + 1e-3]`` (each of the four interpolated dimensions gives at
    most 1; reference shot.py:414-428)."""
    bad_bin = ((cos_bin < 0) | (cos_bin >= N_COS) | (cos_nb < 0) | (cos_nb >= N_COS)
               | (az_bin < 0) | (az_bin >= N_AZ) | (elev_bin < 0) | (elev_bin >= N_ELEV)
               | (rad_bin < 0) | (rad_bin >= N_RAD))
    bad_w = torch.isnan(total_w) | (total_w > 4.0 + 1e-3) | (total_w <= 0.0)
    return (bad_bin & valid).sum(dtype=torch.int32), (bad_w & valid).sum(dtype=torch.int32)


def soft_histogram(lx, ly, lz, rho, cosine, valid, radius, violations=None) -> torch.Tensor:
    """Unnormalized ``(Q, 352)`` SHOT histograms from per-neighbor ``(Q, K)``
    local coordinates, distances, normal cosines and validity: each valid
    neighbor adds its five merged soft-bin weights.  With a ``violations``
    counter, the debug checks count into it and out-of-range bins are
    dropped."""
    rho_safe = torch.where(valid, rho, torch.ones_like(rho))
    theta = atan2(ly, lx)
    phi = acos(torch.clamp(lz / rho_safe, -1.0, 1.0))
    sb = shot_soft_bins(lx, ly, lz, rho, theta, phi, cosine, radius)
    q = lx.shape[0]
    terms = [(sb.cos_bin, sb.base, sb.w_same), (sb.cos_bin, sb.lo_husk, sb.w_husk_nb),
             (sb.cos_bin, sb.lo_vert, sb.w_vert_nb), (sb.cos_bin, sb.lo_az, sb.abs_az),
             (sb.cos_nb, sb.base, sb.abs_cos)]
    if violations is not None:
        total_w = sb.w_same + sb.w_husk_nb + sb.w_vert_nb + sb.abs_az + sb.abs_cos
        violations += torch.stack(binning_violations(
            sb.cos_bin, sb.cos_nb, sb.az_bin, sb.elev_bin, sb.rad_bin, total_w, valid))
        terms = [_drop_out_of_range(hi, lo, w) for hi, lo, w in terms]
    row = (torch.arange(q, device=lx.device) * SHOT_DIM)[:, None]
    idx = torch.cat([(hi.to(torch.int64) * N_LO + lo + row).reshape(-1) for hi, lo, _ in terms])
    # an invalid neighbor adds nothing, as in the kernels, which never bin
    # it: selected away, not multiplied by 0, so a NaN weight (a NaN frame)
    # stays out of the histogram
    wts = torch.cat([torch.where(valid, w, 0.0).reshape(-1) for _, _, w in terms])
    hist = torch.zeros(q * SHOT_DIM, dtype=torch.float32, device=lx.device)
    return hist.index_add_(0, idx, wts).reshape(q, SHOT_DIM)


def _drop_out_of_range(hi, lo, w):
    """A contribution's ``(cosine bin, cell, weight)`` with its weight zeroed
    and its bins moved to 0 where either is out of range: the reference's
    one-hot contraction adds nothing for such a bin."""
    ok = (hi >= 0) & (hi < N_COS) & (lo >= 0) & (lo < N_LO)
    return torch.where(ok, hi, 0), torch.where(ok, lo, 0), torch.where(ok, w, 0.0)


def shot_binning_histogram_plain(vals, dist_inf, keypoints, rfs, radius, rf_dist_inf=None,
                                 rf_radius=None, violations=None):
    """PyTorch twin of the kernel: ``hist`` given ``rfs``, or
    ``(hist, rfs)`` when ``rfs`` is None (frames from the window, or from
    the ``rf_dist_inf`` plane with ``rf_radius`` when it is given);
    ``violations`` goes to :func:`soft_histogram`."""
    ok = torch.isfinite(dist_inf)
    pts = vals[:, :3, :]
    nrms = torch.where(ok[:, None, :], vals[:, 3:6, :], 0.0)
    centered = torch.where(ok[:, None, :], pts - keypoints[:, :, None], 0.0)
    rho = torch.where(ok, dist_inf, 0.0)
    if rfs is not None:
        frames = rfs
    elif rf_dist_inf is not None:
        ok_rf = torch.isfinite(rf_dist_inf)
        centered_rf = torch.where(ok_rf[:, None, :], pts - keypoints[:, :, None], 0.0)
        frames = local_frames(centered_rf, torch.where(ok_rf, rf_dist_inf, 0.0), ok_rf,
                              rf_radius)
    else:
        frames = local_frames(centered, rho, ok, radius)
    lx, ly, lz = (_project(centered, frames[..., :, j]) for j in range(3))
    cosine = torch.clamp(_project(nrms, frames[..., :, 2]), -1.0, 1.0)
    hist = soft_histogram(lx, ly, lz, rho, cosine, ok & (rho > 0), radius, violations)
    return (hist, frames) if rfs is None else hist


def shot_binning_histogram(vals: torch.Tensor, dist_inf: torch.Tensor,
                           keypoints: torch.Tensor, rfs, radius: float, rf_dist_inf=None,
                           rf_radius=None, violations=None):
    """Unnormalized ``(Q, 352)`` SHOT histograms of a window; with
    ``rfs=None`` the frames are computed too and ``(hist, rfs)`` returned,
    from ``rf_dist_inf`` with ``rf_radius`` (bi-scale) when it is given;
    the debug checks count into ``violations`` when it is given."""
    if rfs is not None:
        rf_dist_inf = None
    if rf_dist_inf is not None and rf_radius is None:
        raise ValueError("rf_dist_inf needs rf_radius")
    if vals.device.type == "cpu":
        return shot_binning_histogram_plain(vals, dist_inf, keypoints, rfs, radius,
                                            rf_dist_inf, rf_radius, violations)
    tensors = [vals, dist_inf, keypoints] + [t for t in (rfs, rf_dist_inf) if t is not None]
    device = _kernels.require_cuda(*tensors)
    q, nf, w = vals.shape
    if (nf < 6 or dist_inf.shape != (q, w) or keypoints.shape != (q, 3)
            or (rf_dist_inf is not None and rf_dist_inf.shape != (q, w))):
        raise ValueError(f"bad window shapes {tuple(vals.shape)}, "
                         f"{tuple(dist_inf.shape)}, {tuple(keypoints.shape)}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("SHOT kernel inputs must be float32")
    _check_counter(violations, vals.device)
    vals, dist_inf, keypoints = (t.contiguous() for t in (vals, dist_inf, keypoints))
    rf_plane = None if rf_dist_inf is None else rf_dist_inf.contiguous()
    rfs_in = None if rfs is None else rfs.reshape(q, 9).contiguous()
    hist = torch.empty((q, SHOT_DIM), dtype=torch.float32, device=vals.device)
    rfs_out = (torch.empty((q, 3, 3), dtype=torch.float32, device=vals.device)
               if rfs is None else None)
    _kernels.launch(
        "shot_binning_histogram", device, vals.data_ptr(), dist_inf.data_ptr(),
        _kernels.ptr(rf_plane), keypoints.data_ptr(), _kernels.ptr(rfs_in), hist.data_ptr(),
        _kernels.ptr(rfs_out), q, nf, w, float(radius),
        float(radius if rf_radius is None else rf_radius), _kernels.ptr(violations),
        checked=(vals, dist_inf, keypoints, rf_plane, rfs_in, hist, rfs_out))
    return (hist, rfs_out) if rfs is None else hist


def _check_counter(violations, device) -> None:
    """A kernel's debug counter: ``None``, or a contiguous ``(2,)`` int32
    tensor on the kernel's device."""
    if violations is not None and (violations.shape != (2,) or violations.dtype != torch.int32
                                   or violations.device != device
                                   or not violations.is_contiguous()):
        raise ValueError("the SHOT debug counter must be a contiguous (2,) int32 tensor "
                         "on the kernel's device")


def _shot_chunks(grid: HashGrid, kp, radius, rfs, rf_radius, violations, fetch, histogram,
                 chunk: int):
    """``(hist, frames, count)`` of the keypoints over their grid windows,
    in chunks of ``chunk`` keypoints: the window (``fetch``: K8 or its twin)
    and its radius planes (the span ``shot.window``), then the histograms
    and frames (``histogram``: K1 or its twin) and the count of the
    descriptor plane's slots with ``d > 0`` (the span ``shot.bins``), each
    chunk in the span ``shot.chunk``.  Given frames (``rfs``) win over
    ``rf_radius``."""
    inf = float("inf")
    hists, frames, counts = [], [], []
    for s in range(0, kp.shape[0], chunk):
        with span("shot.chunk"):
            qc = kp[s:s + chunk]
            with span("shot.window"):
                start, end = _zcolumn_runs(grid, qc)
                vals, d, valid, _ = fetch(grid.packed_sorted, qc, start, end, grid.window_cap)
                rf_dist_inf = None
                if rfs is None and rf_radius is not None:
                    rf_dist_inf = torch.where(valid & (d <= rf_radius), d,
                                              torch.full_like(d, inf))
                dist_inf = torch.where(valid & (d <= radius), d, torch.full_like(d, inf))
            with span("shot.bins"):
                given = None if rfs is None else rfs[s:s + chunk]
                out = histogram(vals, dist_inf, qc, given, radius, rf_dist_inf=rf_dist_inf,
                                rf_radius=rf_radius if rf_dist_inf is not None else None,
                                violations=violations)
                hist, rfs_c = out if given is None else (out, given)
                count = (torch.isfinite(dist_inf) & (dist_inf > 0)).sum(-1, dtype=torch.int32)
        hists.append(hist)
        frames.append(rfs_c)
        counts.append(count)
    if not hists:
        return (kp.new_zeros((0, SHOT_DIM)), kp.new_zeros((0, 3, 3)),
                torch.zeros(0, dtype=torch.int32, device=kp.device))
    return torch.cat(hists), torch.cat(frames), torch.cat(counts)


def _loop_chunk(grid: HashGrid, chunk: int | None) -> int:
    """Keypoints a chunk of the chunked routes: ``chunk``, else as many as
    :func:`~.grid_hash.window_chunk` allows 8 planes; at most 4096."""
    return min(4096, window_chunk(grid, 8) if chunk is None else chunk)


def shot_grid_plain(grid: HashGrid, kp, radius, rfs=None, rf_radius=None, violations=None,
                    chunk: int | None = None):
    """PyTorch twin of SG: the chunked route over K8's and K1's twins
    (:func:`_shot_chunks`), on any device."""
    return _shot_chunks(grid, kp, radius, rfs, rf_radius, violations, fetch_windows_plain,
                        shot_binning_histogram_plain, _loop_chunk(grid, chunk))


def shot_window_chunked(grid: HashGrid, kp, radius, rfs=None, rf_radius=None, violations=None,
                        chunk: int | None = None):
    """SHOT's grid window route as the port ran it before SG, and as CPU
    tensors and a grid without a cell-start table still run it: K8 (no rows
    plane) over each chunk's windows, the radius planes, K1 (on CPU tensors
    their twins, so :func:`shot_grid_plain`'s arithmetic).  The open stage
    counts the ``chunks``."""
    def fetch(*args):
        return fetch_windows(*args, with_rows=False)

    step = _loop_chunk(grid, chunk)
    out = _shot_chunks(grid, kp, radius, rfs, rf_radius, violations, fetch,
                       shot_binning_histogram, step)
    add_counts(chunks=-(-kp.shape[0] // step))
    return out


def _takes_kernel(grid: HashGrid, kp: torch.Tensor) -> bool:
    """SG's own kernel applies: the keypoints are on a card and the grid has
    a cell-start table, from which the kernel finds each keypoint's runs."""
    return kp.is_cuda and grid.has_table


def shot_grid(grid: HashGrid, kp: torch.Tensor, radius: float, rfs=None, rf_radius=None,
              violations=None, chunk: int | None = None):
    """SG: ``(hist (Q, 352) unnormalized, frames (Q, 3, 3), count (Q,)
    int32)`` of the keypoints ``kp`` (``(Q, 3)`` float32) over their
    z-column windows of ``grid`` (a grid built with ``extras=normals``):
    the frames given (``rfs``), or from the slots with ``sqrt(ρ²) <=
    rf_radius`` (bi-scale) or ``<= radius``; the bins and the count (the
    min-neighborhood rule's) from the slots with ``0 < sqrt(ρ²) <= radius``;
    a keypoint off the grid (the far sentinel of padded keypoints) gets a
    zero row, count 0 and the identity frame.  Where :func:`_takes_kernel`
    holds, one launch for every keypoint (the span ``shot.pass``; the open
    stage counts one ``grid_passes`` and no ``chunks``); else
    :func:`shot_window_chunked` in chunks of ``chunk`` keypoints (see the
    module docstring)."""
    q = kp.shape[0]
    if kp.shape != (q, 3) or (rfs is not None and rfs.shape != (q, 3, 3)):
        raise ValueError(f"bad keypoint shapes {tuple(kp.shape)}"
                         + ("" if rfs is None else f", {tuple(rfs.shape)}"))
    if kp.dtype != torch.float32 or (rfs is not None and rfs.dtype != torch.float32):
        raise ValueError("SHOT grid kernel inputs must be float32")
    table = grid.packed_sorted
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[1] < 6:
        raise ValueError("the SHOT grid kernel takes a float32 (N, >=6) table with normals, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if rfs is not None:
        rf_radius = None
    if not _takes_kernel(grid, kp):
        return shot_window_chunked(grid, kp, radius, rfs, rf_radius, violations, chunk)
    with span("shot.pass"):
        out = _shot_grid_launch(grid, kp, radius, rfs, rf_radius, violations)
    add_counts(grid_passes=1, chunks=0)
    return out


def _shot_grid_launch(grid: HashGrid, kp, radius, rfs, rf_radius, violations):
    """SG's kernel over every keypoint (:func:`shot_grid`'s inputs, checked
    there)."""
    q, table = kp.shape[0], grid.packed_sorted
    extra = () if rfs is None else (rfs,)
    device = _kernels.require_cuda(kp, table, grid.cell_starts, grid.origin, *extra)
    if table.shape[0] >= 2 ** 30:
        raise ValueError("the SHOT grid kernel walks table rows as 32-bit ints (at most 2^30)")
    _check_counter(violations, device)
    kp, table = kp.contiguous(), table.contiguous()
    rfs_in = None if rfs is None else rfs.reshape(q, 9).contiguous()
    hist = torch.empty((q, SHOT_DIM), dtype=torch.float32, device=device)
    rfs_out = torch.empty((q, 3, 3), dtype=torch.float32, device=device) if rfs is None else None
    count = torch.empty(q, dtype=torch.int32, device=device)
    if q:
        # the walk's copy of the points, 16 B a row: one load a window slot
        xyz = torch.nn.functional.pad(table[:, :3], (0, 1))
        _kernels.launch(
            "shot_grid", device, table.data_ptr(), table.shape[1], xyz.data_ptr(),
            grid.cell_starts.data_ptr(), grid.origin.data_ptr(), grid.cell_size, *grid.dims,
            grid.halo, grid.window_cap, kp.data_ptr(), q, _kernels.ptr(rfs_in), float(radius),
            float(radius if rf_radius is None else rf_radius), hist.data_ptr(),
            _kernels.ptr(rfs_out), count.data_ptr(), _kernels.ptr(violations),
            checked=(table, kp, rfs_in, hist, rfs_out))
    return hist, rfs if rfs_out is None else rfs_out, count


def shot_finalize(desc, count, normalize, min_neighborhood_size):
    """L2-normalize, and zero the descriptors of neighborhoods with
    ≤ ``min_neighborhood_size`` points (the validity convention matching
    consumes)."""
    norm = torch.linalg.norm(desc, dim=-1, keepdim=True)
    live = norm > 0
    keep = (count > min_neighborhood_size)[:, None] & live
    if normalize:
        desc = desc / torch.where(live, norm, 1.0)
    return torch.where(keep, desc, 0.0)
