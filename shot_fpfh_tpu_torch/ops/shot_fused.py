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

Both take an optional ``violations`` counter (a zeroed ``(2,)`` int32
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
from .descriptor_bins import N_AZ, N_COS, N_ELEV, N_LO, N_RAD, SHOT_DIM, shot_soft_bins
from .eigh3 import eigh3x3


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


def shot_finalize(desc, count, normalize, min_neighborhood_size):
    """L2-normalize, and zero the descriptors of neighborhoods with
    ≤ ``min_neighborhood_size`` points (the validity convention matching
    consumes)."""
    norm = torch.linalg.norm(desc, dim=-1, keepdim=True)
    keep = (count > min_neighborhood_size)[:, None] & (norm > 0)
    if normalize:
        desc = desc / torch.where(norm > 0, norm, torch.ones_like(norm))
    return torch.where(keep, desc, torch.zeros_like(desc))
