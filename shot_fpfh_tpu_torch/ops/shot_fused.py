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
"""

from __future__ import annotations

import torch

from .. import _kernels
from .descriptor_bins import N_LO, SHOT_DIM, shot_soft_bins
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


def soft_histogram(lx, ly, lz, rho, cosine, valid, radius) -> torch.Tensor:
    """Unnormalized ``(Q, 352)`` SHOT histograms from per-neighbor ``(Q, K)``
    local coordinates, distances, normal cosines and validity: each valid
    neighbor adds its five merged soft-bin weights."""
    rho_safe = torch.where(valid, rho, torch.ones_like(rho))
    theta = torch.atan2(ly, lx)
    phi = torch.acos(torch.clamp(lz / rho_safe, -1.0, 1.0))
    sb = shot_soft_bins(lx, ly, lz, rho, theta, phi, cosine, radius)
    vf = valid.to(torch.float32)
    q = lx.shape[0]
    row = (torch.arange(q, device=lx.device) * SHOT_DIM)[:, None]
    hi = sb.cos_bin.to(torch.int64) * N_LO + row
    hi_nb = sb.cos_nb.to(torch.int64) * N_LO + row
    idx = torch.cat([(hi + sb.base).reshape(-1), (hi + sb.lo_husk).reshape(-1),
                     (hi + sb.lo_vert).reshape(-1), (hi + sb.lo_az).reshape(-1),
                     (hi_nb + sb.base).reshape(-1)])
    wts = torch.cat([(sb.w_same * vf).reshape(-1), (sb.w_husk_nb * vf).reshape(-1),
                     (sb.w_vert_nb * vf).reshape(-1), (sb.abs_az * vf).reshape(-1),
                     (sb.abs_cos * vf).reshape(-1)])
    hist = torch.zeros(q * SHOT_DIM, dtype=torch.float32, device=lx.device)
    return hist.index_add_(0, idx, wts).reshape(q, SHOT_DIM)


def shot_binning_histogram_plain(vals, dist_inf, keypoints, rfs, radius, rf_dist_inf=None,
                                 rf_radius=None):
    """PyTorch twin of the kernel: ``hist`` given ``rfs``, or
    ``(hist, rfs)`` when ``rfs`` is None (frames from the window, or from
    the ``rf_dist_inf`` plane with ``rf_radius`` when it is given)."""
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
    hist = soft_histogram(lx, ly, lz, rho, cosine, ok & (rho > 0), radius)
    return (hist, frames) if rfs is None else hist


def shot_binning_histogram(vals: torch.Tensor, dist_inf: torch.Tensor,
                           keypoints: torch.Tensor, rfs, radius: float, rf_dist_inf=None,
                           rf_radius=None):
    """Unnormalized ``(Q, 352)`` SHOT histograms of a window; with
    ``rfs=None`` the frames are computed too and ``(hist, rfs)`` returned,
    from ``rf_dist_inf`` with ``rf_radius`` (bi-scale) when it is given."""
    if rfs is not None:
        rf_dist_inf = None
    if rf_dist_inf is not None and rf_radius is None:
        raise ValueError("rf_dist_inf needs rf_radius")
    if vals.device.type == "cpu":
        return shot_binning_histogram_plain(vals, dist_inf, keypoints, rfs, radius,
                                            rf_dist_inf, rf_radius)
    tensors = [vals, dist_inf, keypoints] + [t for t in (rfs, rf_dist_inf) if t is not None]
    device = _kernels.require_cuda(*tensors)
    q, nf, w = vals.shape
    if (nf < 6 or dist_inf.shape != (q, w) or keypoints.shape != (q, 3)
            or (rf_dist_inf is not None and rf_dist_inf.shape != (q, w))):
        raise ValueError(f"bad window shapes {tuple(vals.shape)}, "
                         f"{tuple(dist_inf.shape)}, {tuple(keypoints.shape)}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("SHOT kernel inputs must be float32")
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
        float(radius if rf_radius is None else rf_radius))
    return (hist, rfs_out) if rfs is None else hist


def shot_finalize(desc, count, normalize, min_neighborhood_size):
    """L2-normalize, and zero the descriptors of neighborhoods with
    ≤ ``min_neighborhood_size`` points (the validity convention matching
    consumes)."""
    norm = torch.linalg.norm(desc, dim=-1, keepdim=True)
    keep = (count > min_neighborhood_size)[:, None] & (norm > 0)
    if normalize:
        desc = desc / torch.where(norm > 0, norm, torch.ones_like(norm))
    return torch.where(keep, desc, torch.zeros_like(desc))
