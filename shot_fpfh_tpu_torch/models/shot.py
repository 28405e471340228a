"""Single-scale SHOT descriptors — port of ``shot_fpfh_tpu.models.shot``.

352 bins = 11 cosine x 8 azimuth x 2 elevation x 2 radial, with the
reference's bin conventions (``ops.descriptor_bins``) and true accumulation
of every contribution.  Two routes, switched at ``AUTO_GRID_MIN_POINTS``
support points like the reference:

- small supports: brute radius search capped at the ``k_max`` nearest,
  frames by :func:`local_reference_frames`, histogram in PyTorch;
- large supports: a halo-2 grid window per keypoint holding the exact,
  uncapped radius neighborhood, frames + binning + histogram in the K1
  kernel (``ops.shot_fused``).

Descriptors of neighborhoods with ≤ ``min_neighborhood_size`` points are
all-zero, the validity convention matching consumes.  Bi-scale and
multiscale SHOT are not ported yet (ROADMAP.md, Queue 1, item 12).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve
from .._fp import sqnorm3
from ..core.subsampling import grid_subsample
from ..ops.grid_hash import (
    AUTO_GRID_MIN_POINTS,
    build_grid,
    query_chunk,
    window_distances,
)
from ..ops.neighbors import as_f32, radius_search
from ..ops.shot_fused import local_frames as _local_rfs_ff
from ..ops.shot_fused import shot_binning_histogram, soft_histogram

# far sentinel of padded keypoints: its window is empty, so its descriptor
# is zero (the reference pads keypoint sets into 1024-row buckets with it)
_FAR = 1.0e6


def _masked_offsets(keypoints, neighbor_points, mask):
    """``(centered (Q, K, 3) zeroed where masked out, rho (Q, K))``."""
    centered = torch.where(mask[..., None], neighbor_points - keypoints[:, None, :], 0.0)
    return centered, torch.sqrt(sqnorm3(centered[..., 0], centered[..., 1], centered[..., 2]))


def local_reference_frames(keypoints, neighbor_points, mask, radius) -> torch.Tensor:
    """SHOT frames of gathered ``(Q, K, 3)`` neighborhoods (columns x, y, z;
    identity for an empty neighborhood)."""
    centered, rho = _masked_offsets(keypoints, neighbor_points, mask)
    return _local_rfs_ff(centered.transpose(1, 2), rho, mask, radius)


def _shot_finalize(desc, count, normalize, min_neighborhood_size):
    """L2-normalize, and zero the descriptors of neighborhoods with
    ≤ ``min_neighborhood_size`` points."""
    norm = torch.linalg.norm(desc, dim=-1, keepdim=True)
    keep = (count > min_neighborhood_size)[:, None] & (norm > 0)
    if normalize:
        desc = desc / torch.where(norm > 0, norm, torch.ones_like(norm))
    return torch.where(keep, desc, torch.zeros_like(desc))


def _shot_accumulate(lx, ly, lz, rho, cosine, valid, radius, normalize,
                     min_neighborhood_size):
    """Binning + histogram + finalization from per-neighbor ``(Q, K)``
    local coordinates, distances, cosines and validity."""
    desc = soft_histogram(lx, ly, lz, rho, cosine, valid, radius)
    return _shot_finalize(desc, valid.sum(-1), normalize, min_neighborhood_size)


def shot_from_neighborhoods(keypoints, neighbor_points, neighbor_normals, mask,
                            local_rfs, radius, normalize: bool = True,
                            min_neighborhood_size: int = 100) -> torch.Tensor:
    """SHOT from gathered ``(Q, K, 3)`` neighborhoods and given frames."""
    centered, rho = _masked_offsets(keypoints, neighbor_points, mask)
    valid = mask & (rho > 0)
    local = torch.einsum("qki,qij->qkj", centered, local_rfs)
    cosine = torch.clamp(
        torch.einsum("qki,qi->qk", neighbor_normals, local_rfs[..., :, 2]), -1.0, 1.0)
    return _shot_accumulate(local[..., 0], local[..., 1], local[..., 2], rho,
                            cosine, valid, radius, normalize, min_neighborhood_size)


def shot_from_window_ff(keypoints, window_vals, window_dist, radius,
                        normalize: bool = True, min_neighborhood_size: int = 100,
                        local_rfs=None):
    """SHOT from a feature-first window (``(Q, F≥6, W)`` values,
    distance-or-inf ``(Q, W)``) through the K1 kernel; returns
    ``(descriptors (Q, 352), frames (Q, 3, 3))``."""
    if local_rfs is None:
        hist, rfs = shot_binning_histogram(window_vals, window_dist, keypoints, None, radius)
    else:
        rfs = local_rfs
        hist = shot_binning_histogram(window_vals, window_dist, keypoints, rfs, radius)
    count = (torch.isfinite(window_dist) & (window_dist > 0)).sum(-1)
    return _shot_finalize(hist, count, normalize, min_neighborhood_size), rfs


def _shot_window_chunked(grid, kp, local_rfs, radius, normalize,
                         min_neighborhood_size):
    """Grid-window SHOT over keypoint chunks: the window carries the exact
    uncapped radius neighborhood (no top-k, no ``k_max``)."""
    descs, frames = [], []
    step = min(4096, query_chunk(grid, 8))
    inf = float("inf")
    for s in range(0, kp.shape[0], step):
        qc = kp[s:s + step]
        vals, d, valid, _ = window_distances(grid, qc)
        dist_inf = torch.where(valid & (d <= radius), d, torch.full_like(d, inf))
        desc, rfs = shot_from_window_ff(
            qc, vals, dist_inf, radius, normalize=normalize,
            min_neighborhood_size=min_neighborhood_size,
            local_rfs=None if local_rfs is None else local_rfs[s:s + step])
        descs.append(desc)
        frames.append(rfs)
    return torch.cat(descs), torch.cat(frames)


def compute_shot_descriptor(keypoints, support_points, support_normals, radius, *,
                            k_max: int = 512, normalize: bool = True,
                            min_neighborhood_size: int = 100, local_rfs=None,
                            device=None):
    """Single-scale SHOT of ``keypoints`` on a support cloud; returns
    ``((Q, 352) descriptors, (Q, 3, 3) frames)``."""
    sup = as_f32(support_points, resolve(device, support_points))
    nrm = as_f32(support_normals, sup.device)
    kp = as_f32(keypoints, sup.device)
    if sup.shape[0] >= AUTO_GRID_MIN_POINTS:
        grid = build_grid(sup, float(radius) / 2, extras=nrm, halo=2)
        return _shot_window_chunked(grid, kp, local_rfs, radius, normalize,
                                    min_neighborhood_size)
    nbr = radius_search(kp, sup, radius, k_max)
    nb_pts = torch.where(nbr.mask[..., None], sup[nbr.idx], 0.0)
    nb_nrm = torch.where(nbr.mask[..., None], nrm[nbr.idx], 0.0)
    if local_rfs is None:
        local_rfs = local_reference_frames(kp, nb_pts, nbr.mask, radius)
    desc = shot_from_neighborhoods(kp, nb_pts, nb_nrm, nbr.mask, local_rfs, radius,
                                   normalize=normalize,
                                   min_neighborhood_size=min_neighborhood_size)
    return desc, local_rfs


class ShotComputer:
    """Single-scale SHOT front end (the reference's ``ShotMultiprocessor``):
    keypoints are one batch on the device, padded into ``pad_queries_to``
    buckets with the far sentinel."""

    def __init__(self, normalize: bool = True, min_neighborhood_size: int = 100,
                 k_max: int = 512, pad_queries_to: int = 1024, device=None):
        self.normalize = normalize
        self.min_neighborhood_size = min_neighborhood_size
        self.k_max = k_max
        self.pad_queries_to = pad_queries_to
        self.device = device

    def _support(self, point_cloud, normals, voxel_size):
        pts = as_f32(point_cloud, resolve(self.device, point_cloud))
        nrm = as_f32(normals, pts.device)
        if voxel_size is None:
            return pts, nrm
        sel = torch.as_tensor(grid_subsample(pts, voxel_size), device=pts.device)
        return pts[sel], nrm[sel]

    def _pad(self, keypoints):
        kp = np.asarray(keypoints.cpu() if isinstance(keypoints, torch.Tensor)
                        else keypoints, np.float32)
        m = max(self.pad_queries_to, 1)
        padded = ((len(kp) + m - 1) // m) * m
        if padded == len(kp):
            return kp, len(kp)
        far = np.full((padded - len(kp), 3), _FAR, np.float32)
        return np.concatenate([kp, far]), len(kp)

    def compute_descriptor_single_scale(self, point_cloud, normals, keypoints,
                                        radius, subsampling_voxel_size=None):
        sup, nrm = self._support(point_cloud, normals, subsampling_voxel_size)
        kp, n_kp = self._pad(keypoints)
        desc, _ = compute_shot_descriptor(
            kp, sup, nrm, radius, k_max=self.k_max, normalize=self.normalize,
            min_neighborhood_size=self.min_neighborhood_size, device=sup.device)
        return desc[:n_kp]
