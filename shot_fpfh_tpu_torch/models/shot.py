"""SHOT descriptors, single-, bi- and multiscale — port of
``shot_fpfh_tpu.models.shot``.

352 bins = 11 cosine x 8 azimuth x 2 elevation x 2 radial, with the
reference's bin conventions (``ops.descriptor_bins``) and true accumulation
of every contribution.  Two routes, switched at
``ops.grid_hash.AUTO_GRID_MIN_POINTS`` support points (read at call time)
like the reference:

- small supports: brute radius search capped at the ``k_max`` nearest,
  frames by :func:`local_reference_frames`, histogram in PyTorch;
- large supports: a halo-2 grid holding the exact, uncapped radius
  neighborhood of every keypoint, frames + binning + histogram in a kernel:
  SG (``ops.shot_fused.shot_grid``): on the card straight over the grid's
  z-column runs, one launch a cloud, and on CPU tensors or a grid without
  a cell table K1 over gathered ``(Q, F, W)`` windows in keypoint chunks.

Given the frames' neighborhoods (``compute_shot_descriptor(
local_rf_neighborhoods=)``), the bins come from the ``k_max``-capped radius
neighborhoods at any support size (the brute search, or from
``AUTO_GRID_MIN_POINTS`` points the halo-2 grid search through K7), binned
by K1 in its given-frames mode over them.

Bi-scale SHOT takes its frames from the ``local_rf_radius`` neighborhood
and its bins from the ``shot_radius`` one; multiscale SHOT concatenates
per-scale descriptors, each on its own subsampled support, optionally
sharing the first scale's frames.  Descriptors of neighborhoods with
≤ ``min_neighborhood_size`` points are all-zero, the validity convention
matching consumes.

``enable_debug_checks`` (the CLI's ``--debug_shot``) makes every SHOT
accumulation count its out-of-range bin indices and unsound weight sums
among valid neighbors, read the counts back and log them.  The routes stay
as they are: the brute route's PyTorch binning counts them, and on the grid
route SG and K1 count them in the kernel (``ops.shot_fused``), so the
checks see the bins the card computes.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .._device import resolve
from .._fp import sqnorm3, sqrt
from ..core.subsampling import grid_subsample
from ..ops import grid_hash
from ..ops.grid_hash import build_grid, radius_search_with_values_auto, window_chunk
from ..ops.neighbors import Neighborhoods, as_f32, radius_search
from ..ops.shot_fused import local_frames as _local_rfs_ff
from ..ops.shot_fused import binning_violations as _binning_violations  # noqa: F401
from ..ops.shot_fused import shot_binning_histogram, shot_finalize, shot_grid, soft_histogram
from ..utils.perf import blocking, span, uploading

logger = logging.getLogger(__name__)

# far sentinel of padded keypoints: its window is empty, so its descriptor
# is zero (the reference pads keypoint sets into 1024-row buckets with it)
_FAR = 1.0e6


# the SHOT binning sanity checks of the CLI's --debug_shot (the
# reference's sequential-SHOT debug_mode asserts, shot.py:375-379,414-463)
_DEBUG = {"enabled": False, "violations": 0}


def enable_debug_checks(enabled: bool = True) -> None:
    """Turn the SHOT binning sanity checks on or off; resets the count."""
    _DEBUG["enabled"] = enabled
    _DEBUG["violations"] = 0


def debug_violation_count() -> int:
    """Violations counted since the checks were last turned on."""
    return _DEBUG["violations"]


def _debug_report(n_bad_bin, n_bad_weight) -> None:
    n = int(n_bad_bin) + int(n_bad_weight)
    if n:
        _DEBUG["violations"] += n
        logger.warning(
            "SHOT debug checks: %d out-of-range bin indices, %d unsound "
            "quadrilinear weight sums among valid neighbors",
            int(n_bad_bin), int(n_bad_weight))


def _debug_counter(device):
    """A zeroed ``(bad bins, bad weights)`` counter for one accumulation
    while the checks are on, else None (no op, no sync)."""
    return torch.zeros(2, dtype=torch.int32, device=device) if _DEBUG["enabled"] else None


def _debug_read(counter) -> None:
    """Read one accumulation's counter back to the host and report it."""
    if counter is not None:
        _debug_report(*counter.tolist())


def _masked_offsets(keypoints, neighbor_points, mask):
    """``(centered (Q, K, 3) zeroed where masked out, rho (Q, K))``."""
    centered = torch.where(mask[..., None], neighbor_points - keypoints[:, None, :], 0.0)
    return centered, sqrt(sqnorm3(centered[..., 0], centered[..., 1], centered[..., 2]))


def local_reference_frames(keypoints, neighbor_points, mask, radius) -> torch.Tensor:
    """SHOT frames of gathered ``(Q, K, 3)`` neighborhoods (columns x, y, z;
    identity for an empty neighborhood)."""
    centered, rho = _masked_offsets(keypoints, neighbor_points, mask)
    return _local_rfs_ff(centered.transpose(1, 2), rho, mask, radius)


def _shot_accumulate(lx, ly, lz, rho, cosine, valid, radius, normalize,
                     min_neighborhood_size):
    """Binning + histogram + finalization from per-neighbor ``(Q, K)``
    local coordinates, distances, cosines and validity."""
    counter = _debug_counter(lx.device)
    desc = soft_histogram(lx, ly, lz, rho, cosine, valid, radius, counter)
    _debug_read(counter)
    return shot_finalize(desc, valid.sum(-1), normalize, min_neighborhood_size)


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
                        local_rfs=None, rf_dist_inf=None, rf_radius=None):
    """SHOT from a feature-first window (``(Q, F≥6, W)`` values,
    distance-or-inf ``(Q, W)``) through the K1 kernel; returns
    ``(descriptors (Q, 352), frames (Q, 3, 3))``.  Bi-scale: the frames come
    from the ``rf_dist_inf``/``rf_radius`` plane over the same window."""
    counter = _debug_counter(window_vals.device)
    out = shot_binning_histogram(window_vals, window_dist, keypoints, local_rfs, radius,
                                 rf_dist_inf=rf_dist_inf, rf_radius=rf_radius,
                                 violations=counter)
    _debug_read(counter)
    hist, rfs = out if local_rfs is None else (out, local_rfs)
    count = (torch.isfinite(window_dist) & (window_dist > 0)).sum(-1)
    return shot_finalize(hist, count, normalize, min_neighborhood_size), rfs


def _shot_on_grid(grid, kp, local_rfs, radius, normalize, min_neighborhood_size,
                  rf_radius=None):
    """Grid SHOT through SG (``ops.shot_fused.shot_grid``), which takes its
    kernel over the z-column runs on CUDA tensors and a grid with a
    cell-start table, and K1 over gathered windows in keypoint chunks of
    ``window_chunk``'s size otherwise.  Either takes the exact uncapped
    radius neighborhood (no top-k, no ``k_max``); bi-scale frames come from
    the ``rf_radius`` neighbors of the same grid.  ``shot_grid`` opens the
    spans and counts ``grid_passes`` or ``chunks``."""
    counter = _debug_counter(kp.device)
    hist, frames, count = shot_grid(grid, kp, radius, rfs=local_rfs, rf_radius=rf_radius,
                                    violations=counter, chunk=window_chunk(grid, 8))
    desc = shot_finalize(hist, count, normalize, min_neighborhood_size)
    _debug_read(counter)
    return desc, frames


def _shot_routed(kp, sup, nrm, radius, *, k_max: int, normalize: bool,
                 min_neighborhood_size: int, local_rfs=None, rf_radius=None,
                 use_grid: bool | None = None):
    """SHOT of the keypoints ``kp`` on the support's route (the grid from
    ``AUTO_GRID_MIN_POINTS`` support points, or ``use_grid``); returns
    ``(descriptors, frames)``.  Frames: ``local_rfs`` when given, else from
    the ``rf_radius`` neighborhoods (bi-scale; the grid's cell then covers
    both radii), else from the ``radius`` ones.  The one-device entry
    points and ``parallel.sharded_shot_descriptors`` (on a rank's block of
    keypoints) all run this."""
    rf_radius = None if local_rfs is not None else rf_radius
    if use_grid is None:
        use_grid = sup.shape[0] >= grid_hash.AUTO_GRID_MIN_POINTS
    if use_grid:
        max_r = float(radius) if rf_radius is None else float(max(radius, rf_radius))
        with span("shot.grid"):
            grid = build_grid(sup, max_r / 2, extras=nrm, halo=2)
        return _shot_on_grid(grid, kp, local_rfs, radius, normalize, min_neighborhood_size,
                             rf_radius=rf_radius)
    if rf_radius is not None:
        rf_nbr = radius_search(kp, sup, rf_radius, k_max)
        local_rfs = local_reference_frames(kp, sup[rf_nbr.idx], rf_nbr.mask, rf_radius)
    nbr = radius_search(kp, sup, radius, k_max)
    nb_pts = torch.where(nbr.mask[..., None], sup[nbr.idx], 0.0)
    nb_nrm = torch.where(nbr.mask[..., None], nrm[nbr.idx], 0.0)
    if local_rfs is None:
        local_rfs = local_reference_frames(kp, nb_pts, nbr.mask, radius)
    desc = shot_from_neighborhoods(kp, nb_pts, nb_nrm, nbr.mask, local_rfs, radius,
                                   normalize=normalize,
                                   min_neighborhood_size=min_neighborhood_size)
    return desc, local_rfs


def _shot_given_neighborhoods(kp, sup, nrm, radius, rf_nbr: Neighborhoods, *, k_max: int,
                              normalize: bool, min_neighborhood_size: int, local_rfs=None):
    """SHOT with the frames' neighborhoods given (JAX ``models/shot.py:
    536-545``): the ``k_max``-capped radius neighborhoods of the support at
    any size (brute, or from ``AUTO_GRID_MIN_POINTS`` points the halo-2
    grid through K7), the frames over ``rf_nbr`` (rows of the support as
    passed) unless ``local_rfs`` is given, then K1 in given-frames mode
    over the neighborhoods as its window."""
    nbr, vals = radius_search_with_values_auto(kp, sup, nrm, radius, k_max)
    if local_rfs is None:
        idx = torch.as_tensor(rf_nbr.idx, device=sup.device).long()
        mask = torch.as_tensor(rf_nbr.mask, device=sup.device).bool()
        local_rfs = local_reference_frames(kp, sup[idx], mask, radius)
    return shot_from_window_ff(kp, vals.transpose(1, 2), nbr.dist, radius,
                               normalize=normalize,
                               min_neighborhood_size=min_neighborhood_size,
                               local_rfs=as_f32(local_rfs, sup.device))


def compute_shot_descriptor(keypoints, support_points, support_normals, radius, *,
                            k_max: int = 512, normalize: bool = True,
                            min_neighborhood_size: int = 100, local_rfs=None,
                            local_rf_neighborhoods: Neighborhoods | None = None,
                            device=None):
    """Single-scale SHOT of ``keypoints`` on a support cloud; returns
    ``((Q, 352) descriptors, (Q, 3, 3) frames)``.  Given frames
    (``local_rfs``) win over given frame neighborhoods
    (``local_rf_neighborhoods``, which take the ``k_max``-capped route at
    any support size)."""
    sup = as_f32(support_points, resolve(device, support_points))
    nrm = as_f32(support_normals, sup.device)
    kp = as_f32(keypoints, sup.device)
    opts = dict(k_max=k_max, normalize=normalize, min_neighborhood_size=min_neighborhood_size,
                local_rfs=local_rfs)
    if local_rf_neighborhoods is not None:
        return _shot_given_neighborhoods(kp, sup, nrm, radius, local_rf_neighborhoods, **opts)
    return _shot_routed(kp, sup, nrm, radius, **opts)


class ShotComputer:
    """Single-, bi- and multiscale SHOT front end (the reference's
    ``ShotMultiprocessor``): keypoints are one batch on the device, padded
    into ``pad_queries_to`` buckets with the far sentinel.  With a ``mesh``
    of more than one rank every scale shards the keypoints over it
    (``parallel.sharded.sharded_shot_descriptors``) on the rank's device."""

    def __init__(self, normalize: bool = True, share_local_rfs: bool = True,
                 min_neighborhood_size: int = 100, k_max: int = 512, verbose: bool = True,
                 pad_queries_to: int = 1024, mesh=None, device=None):
        self.normalize = normalize
        self.share_local_rfs = share_local_rfs
        self.min_neighborhood_size = min_neighborhood_size
        self.k_max = k_max
        self.verbose = verbose   # the reference's flag: stored, read by nothing
        self.pad_queries_to = pad_queries_to
        self.mesh = mesh
        self.device = mesh.device if device is None and mesh is not None else device

    def _use_mesh(self) -> bool:
        return self.mesh is not None and self.mesh.devices.size > 1

    def _support(self, point_cloud, normals, voxel_size):
        with span("shot.support"):
            pts = as_f32(point_cloud, resolve(self.device, point_cloud))
            nrm = as_f32(normals, pts.device)
            if voxel_size is None:
                return pts, nrm
            sel = grid_subsample(pts, voxel_size)
            with uploading(sel, pts.device):
                sel = torch.as_tensor(sel, device=pts.device)
            return pts[sel], nrm[sel]

    def _pad(self, keypoints):
        with span("shot.pad"):
            if isinstance(keypoints, torch.Tensor) and keypoints.is_cuda:
                with blocking("shot.keypoints"):
                    keypoints = keypoints.cpu()
            kp = np.asarray(keypoints, np.float32)
            m = max(self.pad_queries_to, 1)
            padded = ((len(kp) + m - 1) // m) * m
            if padded == len(kp):
                return kp, len(kp)
            far = np.full((padded - len(kp), 3), _FAR, np.float32)
            return np.concatenate([kp, far]), len(kp)

    def _shot(self, kp, sup, nrm, radius, local_rfs=None, rf_radius=None):
        """``(descriptors, frames)`` of the keypoints: on one device, or
        sharded over the mesh (the frames returned stay on the rank)."""
        opts = dict(k_max=self.k_max, normalize=self.normalize,
                    min_neighborhood_size=self.min_neighborhood_size, rf_radius=rf_radius)
        if self._use_mesh():
            from ..parallel.sharded import sharded_shot_descriptors

            return sharded_shot_descriptors(kp, sup, nrm, radius, self.mesh,
                                            shared_rfs=local_rfs, return_rfs=True, **opts)
        return _shot_routed(as_f32(kp, sup.device), sup, nrm, radius, local_rfs=local_rfs,
                            **opts)

    def compute_descriptor_single_scale(self, point_cloud, normals, keypoints,
                                        radius, subsampling_voxel_size=None):
        sup, nrm = self._support(point_cloud, normals, subsampling_voxel_size)
        kp, n_kp = self._pad(keypoints)
        desc, _ = self._shot(kp, sup, nrm, radius)
        return desc[:n_kp]

    def compute_descriptor_bi_scale(self, point_cloud, normals, keypoints,
                                    local_rf_radius, shot_radius,
                                    subsampling_voxel_size=None):
        """Frames from the ``local_rf_radius`` neighborhoods, bins from the
        ``shot_radius`` ones (reference shot_parallelization.py:185-239).
        Large supports: one grid at ``max(local_rf_radius, shot_radius)/2``,
        halo 2, both planes over the same neighborhoods (SG's bi-scale
        mode); small supports: brute-searched frames, then SHOT with
        them given."""
        sup, nrm = self._support(point_cloud, normals, subsampling_voxel_size)
        kp, n_kp = self._pad(keypoints)
        desc, _ = self._shot(kp, sup, nrm, shot_radius, rf_radius=local_rf_radius)
        return desc[:n_kp]

    def compute_descriptor_multiscale(self, point_cloud, normals, keypoints, radii,
                                      voxel_sizes=None, weights=None):
        """Concatenated per-scale descriptors ``(Q, 352·n_scales)``, each
        scale on its own support (subsampled at ``voxel_sizes[scale]``) and
        scaled by ``weights[scale]``; with ``share_local_rfs`` every scale
        takes the first scale's frames (reference
        shot_parallelization.py:241-312)."""
        if weights is None:
            weights = [1.0] * len(radii)
        kp, n_kp = self._pad(keypoints)
        descs, shared_rfs = [], None
        for scale, radius in enumerate(radii):
            voxel = None if voxel_sizes is None else voxel_sizes[scale]
            sup, nrm = self._support(point_cloud, normals, voxel)
            desc, rfs = self._shot(kp, sup, nrm, radius, local_rfs=shared_rfs)
            if self.share_local_rfs and shared_rfs is None:
                shared_rfs = rfs
            descs.append(desc * weights[scale])
        return torch.cat(descs, dim=1)[:n_kp]
