"""FPFH (Fast Point Feature Histograms) — port of ``shot_fpfh_tpu.models.fpfh``.

Algorithmic parity with the reference (descriptors/fpfh.py:16-117, Rusu et
al. 2009):

- Pass 1 (SPFH): for every cloud point, the Darboux-frame angles over its
  radius neighborhood (``ops.descriptor_bins.darboux_angles``: ``v`` kept
  unnormalized, so out-of-range α values are dropped as ``np.histogramdd``
  drops them), in a joint ``n_bins³`` histogram or three decorrelated 1-D
  histograms, divided by the neighborhood size (self included).
- Pass 2 (FPFH): ``FPFH(p) = SPFH(p) + (1/|N(p)|) Σ_j SPFH(p_j)/d_j``.

Routes, switched at ``ops.grid_hash.AUTO_GRID_MIN_POINTS`` cloud points
(read at call time):

- small clouds: brute radius search capped at the ``k_max`` nearest, SPFH
  in PyTorch, aggregation over the keypoints' neighborhoods searched the
  same way;
- large clouds: a halo-2 grid whose window holds every uncapped radius
  neighborhood; SPFH of every point in grid order in one kernel launch
  (``ops.spfh_fused.spfh_grid``: the runs, radius test, count and bins
  inside it; a grid without a cell-start table takes K8 + K4 in query
  chunks); the aggregation sums the neighbors' 1/d weighted SPFH
  rows over the same windows in K7's aggregation mode
  (``ops.radius_runs.fpfh_aggregate``: one launch a cloud; the reference
  leaves the gather and the sum to XLA).

Both routes run their passes over blocks of rows (``parallel.mesh``'s
``local_rows``/``gather_rows``), so ``parallel.sharded_fpfh`` and the fused
program's FPFH leg (``registration.fused``) run this code on each rank's
block: one device computes the one block of all rows.
"""

from __future__ import annotations

import torch

from .._device import resolve
from ..ops import grid_hash
from ..ops.descriptor_bins import darboux_angles
from ..ops.grid_hash import (
    HashGrid,
    build_grid,
    grid_radius_search,
    radius_search_with_values_auto,
)
from ..ops.neighbors import Neighborhoods, as_f32, radius_search
from ..ops.radius_runs import fpfh_aggregate
from ..ops.spfh_fused import spfh_from_angles, spfh_grid
from ..parallel.mesh import gather_rows, local_rows
from ..utils.perf import span, uploading

# queries per streamed SPFH chunk of compute_spfh's grid route: bounds the
# (chunk, k_max) Darboux intermediates
_SPFH_CHUNK = 1 << 14
# keypoints per aggregation chunk of the brute route
_KP_CHUNK = 256
# far sentinel of padded queries: an empty neighborhood, not the origin's
_FAR = 1.0e6


def _spfh_from_values(cloud, nrm, p_j, n_j, d, mask, radius, n_bins: int,
                      decorrelated: bool):
    """Count-normalized SPFH of ``cloud`` from its gathered ``(N, K)``
    neighbor points, normals, distances and mask."""
    diff = p_j - cloud[:, None, :]
    valid = mask & (d > 0)
    alpha, phi, theta = darboux_angles(
        diff[..., 0], diff[..., 1], diff[..., 2], n_j[..., 0], n_j[..., 1], n_j[..., 2],
        nrm[:, 0:1], nrm[:, 1:2], nrm[:, 2:3], torch.where(valid, d, 1.0))
    count = torch.clamp(mask.sum(-1), min=1).to(torch.float32)
    return spfh_from_angles(alpha, phi, theta, valid, n_bins, decorrelated) / count[:, None]


def compute_spfh(cloud_points, normals, radius, n_bins: int, k_max: int = 128,
                 decorrelated: bool = False, device=None):
    """SPFH for every cloud point: ``(spfh (N, D), neighborhoods)`` over the
    ``k_max`` nearest neighbors within ``radius``.  Large clouds stream
    query chunks through the grid search."""
    cloud = as_f32(cloud_points, resolve(device, cloud_points))
    nrm = as_f32(normals, cloud.device)
    n = cloud.shape[0]
    if n < grid_hash.AUTO_GRID_MIN_POINTS:
        nbr, vals = radius_search_with_values_auto(cloud, cloud, nrm, radius, k_max)
        spfh = _spfh_from_values(cloud, nrm, vals[..., :3], vals[..., 3:6], nbr.dist,
                                 nbr.mask, radius, n_bins, decorrelated)
        return spfh, nbr
    grid = build_grid(cloud, float(radius) / 2, extras=nrm, halo=2)
    spfh_parts, nbr_parts = [], []
    for s in range(0, n, _SPFH_CHUNK):
        nbr_c, vals = grid_radius_search(grid, cloud[s:s + _SPFH_CHUNK], radius, k_max,
                                         with_values=True)
        spfh_parts.append(_spfh_from_values(
            cloud[s:s + _SPFH_CHUNK], nrm[s:s + _SPFH_CHUNK], vals[..., :3], vals[..., 3:6],
            nbr_c.dist, nbr_c.mask, radius, n_bins, decorrelated))
        nbr_parts.append(nbr_c)
    nbr = Neighborhoods(*(torch.cat([getattr(p, f) for p in nbr_parts])
                          for f in ("idx", "dist", "mask")))
    return torch.cat(spfh_parts), nbr


def _spfh_window_sorted(grid: HashGrid, radius, n_bins: int, decorrelated: bool):
    """SPFH of every cloud point in grid-sorted order, ``(N, D)``
    (``ops.spfh_fused.spfh_grid`` over the table's own rows)."""
    table = grid.packed_sorted
    return spfh_grid(grid, table[:, :3], table[:, 3:6], radius, n_bins, decorrelated)


def _fpfh_window_aggregate(grid: HashGrid, spfh_sorted, kp_sorted_idx, radius):
    """FPFH(p) = SPFH(p) + (Σ_{j, d>0} SPFH(j)/d_j) / |N(p)| over each
    keypoint's grid window: K7's aggregation mode (``ops.radius_runs``)."""
    with span("fpfh.aggregate"):
        return fpfh_aggregate(grid, spfh_sorted, kp_sorted_idx, radius)


def _sorted_rows(grid: HashGrid, idx: torch.Tensor) -> torch.Tensor:
    """Original cloud indices ``idx`` as rows of ``grid``'s sorted table."""
    inv = torch.empty_like(grid.orig_idx)
    inv[grid.orig_idx] = torch.arange(grid.orig_idx.shape[0], device=idx.device)
    return inv[idx]


def _fpfh_searched(spfh, cloud, kp, radius, k_max: int):
    """FPFH of the keypoints ``kp`` (cloud indices) over their capped radius
    neighborhoods, searched again (pass 1 searched only this rank's rows)."""
    nbr = radius_search(cloud[kp], cloud, radius, k_max)
    m = nbr.mask & (nbr.dist > 0)
    weights = torch.where(m, 1.0 / torch.where(m, nbr.dist, 1.0), 0.0)
    acc = torch.einsum("ckd,ck->cd", spfh[nbr.idx], weights)
    count = torch.clamp(nbr.mask.sum(-1), min=1).to(torch.float32)
    return spfh[kp] + acc / count[:, None]


def compute_fpfh_descriptor(keypoint_indices, cloud_points, normals, radius,
                            n_bins: int = 5, decorrelated: bool = False, k_max: int = 128,
                            mesh=None, device=None) -> torch.Tensor:
    """FPFH of the keypoints (indices into the cloud): ``(n_keypoints,
    n_bins³)``, or ``(n_keypoints, 3·n_bins)`` when decorrelated (reference
    ``compute_fpfh_descriptor``, descriptors/fpfh.py:16-117).  ``k_max`` caps
    the brute route's neighborhoods; the grid route is uncapped.  With a
    ``mesh`` of more than one rank both passes shard over it
    (``parallel.sharded.sharded_fpfh``)."""
    if mesh is not None and mesh.devices.size > 1:
        from ..parallel.sharded import sharded_fpfh

        return sharded_fpfh(keypoint_indices, cloud_points, normals, radius, mesh,
                            n_bins=n_bins, k_max=k_max, decorrelated=decorrelated)
    cloud = as_f32(cloud_points, resolve(device, cloud_points))
    nrm = as_f32(normals, cloud.device)
    kp = torch.as_tensor(keypoint_indices)
    with uploading(kp, cloud.device):
        kp = kp.to(device=cloud.device, dtype=torch.int64)
    return _fpfh(cloud, nrm, kp.reshape(-1), radius, n_bins, decorrelated, k_max)


def _fpfh(cloud, nrm, kp, radius, n_bins: int, decorrelated: bool, k_max: int, mesh=None):
    """Both passes on the cloud's route (a halo-2 grid from
    ``AUTO_GRID_MIN_POINTS`` points up, built here), each rank computing
    its block of the keypoints (:func:`_fpfh_rows`); the FPFH rows are
    gathered after."""
    grid = None
    if cloud.shape[0] >= grid_hash.AUTO_GRID_MIN_POINTS:
        with span("spfh.grid"):
            grid = build_grid(cloud, float(radius) / 2, extras=nrm, halo=2)
        kp = _sorted_rows(grid, kp)
    out = _fpfh_rows(cloud, nrm, local_rows(kp, mesh), radius, n_bins, decorrelated, k_max,
                     mesh, grid)
    return gather_rows(out, kp.shape[0], mesh)


def _fpfh_rows(cloud, nrm, kp_rows, radius, n_bins: int, decorrelated: bool, k_max: int,
               mesh=None, grid: HashGrid | None = None):
    """FPFH of the keypoints ``kp_rows``, this rank's block of them (all of
    them without a mesh): rows of ``grid``'s sorted table when ``grid``
    (cell ``radius/2``, halo 2, carrying normals) is given, else cloud
    indices.  Pass 1 is the SPFH of the rank's block of the cloud's points
    (pad queries at the far sentinel: empty neighborhoods) — on a grid in
    its sorted order through the SPFH pass kernel (``spfh_grid``), else
    the capped brute search — and one ``all_gather`` of the ``(N, D)``
    table; pass 2 aggregates over the keypoints' neighborhoods found again
    (grid: K7's aggregation mode).  The staged FPFH (:func:`_fpfh`) and the fused program's FPFH leg
    (``registration.fused``) both run this."""
    n = cloud.shape[0]
    if grid is not None:
        table = grid.packed_sorted       # pass 1 in the grid's sorted order
        with span("spfh.pass"):
            spfh = spfh_grid(grid, local_rows(table[:, :3], mesh, fill=_FAR),
                             local_rows(table[:, 3:6], mesh), radius, n_bins, decorrelated)
        return _fpfh_window_aggregate(grid, gather_rows(spfh, n, mesh), kp_rows, radius)
    q = local_rows(cloud, mesh, fill=_FAR)
    nbr, vals = radius_search_with_values_auto(q, cloud, nrm, radius, k_max)
    spfh = _spfh_from_values(q, local_rows(nrm, mesh), vals[..., :3], vals[..., 3:6], nbr.dist,
                             nbr.mask, radius, n_bins, decorrelated)
    spfh = gather_rows(spfh, n, mesh)
    out = [_fpfh_searched(spfh, cloud, kp_rows[s:s + _KP_CHUNK], radius, k_max)
           for s in range(0, kp_rows.shape[0], _KP_CHUNK)]
    return torch.cat(out) if out else spfh.new_zeros((0, spfh.shape[1]))
