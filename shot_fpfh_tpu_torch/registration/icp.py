"""ICP fine registration — port of ``shot_fpfh_tpu.registration.icp``.

The scan is grid-subsampled once; each iteration moves it by the current
transform, finds every point's nearest ref point (a grid 1-NN with
``cell_size = d_max`` once the ref has ``AUTO_GRID_MIN_POINTS`` points or
more — exact for ICP, since a neighbor past ``d_max`` is no inlier anyway),
weights the inliers within ``d_max``, solves the increment, and composes it.
The loop stops after ``max_iter`` iterations or once the iteration's RMS is
below ``rms_threshold`` (that iteration's increment is still applied), and
reports how many iterations ran.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve
from ..core.solvers import solve_point_to_plane, solve_point_to_point
from ..core.subsampling import grid_subsample
from ..core.transform import RigidTransform
from ..ops.grid_hash import AUTO_GRID_MIN_POINTS, build_grid, grid_nearest_neighbor
from ..ops.neighbors import as_f32, nearest_neighbor


class IcpHostResult(NamedTuple):
    """``(transform, rms, has_converged, n_iters)`` — the reference's
    3-tuple plus the iteration count."""

    transform: RigidTransform
    rms: float
    has_converged: bool
    n_iters: int


def _icp(scan, ref, ref_normals, init: RigidTransform, d_max, voxel_size,
         max_iter, rms_threshold, device) -> IcpHostResult:
    ref_t = as_f32(ref, resolve(device, ref))
    scan_t = as_f32(scan, ref_t.device)
    sub = torch.as_tensor(grid_subsample(scan_t, voxel_size), device=ref_t.device)
    scan_sub = scan_t[sub]
    normals = None if ref_normals is None else as_f32(ref_normals, ref_t.device)
    grid = (build_grid(ref_t, float(d_max)) if ref_t.shape[0] >= AUTO_GRID_MIN_POINTS
            else None)
    tf = init.to(ref_t.device)
    rms = torch.tensor(float("inf"))
    done = False
    n_iters = 0
    while n_iters < max_iter and not done:
        moved = tf.apply(scan_sub)
        dist, nn = (grid_nearest_neighbor(grid, moved) if grid is not None
                    else nearest_neighbor(moved, ref_t))
        w = (dist <= d_max).to(torch.float32)
        wsum = torch.clamp(w.sum(), min=1.0)
        target = ref_t[nn]
        if normals is not None:
            delta = solve_point_to_plane(moved, target, normals[nn], w)
            residual = ((moved - target) * normals[nn]).sum(-1).abs()
            rms = (residual * w).sum() / wsum
        else:
            delta = solve_point_to_point(moved, target, w)
            # a grid window miss reports inf; its weight is 0 but 0·inf² is NaN
            safe = torch.where(w > 0, dist, torch.zeros_like(dist))
            rms = torch.sqrt((w * safe ** 2).sum() / wsum)
        tf = delta @ tf
        n_iters += 1
        done = bool(rms < rms_threshold)
    return IcpHostResult(tf, float(rms), done, n_iters)


def icp_point_to_point(scan, ref, transformation_init: RigidTransform, d_max: float,
                       voxel_size: float = 0.2, max_iter: int = 100,
                       rms_threshold: float = 1e-2, device=None) -> IcpHostResult:
    """Point-to-point ICP on a grid-subsampled scan (inlier RMS)."""
    return _icp(scan, ref, None, transformation_init, d_max, voxel_size,
                max_iter, rms_threshold, device)


def icp_point_to_plane(scan, ref, ref_normals, transformation_init: RigidTransform,
                       d_max: float, voxel_size: float = 0.2, max_iter: int = 50,
                       rms_threshold: float = 1e-2, device=None) -> IcpHostResult:
    """Point-to-plane ICP (RMS = mean |residual| over inliers, as the
    reference)."""
    return _icp(scan, ref, ref_normals, transformation_init, d_max, voxel_size,
                max_iter, rms_threshold, device)
