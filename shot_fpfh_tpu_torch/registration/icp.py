"""ICP fine registration — port of ``shot_fpfh_tpu.registration.icp``.

The scan is grid-subsampled once; each iteration moves it by the current
transform, finds every point's nearest ref point (a grid 1-NN with
``cell_size = d_max`` once the ref has ``AUTO_GRID_MIN_POINTS`` points or
more — exact for ICP, since a neighbor past ``d_max`` is no inlier anyway),
weights the inliers within ``d_max``, solves the increment, and composes it.
The loop stops after ``max_iter`` iterations or once the iteration's RMS is
below ``rms_threshold`` (that iteration's increment is still applied), and
reports how many iterations ran.

The loop's state lives on the device (:func:`icp_loop`, JAX's ``_icp_loop``
``lax.while_loop``): an iteration after ``done`` leaves it unchanged, so the
host enqueues ``ICP_BLOCK`` iterations at a time and reads ``done`` once a
block.  The staged ICP and the fused program (``registration.fused``) run
this one loop.  :func:`icp_point_to_point_with_sampling` is the reference's
legacy variant: each iteration aligns a fresh random subset and moves the
whole cloud.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve
from ..core.solvers import (
    point_to_plane_normal_eq,
    point_to_point_stats,
    solve_point_to_plane_from_normal_eq,
    solve_point_to_point,
    solve_point_to_point_from_stats,
)
from ..core.subsampling import grid_subsample
from ..core.transform import RigidTransform
from ..ops.grid_hash import AUTO_GRID_MIN_POINTS, build_grid, grid_nearest_neighbor
from ..ops.neighbors import as_f32, nearest_neighbor
from ..utils.perf import blocking, span, uploading

# iterations enqueued between two host reads of ``done``: a converged loop
# runs at most ICP_BLOCK - 1 no-op iterations, and a 50-iteration loop
# waits on the card 7 times instead of 50
ICP_BLOCK = 8


class IcpResult(NamedTuple):
    """The loop's final state, on the device: ``n_iters`` (int32),
    ``rms`` and ``has_converged`` are 0-d tensors."""

    transform: RigidTransform
    rms: torch.Tensor
    has_converged: torch.Tensor
    n_iters: torch.Tensor


class IcpHostResult(NamedTuple):
    """``(transform, rms, has_converged, n_iters)`` — the reference's
    3-tuple plus the iteration count."""

    transform: RigidTransform
    rms: float
    has_converged: bool
    n_iters: int


def _step(state, scan_sub, ref, ref_normals, d_max, rms_threshold, grid, weights, reduce):
    """One iteration of JAX's ``_icp_loop`` body, a no-op once ``done``.
    With ``reduce`` (a sum over the shards of the points) the solver runs
    on its summed statistics: point-to-plane's normal equations, or
    point-to-point's Kabsch sums."""
    i, rot, t, rms, done = state
    tf = RigidTransform(rot, t)
    moved = tf.apply(scan_sub)
    dist, nn = (grid_nearest_neighbor(grid, moved) if grid is not None
                else nearest_neighbor(moved, ref))
    w = (dist <= d_max).to(torch.float32)
    if weights is not None:
        w = w * weights
    target = ref[nn]
    if ref_normals is not None:
        nrm = ref_normals[nn]
        residual = ((moved - target) * nrm).sum(-1).abs()
        sums = (*point_to_plane_normal_eq(moved, target, nrm, w), (residual * w).sum(), w.sum())
        gtg, gth, r_sum, w_sum = sums if reduce is None else reduce(sums)
        delta = solve_point_to_plane_from_normal_eq(gtg, gth)
        new_rms = r_sum / torch.clamp(w_sum, min=1.0)
    else:
        # a grid window miss reports inf; its weight is 0 but 0·inf² is NaN
        safe = torch.where(w > 0, dist, torch.zeros_like(dist))
        if reduce is None:
            delta = solve_point_to_point(moved, target, w)
            w_sum, sq_sum = w.sum(), (w * safe ** 2).sum()
        else:
            w_sum, s_sum, r_sum, srt, sq_sum = reduce((
                *point_to_point_stats(moved, target, w), (w * safe ** 2).sum()))
            delta = solve_point_to_point_from_stats(w_sum, s_sum, r_sum, srt)
        new_rms = torch.sqrt(sq_sum / torch.clamp(w_sum, min=1.0))
    composed = delta @ tf
    live = ~done
    return (i + live.to(i.dtype), torch.where(live, composed.rotation, rot),
            torch.where(live, composed.translation, t), torch.where(live, new_rms, rms),
            torch.where(live, new_rms < rms_threshold, done))


def icp_loop(scan_sub, ref, ref_normals, init: RigidTransform, d_max: float, max_iter: int,
             rms_threshold: float, grid=None, weights=None, reduce=None) -> IcpResult:
    """ICP from ``init`` on the points ``scan_sub`` (every tensor on one
    device): point-to-plane with ``ref_normals``, point-to-point without;
    1-NN through ``grid`` (a grid of the ref at cell ``d_max``) or brute
    force.  ``weights``: optional per-point validity (0 on padding rows).
    ``reduce``: for ``scan_sub`` a shard of the points, a function summing
    a tuple of tensors over the shards (``parallel.sharded.sharded_icp``);
    every shard then solves the same increment and stops at the same
    iteration.  Iterates while fewer than ``max_iter`` ran and the last RMS
    was not below ``rms_threshold``; the state stays on the device and the
    host reads ``done`` once every ``ICP_BLOCK`` iterations."""
    dev = scan_sub.device
    state = (torch.zeros((), dtype=torch.int32, device=dev),
             init.rotation.to(device=dev, dtype=torch.float32),
             init.translation.to(device=dev, dtype=torch.float32),
             torch.full((), float("inf"), dtype=torch.float32, device=dev),
             torch.zeros((), dtype=torch.bool, device=dev))
    issued = 0
    while issued < max_iter:
        block = min(ICP_BLOCK, max_iter - issued)
        with span("icp.block"):
            for _ in range(block):
                state = _step(state, scan_sub, ref, ref_normals, d_max, rms_threshold, grid,
                              weights, reduce)
            issued += block
            with blocking("icp.done"):
                done = bool(state[4])
        if done:
            break
    i, rot, t, rms, done = state
    return IcpResult(RigidTransform(rot, t), rms, done, i)


def nn_grid(ref: torch.Tensor, d_max: float):
    """The grid of the ref that ICP's 1-NN runs over (cell ``d_max``), from
    ``AUTO_GRID_MIN_POINTS`` ref points up; None (brute force) below."""
    return build_grid(ref, float(d_max)) if ref.shape[0] >= AUTO_GRID_MIN_POINTS else None


def _icp(scan, ref, ref_normals, init: RigidTransform, d_max, voxel_size,
         max_iter, rms_threshold, device) -> IcpHostResult:
    ref_t = as_f32(ref, resolve(device, ref))
    scan_t = as_f32(scan, ref_t.device)
    with span("icp.subsample"):
        sub = grid_subsample(scan_t, voxel_size)
        with uploading(sub, ref_t.device):
            sub = torch.as_tensor(sub, device=ref_t.device)
    normals = None if ref_normals is None else as_f32(ref_normals, ref_t.device)
    with span("icp.grid"):
        grid = nn_grid(ref_t, d_max)
    out = icp_loop(scan_t[sub], ref_t, normals, init, d_max, max_iter, rms_threshold, grid)
    with blocking("icp.result"):
        rms = float(out.rms)
    with blocking("icp.result"):
        converged = bool(out.has_converged)
    with blocking("icp.result"):
        n_iters = int(out.n_iters)
    return IcpHostResult(out.transform, rms, converged, n_iters)


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


def icp_point_to_point_with_sampling(scan, ref, d_max: float, max_iter: int = 100,
                                     rms_threshold: float = 1e-2, sampling_limit: int = 100,
                                     generator: torch.Generator | None = None, subsets=None,
                                     device=None) -> tuple[np.ndarray, float, bool]:
    """Legacy random-sampling point-to-point ICP (reference
    ``icp_point_to_point_with_sampling``, icp.py:20-78): each iteration
    draws ``min(sampling_limit, N)`` distinct scan points (from
    ``generator``, else one seeded 0 on the call's device), aligns them to
    their brute-force nearest ref points within ``d_max``, and moves the
    whole cloud; it stops once the inlier RMS is below ``rms_threshold``.
    ``subsets`` (one index array per iteration) replaces the draws.
    Returns ``(moved points, rms, rms < rms_threshold)`` on the host."""
    ref_t = as_f32(ref, resolve(device, ref))
    points = as_f32(scan, ref_t.device)
    n = points.shape[0]
    limit = min(sampling_limit, n)
    if generator is None and subsets is None:
        generator = torch.Generator(device=ref_t.device).manual_seed(0)
    rms = float("inf")
    for i in range(max_iter):
        idx = (torch.as_tensor(np.asarray(subsets[i]), device=ref_t.device)
               if subsets is not None
               else torch.randperm(n, generator=generator, device=ref_t.device)[:limit])
        subset = points[idx]
        dist, nn = nearest_neighbor(subset, ref_t)
        w = (dist <= d_max).to(torch.float32)
        tf = solve_point_to_point(subset, ref_t[nn], w)
        rms = float(torch.sqrt((w * dist ** 2).sum() / torch.clamp(w.sum(), min=1.0)))
        points = tf.apply(points)
        if rms < rms_threshold:
            break
    return points.cpu().numpy(), rms, rms < rms_threshold
