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
this one loop.  Where its inputs allow (CUDA tensors, a grid with a
cell-start table, point-to-plane, one device's sums) an iteration is one
launch of IS (``csrc/icp_step.cu``: the move, the 1-NN walk, the normal
equations, the 6x6 solve and the composition on the card); every other
case runs :func:`_step`, its plain twin.
:func:`icp_point_to_point_with_sampling` is the reference's legacy
variant: each iteration aligns a fresh random subset and moves the whole
cloud.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels
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
from ..ops.radius_runs import nearest_lanes
from ..utils.perf import add_counts, blocking, span, uploading

# iterations enqueued between two host reads of ``done``: a converged loop
# runs at most ICP_BLOCK - 1 no-op iterations, and a 50-iteration loop
# waits on the card 7 times instead of 50
ICP_BLOCK = 8
# IS's grid: this many blocks an SM (as many as its launch bounds keep
# resident), whatever the point count, so a point's place in the float32
# sums depends on its index alone (zero-weight rows appended change no bit)
# and the launch's last block adds a few hundred partial rows
_IS_BLOCKS_PER_SM = 6


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
    on_card = _takes_kernel(scan_sub, ref_normals, grid, reduce)
    if on_card:
        state, step = _kernel_step(scan_sub, ref, ref_normals, init, d_max, rms_threshold, grid,
                                   weights)
    else:
        dev = scan_sub.device
        state = (torch.zeros((), dtype=torch.int32, device=dev),
                 init.rotation.to(device=dev, dtype=torch.float32),
                 init.translation.to(device=dev, dtype=torch.float32),
                 torch.full((), float("inf"), dtype=torch.float32, device=dev),
                 torch.zeros((), dtype=torch.bool, device=dev))

        def step(s):
            return _step(s, scan_sub, ref, ref_normals, d_max, rms_threshold, grid, weights,
                         reduce)
    issued = 0
    while issued < max_iter:
        block = min(ICP_BLOCK, max_iter - issued)
        with span("icp.block"):
            for _ in range(block):
                state = step(state)
            issued += block
            add_counts(icp_kernel_iters=block if on_card else 0)
            with blocking("icp.done"):
                done = bool(state[4])
        if done:
            break
    i, rot, t, rms, done = state
    return IcpResult(RigidTransform(rot, t), rms, done.bool(), i)


def _takes_kernel(scan_sub, ref_normals, grid, reduce) -> bool:
    """Whether IS runs the loop: CUDA tensors, a grid with a cell-start
    table, point-to-plane (``ref_normals``) and one device's sums (no
    ``reduce``); :func:`_step` in every other case."""
    return (scan_sub.is_cuda and grid is not None and grid.has_table
            and ref_normals is not None and reduce is None)


def _kernel_step(scan_sub, ref, ref_normals, init: RigidTransform, d_max: float,
                 rms_threshold: float, grid, weights):
    """IS's loop: ``(state, step)``, the state ``(i, rotation, translation,
    rms, done)`` as views of the two device buffers the kernel updates in
    place (``done`` int32), and ``step(state)``, one launch of IS, which
    returns it.  Every buffer is allocated here, once a loop."""
    dev = _kernels.require_cuda(scan_sub, ref, ref_normals, grid.packed_sorted, grid.orig_idx,
                                grid.cell_starts, grid.origin)
    q, n = scan_sub.shape[0], ref.shape[0]
    for name, t, shape in (("scan_sub", scan_sub, (q, 3)), ("ref", ref, (n, 3)),
                           ("ref_normals", ref_normals, (n, 3))):
        if t.dtype != torch.float32 or t.shape != shape:
            raise ValueError(f"{name} must be {shape} float32, got {tuple(t.shape)} {t.dtype}")
    table = grid.packed_sorted
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[1] < 3:
        raise ValueError(f"the grid's table must be (N, >=3) float32, got {tuple(table.shape)}")
    if weights is not None:
        weights = weights.to(device=dev, dtype=torch.float32).contiguous()
        if weights.shape != (q,):
            raise ValueError(f"weights must be ({q},), got {tuple(weights.shape)}")
    scan_sub, ref, ref_normals, table = (t.contiguous()
                                         for t in (scan_sub, ref, ref_normals, table))
    fstate = torch.cat([init.rotation.to(device=dev, dtype=torch.float32).reshape(9),
                        init.translation.to(device=dev, dtype=torch.float32).reshape(3),
                        torch.full((1,), float("inf"), device=dev)])
    istate = torch.zeros(3, dtype=torch.int32, device=dev)     # i, done, ticket
    lanes = nearest_lanes(grid.window_cap)
    blocks = _IS_BLOCKS_PER_SM * torch.cuda.get_device_properties(dev).multi_processor_count
    partials = torch.empty((blocks, 32), dtype=torch.float32, device=dev)
    args = (table.data_ptr(), table.shape[1], grid.orig_idx.data_ptr(),
            grid.cell_starts.data_ptr(), grid.origin.data_ptr(), grid.cell_size, *grid.dims,
            grid.halo, grid.window_cap, ref.data_ptr(), ref_normals.data_ptr(),
            scan_sub.data_ptr(), _kernels.ptr(weights), q, lanes, float(d_max),
            float(rms_threshold), fstate.data_ptr(), istate.data_ptr(), partials.data_ptr(),
            blocks)

    # the default keeps alive every tensor whose address ``args`` holds
    def step(state, _held=(table, ref, ref_normals, scan_sub, weights, fstate, istate, partials)):
        _kernels.launch("icp_step", dev, *args, checked=(fstate,))
        return state

    state = (istate[0], fstate[:9].view(3, 3), fstate[9:12], fstate[12], istate[1])
    return state, step


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
