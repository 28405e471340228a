"""Closed-form rigid alignment solvers, batched and mask-weighted.

Port of ``shot_fpfh_tpu.core.solvers``: Kabsch/Umeyama via 3x3 SVD with the
det<0 reflection fix, and the linearized point-to-plane solve on the 6x6
normal equations.  Both take optional per-point weights and batch over
leading axes (RANSAC solves all draws of a chunk in one call).  Each also
comes split in two: the sums over the points (``point_to_point_stats``,
``point_to_plane_normal_eq``), which add up across shards of the points,
and the solve from those sums.
"""

from __future__ import annotations

import torch

from ..utils.perf import blocking
from .transform import RigidTransform, euler_xyz_to_matrix


def _kabsch(cov: torch.Tensor, scan_bary: torch.Tensor,
            ref_bary: torch.Tensor) -> RigidTransform:
    """The rotation of the ``[..., 3, 3]`` cross-covariance by SVD, with
    the reflection fix, and the translation between the barycenters."""
    with blocking("kabsch.svd", waits=2):
        u, _, vt = torch.linalg.svd(cov)
    v = vt.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    rot = v @ ut
    # reflection fix: flip the last row of Uᵀ when det < 0
    flip = torch.where(torch.linalg.det(rot) < 0, -1.0, 1.0).to(cov.dtype)[..., None, None]
    ut_fixed = torch.cat([ut[..., :2, :], ut[..., 2:3, :] * flip], dim=-2)
    rot = v @ ut_fixed
    trans = ref_bary - torch.einsum("...ij,...j->...i", rot, scan_bary)
    return RigidTransform(rot, trans)


def solve_point_to_point(scan: torch.Tensor, ref: torch.Tensor,
                         weights: torch.Tensor | None = None) -> RigidTransform:
    """Least-squares rigid transform mapping ``scan`` onto ``ref``
    (``[..., N, 3]`` correspondences, optional ``[..., N]`` weights)."""
    dtype = scan.dtype
    w = (torch.ones(scan.shape[:-1], dtype=dtype, device=scan.device)
         if weights is None else weights.to(dtype))
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    wn = (w / wsum)[..., None]
    scan_bary = (scan * wn).sum(-2)
    ref_bary = (ref * wn).sum(-2)
    cov = torch.einsum("...ki,...kj->...ij",
                       (scan - scan_bary[..., None, :]) * wn,
                       ref - ref_bary[..., None, :])
    return _kabsch(cov, scan_bary, ref_bary)


def point_to_point_stats(scan: torch.Tensor, ref: torch.Tensor, weights: torch.Tensor):
    """Sufficient statistics of weighted Kabsch over ``[..., N]`` points:
    ``(W, Σw·s, Σw·r, Σw·s·rᵀ)``, 22 floats that add up across shards."""
    w = weights[..., None]
    return (weights.sum(-1), (scan * w).sum(-2), (ref * w).sum(-2),
            torch.einsum("...ki,...kj->...ij", scan * w, ref))


def solve_point_to_point_from_stats(wsum, s_sum, r_sum, srt) -> RigidTransform:
    """Kabsch from the (summed) statistics of :func:`point_to_point_stats`."""
    wsum = torch.clamp(wsum, min=1e-12)
    s_bar = s_sum / wsum[..., None]
    r_bar = r_sum / wsum[..., None]
    cov = srt / wsum[..., None, None] - s_bar[..., :, None] * r_bar[..., None, :]
    return _kabsch(cov, s_bar, r_bar)


def point_to_plane_normal_eq(scan: torch.Tensor, ref: torch.Tensor,
                             ref_normals: torch.Tensor,
                             weights: torch.Tensor | None = None):
    """The weighted 6x6 normal equations ``(GᵀG, Gᵀh)`` of the linearized
    point-to-plane problem, ``G = [s × n | n]``, ``h = (r − s)·n``; they add
    up across shards."""
    dtype = scan.dtype
    w = (torch.ones(scan.shape[:-1], dtype=dtype, device=scan.device)
         if weights is None else weights.to(dtype))
    g = torch.cat([torch.linalg.cross(scan, ref_normals, dim=-1), ref_normals], dim=-1)
    h = ((ref - scan) * ref_normals).sum(-1)
    gw = g * w[..., None]
    return (torch.einsum("...ki,...kj->...ij", gw, g),
            torch.einsum("...ki,...k->...i", gw, h))


def solve_point_to_plane_from_normal_eq(gtg: torch.Tensor, gth: torch.Tensor) -> RigidTransform:
    """The transform of (summed) normal equations: rotation from
    extrinsic-xyz Euler angles, then the translation."""
    # the same tiny Tikhonov term as the reference keeps degenerate inlier
    # sets solvable in f32
    trace = gtg.diagonal(dim1=-2, dim2=-1).sum(-1)
    gtg = gtg + torch.eye(6, dtype=gtg.dtype, device=gtg.device) * 1e-8 * trace[..., None, None]
    # solve_ex leaves the solver's status on the device (solve would read it
    # back and wait); the Tikhonov term keeps the system nonsingular
    x = torch.linalg.solve_ex(gtg, gth).result
    return RigidTransform(euler_xyz_to_matrix(x[..., :3]), x[..., 3:])


def solve_point_to_plane(scan: torch.Tensor, ref: torch.Tensor,
                         ref_normals: torch.Tensor,
                         weights: torch.Tensor | None = None) -> RigidTransform:
    """Small-angle point-to-plane alignment: ``min Σ w ((R s + t - r)·n)²``
    through the 6x6 normal equations, rotation rebuilt from extrinsic-xyz
    Euler angles."""
    return solve_point_to_plane_from_normal_eq(
        *point_to_plane_normal_eq(scan, ref, ref_normals, weights))


def registration_rms(scan: torch.Tensor, ref: torch.Tensor,
                     transform: RigidTransform):
    """RMS of 1-NN distances after moving ``scan`` by ``transform``; returns
    ``(rms, moved)``."""
    from ..ops.neighbors import nearest_neighbor

    moved = transform.apply(scan)
    dist, _ = nearest_neighbor(moved, ref)
    return torch.sqrt(torch.mean(dist ** 2)), moved
