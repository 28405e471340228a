"""Plain single-scale SHOT (Tombari et al., ECCV 2010) with the bin
conventions of aubin-tchoi/shot-fpfh: 352 bins = 11 cosine × 8 azimuth ×
2 elevation × 2 radial, quadrilinear soft binning, L2 normalisation, and an
all-zero descriptor for a neighbourhood of ``min_neighborhood_size`` points
or fewer.

The support is the cloud's voxel representatives at ``radius / rho``; a
keypoint's neighbourhood is every support point within ``radius`` (no cap).
The support and the neighbourhoods are found in float32 or wider; the
descriptor's arithmetic runs in ``dtype`` on each neighbour's offset from
its keypoint, so a lower ``dtype`` (the control) rounds the offsets, not
the cloud's coordinates.
Its frame is the eigenbasis of the ``(radius − d)``-weighted covariance of
the offsets, x and z signed by the majority of the neighbours' projections
(a tie keeps the sign), y = z × x; an empty neighbourhood takes the
identity.  Each neighbour at ``d > 0`` adds five weighted contributions.
"""

from __future__ import annotations

import math

import torch

from .common import Strips, radius_pairs, solver_dtype, voxel_representatives

N_COS, N_AZ, N_ELEV, N_RAD = 11, 8, 2, 2
N_CELLS = N_AZ * N_ELEV * N_RAD
DIM = N_COS * N_CELLS


def _wrap(v, n):
    return torch.remainder(v, n)


def _azimuth_bin(x, y):
    """The 8-way azimuth octant (clockwise, the first bin between π and 3π/4)."""
    a = ((y > 0) | ((y == 0) & (x < 0))).long()
    h = ((x > 0) | ((x == 0) & (y > 0))).long()
    cond = ((x * y > 0) | (x == 0)).long()
    corner = cond * (x.abs() < y.abs()).long() + (1 - cond) * (x.abs() > y.abs()).long()
    return 4 * a + 2 * (a ^ h) + corner


def _cell(az, elev, rad):
    return (az * N_ELEV + elev) * N_RAD + rad


def _contributions(lx, ly, lz, rho, cosine, radius):
    """``[(cosine bin, cell, weight)] × 5`` of each neighbour."""
    theta = torch.atan2(ly, lx)
    phi = torch.acos(torch.clamp(lz / rho, -1.0, 1.0))
    cos_pos = (cosine + 1.0) * (N_COS / 2.0) - 0.5
    cos_bin = torch.round(cos_pos).long()
    d_cos = cos_pos - cos_bin.to(cos_pos.dtype)
    cos_nb = _wrap(cos_bin + torch.sign(d_cos).long(), N_COS)
    abs_cos = d_cos.abs()

    az = _azimuth_bin(lx, ly)
    elev = (lz > 0).long()
    rad = (rho > radius / 2.0).long()

    half, r34, r14 = radius / 2.0, radius * 0.75, radius * 0.25
    inner = ((rho > half) & (rho < r34)) * (r34 - rho) / half
    outer = ((rho < half) & (rho > r14)) * (rho - r14) / half
    husk = (rho < half) * (1.0 - (rho - r14).abs() / half) + (rho > half) * (
        1.0 - (rho - r34).abs() / half)

    hp = math.pi / 2.0
    edge = (phi - hp).abs() < 1e-10
    upper = (((phi > hp) | (edge & (lz <= 0))) & (phi <= math.pi * 0.75)) * (
        math.pi * 0.75 - phi) / hp
    lower = (((phi < hp) & (~edge | (lz > 0))) & (phi >= math.pi * 0.25)) * (
        phi - math.pi * 0.25) / hp
    vert = (phi < hp) * (1.0 - (phi - math.pi * 0.25).abs() / hp) + (phi >= hp) * (
        1.0 - (phi - math.pi * 0.75).abs() / hp)

    az_size = 2.0 * math.pi / N_AZ
    d_az = torch.clamp((theta - (-math.pi + az.to(theta.dtype) * az_size)) / az_size - 0.5,
                       -0.5, 0.5)
    az_nb = _wrap(az + torch.sign(d_az).long(), N_AZ)
    abs_az = d_az.abs()

    base = _cell(az, elev, rad)
    return [
        (cos_bin, base, (1.0 - abs_cos) + husk + vert + (1.0 - abs_az)),
        (cos_bin, _cell(az, elev, 1 - rad), outer * (rad == 0) + inner * (rad == 1)),
        (cos_bin, _cell(az, 1 - elev, rad), upper * (elev == 0) + lower * (elev == 1)),
        (cos_bin, _cell(az_nb, elev, rad), abs_az),
        (cos_nb, base, abs_cos),
    ]


def _frames(qi, off, rho, n_q, radius, dtype):
    """``(Q, 3, 3)`` frames (columns x, y, z) from the pairs' offsets."""
    dev = off.device
    w = torch.clamp(radius - rho, min=0.0)
    outer = (off[:, :, None] * off[:, None, :]) * w[:, None, None]
    cov = torch.zeros((n_q, 3, 3), dtype=dtype, device=dev).index_add_(0, qi, outer)
    wsum = torch.zeros(n_q, dtype=dtype, device=dev).index_add_(0, qi, w)
    cov = cov / torch.clamp(wsum, min=1e-12)[:, None, None]
    _, vec = torch.linalg.eigh(cov.to(solver_dtype(dtype)))
    vec = vec.to(dtype)
    axes = []
    for axis in (vec[:, :, 2], vec[:, :, 0]):
        proj = (off * axis[qi]).sum(-1)
        neg = torch.zeros(n_q, dtype=torch.int64, device=dev).index_add_(
            0, qi, (proj < 0).long())
        nonneg = torch.zeros(n_q, dtype=torch.int64, device=dev).index_add_(
            0, qi, (proj >= 0).long())
        axes.append(torch.where((neg > nonneg)[:, None], -axis, axis))
    x, z = axes
    frames = torch.stack([x, torch.linalg.cross(z, x, dim=-1), z], dim=-1)
    count = torch.zeros(n_q, dtype=torch.int64, device=dev).index_add_(
        0, qi, torch.ones_like(qi))
    eye = torch.eye(3, dtype=dtype, device=dev).expand(n_q, 3, 3)
    return torch.where((count == 0)[:, None, None], eye, frames)


def descriptors(cloud: torch.Tensor, normals: torch.Tensor, keypoint_idx: torch.Tensor,
                cfg: dict, dtype) -> torch.Tensor:
    """``(Q, 352)`` SHOT of the cloud points ``keypoint_idx`` in ``dtype``."""
    desc = cfg["descriptor"]
    radius = float(desc["radius"])
    pts = cloud.to(torch.promote_types(dtype, torch.float32))
    sup_idx, _ = voxel_representatives(cloud, radius / float(desc["rho"]), torch.float32)
    sup, sup_n = pts[sup_idx], normals.to(dtype)[sup_idx]
    kp = pts[keypoint_idx]
    n_q = kp.shape[0]
    pairs = list(radius_pairs(kp, Strips(sup), radius))
    qi = torch.cat([p[0] for p in pairs])
    pj = torch.cat([p[1] for p in pairs])
    rho = torch.cat([p[2] for p in pairs]).to(dtype)
    off = (sup[pj] - kp[qi]).to(dtype)
    frames = _frames(qi, off, rho, n_q, radius, dtype)
    valid = rho > 0
    qi, pj, off, rho = qi[valid], pj[valid], off[valid], rho[valid]
    f = frames[qi]
    lx, ly, lz = ((off * f[:, :, j]).sum(-1) for j in range(3))
    cosine = torch.clamp((sup_n[pj] * f[:, :, 2]).sum(-1), -1.0, 1.0)
    hist = torch.zeros(n_q * DIM, dtype=dtype, device=kp.device)
    for hi, lo, w in _contributions(lx, ly, lz, rho, cosine, radius):
        hist.index_add_(0, qi * DIM + hi * N_CELLS + lo, w.to(dtype))
    hist = hist.reshape(n_q, DIM)
    count = torch.zeros(n_q, dtype=torch.int64, device=kp.device).index_add_(
        0, qi, torch.ones_like(qi))
    norm = torch.linalg.norm(hist.to(solver_dtype(dtype)), dim=-1, keepdim=True).to(dtype)
    keep = (count > int(desc["min_neighborhood_size"]))[:, None] & (norm > 0)
    if desc.get("normalize", True):
        hist = hist / torch.where(norm > 0, norm, torch.ones_like(norm))
    return torch.where(keep, hist, torch.zeros_like(hist))
