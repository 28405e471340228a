"""SHOT bin conventions and the FPFH Darboux angles — port of
``shot_fpfh_tpu.ops.descriptor_bins``.

Quadrilinear soft binning of the reference SHOT (azimuth octants, radial
husks at r/4 and 3r/4, elevation volumes at π/4 and 3π/4, round-half-even
cosine bins, wrap-around azimuth), elementwise on tensors.  The SHOT kernel
in ``csrc/shot_fused.cu`` evaluates the same formulas in the same float32
order; a convention change here must be made there too.

The SPFH kernels (``csrc/spfh_fused.cu``, ``csrc/spfh_runs.cu``) evaluate
:func:`darboux_angles` in the same float32 order.  Angles come from
``_fp.atan2``/``_fp.acos`` (the JAX package's Mosaic
``mosaic_atan2`` polynomial was a TPU workaround and is not ported).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .._fp import atan2
from ..utils.perf import uploading

N_COS = 11   # cosine (normal-angle) bins
N_AZ = 8     # azimuth octants
N_ELEV = 2   # elevation volumes
N_RAD = 2    # radial husks
N_LO = N_AZ * N_ELEV * N_RAD            # 32 spatial cells
SHOT_DIM = N_COS * N_LO                 # 352


def wrap(v: torch.Tensor, n: int) -> torch.Tensor:
    """``v mod n`` for ``v`` in [-1, n]."""
    v = torch.where(v < 0, v + n, v)
    return torch.where(v >= n, v - n, v)


def azimuth_bin(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """8-way azimuth octant of (x, y), the reference convention
    (clockwise, first bin between π and 3π/4)."""
    a = ((y > 0) | ((y == 0) & (x < 0))).to(torch.int32)
    h = ((x > 0) | ((x == 0) & (y > 0))).to(torch.int32)
    cond = ((x * y > 0) | (x == 0)).to(torch.int32)
    lt = (x.abs() < y.abs()).to(torch.int32)
    gt = (x.abs() > y.abs()).to(torch.int32)
    corner = cond * lt + (1 - cond) * gt
    xor = a + h - 2 * a * h
    return 4 * a + 2 * xor + corner


def interpolate_husks(distance, radius):
    """Radial soft-binning between the husks centered at r/4 and 3r/4:
    returns (outer, inner, current) weights."""
    r = radius
    half = r / 2.0
    r34 = r * 0.75
    r14 = r * 0.25
    inner = ((distance > half) & (distance < r34)) * (r34 - distance) / half
    outer = ((distance < half) & (distance > r14)) * (distance - r14) / half
    current = (distance < half) * (1.0 - (distance - r14).abs() / half) + (
        distance > half) * (1.0 - (distance - r34).abs() / half)
    return outer, inner, current


def interpolate_vertical(phi, z):
    """Elevation soft-binning between the volumes centered at π/4 and 3π/4:
    returns (upper, lower, current) weights."""
    half_pi = math.pi / 2.0
    at_edge = (phi - half_pi).abs() < 1e-10
    upper = ((((phi > half_pi) | (at_edge & (z <= 0))) & (phi <= math.pi * 0.75))
             * (math.pi * 0.75 - phi) / half_pi)
    lower = ((((phi < half_pi) & (~at_edge | (z > 0))) & (phi >= math.pi * 0.25))
             * (phi - math.pi * 0.25) / half_pi)
    current = (phi < half_pi) * (1.0 - (phi - math.pi * 0.25).abs() / half_pi) + (
        phi >= half_pi) * (1.0 - (phi - math.pi * 0.75).abs() / half_pi)
    return upper, lower, current


def cell_index(az, elev, rad):
    """Flat index of an (azimuth, elevation, radial) cell among the 32."""
    return (az * N_ELEV + elev) * N_RAD + rad


class ShotBins(NamedTuple):
    """Per-neighbor soft-bin indices and weights, raw and merged into the
    five contributions a neighbor adds to its histogram."""

    cos_bin: torch.Tensor
    cos_nb: torch.Tensor
    az_bin: torch.Tensor
    az_nb: torch.Tensor
    elev_bin: torch.Tensor
    rad_bin: torch.Tensor
    abs_cos: torch.Tensor
    abs_az: torch.Tensor
    outer: torch.Tensor
    inner: torch.Tensor
    husk_cur: torch.Tensor
    upper: torch.Tensor
    lower: torch.Tensor
    vert_cur: torch.Tensor
    base: torch.Tensor
    lo_husk: torch.Tensor
    lo_vert: torch.Tensor
    lo_az: torch.Tensor
    w_same: torch.Tensor
    w_husk_nb: torch.Tensor
    w_vert_nb: torch.Tensor


def shot_soft_bins(lx, ly, lz, rho, theta, phi, cosine, radius) -> ShotBins:
    """Quadrilinear soft binning of neighbors in local-frame coordinates
    (weights unmasked: validity stays with the caller).  ``radius`` is taken
    as a float32 scalar, like the reference's traced radius."""
    with uploading(radius, lx.device):
        r = torch.as_tensor(radius, dtype=torch.float32, device=lx.device)
    cos_pos = (cosine + 1.0) * (N_COS / 2.0) - 0.5
    cos_bin = torch.round(cos_pos).to(torch.int32)   # round-half-even
    az_bin = azimuth_bin(lx, ly)
    elev_bin = (lz > 0).to(torch.int32)
    rad_bin = (rho > r / 2.0).to(torch.int32)

    delta_cos = cos_pos - cos_bin.to(torch.float32)
    sign_cos = torch.sign(delta_cos).to(torch.int32)
    abs_cos = delta_cos.abs()
    cos_nb = wrap(cos_bin + sign_cos, N_COS)

    outer, inner, husk_cur = interpolate_husks(rho, r)
    upper, lower, vert_cur = interpolate_vertical(phi, lz)

    az_size = 2.0 * math.pi / N_AZ
    delta_az = torch.clamp(
        (theta - (-math.pi + az_bin.to(torch.float32) * az_size)) / az_size - 0.5,
        -0.5, 0.5)
    sign_az = torch.sign(delta_az).to(torch.int32)
    abs_az = delta_az.abs()
    az_nb = wrap(az_bin + sign_az, N_AZ)

    base = cell_index(az_bin, elev_bin, rad_bin)
    return ShotBins(
        cos_bin=cos_bin, cos_nb=cos_nb, az_bin=az_bin, az_nb=az_nb,
        elev_bin=elev_bin, rad_bin=rad_bin,
        abs_cos=abs_cos, abs_az=abs_az,
        outer=outer, inner=inner, husk_cur=husk_cur,
        upper=upper, lower=lower, vert_cur=vert_cur,
        base=base,
        lo_husk=cell_index(az_bin, elev_bin, 1 - rad_bin),
        lo_vert=cell_index(az_bin, 1 - elev_bin, rad_bin),
        lo_az=cell_index(az_nb, elev_bin, rad_bin),
        w_same=(1.0 - abs_cos) + husk_cur + vert_cur + (1.0 - abs_az),
        w_husk_nb=outer * (rad_bin == 0) + inner * (rad_bin == 1),
        w_vert_nb=upper * (elev_bin == 0) + lower * (elev_bin == 1),
    )


def darboux_angles(dx, dy, dz, nx, ny, nz, ux, uy, uz, d_safe):
    """(alpha, phi, theta) of the reference Darboux frame (fpfh.py:50-66):
    u = query normal, v = diff x u (UNNORMALIZED, the reference's semantics:
    alpha values outside [-1, 1] fall out of the histogram), w = u x v;
    alpha = v.n_j, phi = diff.u / |diff|, theta = atan2(n_j.w, n_j.u).
    ``d_safe`` is |diff| with invalid/zero lanes replaced by 1.  Each sum
    runs left to right with every product rounded, as the kernels do."""
    vx = dy * uz - dz * uy
    vy = dz * ux - dx * uz
    vz = dx * uy - dy * ux
    wx = uy * vz - uz * vy
    wy = uz * vx - ux * vz
    wz = ux * vy - uy * vx
    alpha = vx * nx + vy * ny + vz * nz
    phi = (dx * ux + dy * uy + dz * uz) / d_safe
    theta = atan2(nx * wx + ny * wy + nz * wz, nx * ux + ny * uy + nz * uz)
    return alpha, phi, theta
