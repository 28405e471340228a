"""Plain multiscale SHOT: aubin-tchoi/shot-fpfh's
``descriptors/shot_parallelization.py:241-312`` (``ShotMultiprocessor.
compute_descriptor_multiscale``) as ``pipeline.py`` drives it for
``descriptor_choice: shot_multiscale``: scale ``s`` of ``n_scales`` has
the radius ``r_s = radius · phi^s`` and its own support, the cloud's voxel
representatives at ``r_s / rho``; its row is ``shot_single_scale``'s bins
at ``r_s`` (the radial split at ``r_s / 2``) over that support, zeroed for
a keypoint with ``min_neighborhood_size`` or fewer ``r_s`` neighbours at
``d > 0``, L2-normalised and weighted 1.  The rows are concatenated, scale
0 first: ``352 · n_scales`` columns.

With ``share_local_rfs`` (the configuration's, as default.yaml has it)
every scale bins under the frames of scale 0: ``shot_single_scale``'s rule
at ``r_0`` over scale 0's support (the eigenbasis of the ``(r_0 −
d)``-weighted covariance of the offsets, x and z signed by the majority of
the ``r_0`` neighbours' projections, y = z × x, the identity for an empty
neighbourhood).  Without it each scale takes its own frames at ``r_s``.

Departures from the upstream:

- SURVEY quirk 4: the upstream's dispatcher tests ``shot_multi_scale``
  while its configuration and CLI spell ``shot_multiscale``, so the mode
  given through the configuration raises; the port accepts both spellings,
  and this reference computes what the mode's code computes;
- as ``shot_single_scale`` has them: a neighbour at ``d = 0`` weighs in the
  frame's covariance and votes but adds no bin; the float64 reference and
  the bfloat16 control take their arithmetic on each neighbour's offset
  from its keypoint, the supports and neighbourhoods found in float32 or
  wider.

Neighbourhoods are uncapped, as the upstream's ``KDTree.query_radius``
keeps every neighbour.
"""

from __future__ import annotations

import torch

from .common import Strips, radius_pairs, solver_dtype, voxel_representatives
from .shot_single_scale import DIM, N_CELLS, _contributions, _frames


def descriptors(cloud: torch.Tensor, normals: torch.Tensor, keypoint_idx: torch.Tensor,
                cfg: dict, dtype) -> torch.Tensor:
    """``(Q, 352 · n_scales)`` multiscale SHOT of the cloud points
    ``keypoint_idx`` in ``dtype``."""
    matmul_tf32, cudnn_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                               torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _descriptors(cloud, normals, keypoint_idx, cfg["descriptor"], dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def _neighbours(pts, normals, kp, cloud, voxel, radius, dtype):
    """``(query rows, support normals of the pairs, offsets, distances)``
    of every support point within ``radius`` of each keypoint, the support
    the cloud's voxel representatives at ``voxel`` (every point if None)."""
    if voxel is None:
        sup_idx = torch.arange(cloud.shape[0], device=cloud.device)
    else:
        sup_idx, _ = voxel_representatives(cloud, voxel, torch.float32)
    sup, sup_n = pts[sup_idx], normals.to(dtype)[sup_idx]
    pairs = list(radius_pairs(kp, Strips(sup), radius))
    qi = torch.cat([p[0] for p in pairs])
    pj = torch.cat([p[1] for p in pairs])
    rho = torch.cat([p[2] for p in pairs]).to(dtype)
    return qi, sup_n[pj], (sup[pj] - kp[qi]).to(dtype), rho


def _row(qi, nrm, off, rho, frames, n_q, radius, desc: dict, dtype) -> torch.Tensor:
    """One scale's ``(Q, 352)`` rows under ``frames``."""
    valid = rho > 0
    qi, nrm, off, rho = qi[valid], nrm[valid], off[valid], rho[valid]
    f = frames[qi]
    lx, ly, lz = ((off * f[:, :, j]).sum(-1) for j in range(3))
    cosine = torch.clamp((nrm * f[:, :, 2]).sum(-1), -1.0, 1.0)
    hist = torch.zeros(n_q * DIM, dtype=dtype, device=off.device)
    for hi, lo, w in _contributions(lx, ly, lz, rho, cosine, radius):
        hist.index_add_(0, qi * DIM + hi * N_CELLS + lo, w.to(dtype))
    hist = hist.reshape(n_q, DIM)
    count = torch.zeros(n_q, dtype=torch.int64, device=off.device).index_add_(
        0, qi, torch.ones_like(qi))
    norm = torch.linalg.norm(hist.to(solver_dtype(dtype)), dim=-1, keepdim=True).to(dtype)
    keep = (count > int(desc["min_neighborhood_size"]))[:, None] & (norm > 0)
    if desc.get("normalize", True):
        hist = hist / torch.where(norm > 0, norm, torch.ones_like(norm))
    return torch.where(keep, hist, torch.zeros_like(hist))


def _descriptors(cloud, normals, keypoint_idx, desc: dict, dtype) -> torch.Tensor:
    radius, phi, rho = float(desc["radius"]), float(desc["phi"]), float(desc["rho"])
    share = desc.get("share_local_rfs", True)
    pts = cloud.to(torch.promote_types(dtype, torch.float32))
    kp = pts[keypoint_idx]
    n_q = kp.shape[0]
    rows, shared = [], None
    for scale in range(int(desc["n_scales"])):
        r_s = radius * phi ** scale
        voxel = r_s / rho if desc.get("subsample_support", True) else None
        qi, nrm, off, dist = _neighbours(pts, normals, kp, cloud, voxel, r_s, dtype)
        frames = shared if shared is not None else _frames(qi, off, dist, n_q, r_s, dtype)
        if share:
            shared = frames
        rows.append(_row(qi, nrm, off, dist, frames, n_q, r_s, desc, dtype))
    return torch.cat(rows, dim=1)
