"""Plain bi-scale SHOT: aubin-tchoi/shot-fpfh's
``descriptors/shot_parallelization.py:185-239`` (``ShotMultiprocessor.
compute_descriptor_bi_scale``) as ``pipeline.py:293,306`` drives it for
``descriptor_choice: shot_bi_scale``: each keypoint's frame is taken over
its neighbourhood at ``r_f = radius`` and its histogram over its
neighbourhood at ``r_s = radius · phi``.

The frame is ``shot_single_scale``'s at ``r_f``: the eigenbasis of the
``(r_f − d)``-weighted covariance of the offsets, x and z signed by the
majority of the ``r_f`` neighbours' projections, y = z × x, the identity
for an empty ``r_f`` neighbourhood.  The bins are ``shot_single_scale``'s
at ``r_s`` (the radial split at ``r_s / 2``) under that frame, and a
keypoint with ``min_neighborhood_size`` or fewer ``r_s`` neighbours at
``d > 0`` gets the all-zero row.

Departures from the upstream, each as ``shot_single_scale`` has them: one
support, the cloud's voxel representatives at ``radius / rho``, serves both
radii (the upstream queries the same subsampled support twice; without a
support it fails, SURVEY quirk 5, and this configuration always has one);
neighbourhoods are uncapped; a neighbour at ``d = 0`` weighs in the frame's
covariance and votes but adds no bin; the float64 reference and the
bfloat16 control take their arithmetic on each neighbour's offset from its
keypoint.
"""

from __future__ import annotations

import torch

from .common import Strips, radius_pairs, solver_dtype, voxel_representatives
from .shot_single_scale import DIM, N_CELLS, _contributions, _frames


def descriptors(cloud: torch.Tensor, normals: torch.Tensor, keypoint_idx: torch.Tensor,
                cfg: dict, dtype) -> torch.Tensor:
    """``(Q, 352)`` bi-scale SHOT of the cloud points ``keypoint_idx`` in
    ``dtype``."""
    matmul_tf32, cudnn_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                               torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _descriptors(cloud, normals, keypoint_idx, cfg["descriptor"], dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def _descriptors(cloud, normals, keypoint_idx, desc: dict, dtype) -> torch.Tensor:
    r_f = float(desc["radius"])
    r_s = r_f * float(desc["phi"])
    pts = cloud.to(torch.promote_types(dtype, torch.float32))
    sup_idx, _ = voxel_representatives(cloud, r_f / float(desc["rho"]), torch.float32)
    sup, sup_n = pts[sup_idx], normals.to(dtype)[sup_idx]
    kp = pts[keypoint_idx]
    n_q = kp.shape[0]
    pairs = list(radius_pairs(kp, Strips(sup), max(r_f, r_s)))
    qi = torch.cat([p[0] for p in pairs])
    pj = torch.cat([p[1] for p in pairs])
    d = torch.cat([p[2] for p in pairs])
    rho = d.to(dtype)
    off = (sup[pj] - kp[qi]).to(dtype)
    in_f = d <= r_f
    frames = _frames(qi[in_f], off[in_f], rho[in_f], n_q, r_f, dtype)
    valid = (d <= r_s) & (rho > 0)
    qi, pj, off, rho = qi[valid], pj[valid], off[valid], rho[valid]
    f = frames[qi]
    lx, ly, lz = ((off * f[:, :, j]).sum(-1) for j in range(3))
    cosine = torch.clamp((sup_n[pj] * f[:, :, 2]).sum(-1), -1.0, 1.0)
    hist = torch.zeros(n_q * DIM, dtype=dtype, device=kp.device)
    for hi, lo, w in _contributions(lx, ly, lz, rho, cosine, r_s):
        hist.index_add_(0, qi * DIM + hi * N_CELLS + lo, w.to(dtype))
    hist = hist.reshape(n_q, DIM)
    count = torch.zeros(n_q, dtype=torch.int64, device=kp.device).index_add_(
        0, qi, torch.ones_like(qi))
    norm = torch.linalg.norm(hist.to(solver_dtype(dtype)), dim=-1, keepdim=True).to(dtype)
    keep = (count > int(desc["min_neighborhood_size"]))[:, None] & (norm > 0)
    if desc.get("normalize", True):
        hist = hist / torch.where(norm > 0, norm, torch.ones_like(norm))
    return torch.where(keep, hist, torch.zeros_like(hist))
