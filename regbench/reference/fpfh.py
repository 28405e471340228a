"""Plain FPFH (Rusu et al., ICRA 2009) with the conventions of
aubin-tchoi/shot-fpfh: a joint ``n_bins³`` histogram of the Darboux angles.

For a point q with normal u, each neighbour j within ``radius`` at
``d = |p_j − q| > 0`` gives ``v = (p_j − q) × u`` (not normalised),
``w = u × v``, ``α = v·n_j``, ``φ = (p_j − q)·u / d`` and
``θ = atan2(n_j·w, n_j·u)``, binned uniformly on [−1, 1], [−1, 1] and
[−π/2, π/2] (the upper edge in the last bin, values outside dropped);
SPFH(q) is that histogram over q's neighbourhood size, q itself counted.
FPFH(p) = SPFH(p) + (Σ_{j, d_j > 0} SPFH(j) / d_j) / |N(p)|, over every
cloud point within ``radius`` (no cap).  Neighbourhoods are found in
float32 or wider; the arithmetic runs in ``dtype`` on each neighbour's
offset from its query point, so a lower ``dtype`` (the control) rounds the
offsets, not the cloud's coordinates.
"""

from __future__ import annotations

import math

import torch

from .common import Strips, radius_pairs


def _bins(x, lo, hi, n_bins):
    idx = torch.clamp(torch.floor((x - lo) / ((hi - lo) / n_bins)), 0, n_bins - 1).long()
    return idx, (x >= lo) & (x <= hi)


def spfh(points: torch.Tensor, normals: torch.Tensor, query_idx: torch.Tensor,
         strips: Strips, radius: float, n_bins: int, dtype) -> torch.Tensor:
    """``(Q, n_bins³)`` SPFH of the points ``query_idx`` (``points`` in
    float32 or wider, ``normals`` in ``dtype``)."""
    n_q = query_idx.shape[0]
    dim = n_bins ** 3
    hist = torch.zeros(n_q * dim, dtype=dtype, device=points.device)
    count = torch.zeros(n_q, dtype=dtype, device=points.device)
    for qi, j, d in radius_pairs(points[query_idx], strips, radius):
        count.index_add_(0, qi, torch.ones_like(d, dtype=dtype))
        ok = d > 0
        qi, j, d = qi[ok], j[ok], d[ok].to(dtype)
        q = query_idx[qi]
        diff = (points[j] - points[q]).to(dtype)
        u, n_j = normals[q], normals[j]
        v = torch.linalg.cross(diff, u, dim=-1)
        w = torch.linalg.cross(u, v, dim=-1)
        alpha = (v * n_j).sum(-1)
        phi = (diff * u).sum(-1) / d
        theta = torch.atan2((n_j * w).sum(-1), (n_j * u).sum(-1))
        a, a_in = _bins(alpha, -1.0, 1.0, n_bins)
        p, p_in = _bins(phi, -1.0, 1.0, n_bins)
        t, t_in = _bins(theta, -math.pi / 2, math.pi / 2, n_bins)
        keep = a_in & p_in & t_in
        flat = qi * dim + (a * n_bins + p) * n_bins + t
        hist.index_add_(0, flat[keep], torch.ones_like(d[keep]))
    return hist.reshape(n_q, dim) / torch.clamp(count, min=1.0)[:, None]


def descriptors(cloud: torch.Tensor, normals: torch.Tensor, keypoint_idx: torch.Tensor,
                cfg: dict, dtype) -> torch.Tensor:
    """``(Q, n_bins³)`` FPFH of the cloud points ``keypoint_idx`` in ``dtype``."""
    desc = cfg["descriptor"]
    radius, n_bins = float(desc["radius"]), int(desc["fpfh_n_bins"])
    pts, nrm = cloud.to(torch.promote_types(dtype, torch.float32)), normals.to(dtype)
    strips = Strips(pts)
    pairs = list(radius_pairs(pts[keypoint_idx], strips, radius))
    qi = torch.cat([p[0] for p in pairs])
    j = torch.cat([p[1] for p in pairs])
    d = torch.cat([p[2] for p in pairs]).to(dtype)
    needed = torch.unique(torch.cat([j, keypoint_idx]))
    rows = torch.full((cloud.shape[0],), -1, dtype=torch.int64, device=cloud.device)
    rows[needed] = torch.arange(needed.shape[0], device=cloud.device)
    table = spfh(pts, nrm, needed, strips, radius, n_bins, dtype)
    n_q = keypoint_idx.shape[0]
    count = torch.zeros(n_q, dtype=dtype, device=cloud.device).index_add_(
        0, qi, torch.ones_like(d))
    ok = d > 0
    acc = torch.zeros((n_q, table.shape[1]), dtype=dtype, device=cloud.device).index_add_(
        0, qi[ok], table[rows[j[ok]]] / d[ok][:, None])
    return table[rows[keypoint_idx]] + acc / torch.clamp(count, min=1.0)[:, None]
