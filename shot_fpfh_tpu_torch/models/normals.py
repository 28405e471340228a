"""PCA normals in k-mode — port of ``shot_fpfh_tpu.models.normals``.

The normal of a point is the smallest-eigenvalue eigenvector of its
neighborhood covariance (``ops.eigh3``), optionally sign-aligned to given
normals.  Clouds below ``AUTO_GRID_MIN_POINTS`` use exact k-NN
neighborhoods; larger clouds take the streaming route: per-query radii
calibrated to hold ≈1.2·k neighbors, one pass of the K3 radius covariance
kernel over the grid (``ops.radius_pca``), and a k-NN re-solve for the
queries whose radius under-covered (the reference's documented deviation
from exact k-NN PCA, PARITY.md round 4).
"""

from __future__ import annotations

import logging

import torch

from .._device import resolve
from ..ops.eigh3 import eigh3x3, pca_eigh
from ..ops.grid_hash import (
    AUTO_GRID_MIN_POINTS,
    _zcolumn_runs,
    build_grid,
    kth_distance_bound,
    knn_auto,
    quantized_kth_radius,
)
from ..ops.neighbors import Neighborhoods, as_f32, knn
from ..ops.radius_pca import radius_pca

logger = logging.getLogger(__name__)

# misses re-solved by the brute k-NN net; larger miss sets go through the
# grid-accelerated exact k-NN instead (the reference's host re-solve)
_NET_BUCKET = 2048


def _flip_to(normals: torch.Tensor, pre: torch.Tensor | None) -> torch.Tensor:
    if pre is None:
        return normals
    flip = (normals * pre).sum(-1) < 0
    return torch.where(flip[..., None], -normals, normals)


def _normals_from_neighborhoods(cloud: torch.Tensor, nbr: Neighborhoods, pre):
    _, v, _ = pca_eigh(cloud[nbr.idx], nbr.mask)
    return _flip_to(v[..., :, 0], pre)


def _normals_from_cov(cov: torch.Tensor, pre) -> torch.Tensor:
    _, v = eigh3x3(cov)
    return _flip_to(v[..., :, 0], pre)


def _normals_knn(q, c, k, pre):
    return _normals_from_neighborhoods(c, knn_auto(q, c, k), pre)


def _knn_target_radii(grid, queries, k, sample, sample_kth):
    """Per-query radius targeting ≈1.2·k neighbors: fit ``r_k ≈ A·wcnt^−e``
    between a sample's window counts (cell-table lookups only) and its k-th
    neighbor distances in log space, add the 98th-percentile residual plus
    15%, and clip to the grid's coverage (≤ cell size)."""
    r_hat = float(grid.cell_size)
    s, e = _zcolumn_runs(grid, sample)
    wcnt_s = torch.clamp((e - s).sum(1).to(torch.float32), min=1.0)
    x = torch.log(wcnt_s)
    y = torch.log(torch.clamp(sample_kth.to(torch.float32), min=1e-9))
    var = torch.mean((x - x.mean()) ** 2)
    cov_xy = torch.mean((x - x.mean()) * (y - y.mean()))
    e_fit = torch.where(var > 1e-12, -cov_xy / torch.clamp(var, min=1e-12),
                        torch.full_like(var, 0.5))
    e_fit = torch.clamp(e_fit, 1.0 / 3.0, 0.6)
    log_a = torch.quantile(y + e_fit * x, 0.5)     # jnp.median: midpoint mean
    resid = y - (log_a - e_fit * x)
    margin = torch.exp(torch.quantile(resid, 0.98)) * 1.15
    qs, qe = _zcolumn_runs(grid, queries)
    wcnt = torch.clamp((qe - qs).sum(1).to(torch.float32), min=1.0)
    r_q = torch.exp(log_a) * margin * wcnt ** (-e_fit)
    return torch.clamp(r_q, r_hat / 8.0, r_hat)


def _streaming_knn_normals(q, c, k, pre, sample_size: int = 512):
    """k-mode normals for large clouds through one streaming covariance
    pass (K3) with adaptive per-query radii, then the miss net."""
    n = c.shape[0]
    stride = max(1, n // sample_size)
    sample = c[::stride][:sample_size]
    kth = kth_distance_bound(sample, c, k)
    r_hat = quantized_kth_radius(kth.cpu().numpy())
    grid = build_grid(c, r_hat)
    r_q = _knn_target_radii(grid, q, k, sample, kth)
    cov, _, cnt = radius_pca(grid, q, r_q)
    normals = _normals_from_cov(cov, pre)
    miss = torch.nonzero(cnt < min(k, n))[:, 0]
    if miss.numel():
        if miss.numel() > min(_NET_BUCKET, n):
            logger.warning(
                "streaming k-NN normals net overflow: %.1f%% of %d queries "
                "under-covered (bucket %d); re-solving exactly",
                100.0 * miss.numel() / q.shape[0], q.shape[0], _NET_BUCKET)
            fix = knn_auto(q[miss], c, k)
        else:
            fix = knn(q[miss], c, k)
        normals[miss] = _normals_from_neighborhoods(
            c, fix, None if pre is None else pre[miss])
    return normals


def compute_normals(query_points, cloud_points, *, k: int | None = None,
                    radius: float | None = None, pre_computed_normals=None,
                    device=None) -> torch.Tensor:
    """PCA normals of ``query_points`` from ``cloud_points`` neighborhoods
    (``k`` nearest), sign-aligned to ``pre_computed_normals`` when given.
    Returns a ``(Q, 3)`` float32 tensor on ``device`` (default: the
    cloud tensor's device, ``cuda`` for host arrays)."""
    if k is None and radius is None:
        raise ValueError("Provide k or radius.")
    if k is None:
        raise NotImplementedError(
            "radius-mode normals are not ported yet (ROADMAP.md, Queue 1, "
            "item 7: radius-mode and PCA-feature normals)")
    c = as_f32(cloud_points, resolve(device, cloud_points))
    q = as_f32(query_points, c.device)
    pre = (None if pre_computed_normals is None
           else as_f32(pre_computed_normals, c.device))
    if c.shape[0] >= AUTO_GRID_MIN_POINTS:
        return _streaming_knn_normals(q, c, k, pre)
    return _normals_knn(q, c, k, pre)
