"""PCA normals and geometric features — port of ``shot_fpfh_tpu.models.normals``.

The normal of a point is the smallest-eigenvalue eigenvector of its
neighborhood covariance (``ops.eigh3``), optionally sign-aligned to given
normals.  Every function switches at ``AUTO_GRID_MIN_POINTS`` cloud points
(this module's name, read at call time):

- k-mode normals: exact k-NN neighborhoods below it; above it the streaming
  route: per-query radii calibrated to hold ≈1.2·k neighbors, one pass of
  the K3 radius covariance kernel over the grid (``ops.radius_pca``), and a
  k-NN re-solve for the queries whose radius under-covered (the reference's
  documented deviation from exact k-NN PCA, PARITY.md round 4);
- radius-mode normals, sphericity and the basic features: the brute radius
  search capped at the ``k_max`` nearest below it; above it K3 over a grid
  of cell ``radius`` (every in-radius point, no cap);
- the moments of ``local_pca_with_moments`` and the full features: the
  brute radius search below it; above it the window of a halo-2 grid of cell
  ``radius/2`` (K8, ``ops.radius_runs``), every in-radius point.
"""

from __future__ import annotations

import logging

import torch

from .. import _fp
from .._device import resolve
from ..analysis import plot_neighborhood_sizes
from ..ops.eigh3 import eigh3x3, pca_eigh
from ..ops.grid_hash import (
    AUTO_GRID_MIN_POINTS,
    _zcolumn_runs,
    build_grid,
    kth_distance_bound,
    knn_auto,
    quantized_kth_radius,
    window_chunk,
    window_distances,
)
from ..ops.neighbors import Neighborhoods, as_f32, knn, radius_search
from ..ops.radius_pca import radius_pca
from ..parallel.mesh import gather_rows, local_rows
from ..utils.perf import StageMetrics, blocking, span

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
    r_q = torch.exp(log_a) * margin * _fp.pow(wcnt, -e_fit)
    return torch.clamp(r_q, r_hat / 8.0, r_hat)


def _streaming_grid(c, k, sample_size: int = 512):
    """The streaming route's shared state, from the cloud alone: a sample
    of it, the sample's k-th neighbor distances, and the grid at their
    quantized bound."""
    n = c.shape[0]
    stride = max(1, n // sample_size)
    sample = c[::stride][:sample_size]
    kth = kth_distance_bound(sample, c, k)
    with blocking("normals.kth"):
        kth_host = kth.cpu().numpy()
    return build_grid(c, quantized_kth_radius(kth_host)), sample, kth


def _streaming_pass(grid, sample, kth, q, k, pre):
    """One streaming covariance pass (K3) at each query's adaptive radius:
    ``(normals, neighbor counts)``, per query."""
    r_q = _knn_target_radii(grid, q, k, sample, kth)
    cov, _, cnt = radius_pca(grid, q, r_q)
    return _normals_from_cov(cov, pre), cnt


def _knn_net(q, c, k, pre, normals, cnt):
    """The miss net: queries whose radius held fewer than ``k`` neighbors
    re-solved from their exact k-NN (in ``normals``, which it returns)."""
    n = c.shape[0]
    with blocking("normals.misses"):
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


def _clouds(query_points, cloud_points, device):
    c = as_f32(cloud_points, resolve(device, cloud_points))
    return as_f32(query_points, c.device), c


def _radius_cov(q, c, radius, k_max: int):
    """``(w, v)`` of each query's radius neighborhood: K3 over a grid of
    cell ``radius`` from ``AUTO_GRID_MIN_POINTS`` cloud points up (every
    in-radius point), the brute search capped at ``k_max`` below."""
    if c.shape[0] >= AUTO_GRID_MIN_POINTS:
        cov, _, _ = radius_pca(build_grid(c, float(radius)), q, radius)
        return eigh3x3(cov)
    nbr = radius_search(q, c, radius, k_max)
    w, v, _ = pca_eigh(c[nbr.idx], nbr.mask)
    return w, v


def compute_normals(query_points, cloud_points, *, k: int | None = None,
                    radius: float | None = None, pre_computed_normals=None,
                    k_max: int = 64, mesh=None, device=None,
                    metrics: StageMetrics | None = None) -> torch.Tensor:
    """PCA normals of ``query_points`` from ``cloud_points`` neighborhoods
    (the ``k`` nearest, or every point within ``radius``: capped at the
    ``k_max`` nearest below ``AUTO_GRID_MIN_POINTS`` cloud points),
    sign-aligned to ``pre_computed_normals`` when given.  Returns a
    ``(Q, 3)`` float32 tensor on ``device`` (default: the cloud tensor's
    device, ``cuda`` for host arrays).  With a ``mesh`` of more than one
    rank the queries shard over it (``parallel.sharded.sharded_normals``)
    and the result is on the rank's device.  On one device the call is a
    ``StageMetrics`` stage, ``normals[knn]`` or ``normals[radius]``
    (synchronized at both ends), recorded into ``metrics`` when given."""
    if k is None and radius is None:
        raise ValueError("Provide k or radius.")
    if mesh is not None and mesh.devices.size > 1:
        from ..parallel.sharded import sharded_normals

        return sharded_normals(query_points, cloud_points, mesh, k=k, radius=radius,
                               pre_computed_normals=pre_computed_normals, k_max=k_max)
    metrics = StageMetrics() if metrics is None else metrics
    metrics.start("normals[knn]" if k is not None else "normals[radius]")
    q, c = _clouds(query_points, cloud_points, device)
    pre = (None if pre_computed_normals is None
           else as_f32(pre_computed_normals, c.device))
    normals = _normals(q, c, k, radius, pre, k_max)
    metrics.stop(queries=q.shape[0])
    return normals


def _normals(q_all, c, k, radius, pre_all, k_max: int, mesh=None, sample_size: int = 512):
    """The routes of :func:`compute_normals`: radius normals through K3 from
    ``AUTO_GRID_MIN_POINTS`` cloud points (else the capped brute search);
    k-NN normals through one streaming K3 pass at adaptive per-query radii
    (large clouds; a ``sample_size`` sample and the grid come from the cloud
    alone), then
    the miss net, or exact k-NN.  With a ``mesh`` each rank computes its
    block of the queries and the blocks are gathered; the net then
    re-solves, on every rank alike, the queries the gathered counts show
    under-covered."""
    n_q = q_all.shape[0]
    q = local_rows(q_all, mesh)
    pre = None if pre_all is None else local_rows(pre_all, mesh)
    if k is None:
        _, v = _radius_cov(q, c, radius, k_max)
        return gather_rows(_flip_to(v[..., :, 0], pre), n_q, mesh)
    if c.shape[0] < AUTO_GRID_MIN_POINTS:
        return gather_rows(_normals_knn(q, c, k, pre), n_q, mesh)
    with span("normals.grid"):
        grid, sample, kth = _streaming_grid(c, k, sample_size)
    with span("normals.pass"):
        normals, cnt = _streaming_pass(grid, sample, kth, q, k, pre)
    with span("normals.net"):
        return _knn_net(q_all, c, k, pre_all, gather_rows(normals, n_q, mesh),
                        gather_rows(cnt, n_q, mesh))


def compute_sphericity(query_points, cloud_points, radius, k_max: int = 64,
                       device=None) -> torch.Tensor:
    """``λ_min / (λ_max + 1e-6)`` of radius neighborhoods (reference
    pca_based_descriptors.py:62-74)."""
    w, _ = _radius_cov(*_clouds(query_points, cloud_points, device), radius, k_max)
    return w[..., 0] / (w[..., 2] + 1e-6)


def _moments(centered, v, count):
    """``(Q, 8)`` from the centered neighbors ``(Q, K, 3)`` (zero rows for
    the masked ones): |mean| and mean square of their coordinates in the
    eigenbasis (the columns of ``v``), then mean and mean square of their z."""
    proj = torch.einsum("qki,qij->qkj", centered, v)
    vert = centered[..., 2]
    return torch.cat([torch.abs(proj.sum(1) / count[:, None]),
                      (proj ** 2).sum(1) / count[:, None],
                      (vert.sum(-1) / count)[:, None], ((vert ** 2).sum(-1) / count)[:, None]],
                     dim=1)


def _pca_moments_window(grid, q, radius):
    """``local_pca_with_moments`` over the grid windows (K8), in query
    chunks; accumulated query-centered so float32 stays accurate far from
    the origin, then re-centered on the barycenter."""
    parts = []
    step = window_chunk(grid, 8)
    for s in range(0, q.shape[0], step):
        qc = q[s:s + step]
        vals, d, win_ok, _ = window_distances(grid, qc, with_rows=False)
        ok = win_ok & (d <= radius)
        count = torch.clamp(ok.sum(-1).to(torch.float32), min=1.0)
        rel = torch.where(ok[:, None, :], vals[:, :3, :] - qc[:, :, None], 0.0)
        bary_off = rel.sum(-1) / count[:, None]
        centered = torch.where(ok[:, None, :], rel - bary_off[:, :, None], 0.0)
        cov = torch.einsum("qiw,qjw->qij", centered, centered) / count[:, None, None]
        w, v = eigh3x3(cov)
        parts.append((w, v, _moments(centered.transpose(1, 2), v, count), ok.sum(-1)))
    return tuple(torch.cat(p) for p in zip(*parts))


def _pca_moments_brute(q, c, radius, k_max: int):
    nbr = radius_search(q, c, radius, k_max)
    pts = c[nbr.idx]
    w, v, bary = pca_eigh(pts, nbr.mask)
    m = nbr.mask.to(torch.float32)
    count = torch.clamp(m.sum(-1), min=1.0)
    centered = (pts - bary[..., None, :]) * m[..., None]
    return w, v, _moments(centered, v, count), nbr.mask.sum(-1)


def local_pca_with_moments(query_points, cloud_points, radius, k_max: int = 64,
                           device=None):
    """Local PCA and moments (reference ``compute_local_pca_with_moments``,
    pca_based_descriptors.py:77-147): ``(eigenvalues (Q, 3), eigenvectors
    (Q, 3, 3), moments (Q, 8), sizes (Q,))``.

    Deviation kept from the JAX package: moments project the centered
    neighborhood onto the eigenvector *columns* (the intended basis); the
    reference uses ``@ eigenvectors.T`` (line 131), an apparent
    transposition slip."""
    q, c = _clouds(query_points, cloud_points, device)
    if c.shape[0] >= AUTO_GRID_MIN_POINTS:
        return _pca_moments_window(build_grid(c, float(radius) / 2, halo=2), q, radius)
    return _pca_moments_brute(q, c, radius, k_max)


def _arcsin_feature(x):
    return 2.0 * torch.arcsin(torch.clamp(torch.abs(x), 0, 1)) / torch.pi


def compute_pca_based_basic_features(query_points, cloud_points, radius, k_max: int = 64,
                                     device=None):
    """``(verticality, linearity, planarity, sphericity)`` (reference
    pca_based_descriptors.py:150-184)."""
    w, v = _radius_cov(*_clouds(query_points, cloud_points, device), radius, k_max)
    lbd3, lbd2, lbd1 = w[..., 0], w[..., 1], w[..., 2] + 1e-6
    return (_arcsin_feature(v[..., 2, 0]), 1.0 - lbd2 / lbd1, (lbd2 - lbd3) / lbd1,
            lbd3 / lbd1)


def compute_pca_based_features(query_points, cloud_points, radius, k_max: int = 64,
                               verbose: bool = False, device=None) -> torch.Tensor:
    """The 21-column eigen-feature stack (reference
    ``compute_pca_based_features``, pca_based_descriptors.py:187-244):
    eigensum, eigen square sum, omnivariance, eigenentropy, linearity,
    planarity, sphericity, curvature change, four verticality-style angles,
    the 8 moments and the neighborhood size.  ``verbose`` logs the
    neighborhood-size statistics and draws their histogram
    (:func:`shot_fpfh_tpu_torch.analysis.plot_neighborhood_sizes`; a
    device→host copy)."""
    w, v, moments, sizes = local_pca_with_moments(query_points, cloud_points, radius, k_max,
                                                  device)
    if verbose:
        plot_neighborhood_sizes(sizes)
    lbd3, lbd2, lbd1 = w[..., 0], w[..., 1], w[..., 2] + 1e-6
    normals, principal_axis = v[..., :, 0], v[..., :, 2]
    eigensum = w.sum(-1)
    prod = w.prod(-1)
    cols = [
        eigensum, (w ** 2).sum(-1), torch.sign(prod) * torch.abs(prod) ** (1.0 / 3.0),
        (-w * torch.log(w + 1e-6)).sum(-1),
        1.0 - lbd2 / lbd1, (lbd2 - lbd3) / lbd1, lbd3 / lbd1,
        lbd3 / torch.clamp(eigensum, min=1e-12),
        _arcsin_feature(normals[..., 2]), _arcsin_feature(principal_axis[..., 2]),
        _arcsin_feature(normals[..., 0]), _arcsin_feature(normals[..., 1]),
    ]
    return torch.cat([torch.stack(cols, dim=1), moments,
                      sizes[:, None].to(torch.float32)], dim=1)
