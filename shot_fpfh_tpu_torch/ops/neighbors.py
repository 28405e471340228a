"""Brute-force neighbor search with fixed-shape padded results.

Port of ``shot_fpfh_tpu.ops.neighbors``: each query returns ``k`` padded
slots plus a validity mask; distances come from the matmul expansion
``‖q−p‖² = ‖q‖² + ‖p‖² − 2 q·p`` (full float32: TF32 is off), chunked over
queries so one distance tile stays under ``2^26`` elements.  The grid-hash
engine (``grid_hash.py``) takes over for large clouds.

Every search runs where its ``points`` tensor is; host arrays go to
``cuda`` (``_device.resolve``), so a caller wanting the CPU passes CPU
tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve
from .._fp import sqnorm3, sqrt
from ..utils.perf import span, uploading

_MAX_TILE_ELEMS = 1 << 26


@dataclass(frozen=True)
class Neighborhoods:
    """Padded neighborhoods: ``idx``/``dist`` are ``(Q, K)``; ``mask`` flags
    real neighbors.  Invalid slots have ``idx == 0`` and ``dist == inf``."""

    idx: torch.Tensor   # (Q, K) int64
    dist: torch.Tensor  # (Q, K) float32
    mask: torch.Tensor  # (Q, K) bool

    @property
    def count(self) -> torch.Tensor:
        return self.mask.sum(-1)


def as_f32(x, device=None) -> torch.Tensor:
    """Tensor view of ``x`` as float32 on ``device`` (default: where it is)."""
    if isinstance(x, torch.Tensor):
        with uploading(x, device):
            return x.to(device=device or x.device, dtype=torch.float32)
    with span("host.f32"):
        arr = np.asarray(x, np.float32)
        if not arr.flags.writeable:  # e.g. a view of a JAX array
            arr = arr.copy()
    with uploading(arr, device):
        return torch.as_tensor(arr, device=device)


def _sq_dists(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    qn = (queries * queries).sum(-1, keepdim=True)
    pn = (points * points).sum(-1)[None, :]
    return torch.clamp(qn + pn - 2.0 * (queries @ points.T), min=0.0)


def _chunk(n_points: int) -> int:
    return max(1, min(4096, _MAX_TILE_ELEMS // max(n_points, 1)))


def _exact_dist(queries, points, idx):
    diff = queries[:, None, :] - points[idx]
    return sqrt(sqnorm3(diff[..., 0], diff[..., 1], diff[..., 2]))


def _topk_smallest(queries, points, k: int, r2=None):
    """Chunked ``(idx, d2)`` of the ``k`` smallest squared distances
    (entries beyond ``r2`` set to inf when given)."""
    idx_out, d2_out = [], []
    step = _chunk(points.shape[0])
    for s in range(0, queries.shape[0], step):
        d2 = _sq_dists(queries[s:s + step], points)
        if r2 is not None:
            d2 = torch.where(d2 <= r2, d2, torch.full_like(d2, float("inf")))
        vals, idx = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        idx_out.append(idx)
        d2_out.append(vals)
    return torch.cat(idx_out), torch.cat(d2_out)


def _padded(queries, points, idx, d2, k: int, k_eff: int) -> Neighborhoods:
    if k_eff < k:
        q = queries.shape[0]
        idx = torch.cat([idx, idx.new_zeros((q, k - k_eff))], 1)
        d2 = torch.cat([d2, d2.new_full((q, k - k_eff), float("inf"))], 1)
    mask = torch.isfinite(d2)
    idx = torch.where(mask, idx, torch.zeros_like(idx))
    dist = torch.where(mask, _exact_dist(queries, points, idx),
                       torch.full_like(d2, float("inf")))
    return Neighborhoods(idx, dist, mask)


def knn(queries, points, k: int) -> Neighborhoods:
    """Exact k nearest neighbors (the tail is masked if the cloud has fewer
    than ``k`` points)."""
    points = as_f32(points, resolve(None, points))
    queries = as_f32(queries, points.device)
    k_eff = min(k, points.shape[0])
    idx, d2 = _topk_smallest(queries, points, k_eff)
    return _padded(queries, points, idx, d2, k, k_eff)


def approx_knn(queries, points, k: int) -> Neighborhoods:
    """k near neighbors.  The reference uses ``approx_max_k`` here, a TPU
    partial reduction (exact on CPU); this port selects with the exact
    ``torch.topk``, so it returns the true k nearest."""
    return knn(queries, points, k)


def radius_search(queries, points, radius, k_max: int) -> Neighborhoods:
    """All neighbors within ``radius``, capped at the ``k_max`` nearest; the
    radius is rechecked on the exact distances."""
    points = as_f32(points, resolve(None, points))
    queries = as_f32(queries, points.device)
    k_eff = min(k_max, points.shape[0])
    r2 = torch.as_tensor(radius, dtype=torch.float32) ** 2
    with uploading(r2, points.device):
        r2 = r2.to(points.device)
    idx, d2 = _topk_smallest(queries, points, k_eff, r2=r2)
    nbr = _padded(queries, points, idx, d2, k_max, k_eff)
    mask = nbr.mask & (nbr.dist <= radius)
    return Neighborhoods(
        torch.where(mask, nbr.idx, torch.zeros_like(nbr.idx)),
        torch.where(mask, nbr.dist, torch.full_like(nbr.dist, float("inf"))),
        mask)


def radius_count(queries, points, radius) -> torch.Tensor:
    """Number of points within ``radius`` of each query."""
    points = as_f32(points, resolve(None, points))
    queries = as_f32(queries, points.device)
    r2 = float(radius) ** 2
    step = _chunk(points.shape[0])
    return torch.cat([
        (_sq_dists(queries[s:s + step], points) <= r2).sum(-1).to(torch.int32)
        for s in range(0, queries.shape[0], step)])


def nearest_neighbor(queries, points):
    """1-NN: ``(dist, idx)`` of shape ``(Q,)``, exact distances."""
    points = as_f32(points, resolve(None, points))
    queries = as_f32(queries, points.device)
    step = _chunk(points.shape[0])
    idx = torch.cat([
        torch.argmin(_sq_dists(queries[s:s + step], points), dim=-1)
        for s in range(0, queries.shape[0], step)])
    diff = queries - points[idx]
    return sqrt(sqnorm3(diff[:, 0], diff[:, 1], diff[:, 2])), idx
