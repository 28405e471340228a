"""Keypoint selection — port of ``shot_fpfh_tpu.keypoints``.

- ``iterative``: greedy coverage (select the first unvisited point, mark its
  radius ball visited, repeat).  Below ``AUTO_GRID_MIN_POINTS`` points the
  sequential greedy, one device step and one host sync per keypoint; from it
  up the round-parallel form over grid radius neighborhoods (K7), the same
  fixpoint while no ball reaches the neighbor cap.
- ``subsampling``: one representative per voxel (``core.subsampling``).
- ``subsampling_with_density``: the representatives whose voxel population
  (or radius-ball count, when a distinct density radius is given) exceeds a
  threshold.
- ``random``: indices drawn from an explicit CPU ``torch.Generator`` (the
  same draws on every device), or injected.  ``jax.random``'s draws cannot be
  reproduced in PyTorch, so the same seed picks other points than the JAX
  package; tests inject JAX's indices.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ._device import resolve
from ._fp import sqnorm3
from .core.subsampling import _as_points, grid_subsample, voxel_counts_for_representatives
from .ops import grid_hash
from .ops.neighbors import radius_count
from .utils.perf import blocking

logger = logging.getLogger(__name__)


def _all_visited(visited: torch.Tensor) -> bool:
    with blocking("keypoints.visited"):
        return bool(visited.all())


def _host_indices(mask: torch.Tensor) -> np.ndarray:
    """Host indices of the True entries of a device mask."""
    with blocking("keypoints.nonzero"):
        idx = torch.nonzero(mask)[:, 0]
    with blocking("keypoints.indices"):
        return idx.cpu().numpy()


def _kept(idx: torch.Tensor, keep: torch.Tensor) -> np.ndarray:
    """The entries of ``idx`` that ``keep`` flags, on the host."""
    with blocking("keypoints.kept"):
        kept = idx[keep]
    with blocking("keypoints.indices"):
        return kept.cpu().numpy()


def _densest(nbr) -> int:
    with blocking("keypoints.densest"):
        return int(nbr.count.max())


def _iterative_masked(points: torch.Tensor, radius) -> torch.Tensor:
    """Sequential greedy coverage; returns the ``(N,)`` selected mask."""
    n = points.shape[0]
    r2 = torch.tensor(radius, dtype=torch.float32, device=points.device) ** 2
    visited = torch.zeros(n, dtype=torch.bool, device=points.device)
    selected = torch.zeros_like(visited)
    while not _all_visited(visited):
        i = torch.argmax((~visited).to(torch.uint8))     # the first unvisited point
        selected[i] = True
        diff = points - points[i]
        visited |= sqnorm3(diff[:, 0], diff[:, 1], diff[:, 2]) <= r2
    return selected


def _iterative_rounds(idx: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Round-parallel greedy coverage from ``(N, k)`` neighborhoods: each
    round selects every unvisited point whose index is the least among its
    unvisited neighbors (itself included), then marks the selected points'
    neighborhoods visited — the lexicographically first maximal independent
    set of the radius graph, the sequential greedy's fixpoint.  Returns the
    selected mask and the number of rounds."""
    n = idx.shape[0]
    own = torch.arange(n, device=idx.device)
    visited = torch.zeros(n, dtype=torch.bool, device=idx.device)
    selected = torch.zeros_like(visited)
    rounds = 0
    while rounds < n and not _all_visited(visited):
        nbr_unvis = torch.where(mask & ~visited[idx], idx, n)
        new_sel = ~visited & (nbr_unvis.min(dim=1).values >= own)
        covered = (mask & new_sel[idx]).any(dim=1)
        visited |= covered | new_sel
        selected |= new_sel
        rounds += 1
    return selected, rounds


def select_keypoints_iteratively(points, radius, k_max: int = 128, device=None) -> np.ndarray:
    """Greedy coverage keypoints (reference keypoint_selection.py:11-31);
    returns host indices.  From ``AUTO_GRID_MIN_POINTS`` points up, radius
    balls of more than ``k_max`` points would be cut to the nearest ``k_max``:
    the cap is doubled (up to 8×) while the densest ball fills it, and a
    warning says when even that is not enough."""
    pts = _as_points(points, resolve(device, points))
    if pts.shape[0] < grid_hash.AUTO_GRID_MIN_POINTS:
        return _host_indices(_iterative_masked(pts, radius))
    grid = grid_hash.build_grid(pts, float(radius) / 2, halo=2)
    k_cap = k_max
    nbr = grid_hash.grid_radius_search(grid, pts, radius, k_cap)
    while _densest(nbr) >= k_cap and k_cap < 8 * k_max:
        k_cap *= 2
        nbr = grid_hash.grid_radius_search(grid, pts, radius, k_cap)
    if _densest(nbr) >= k_cap:
        logger.warning(
            "select_keypoints_iteratively: radius balls exceed the %d-neighbor "
            "cap even after auto-raising from %d; the greedy cover may be "
            "slightly denser than the reference's exact semantics "
            "(raise k_max or shrink the radius)", k_cap, k_max)
    selected, rounds = _iterative_rounds(nbr.idx, nbr.mask)
    with blocking("keypoints.count"):
        n_selected = int(selected.sum())
    logger.info("select_keypoints_iteratively: %d keypoints of %d points in %d rounds "
                "(neighbor cap %d)", n_selected, pts.shape[0], rounds, k_cap)
    return _host_indices(selected)


def select_keypoints_subsampling(points, voxel_size, device=None) -> np.ndarray:
    return grid_subsample(points, voxel_size, device=resolve(device, points))


def select_query_indices_randomly(n_points: int, n_feature_points: int,
                                  generator: torch.Generator | None = None,
                                  indices=None) -> np.ndarray:
    """``n_feature_points`` distinct indices below ``n_points``: ``indices``
    when given (checked), else drawn from ``generator`` (default: a CPU
    generator seeded 0)."""
    if indices is not None:
        idx = np.asarray(indices, np.int64)
        if (idx.shape != (n_feature_points,) or len(np.unique(idx)) != len(idx)
                or (len(idx) and (idx.min() < 0 or idx.max() >= n_points))):
            raise ValueError(f"indices must be {n_feature_points} distinct indices "
                             f"below {n_points}")
        return idx
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return torch.randperm(n_points, generator=generator)[:n_feature_points].numpy()


def select_keypoints_randomly(points, n_feature_points: int,
                              generator: torch.Generator | None = None, indices=None):
    """Random *points* (coordinates), as the reference returns
    (keypoint_selection.py:47-53); the generator defaults to a CPU one
    seeded 1."""
    if generator is None and indices is None:
        generator = torch.Generator().manual_seed(1)
    idx = select_query_indices_randomly(len(points), n_feature_points, generator, indices)
    if isinstance(points, torch.Tensor):
        return points[torch.as_tensor(idx, device=points.device)]
    return np.asarray(points)[idx]


def select_keypoints_with_density_threshold(
    points, voxel_size, density_threshold_value: int,
    density_threshold_radius: float | None = None, device=None,
) -> np.ndarray:
    """Voxel representatives filtered by local density (reference
    keypoint_selection.py:65-122); returns host indices."""
    pts = _as_points(points, resolve(device, points))
    idx, mask, counts = voxel_counts_for_representatives(pts, voxel_size)
    with blocking("keypoints.representatives"):
        idx = idx[mask]
    with blocking("keypoints.representatives"):
        counts = counts[mask]
    if density_threshold_radius is None or density_threshold_radius == voxel_size:
        return _kept(idx, counts > density_threshold_value)
    ball = radius_count(pts[idx], pts, density_threshold_radius)
    return _kept(idx, ball > density_threshold_value)
