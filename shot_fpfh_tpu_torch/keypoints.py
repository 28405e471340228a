"""Keypoint selection — the voxel strategies of ``shot_fpfh_tpu.keypoints``.

``subsampling`` keeps one representative per voxel (``core.subsampling``);
``subsampling_with_density`` keeps the representatives whose voxel
population (or radius-ball count, when a distinct density radius is given)
exceeds a threshold.  The random and iterative strategies are not ported
yet (ROADMAP.md, Queue 1, item 8).
"""

from __future__ import annotations

import numpy as np

from ._device import resolve
from .core.subsampling import _as_points, grid_subsample, voxel_counts_for_representatives
from .ops.neighbors import radius_count


def select_keypoints_subsampling(points, voxel_size, device=None) -> np.ndarray:
    return grid_subsample(points, voxel_size, device=resolve(device, points))


def select_keypoints_with_density_threshold(
    points, voxel_size, density_threshold_value: int,
    density_threshold_radius: float | None = None, device=None,
) -> np.ndarray:
    """Voxel representatives filtered by local density (reference
    keypoint_selection.py:65-122); returns host indices."""
    pts = _as_points(points, resolve(device, points))
    idx, mask, counts = voxel_counts_for_representatives(pts, voxel_size)
    idx, counts = idx[mask], counts[mask]
    if density_threshold_radius is None or density_threshold_radius == voxel_size:
        return idx[counts > density_threshold_value].cpu().numpy()
    ball = radius_count(pts[idx], pts, density_threshold_radius)
    return idx[ball > density_threshold_value].cpu().numpy()

