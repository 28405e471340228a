"""Grid (voxel) subsampling: one representative per non-empty voxel.

Port of ``shot_fpfh_tpu.core.subsampling`` with the same selection rule and
the same indices: voxelize at ``voxel_size`` from the cloud's minimum corner,
stable-sort by cell (x, y, z), and keep in each voxel the point closest to
the voxel barycenter, ties going to the earlier point in cell order (a
second stable sort on (cell, distance), ``core/subsampling.py:88-106``).
Each function runs on ``device``: by default the points tensor's device,
``cuda`` for host arrays (``_device.resolve``).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve
from .._fp import div, sqnorm3, sqrt
from ..utils.perf import blocking


def _as_points(points, device=None) -> torch.Tensor:
    from ..ops.neighbors import as_f32

    return as_f32(points, resolve(device, points))


def _stable_argsort(key: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Reorder ``order`` stably by ``key[order]``."""
    return order[torch.sort(key[order], stable=True).indices]


def _segment_sums(sorted_pts: torch.Tensor, lengths: torch.Tensor):
    """``(S, 3)`` sums of consecutive segments of ``sorted_pts`` with the
    given ``lengths``, each added from 0 in sorted order: the rounding of the
    CPU's ``index_add_`` and of XLA's ``segment_sum``, on every device (the
    card's ``index_add_`` adds in atomic order, so at an exact distance tie
    the barycenter's last bit could pick another representative).
    ``segment_reduce`` over a 2-D input runs one sequential loop per
    (segment, coordinate) on both devices: one launch, no host sync, the
    longest segment's length in steps."""
    return torch.segment_reduce(sorted_pts, "sum", lengths=lengths, axis=0, unsafe=True,
                                initial=0.0)


def _voxel_segments(points: torch.Tensor, voxel_size):
    """Points sorted by voxel: returns ``(order, seg, counts, d)`` with the
    sorted→original ``order``, each sorted point's segment id, per-segment
    point counts (f32, length N) and each sorted point's distance to its
    voxel barycenter."""
    n = points.shape[0]
    cell = torch.floor(div(points - points.min(dim=0).values, voxel_size)).to(torch.int64)
    order = torch.arange(n, device=points.device)
    # lexicographic (cx, cy, cz) = stable sorts from the minor key up
    for axis in (2, 1, 0):
        order = _stable_argsort(cell[:, axis], order)
    sorted_cell = cell[order]
    new_seg = torch.ones(n, dtype=torch.bool, device=points.device)
    new_seg[1:] = (sorted_cell[1:] != sorted_cell[:-1]).any(dim=1)
    seg = torch.cumsum(new_seg.to(torch.int64), 0) - 1
    sorted_pts = points[order]
    with blocking("voxel.segments"):
        starts = torch.nonzero(new_seg)[:, 0]
    lengths = torch.diff(starts, append=starts.new_full((1,), n))
    counts = torch.zeros(n, dtype=torch.float32, device=points.device)
    counts[:starts.shape[0]] = lengths.to(torch.float32)
    bary = _segment_sums(sorted_pts, lengths) / lengths.to(torch.float32)[:, None]
    diff = sorted_pts - bary[seg]
    d = sqrt(sqnorm3(diff[:, 0], diff[:, 1], diff[:, 2]))
    return order, seg, counts, d


def _representatives(seg: torch.Tensor, d: torch.Tensor):
    """Positions (into the voxel-sorted order) of each segment's point of
    least ``d``, with ties to the earlier position: a stable sort by
    (segment, distance), then each segment's first element."""
    pos = torch.arange(seg.shape[0], device=seg.device)
    pos = _stable_argsort(d, pos)
    pos = _stable_argsort(seg, pos)
    seg2 = seg[pos]
    first = torch.ones_like(seg2, dtype=torch.bool)
    first[1:] = seg2[1:] != seg2[:-1]
    with blocking("voxel.representatives"):
        return pos[first]


def grid_subsample_masked(points, voxel_size, device=None):
    """``(indices, mask)`` of shape ``(N,)``: the selected representatives
    in ascending original index, padded with ``N`` where ``mask`` is False."""
    pts = _as_points(points, device)
    n = pts.shape[0]
    order, seg, _, d = _voxel_segments(pts, voxel_size)
    chosen = torch.sort(order[_representatives(seg, d)]).values
    indices = torch.full((n,), n, dtype=torch.int64, device=pts.device)
    indices[:chosen.shape[0]] = chosen
    return indices, indices < n


def grid_subsample(points, voxel_size, device=None) -> np.ndarray:
    """Compacted host int array of the selected indices (the reference's
    ``grid_subsampling``)."""
    pts = _as_points(points, device)
    order, seg, _, d = _voxel_segments(pts, voxel_size)
    chosen = torch.sort(order[_representatives(seg, d)]).values
    with blocking("voxel.indices"):
        return chosen.cpu().numpy()


def voxel_counts_for_representatives(points, voxel_size, device=None):
    """``(indices, mask, counts)`` aligned with :func:`grid_subsample_masked`:
    each representative's voxel population (0 on padding)."""
    pts = _as_points(points, device)
    n = pts.shape[0]
    order, seg, counts, d = _voxel_segments(pts, voxel_size)
    rep = _representatives(seg, d)
    chosen, perm = torch.sort(order[rep])
    indices = torch.full((n,), n, dtype=torch.int64, device=pts.device)
    rep_counts = torch.zeros(n, dtype=torch.int32, device=pts.device)
    indices[:chosen.shape[0]] = chosen
    rep_counts[:chosen.shape[0]] = counts[seg[rep]][perm].to(torch.int32)
    return indices, indices < n, rep_counts
