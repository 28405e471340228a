"""RANSAC coarse alignment with every draw batched on the device.

Port of ``shot_fpfh_tpu.registration.ransac``: draws of ``draw_size``
matches (without replacement within a draw) are solved by batched Kabsch in
chunks of 512, each transform's inliers are counted over all matches, and
the first draw with the most inliers wins (the reference's tie rule: first
maximum within a chunk, strictly more to replace an earlier chunk).

Randomness comes from an explicit ``torch.Generator``.  It cannot reproduce
JAX's PRNG, so ``draws`` takes an explicit ``(n_draws, draw_size)`` index
array — the parity tests inject the reference's draws that way.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve
from ..core.solvers import solve_point_to_point
from ..core.transform import RigidTransform
from ..ops.neighbors import as_f32
from ..parallel.mesh import all_reduce_sums, local_rows
from ..utils.perf import blocking, span, uploading

_DRAW_CHUNK = 512


def sample_draws(m: int, n_draws: int, draw_size: int,
                 generator: torch.Generator | None = None,
                 device=None) -> torch.Tensor:
    """``(n_draws, draw_size)`` match indices on ``device``, distinct within
    each draw (rows with a repeat are redrawn until none is left).  They are
    drawn on the host from a CPU ``generator``, so one seed gives the same
    draws on every device."""
    if draw_size > m:
        raise ValueError(f"cannot draw {draw_size} distinct matches out of {m}")
    draws = torch.randint(m, (n_draws, draw_size), generator=generator)
    while True:
        s = torch.sort(draws, dim=1).values
        dup = (s[:, 1:] == s[:, :-1]).any(dim=1)
        n_dup = int(dup.sum())
        if n_dup == 0:
            with uploading(draws, device):
                return draws.to(device)
        draws[dup] = torch.randint(m, (n_dup, draw_size), generator=generator)


def ransac_on_matches(scan_matched, ref_matched, generator: torch.Generator | None = None,
                      draws=None, n_draws: int = 10000, draw_size: int = 4,
                      distance_threshold: float = 1.0):
    """Best rigid transform over random draws of matched keypoint pairs.

    ``scan_matched``/``ref_matched``: ``(M, 3)`` matched coordinates; the
    call runs on the scan tensor's device, on ``cuda`` for host arrays.
    Returns ``(inlier_ratio, transform)`` — best inlier count / M
    and the quaternion-renormalized transform."""
    scan = as_f32(scan_matched, resolve(None, scan_matched))
    ref = as_f32(ref_matched, scan.device)
    m = scan.shape[0]
    with span("ransac.draws"):
        if draws is None:
            draws = sample_draws(m, n_draws, draw_size, generator, scan.device)
        elif not isinstance(draws, torch.Tensor):
            draws = torch.as_tensor(np.array(draws))   # a copy: host arrays may be read-only
        with uploading(draws, scan.device):
            draws = draws.to(scan.device).long()
    return _search(scan, ref, draws, distance_threshold)


def _search(scan, ref, draws, distance_threshold: float, mesh=None,
            draw_chunk: int | None = None):
    """The search over ``draws`` (on the matches' device) in chunks of
    ``draw_chunk`` (default ``_DRAW_CHUNK``): each chunk's transforms
    solved, their inliers counted, the best kept (the first draw with the
    most inliers under any chunking).  With a ``mesh`` every rank solves
    the same transforms and counts them over its block of the matches, and
    the counts are summed over the ranks (whole numbers, exact)."""
    m = scan.shape[0]
    # a pad row's ref is at infinity: never an inlier
    scan_rows, ref_rows = local_rows(scan, mesh), local_rows(ref, mesh, fill=float("inf"))
    thr2 = torch.tensor(distance_threshold, dtype=torch.float32) ** 2
    with uploading(-1, scan.device):
        best_count = torch.tensor(-1, device=scan.device)
    best_rot = torch.eye(3, device=scan.device)
    best_t = torch.zeros(3, device=scan.device)
    step = _DRAW_CHUNK if draw_chunk is None else int(draw_chunk)
    with span("ransac.search"):
        for s in range(0, draws.shape[0], step):
            idx = draws[s:s + step]
            tf = solve_point_to_point(scan[idx], ref[idx])
            moved = (torch.einsum("cij,mj->cmi", tf.rotation, scan_rows)
                     + tf.translation[:, None, :])
            with uploading(thr2, scan.device):
                inlier = ((moved - ref_rows[None]) ** 2).sum(-1) <= thr2.to(scan.device)
            counts, = all_reduce_sums((inlier.sum(-1),), mesh)
            # a 0-d index tensor is read back to the host, once a use
            i = torch.argmax(counts)
            with blocking("ransac.best"):
                better = counts[i] > best_count
            with blocking("ransac.best"):
                best_count = torch.where(better, counts[i], best_count)
            with blocking("ransac.best"):
                best_rot = torch.where(better, tf.rotation[i], best_rot)
            with blocking("ransac.best"):
                best_t = torch.where(better, tf.translation[i], best_t)
    best = RigidTransform(best_rot, best_t).normalize_rotation()
    return best_count.to(torch.float32) / m, best
