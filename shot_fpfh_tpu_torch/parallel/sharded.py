"""The registration stages sharded over a mesh of ranks — port of
``shot_fpfh_tpu.parallel.sharded``.

Every rank holds the same full inputs and runs the single-device port's own
code on its block of rows, so the hand-written kernels run in every shard
as they do on one device; the ranks exchange only what the layout needs:

- **Descriptors** (SHOT, FPFH) and **normals**: queries sharded, the
  support cloud and its grid replicated; one ``all_gather`` of the result
  rows (FPFH: two, the SPFH table of every point between its passes).
  The k-NN normals' miss net re-solves, on every rank alike, the queries
  the gathered counts show under-covered.
- **Matching**: scan rows sharded, ref tiles passed round the ring (each
  rank sends its tile to ``rank + 1`` and takes ``rank − 1``'s), each tile
  through K2 with its validity mask, the running top-2 merged in the ring's
  visiting order.  Multiscale matching replicates the ref stack and
  combines the per-scale reciprocal column minima with one ``all_gather``.
- **RANSAC**: the same draws on every rank, inlier counts over the rank's
  matches summed by ``all_reduce`` (whole numbers, exact).
- **ICP**: the scan sharded; each iteration sums the solver's statistics
  (point-to-plane: the 6x6 normal equations; point-to-point: the Kabsch
  sums) with one ``all_reduce``, so every rank solves the same increment
  and stops at the same iteration.

Every branch is decided from replicated data, and :func:`mesh.agree` holds
its inputs equal across the ranks first, so a rank given other inputs
raises instead of leaving a collective to hang.  Results are full tensors
on the rank's device, the same on every rank.  A mesh of one rank runs the
single-device computation with its collectives (a 1-rank NCCL group on the
card).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._fp import sqrt
from ..core.transform import RigidTransform
from ..ops.match import top2_match
from ..ops.neighbors import as_f32
from .mesh import Mesh, agree, all_reduce_sums, gather_rows, local_rows, pad_to_multiple
from .mesh import ring_pass


# ------------------------------------------------------------- descriptors --
def sharded_shot_descriptors(keypoints, support, normals, radius: float, mesh: Mesh, *,
                             k_max: int = 256, min_neighborhood_size: int = 100,
                             normalize: bool = True, use_grid: bool | None = None,
                             rf_radius: float | None = None, shared_rfs=None,
                             return_rfs: bool = False):
    """SHOT descriptors ``(Q, 352)`` with the keypoints sharded over the
    mesh (JAX ``sharded.py:46-215``): every rank runs the one-device route
    (``models.shot``: the grid through SG where ``models.shot.takes_grid``
    holds or ``use_grid=True``, else the brute search capped at ``k_max``)
    on its block of keypoints.
    ``rf_radius`` takes the frames from a second radius (bi-scale);
    ``shared_rfs`` reuses frames: the rank's block that ``return_rfs=True``
    returned (it stays on the rank, for the next scale over the same
    keypoints), or a full ``(Q, 3, 3)`` array."""
    from ..models import shot as m_shot

    dev = mesh.device
    sup, nrm, kp_all = (as_f32(x, dev) for x in (support, normals, keypoints))
    n_kp = kp_all.shape[0]
    kp = local_rows(kp_all, mesh)
    rfs = None
    if shared_rfs is not None:
        local = isinstance(shared_rfs, torch.Tensor) and shared_rfs.shape[0] == kp.shape[0]
        rfs = shared_rfs.to(dev) if local else local_rows(as_f32(shared_rfs, dev), mesh)
    agree("the SHOT route", mesh, n_kp, sup.shape[0], -1 if use_grid is None else use_grid,
          rfs is None, rf_radius is not None)
    desc, rfs_out = m_shot._shot_routed(
        kp, sup, nrm, radius, k_max=k_max, normalize=normalize,
        min_neighborhood_size=min_neighborhood_size, local_rfs=rfs, rf_radius=rf_radius,
        use_grid=use_grid)
    full = gather_rows(desc, n_kp, mesh)
    return (full, rfs_out) if return_rfs else full


# ---------------------------------------------------------------- normals ---
def sharded_normals(query_points, cloud_points, mesh: Mesh, *, k: int | None = None,
                    radius: float | None = None, pre_computed_normals=None, k_max: int = 64,
                    sample_size: int = 512) -> torch.Tensor:
    """PCA normals ``(Q, 3)`` with the queries sharded over the mesh (JAX
    ``sharded.py:218-387``): every rank runs the routes of
    ``models.normals.compute_normals`` on its block of queries (K3 on the
    grid routes); the k-NN streaming route's exactness net re-solves, on
    every rank alike, the queries whose gathered counts fell under ``k``."""
    from ..models import normals as m_nrm

    if k is None and radius is None:
        raise ValueError("Provide k or radius.")
    dev = mesh.device
    c, q = as_f32(cloud_points, dev), as_f32(query_points, dev)
    pre = None if pre_computed_normals is None else as_f32(pre_computed_normals, dev)
    agree("the normals route", mesh, q.shape[0], c.shape[0], k or 0, pre is None)
    return m_nrm._normals(q, c, k, radius, pre, k_max, mesh, sample_size)


# ------------------------------------------------------------------ FPFH ----
def sharded_fpfh(keypoint_indices, cloud_points, normals, radius: float, mesh: Mesh, *,
                 n_bins: int = 5, k_max: int = 128, decorrelated: bool = False) -> torch.Tensor:
    """FPFH of the keypoints (indices into the cloud) with both passes
    sharded over the mesh (JAX ``sharded.py:390-565``), on the one-device
    route (``models.fpfh``).  Pass 1: the SPFH of the rank's block of cloud
    points (padded queries at the far sentinel): from
    ``AUTO_GRID_MIN_POINTS`` points over a replicated halo-2 grid in its
    sorted order, through the SPFH pass kernel; below it the capped
    brute search.  One ``all_gather`` of the ``(N, D)`` SPFH table.  Pass
    2: the rank's block of keypoints, their neighborhoods found again and
    the neighbors' SPFH rows aggregated (grid: K7's aggregation mode); one
    ``all_gather`` of the rows."""
    from ..models import fpfh as m_fpfh

    dev = mesh.device
    cloud, nrm = as_f32(cloud_points, dev), as_f32(normals, dev)
    kp = torch.as_tensor(keypoint_indices).to(device=dev, dtype=torch.int64).reshape(-1)
    agree("the FPFH route", mesh, cloud.shape[0], kp.shape[0])
    return m_fpfh._fpfh(cloud, nrm, kp, radius, n_bins, decorrelated, k_max, mesh)


# ------------------------------------------------------------ ring matching --
class RingMatchResult(NamedTuple):
    idx: torch.Tensor   # (Qs,) global index of the nearest ref descriptor
    d1: torch.Tensor    # (Qs,) nearest distance
    d2: torch.Tensor    # (Qs,) second-nearest distance


def ring_match(scan_descriptors, ref_descriptors, mesh: Mesh, *,
               use_bf16: bool = True) -> RingMatchResult:
    """Nearest and second-nearest ref descriptor of each scan descriptor
    (JAX ``sharded.py:568-656``): scan rows sharded, the ref padded to a
    multiple of twice the mesh size and cut into one tile a rank; the tiles
    travel round the ring, so at step ``i`` a rank holds the tile of rank
    ``(rank − i) % n``.  Each tile goes through K2 with its validity mask
    (bf16 operands, norms from the rounded values, f32 accumulation: the
    function JAX's XLA tile computes), and the running top-2 is merged in
    the ring's visiting order with JAX's strict ``<``, so tied refs map to
    JAX's index."""
    dev = mesh.device
    a_all, b_all = as_f32(scan_descriptors, dev), as_f32(ref_descriptors, dev)
    n_scan, n_ref, n = a_all.shape[0], b_all.shape[0], mesh.size
    agree("the ring's shapes", mesh, n_scan, n_ref, a_all.shape[1], use_bf16)
    a = local_rows(a_all, mesh)
    b_pad, _ = pad_to_multiple(b_all, 2 * n)
    qb = b_pad.shape[0] // n
    tile = b_pad[mesh.rank * qb:(mesh.rank + 1) * qb]
    valid = torch.arange(mesh.rank * qb, (mesh.rank + 1) * qb, device=dev) < n_ref
    inf = float("inf")
    best_d = torch.full((a.shape[0],), inf, device=dev)
    second = torch.full((a.shape[0],), inf, device=dev)
    best_i = torch.zeros(a.shape[0], dtype=torch.int64, device=dev)
    for i in range(n):
        src = (mesh.rank - i) % n
        i1, d1_sq, d2_sq = top2_match(a, tile, valid, use_bf16)
        d1 = sqrt(torch.clamp(d1_sq, min=0.0))
        d2 = sqrt(torch.clamp(d2_sq, min=0.0))
        better = d1 < best_d
        second = torch.minimum(torch.minimum(torch.maximum(best_d, d1), second), d2)
        best_d = torch.where(better, d1, best_d)
        best_i = torch.where(better, src * qb + i1, best_i)
        if i + 1 < n:
            tile, valid = ring_pass(tile, mesh), ring_pass(valid, mesh)
    return RingMatchResult(*(gather_rows(x, n_scan, mesh) for x in (best_i, best_d, second)))


def sharded_multiscale_match(scan_ms, ref_ms, mesh: Mesh, *,
                             filter_nonreciprocal: bool = False):
    """``registration.matching.multiscale_top1`` with the scan rows sharded
    and the ref stack replicated (JAX ``sharded.py:659-722``); returns
    ``(idx (Q,), dist (Q,))``.  The reciprocal filter gathers each scale's
    ``(R,)`` column minima and argmins once; ties go to the lowest global
    row, so the indices are the single-device function's."""
    from ..registration import matching as m

    dev = mesh.device
    a_all, b = as_f32(scan_ms, dev), as_f32(ref_ms, dev)
    n_points = a_all.shape[1]
    agree("the multiscale shapes", mesh, *a_all.shape, *b.shape, filter_nonreciprocal)
    # the rank's block of scan rows; pad rows are all zero, so invalid
    a = local_rows(a_all.transpose(0, 1), mesh).transpose(0, 1)
    idx, dist = m._ms_combined_top1(a, b, *m._ms_row_mask(a, b, filter_nonreciprocal, mesh))
    return gather_rows(idx, n_points, mesh), gather_rows(dist, n_points, mesh)


# ----------------------------------------------------------------- RANSAC ---
def sharded_ransac(scan_matched, ref_matched, generator: torch.Generator | None,
                   mesh: Mesh, *, draws=None, n_draws: int = 10000, draw_size: int = 4,
                   distance_threshold: float = 1.0, draw_chunk: int | None = None):
    """``registration.ransac.ransac_on_matches`` with the inlier counting
    sharded over the matches (JAX ``sharded.py:725-800``): the draws are the
    same on every rank (``sample_draws`` from the CPU ``generator``, or
    ``draws``), each chunk's transforms are solved on every rank alike, and
    each transform's inliers among the rank's matches are summed with
    ``all_reduce`` (whole numbers, exact).  The first draw with the most
    inliers wins (strictly more to replace an earlier chunk's), so the
    result does not depend on ``draw_chunk``, the draws solved at a time
    (default: the one-device search's).  Returns ``(inlier ratio,
    transform)``."""
    from ..registration.ransac import _search, sample_draws

    dev = mesh.device
    scan, ref = as_f32(scan_matched, dev), as_f32(ref_matched, dev)
    m = scan.shape[0]
    if draws is None:
        draws = sample_draws(m, n_draws, draw_size, generator)
    elif not isinstance(draws, torch.Tensor):
        draws = torch.as_tensor(np.array(draws))   # a copy: host arrays may be read-only
    draws = draws.long()
    agree("the RANSAC draws", mesh, m, *draws.shape, int(draws.sum()))
    return _search(scan, ref, draws.to(dev), distance_threshold, mesh, draw_chunk)


# -------------------------------------------------------------------- ICP ---
def sharded_icp(scan_sub, ref, ref_normals, init: RigidTransform, mesh: Mesh, *,
                d_max: float, max_iter: int = 50, rms_threshold: float = 1e-3,
                point_to_plane: bool = True) -> tuple[RigidTransform, float, bool, int]:
    """ICP with the (subsampled) scan sharded over the mesh (JAX
    ``sharded.py:803-913``): ``registration.icp.icp_loop`` on the rank's
    points (pad rows weighted 0), the solver's sums (point-to-plane: the
    normal equations, point-to-point: the Kabsch statistics) and the RMS
    sums reduced over the ranks by one ``all_reduce`` an iteration, so
    ``done`` comes from the reduced sums and every rank stops at the same
    iteration.  The 1-NN runs K7 on a replicated grid of the ref at cell
    ``d_max`` from ``AUTO_GRID_MIN_POINTS`` ref points up.  Returns
    ``(transform, rms, has_converged, n_iters)``."""
    from ..registration import icp as m_icp

    if point_to_plane and ref_normals is None:
        raise ValueError("point-to-plane ICP needs ref_normals")
    dev = mesh.device
    scan = as_f32(scan_sub, dev)
    ref_t = as_f32(ref, dev)
    normals = as_f32(ref_normals, dev) if point_to_plane else None
    agree("the ICP inputs", mesh, scan.shape[0], ref_t.shape[0], point_to_plane, max_iter)
    valid = local_rows(torch.ones(scan.shape[0], device=dev), mesh)
    out = m_icp.icp_loop(local_rows(scan, mesh), ref_t, normals, init, d_max, max_iter,
                         rms_threshold, m_icp.nn_grid(ref_t, d_max), weights=valid,
                         reduce=lambda sums: all_reduce_sums(sums, mesh))
    return out.transform, float(out.rms), bool(out.has_converged), int(out.n_iters)
