"""The single-program registration path — port of
``shot_fpfh_tpu.registration.fused``.

The JAX package compiles the whole chain —

  descriptors (scan + ref) → ratio matching → RANSAC → point-to-plane ICP

— into one ``jit``.  Here it is one call that keeps every intermediate on
the device and reads nothing back between RANSAC's first draw and the end
of ICP except ICP's ``done`` flag, once every ``ICP_BLOCK`` iterations
(``registration.icp.icp_loop``, the loop the staged ICP runs too), and the
one status read of the batched SVD that solves every RANSAC draw.

The same fixed-shape conventions as the JAX program:

- keypoints are padded with validity masks; padding rows get all-zero
  descriptors, which matching treats as empty (here they are computed like
  any row and then zeroed: the per-row result is the same);
- the match list is a boolean ``valid_match`` row mask;
- RANSAC samples ``draw_size`` valid matches per draw by masked Gumbel-top-k
  and counts inliers only over valid rows;
- ICP runs on a pre-subsampled, padded scan with per-point validity weights.

Descriptor routes, as in the JAX program: SHOT on a grid takes SG (on CPU
tensors K8 + K1's twins in chunks), and takes the grid by the staged path's
rule (``models.shot.takes_grid``); FPFH on a grid takes the SPFH pass
kernel for SPFH and K7's aggregation mode for the aggregation; without
grids the brute routes run.  Matching is K2 in
float32; ICP's grid 1-NN is K7's 1-NN mode.

Randomness: the Gumbel noise is drawn from a ``torch.Generator`` on the
call's device seeded with ``seed``; it cannot reproduce ``jax.random``, so
``gumbel`` injects the noise instead (the parity tests pass JAX's).

Over a mesh of ranks (``parallel.mesh``; :func:`fused_registration_mesh`,
JAX ``fused.py:323-716``) every leg runs the same code on the rank's block
of rows, through ``local_rows``/``gather_rows``/``all_reduce_sums``, which
are the identity without a mesh: the keypoints are row-sharded and the
clouds and grids replicated; FPFH's SPFH pass shards the table rows and
gathers the ``(N, D)`` table once (``models.fpfh._fpfh_rows``); matching
keeps the scan rows sharded against the gathered ref descriptors;
RANSAC's draws are the same on every rank (the match rows gathered once,
the noise from one seed on one device type) and each rank counts inliers
over its match rows, the count vector summed by one ``all_reduce`` (whole
numbers: the first maximum is the one device's); ICP sums its normal
equations (or Kabsch sums) over the ranks once an iteration
(``icp_loop(reduce=)``).  Every rank returns the same result.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve
from .._fp import sqrt
from ..core.solvers import solve_point_to_point
from ..core.subsampling import grid_subsample
from ..core.transform import RigidTransform
from ..models.fpfh import _fpfh_rows, _sorted_rows
from ..models.shot import (
    _shot_on_grid,
    local_reference_frames,
    shot_from_neighborhoods,
    takes_grid,
)
from ..ops import grid_hash
from ..ops.grid_hash import build_grid
from ..ops.match import top2_match
from ..ops.neighbors import as_f32, radius_search
from ..parallel.mesh import agree, all_reduce_sums, gather_rows, local_rows, replicate
from .icp import icp_loop

# RANSAC draws per Gumbel-top-k chunk (the JAX program's scan step): the
# noise is drawn and the draws picked one (RANSAC_CHUNK, Q) tile at a time
RANSAC_CHUNK = 256

DESCRIPTORS = ("shot", "fpfh", "shot_multiscale")


class FusedResult(NamedTuple):
    ransac_transform: RigidTransform
    icp_transform: RigidTransform
    ransac_inlier_ratio: torch.Tensor
    n_matches: torch.Tensor
    icp_rms: torch.Tensor
    icp_converged: torch.Tensor
    # keypoint indices derived by register_pair (grid subsampling at
    # keypoint_voxel); None when fused_registration is called directly.
    # Recorded so callers (pipeline.run_fused) don't repeat the full-cloud
    # subsample passes.
    scan_keypoint_idx: np.ndarray | None = None
    ref_keypoint_idx: np.ndarray | None = None


def _shot(kp, valid, sup, nrm, radius, k_max, min_nb, grid=None, rf_radius=None,
          local_rfs=None, return_rfs=False):
    """Single-scale SHOT, or bi-scale when ``rf_radius`` is given (frames
    from the ``rf_radius`` neighborhood, bins over ``radius``);
    ``local_rfs``/``return_rfs`` thread shared frames across multiscale
    scales.  With ``grid`` (cell covering ``max(radius, rf_radius)``,
    carrying normals): the exact uncapped neighborhoods through SG
    (``models.shot._shot_on_grid``); without: a brute search
    capped at the ``k_max`` nearest within the larger radius."""
    if grid is not None:
        desc, rfs = _shot_on_grid(grid, kp, local_rfs, radius, True, min_nb,
                                  rf_radius=rf_radius)
        desc = torch.where(valid[:, None], desc, 0.0)
        return (desc, rfs) if return_rfs else desc
    search_r = radius if rf_radius is None else max(radius, rf_radius)
    nbr = radius_search(kp, sup, search_r, k_max)
    mask = nbr.mask & valid[:, None] & (nbr.dist <= radius)
    nb_pts, nb_nrm = sup[nbr.idx], nrm[nbr.idx]
    if local_rfs is not None:
        rfs = local_rfs
    elif rf_radius is None:
        rfs = local_reference_frames(kp, nb_pts, mask, radius)
    else:
        mask_rf = nbr.mask & valid[:, None] & (nbr.dist <= rf_radius)
        rfs = local_reference_frames(kp, nb_pts, mask_rf, rf_radius)
    desc = shot_from_neighborhoods(kp, nb_pts, nb_nrm, mask, rfs, radius, normalize=True,
                                   min_neighborhood_size=min_nb)
    return (desc, rfs) if return_rfs else desc


def _fpfh(kp_idx, valid, sup, nrm, radius, k_max, n_bins, decorrelated, grid=None, mesh=None):
    """FPFH of the keypoints ``kp_idx`` (the rank's block): grid-sorted
    indices when ``grid`` (cell ``radius/2``, halo 2, carrying normals) is
    given — SPFH of every point through the SPFH pass kernel, aggregation
    in K7's aggregation mode — original cloud indices otherwise (brute
    search capped at ``k_max``); over a mesh each rank's SPFH pass takes its block of the
    cloud's rows (``models.fpfh._fpfh_rows``).  Padding rows are zeroed
    like empty SHOT rows."""
    desc = _fpfh_rows(sup, nrm, kp_idx, radius, n_bins, decorrelated, k_max, mesh, grid)
    return torch.where(valid[:, None], desc, 0.0)


def _cloud_descriptors(kp, valid, sup, nrm, kp_idx, grid, fpfh_grid, *, descriptor, radius,
                       k_max, min_neighborhood_size, rf_radius, fpfh_n_bins,
                       fpfh_decorrelated, ms_radii, mesh=None):
    """One cloud's descriptor leg on the rank's block of keypoints (``kp``,
    ``valid``, ``kp_idx``): ``(Q, 352)`` SHOT, ``(Q, 352·S)`` multiscale
    SHOT or ``(Q, D)`` FPFH."""
    if descriptor == "fpfh":
        return _fpfh(kp_idx, valid, sup, nrm, radius, k_max, fpfh_n_bins, fpfh_decorrelated,
                     grid=fpfh_grid, mesh=mesh)
    if descriptor == "shot_multiscale":
        # every scale takes the first (smallest-radius) scale's frames (over
        # a mesh, the rank's own); the scales concatenate, the reference
        # multiscale workflow's layout
        descs, rfs = [], None
        for r in ms_radii:
            d_s, rfs_s = _shot(kp, valid, sup, nrm, r, k_max, min_neighborhood_size, grid=grid,
                               local_rfs=rfs, return_rfs=True)
            if rfs is None:
                rfs = rfs_s
            descs.append(d_s)
        return torch.cat(descs, dim=1)
    return _shot(kp, valid, sup, nrm, radius, k_max, min_neighborhood_size, grid=grid,
                 rf_radius=rf_radius)


def _ratio_match(scan_desc, scan_kp_valid, ref_desc, ref_kp_valid, ratio_threshold):
    """``(nn_idx, valid_match)``: each scan row's nearest valid ref row by
    K2 in float32 (JAX's ``descriptor_sq_dists`` + ``top2_rows``), kept
    when the scan row is valid and non-empty and its distance ratio to the
    second nearest is at most ``ratio_threshold``."""
    ref_ok = (ref_desc != 0).any(dim=1) & ref_kp_valid
    nn_idx, d1_sq, d2_sq = top2_match(scan_desc, ref_desc, ref_ok, use_bf16=False)
    d1 = sqrt(torch.clamp(d1_sq, min=0.0))           # inf rows stay inf
    dsecond = sqrt(torch.clamp(d2_sq, min=0.0))
    scan_ok = (scan_desc != 0).any(dim=1) & scan_kp_valid
    ratio = d1 / torch.where(dsecond > 0, dsecond, 1.0)
    return nn_idx, scan_ok & (ratio <= ratio_threshold) & torch.isfinite(d1)


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(u))`` with ``u`` uniform in
    ``[tiny, 1)`` (``jax.random.gumbel``'s form)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


def _ransac(src, dst, valid_match, n_matches, ransac_threshold, n_draws, draw_size,
            generator, gumbel=None, mesh=None):
    """``(transform, inlier_ratio)`` of the best of ``ceil(n_draws / 256)·256``
    draws of ``draw_size`` valid matches each (masked Gumbel-top-k per
    chunk of 256; ``gumbel``, when given, is the ``(n_chunks, 256, Q)``
    noise).  Every draw is solved in one batched call; inliers (within
    ``ransac_threshold``, over valid matches) are counted a chunk at a time,
    over a mesh among the rank's match rows, the counts then summed over the
    ranks in one ``all_reduce``.  The first draw with the most inliers wins:
    the JAX program's rule (the first maximum within a chunk, a later chunk
    only with strictly more)."""
    n_chunks = -(-n_draws // RANSAC_CHUNK)
    if gumbel is not None and gumbel.shape != (n_chunks, RANSAC_CHUNK, src.shape[0]):
        raise ValueError(f"gumbel must have shape {(n_chunks, RANSAC_CHUNK, src.shape[0])}, "
                         f"got {tuple(gumbel.shape)}")
    draws = []
    for c in range(n_chunks):
        g = (_gumbel((RANSAC_CHUNK, src.shape[0]), generator, src.device) if gumbel is None
             else gumbel[c].to(src.device))
        logits = torch.where(valid_match[None, :], g, float("-inf"))
        draws.append(torch.topk(logits, draw_size, dim=1).indices)
    draws = torch.cat(draws)
    tf = solve_point_to_point(src[draws], dst[draws])
    thr2 = float(np.float32(ransac_threshold) ** 2)
    src_rows, dst_rows = local_rows(src, mesh), local_rows(dst, mesh)
    match_w = local_rows(valid_match.to(torch.float32), mesh)
    counts = []
    for s in range(0, draws.shape[0], RANSAC_CHUNK):
        rot, t = tf.rotation[s:s + RANSAC_CHUNK], tf.translation[s:s + RANSAC_CHUNK]
        moved = torch.einsum("cij,mj->cmi", rot, src_rows) + t[:, None, :]
        dd = ((moved - dst_rows[None]) ** 2).sum(-1)
        counts.append(((dd <= thr2).to(torch.float32) * match_w[None, :]).sum(-1))
    (counts,) = all_reduce_sums((torch.cat(counts),), mesh)
    # a 1-element index tensor keeps the pick on the device
    best = torch.argmax(counts).view(1)
    ransac_tf = RigidTransform(tf.rotation[best][0], tf.translation[best][0]).normalize_rotation()
    return ransac_tf, counts[best][0] / torch.clamp(n_matches.to(torch.float32), min=1.0)


def fused_registration(
    scan_kp: torch.Tensor,         # (Qs, 3) padded scan keypoints
    scan_kp_valid: torch.Tensor,   # (Qs,) bool
    ref_kp: torch.Tensor,          # (Qr, 3)
    ref_kp_valid: torch.Tensor,    # (Qr,)
    scan_support: torch.Tensor,    # (Ns, 3) descriptor support clouds
    scan_normals: torch.Tensor,
    ref_support: torch.Tensor,     # (Nr, 3)
    ref_normals: torch.Tensor,
    scan_sub: torch.Tensor,        # (S, 3) ICP-subsampled scan
    scan_sub_valid: torch.Tensor,  # (S,)
    *,
    radius: float,
    seed: int = 72,
    gumbel: torch.Tensor | None = None,
    ratio_threshold: float = 0.9,
    ransac_threshold: float = 0.3,
    d_max: float = 0.3,
    rms_threshold: float = 1e-4,
    k_max: int = 256,
    min_neighborhood_size: int = 10,
    n_draws: int = 2048,
    draw_size: int = 4,
    max_iter: int = 40,
    point_to_plane: bool = True,
    scan_grid=None,
    ref_grid=None,
    ref_icp_grid=None,
    descriptor: str = "shot",      # "shot" | "fpfh" | "shot_multiscale"
    rf_radius=None,                # bi-scale SHOT: frames from this radius
    fpfh_n_bins: int = 5,
    fpfh_decorrelated: bool = False,
    scan_kp_idx=None,              # FPFH: keypoint indices (sorted order
    ref_kp_idx=None,               # when the fpfh grids are given)
    scan_fpfh_grid=None,
    ref_fpfh_grid=None,
    ms_radii=None,                 # multiscale: tuple of scale radii
    mesh=None,                     # parallel.Mesh: shard every leg over its ranks
) -> FusedResult:
    """Descriptors, ratio matching, RANSAC and ICP of one padded pair, on
    the device the tensors are on (every input on one device).  With a
    ``mesh`` every rank passes the same full inputs on its own device and
    computes its block of each leg's rows (module docstring); every rank
    returns the same result."""
    if descriptor not in DESCRIPTORS:
        raise ValueError(f"descriptor must be one of {DESCRIPTORS}, got {descriptor!r}")
    grids = (scan_grid, ref_grid, ref_icp_grid, scan_fpfh_grid, ref_fpfh_grid)
    if mesh is not None:
        # every branch below and the Gumbel stream (one seed, one device
        # type) must be the same on every rank: one check, before the
        # first collective
        agree("the fused program", mesh, DESCRIPTORS.index(descriptor),
              *(g is not None for g in grids), scan_kp.shape[0],
              ref_kp.shape[0], scan_sub.shape[0], scan_support.shape[0],
              ref_support.shape[0], n_draws, draw_size, max_iter, point_to_plane,
              gumbel is None, scan_kp.device.type == "cuda")
    rows = functools.partial(local_rows, mesh=mesh)
    opts = dict(descriptor=descriptor, radius=radius, k_max=k_max,
                min_neighborhood_size=min_neighborhood_size, rf_radius=rf_radius,
                fpfh_n_bins=fpfh_n_bins, fpfh_decorrelated=fpfh_decorrelated,
                ms_radii=ms_radii, mesh=mesh)
    scan_kp_valid_rows = rows(scan_kp_valid)
    scan_desc = _cloud_descriptors(
        rows(scan_kp), scan_kp_valid_rows, scan_support, scan_normals,
        None if scan_kp_idx is None else rows(scan_kp_idx), scan_grid, scan_fpfh_grid, **opts)
    ref_desc = gather_rows(_cloud_descriptors(
        rows(ref_kp), rows(ref_kp_valid), ref_support, ref_normals,
        None if ref_kp_idx is None else rows(ref_kp_idx), ref_grid, ref_fpfh_grid, **opts),
        ref_kp.shape[0], mesh)

    # the rank's scan rows against every ref row; RANSAC draws over all the
    # match rows, so they are gathered once (nearest index and validity)
    nn_idx, valid_match = _ratio_match(scan_desc, scan_kp_valid_rows, ref_desc, ref_kp_valid,
                                       ratio_threshold)
    matches = gather_rows(torch.stack((nn_idx, valid_match.to(nn_idx.dtype)), 1),
                          scan_kp.shape[0], mesh)
    nn_idx, valid_match = matches[:, 0], matches[:, 1].bool()
    n_matches = valid_match.sum()

    generator = torch.Generator(device=scan_kp.device).manual_seed(seed)
    ransac_tf, inlier_ratio = _ransac(scan_kp, ref_kp[nn_idx], valid_match, n_matches,
                                      ransac_threshold, n_draws, draw_size, generator, gumbel,
                                      mesh)

    icp = icp_loop(rows(scan_sub), ref_support, ref_normals if point_to_plane else None,
                   ransac_tf, d_max, max_iter, rms_threshold, grid=ref_icp_grid,
                   weights=rows(scan_sub_valid.to(torch.float32)),
                   reduce=None if mesh is None else functools.partial(all_reduce_sums,
                                                                      mesh=mesh))
    return FusedResult(ransac_tf, icp.transform, inlier_ratio, n_matches, icp.rms,
                       icp.has_converged)


def _grid_on(grid, device):
    """``grid`` with its tensors on ``device`` (None stays None)."""
    if grid is None:
        return None
    return dataclasses.replace(grid, **{
        f.name: getattr(grid, f.name).to(device) for f in dataclasses.fields(grid)
        if isinstance(getattr(grid, f.name), torch.Tensor)})


_MESH_GRIDS = ("scan_grid", "ref_grid", "ref_icp_grid", "scan_fpfh_grid", "ref_fpfh_grid")


def fused_registration_mesh(mesh, scan_kp, scan_kp_valid, ref_kp, ref_kp_valid, scan_support,
                            scan_normals, ref_support, ref_normals, scan_sub, scan_sub_valid, *,
                            radius: float, seed: int = 72, gumbel=None,
                            **kwargs) -> FusedResult:
    """:func:`fused_registration` sharded over ``mesh`` (JAX
    ``fused.py:323-716``): every rank passes the same full host arrays or
    tensors (the keyword arguments are :func:`fused_registration`'s), which
    are placed on the rank's device; the keypoint and ICP rows shard over
    the ranks, the clouds and grids are replicated.  The rows of
    ``scan_kp``, ``ref_kp`` and ``scan_sub`` must divide the mesh
    (``register_pair`` pads to ``lcm(pad_multiple, mesh size)``).  Returns
    the same ``FusedResult`` on every rank, on its device."""
    n_dev = mesh.devices.size
    for name, arr in (("scan_kp", scan_kp), ("ref_kp", ref_kp), ("scan_sub", scan_sub)):
        if len(arr) % n_dev:
            raise ValueError(f"{name} rows ({len(arr)}) must divide the mesh ({n_dev})")
    dev = mesh.device
    points = [as_f32(x, dev) for x in (scan_kp, ref_kp, scan_support, scan_normals,
                                        ref_support, ref_normals, scan_sub)]
    valid = [replicate(np.asarray(v, bool) if not isinstance(v, torch.Tensor) else v.bool(),
                       mesh) for v in (scan_kp_valid, ref_kp_valid, scan_sub_valid)]
    for name in ("scan_kp_idx", "ref_kp_idx"):
        if kwargs.get(name) is not None:
            kwargs[name] = replicate(kwargs[name], mesh).long()
    for name in _MESH_GRIDS:
        kwargs[name] = _grid_on(kwargs.get(name), dev)
    skp, rkp, ssup, snrm, rsup, rnrm, sub = points
    return fused_registration(skp, valid[0], rkp, valid[1], ssup, snrm, rsup, rnrm, sub,
                              valid[2], radius=radius, seed=seed, gumbel=gumbel, mesh=mesh,
                              **kwargs)


def _padded(rows: torch.Tensor, mult: int):
    """``rows`` zero-padded to a multiple of ``mult`` (at least one), and
    the validity mask of the padded rows."""
    n = rows.shape[0]
    target = -(-max(n, 1) // mult) * mult
    out = rows.new_zeros((target,) + tuple(rows.shape[1:]))
    out[:n] = rows
    return out, torch.arange(target, device=rows.device) < n


def register_pair(scan, scan_normals, ref, ref_normals, *, keypoint_voxel: float,
                  icp_voxel: float, radius: float, seed: int = 72, pad_multiple: int = 256,
                  mesh=None, device=None, **fused_kwargs) -> FusedResult:
    """Keypoints (grid subsampling at ``keypoint_voxel``) and the ICP
    subsample (at ``icp_voxel``) of both clouds, padded to multiples of
    ``pad_multiple``, then :func:`fused_registration` on ``device``
    (default ``cuda``).  The SHOT leg gets a grid where
    ``models.shot.takes_grid`` holds (on the card at any size, on CPU
    tensors from ``AUTO_GRID_MIN_POINTS`` cloud points; cell
    ``max(radius, rf_radius)`` or the largest multiscale radius, carrying
    normals), the FPFH leg from ``AUTO_GRID_MIN_POINTS`` cloud points (cell
    ``radius/2``, halo 2, keypoints as sorted-order indices), and ICP from
    as many ref points a grid of the ref at cell ``d_max`` (``d_max``
    pinned, default 0.3).  With a ``mesh`` of
    more than one rank (every rank given the same clouds) the rows pad to
    ``lcm(pad_multiple, mesh size)`` and the program shards over it on the
    rank's device (:func:`fused_registration_mesh`).  Returns the result
    with the keypoint indices."""
    use_mesh = mesh is not None and mesh.devices.size > 1
    if use_mesh:
        # every row-sharded input must divide the mesh
        pad_multiple = math.lcm(pad_multiple, mesh.devices.size)
    dev = mesh.device if use_mesh else resolve(device, scan)
    scan_t, ref_t = as_f32(scan, dev), as_f32(ref, dev)
    scan_n, ref_n = as_f32(scan_normals, dev), as_f32(ref_normals, dev)
    scan_kp_idx = grid_subsample(scan_t, keypoint_voxel)
    ref_kp_idx = grid_subsample(ref_t, keypoint_voxel)
    scan_idx = torch.as_tensor(scan_kp_idx, device=dev)
    ref_idx = torch.as_tensor(ref_kp_idx, device=dev)
    scan_kp, scan_kp_valid = _padded(scan_t[scan_idx], pad_multiple)
    ref_kp, ref_kp_valid = _padded(ref_t[ref_idx], pad_multiple)
    sub = torch.as_tensor(grid_subsample(scan_t, icp_voxel), device=dev)
    scan_sub, scan_sub_valid = _padded(scan_t[sub], pad_multiple)

    descriptor = fused_kwargs.get("descriptor", "shot")
    rf_radius = fused_kwargs.get("rf_radius")
    ms_radii = fused_kwargs.get("ms_radii")
    # the SHOT window covers the largest radius any scale bins over
    shot_cell = max(radius, rf_radius) if rf_radius is not None else radius
    if ms_radii is not None:
        shot_cell = max(ms_radii)
    big = grid_hash.AUTO_GRID_MIN_POINTS
    grids = {}
    for side, pts, nrm, idx in (("scan", scan_t, scan_n, scan_idx),
                                ("ref", ref_t, ref_n, ref_idx)):
        if descriptor == "fpfh":
            if pts.shape[0] >= big:
                grid = build_grid(pts, radius / 2, extras=nrm, halo=2)
                grids[f"{side}_fpfh_grid"] = grid
                idx = _sorted_rows(grid, idx)
            fused_kwargs[f"{side}_kp_idx"] = _padded(idx, pad_multiple)[0]
        elif takes_grid(pts):
            grids[f"{side}_grid"] = build_grid(pts, shot_cell, extras=nrm)
    if ref_t.shape[0] >= big:
        # pinned, so the ICP grid's cell (its exactness bound) and the
        # program's d_max agree
        d_max = fused_kwargs.setdefault("d_max", 0.3)
        grids["ref_icp_grid"] = build_grid(ref_t, float(d_max))

    run = functools.partial(fused_registration_mesh, mesh) if use_mesh else fused_registration
    res = run(scan_kp, scan_kp_valid, ref_kp, ref_kp_valid, scan_t, scan_n, ref_t, ref_n,
              scan_sub, scan_sub_valid, radius=radius, seed=seed, **grids, **fused_kwargs)
    return res._replace(scan_keypoint_idx=scan_kp_idx, ref_keypoint_idx=ref_kp_idx)
