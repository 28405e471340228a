"""Descriptor matching — the nearest and ratio-test matchers of
``shot_fpfh_tpu.registration.matching``.

All-zero descriptors (neighborhoods too sparse) are left out of matching,
as in the reference.  Nearest and second-nearest descriptors come from the
K2 top-2 kernel (``ops.match``); by default its operands are bf16 with f32
accumulation and norms from the rounded values (``matching.py:40-46``);
``use_bf16=False`` selects f32 operands.  ``lowe_matching`` keeps
matches whose distance ratio is ≤ the threshold (the corrected ratio test).
``match_descriptors`` keeps the nearest matches a distance filter passes
(``threshold_filter``, ``quantile_filter``, ``left_median_filter``, NumPy on
the host distances as in the reference), optionally only the reciprocal
ones.  Given ``(n_scales, K, D)`` stacks it matches each scan row to the
ref row nearest under the elementwise minimum of the per-scale distances
(``multiscale_top1``: f32 ``torch.matmul`` in chunks of 1024 scan rows,
so no ``K x K`` matrix is ever held whole).  Given a ``mesh`` of more than
one rank, the matchers shard the scan rows over it (``parallel.sharded``:
``ring_match``, ``sharded_multiscale_match``).
"""

from __future__ import annotations

import logging
from typing import Callable

import numpy as np
import torch

from .._device import resolve
from .._fp import sqrt
from ..ops.match import top2_match
from ..ops.match import top2_merge, top2_rows  # noqa: F401  (JAX defines them here)
from ..ops.neighbors import _sq_dists, as_f32
from ..parallel.mesh import all_gather_rows
from ..utils.perf import blocking, span

logger = logging.getLogger(__name__)

# scan rows per distance tile of the multiscale matcher
_CHUNK = 1024
# sentinel distance of a pair with an all-zero row at a scale (the
# reference's ``max_val``, matching/matching.py:96); a match whose combined
# distance reaches it is dropped
MS_MAX_VAL = 1000.0


def nearest_descriptor(a: torch.Tensor, b: torch.Tensor, b_valid: torch.Tensor,
                       use_bf16: bool = True):
    """Per-row nearest neighbor of ``a`` in ``b``: ``(idx, dist)``."""
    idx, d1_sq, _ = top2_match(a, b, b_valid, use_bf16)
    return idx, sqrt(d1_sq)


def top2_descriptor(a: torch.Tensor, b: torch.Tensor, b_valid: torch.Tensor,
                    use_bf16: bool = True):
    """Nearest and second-nearest: ``(idx1, d1, d2)``."""
    idx, d1_sq, d2_sq = top2_match(a, b, b_valid, use_bf16)
    return idx, sqrt(d1_sq), sqrt(d2_sq)


def descriptor_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense ``(A, B)`` squared distances ``‖a‖² + ‖b‖² − 2a·b``, clamped
    at 0 (use only when the matrix fits)."""
    return _sq_dists(a, b)


def _ms_chunk_dists(a_chunk, b, a_ok_chunk, b_ok):
    """``(chunk, R)`` distances at one scale, ``MS_MAX_VAL`` where either
    row is all zero."""
    d = sqrt(descriptor_sq_dists(a_chunk, b))
    return torch.where(a_ok_chunk[:, None] & b_ok[None, :], d, MS_MAX_VAL)


def _ms_scale_pass(a, b, a_ok, b_ok):
    """One scale's row argmin ``(Q,)`` and column minimum and argmin
    ``(R,)``, over chunks of scan rows; ties go to the lowest index (an
    earlier chunk wins a column's tie by the strict ``<``)."""
    n_ref = b.shape[0]
    col_d = torch.full((n_ref,), float("inf"), dtype=torch.float32, device=a.device)
    col_i = torch.zeros(n_ref, dtype=torch.int64, device=a.device)
    row_i = []
    for s in range(0, a.shape[0], _CHUNK):
        d = _ms_chunk_dists(a[s:s + _CHUNK], b, a_ok[s:s + _CHUNK], b_ok)
        i_local = torch.argmin(d, dim=0)
        d_local = d.gather(0, i_local[None, :])[0]
        better = d_local < col_d
        col_d = torch.where(better, d_local, col_d)
        col_i = torch.where(better, i_local + s, col_i)
        row_i.append(torch.argmin(d, dim=1))
    return torch.cat(row_i), col_d, col_i


def _ms_row_mask(scan_ms, ref_ms, filter_nonreciprocal: bool, mesh=None):
    """``(row_ok (S, Q), ref_ok (S, R))``: the nonzero rows of each scale;
    with ``filter_nonreciprocal`` only the scan rows whose match at that
    scale is reciprocal there.  With a ``mesh`` the scan rows are the
    rank's block (``parallel.sharded_multiscale_match``): each scale's
    column minima are gathered from every rank, ties to the lowest rank,
    so the mask is the one device's."""
    s_ok = (scan_ms != 0).any(dim=2)
    r_ok = (ref_ms != 0).any(dim=2)
    if not filter_nonreciprocal:
        return s_ok, r_ok
    start = 0 if mesh is None else mesh.rank * scan_ms.shape[1]
    rows = torch.arange(start, start + scan_ms.shape[1], device=scan_ms.device)
    recip = []
    for scale in range(scan_ms.shape[0]):
        row_i, col_d, col_i = _ms_scale_pass(scan_ms[scale], ref_ms[scale], s_ok[scale],
                                             r_ok[scale])
        if mesh is not None:
            all_d = all_gather_rows(col_d[None], mesh)            # (ranks, R)
            all_i = all_gather_rows((col_i + start)[None], mesh)
            col_i = all_i.gather(0, torch.argmin(all_d, dim=0)[None])[0]
        recip.append(col_i[row_i] == rows)
    return s_ok & torch.stack(recip), r_ok


def _ms_combined_top1(a_ms, b_ms, row_ok_ms, b_ok_ms, second: bool = False):
    """Row argmin and distance of ``min_s D_s``: per chunk of scan rows, the
    running elementwise minimum over the scales; with ``second``, each
    row's second-smallest combined distance too."""
    n = a_ms.shape[1]
    idx, dist, dist2 = [], [], []
    for s in range(0, n, _CHUNK):
        run = torch.full((min(_CHUNK, n - s), b_ms.shape[1]), MS_MAX_VAL,
                         dtype=torch.float32, device=a_ms.device)
        for scale in range(a_ms.shape[0]):
            run = torch.minimum(run, _ms_chunk_dists(a_ms[scale, s:s + _CHUNK], b_ms[scale],
                                                     row_ok_ms[scale, s:s + _CHUNK],
                                                     b_ok_ms[scale]))
        i = torch.argmin(run, dim=1)
        idx.append(i)
        dist.append(run.gather(1, i[:, None])[:, 0])
        if second:
            dist2.append(torch.topk(run, 2, dim=1, largest=False).values[:, 1])
    if second:
        return torch.cat(idx), torch.cat(dist), torch.cat(dist2)
    return torch.cat(idx), torch.cat(dist)


def multiscale_top1(scan_ms, ref_ms, *, filter_nonreciprocal: bool = False, device=None):
    """For each scan row of ``(S, Q, D)`` stacks, the ref row nearest under
    the elementwise minimum over scales of the per-scale distances (a pair
    with an all-zero row at a scale is ``MS_MAX_VAL`` apart there); with
    ``filter_nonreciprocal``, a scan row whose match at a scale is not
    reciprocal at that scale is ``MS_MAX_VAL`` from everything there (the
    reference's evident intent: its own mask is a silent no-op, PARITY.md).
    Returns ``(idx (Q,), dist (Q,))`` on the call's device; a row whose
    distance reaches ``MS_MAX_VAL`` has no match."""
    dev = resolve(device, scan_ms)
    scan_ms, ref_ms = as_f32(scan_ms, dev), as_f32(ref_ms, dev)
    return _ms_combined_top1(scan_ms, ref_ms, *_ms_row_mask(scan_ms, ref_ms,
                                                             filter_nonreciprocal))


def _split_nonzero(desc, device=None):
    """``(host indices of the nonzero rows, those rows as a float32 tensor
    on the device)``; only the row mask crosses to the host."""
    with span("match.rows"):
        d = as_f32(desc, device)
        with blocking("match.nonzero"):
            nz = torch.nonzero((d != 0).any(dim=1))[:, 0]
        with blocking("match.indices"):
            return nz.cpu().numpy(), d[nz]


def _use_mesh(mesh) -> bool:
    return mesh is not None and mesh.devices.size > 1


def _device(device, like, mesh):
    """The call's device: the rank's under a mesh of more than one rank."""
    return mesh.device if _use_mesh(mesh) else resolve(device, like)


def _top2(a, b, mesh):
    """``(idx, d1, d2)`` of each ``a`` row among the ``b`` rows: K2 on one
    device, or the ring over a mesh (``parallel.sharded.ring_match``)."""
    if _use_mesh(mesh):
        from ..parallel.sharded import ring_match

        return ring_match(a, b, mesh)
    return top2_descriptor(a, b, torch.ones(b.shape[0], dtype=torch.bool, device=b.device))


def _host(x: torch.Tensor, site: str = "match.read") -> np.ndarray:
    """``x`` read back to the host."""
    with blocking(site):
        return x.cpu().numpy()


def basic_matching(scan_descriptors, ref_descriptors, device=None, mesh=None):
    """Each non-empty scan descriptor matched to its nearest non-empty ref
    descriptor; returns host ``(scan_indices, ref_indices)``.  With a
    ``mesh`` of more than one rank the ref tiles ride the ring."""
    scan_nz, a = _split_nonzero(scan_descriptors, _device(device, scan_descriptors, mesh))
    ref_nz, b = _split_nonzero(ref_descriptors, a.device)
    with span("match.top2"):
        idx = _host(_top2(a, b, mesh)[0])
    return scan_nz, ref_nz[idx]


def lowe_matching(scan_descriptors, ref_descriptors, threshold: float = 0.8,
                  verbose: bool = True, device=None, mesh=None):
    """Ratio-test matching: keep matches with ``d1/d2 <= threshold``
    (``d2 == 0`` counts as ratio 1)."""
    scan_nz, a = _split_nonzero(scan_descriptors, _device(device, scan_descriptors, mesh))
    ref_nz, b = _split_nonzero(ref_descriptors, a.device)
    with span("match.top2"):
        idx, d1, d2 = _top2(a, b, mesh)
        ratio = torch.where(d2 > 0, d1 / torch.where(d2 > 0, d2, torch.ones_like(d2)),
                            torch.ones_like(d1))
        mask = _host(ratio <= threshold)
        idx = _host(idx)
    if verbose:
        logger.info("Kept %d matches out of %d descriptors.", mask.sum(), len(scan_nz))
    return scan_nz[mask], ref_nz[idx[mask]]


# ------------------------------------------------------------------ filters --
FilterFunction = Callable[..., np.ndarray]


def threshold_filter(distances: np.ndarray, threshold_multiplier: float) -> np.ndarray:
    """Keep matches within ``multiplier ×`` the smallest nonzero distance
    (reference matching/filters.py:19-23)."""
    nonzero = distances[np.nonzero(distances)[0]]
    floor = nonzero.min() if len(nonzero) else 0.0
    return distances <= floor * threshold_multiplier


def quantile_filter(distances: np.ndarray, quantiles: tuple[float, float]) -> np.ndarray:
    lo, hi = np.quantile(distances, quantiles)
    return (distances >= lo) & (distances <= hi)


def left_median_filter(distances: np.ndarray) -> np.ndarray:
    """Keep matches between halfway-to-the-median and the median, the band
    floor halfway between the smallest nonzero distance and the median (the
    JAX package's documented correction of reference filters.py:34-40)."""
    med = np.median(distances)
    nonzero = distances[np.nonzero(distances)[0]]
    floor = nonzero.min() if len(nonzero) else 0.0
    return (distances <= med) & (distances >= (med + floor) / 2)


def match_descriptors(scan_descriptors, ref_descriptors,
                      filter_callback: FilterFunction | None = None,
                      filter_nonreciprocal: bool = False, verbose: bool = True,
                      n_min_matches: int = 100, device=None, mesh=None, **kwargs):
    """Nearest-descriptor matches kept by ``filter_callback(distances,
    **kwargs)``; with ``filter_nonreciprocal`` only matches that are also the
    ref's nearest back, unless fewer than ``n_min_matches`` survive that
    (reference ``match_descriptors``, matching/matching.py:9-146).
    ``(n_scales, K, D)`` stacks match by :func:`multiscale_top1`.  With a
    ``mesh`` of more than one rank the ring matches the rows
    (``parallel.sharded.ring_match``; stacks: ``sharded_multiscale_match``).
    Returns host ``(scan_indices, ref_indices)``."""
    if np.ndim(scan_descriptors) != 2:
        return _match_multiscale(scan_descriptors, ref_descriptors, filter_callback,
                                 filter_nonreciprocal, verbose, n_min_matches, device, mesh,
                                 kwargs)
    scan_nz, a = _split_nonzero(scan_descriptors, _device(device, scan_descriptors, mesh))
    ref_nz, b = _split_nonzero(ref_descriptors, a.device)
    with span("match.top2"):
        idx_t, dist_t, _ = _top2(a, b, mesh)
        idx, dist = _host(idx_t), _host(dist_t)
    keep = (filter_callback(dist, **kwargs) if filter_callback is not None
            else np.ones(len(dist), bool))
    if filter_nonreciprocal:
        with span("match.top2"):
            back = _host(_top2(b, a, mesh)[0])
        reciprocal = back[idx] == np.arange(len(idx))
        if (keep & reciprocal).sum() >= n_min_matches:
            keep = keep & reciprocal
        elif verbose:
            logger.warning("Too few reciprocal matches, keeping non-reciprocal matches.")
    if verbose:
        logger.info("Kept %d matches out of %d descriptors.", keep.sum(), len(scan_nz))
    return scan_nz[keep], ref_nz[idx[keep]]


def _match_multiscale(scan_ms, ref_ms, filter_callback, filter_nonreciprocal, verbose,
                      n_min_matches, device, mesh, kwargs):
    """``match_descriptors`` on ``(n_scales, K, D)`` stacks: the rows whose
    combined distance the filter keeps and is under ``MS_MAX_VAL``, as
    positions among all scan rows; without the reciprocal filter when fewer
    than ``n_min_matches`` survive it."""
    if _use_mesh(mesh):
        from ..parallel.sharded import sharded_multiscale_match

        idx_t, dist_t = sharded_multiscale_match(scan_ms, ref_ms, mesh,
                                                 filter_nonreciprocal=filter_nonreciprocal)
    else:
        idx_t, dist_t = multiscale_top1(scan_ms, ref_ms,
                                        filter_nonreciprocal=filter_nonreciprocal,
                                        device=resolve(device, scan_ms))
    indices, distances = _host(idx_t), _host(dist_t)
    keep = (filter_callback(distances, **kwargs) if filter_callback is not None
            else np.ones(len(distances), bool)) & (distances < MS_MAX_VAL)
    if keep.sum() < n_min_matches and filter_nonreciprocal:
        logger.warning("Too few reciprocal matches, keeping non-reciprocal matches.")
        return match_descriptors(scan_ms, ref_ms, filter_callback, filter_nonreciprocal=False,
                                 verbose=verbose, device=device, mesh=mesh, **kwargs)
    if verbose:
        logger.info("Kept %d matches out of %d descriptors.", keep.sum(), len(distances))
    return np.nonzero(keep)[0], indices[keep]


# the reference's name for the ratio test, so its configs and call sites
# translate one to one
double_matching_with_rejects = lowe_matching
