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
ones.  Its multiscale branch (``multiscale_top1``) is not ported yet
(ROADMAP.md, Queue 1, item 6).
"""

from __future__ import annotations

import logging
from typing import Callable

import numpy as np
import torch

from .._device import resolve
from .._fp import sqrt
from ..ops.match import top2_match
from ..ops.neighbors import as_f32

logger = logging.getLogger(__name__)


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


def _split_nonzero(desc, device=None):
    """``(host indices of the nonzero rows, those rows as a float32 tensor
    on the device)``; only the row mask crosses to the host."""
    d = as_f32(desc, device)
    nz = torch.nonzero((d != 0).any(dim=1))[:, 0]
    return nz.cpu().numpy(), d[nz]


def basic_matching(scan_descriptors, ref_descriptors, device=None):
    """Each non-empty scan descriptor matched to its nearest non-empty ref
    descriptor; returns host ``(scan_indices, ref_indices)``."""
    scan_nz, a = _split_nonzero(scan_descriptors, resolve(device, scan_descriptors))
    ref_nz, b = _split_nonzero(ref_descriptors, a.device)
    idx, _ = nearest_descriptor(a, b, torch.ones(b.shape[0], dtype=torch.bool,
                                                 device=b.device))
    return scan_nz, ref_nz[idx.cpu().numpy()]


def lowe_matching(scan_descriptors, ref_descriptors, threshold: float = 0.8,
                  verbose: bool = True, device=None):
    """Ratio-test matching: keep matches with ``d1/d2 <= threshold``
    (``d2 == 0`` counts as ratio 1)."""
    scan_nz, a = _split_nonzero(scan_descriptors, resolve(device, scan_descriptors))
    ref_nz, b = _split_nonzero(ref_descriptors, a.device)
    idx, d1, d2 = top2_descriptor(a, b, torch.ones(b.shape[0], dtype=torch.bool,
                                                   device=b.device))
    ratio = torch.where(d2 > 0, d1 / torch.where(d2 > 0, d2, torch.ones_like(d2)),
                        torch.ones_like(d1))
    mask = (ratio <= threshold).cpu().numpy()
    if verbose:
        logger.info("Kept %d matches out of %d descriptors.", mask.sum(), len(scan_nz))
    return scan_nz[mask], ref_nz[idx.cpu().numpy()[mask]]


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
                      n_min_matches: int = 100, device=None, **kwargs):
    """Nearest-descriptor matches kept by ``filter_callback(distances,
    **kwargs)``; with ``filter_nonreciprocal`` only matches that are also the
    ref's nearest back, unless fewer than ``n_min_matches`` survive that
    (reference ``match_descriptors``, matching/matching.py:9-146).  Returns
    host ``(scan_indices, ref_indices)``."""
    if np.ndim(scan_descriptors) != 2:
        raise NotImplementedError(
            "multiscale (n_scales, K, D) descriptor matching is not ported yet "
            "(ROADMAP.md, Queue 1, item 6: multiscale_top1)")
    scan_nz, a = _split_nonzero(scan_descriptors, resolve(device, scan_descriptors))
    ref_nz, b = _split_nonzero(ref_descriptors, a.device)
    idx_t, dist_t = nearest_descriptor(a, b, torch.ones(b.shape[0], dtype=torch.bool,
                                                        device=b.device))
    idx, dist = idx_t.cpu().numpy(), dist_t.cpu().numpy()
    keep = (filter_callback(dist, **kwargs) if filter_callback is not None
            else np.ones(len(dist), bool))
    if filter_nonreciprocal:
        back, _ = nearest_descriptor(b, a, torch.ones(a.shape[0], dtype=torch.bool,
                                                      device=a.device))
        reciprocal = back.cpu().numpy()[idx] == np.arange(len(idx))
        if (keep & reciprocal).sum() >= n_min_matches:
            keep = keep & reciprocal
        elif verbose:
            logger.warning("Too few reciprocal matches, keeping non-reciprocal matches.")
    if verbose:
        logger.info("Kept %d matches out of %d descriptors.", keep.sum(), len(scan_nz))
    return scan_nz[keep], ref_nz[idx[keep]]
