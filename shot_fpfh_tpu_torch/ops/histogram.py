"""Batched masked histograms — port of ``shot_fpfh_tpu.ops.histogram``.

A whole batch of histograms is built in one call from ``(row, bin)``
index/weight tensors, with ``np.add.at`` semantics (every contribution
accumulates).  The reference's one-hot MXU contraction was a TPU
workaround; here the same contract is one ``index_add_``.
"""

from __future__ import annotations

import torch

from .._fp import div


def batched_histogram(idx: torch.Tensor, weights: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``out[q, idx[q, m]] += weights[q, m]`` over m; out-of-range indices
    are dropped.  Returns ``(Q, n_bins)`` float32."""
    q = idx.shape[0]
    valid = (idx >= 0) & (idx < n_bins)
    w = torch.where(valid, weights.to(torch.float32), 0.0)
    flat = (torch.arange(q, device=idx.device)[:, None] * n_bins
            + torch.where(valid, idx.to(torch.int64), 0))
    out = torch.zeros(q * n_bins, dtype=torch.float32, device=idx.device)
    return out.index_add_(0, flat.reshape(-1), w.reshape(-1)).reshape(q, n_bins)


def factored_histogram(idx_hi: torch.Tensor, idx_lo: torch.Tensor, weights: torch.Tensor,
                       n_hi: int, n_lo: int) -> torch.Tensor:
    """Histogram over the product bin space ``bin = hi * n_lo + lo``;
    entries with either index out of range contribute nothing.  Returns
    ``(Q, n_hi·n_lo)`` float32."""
    valid = (idx_hi >= 0) & (idx_hi < n_hi) & (idx_lo >= 0) & (idx_lo < n_lo)
    flat = torch.where(valid, idx_hi.to(torch.int64) * n_lo + idx_lo.to(torch.int64), -1)
    return batched_histogram(flat, weights, n_hi * n_lo)


def bin_index(x: torch.Tensor, lo: float, hi: float, n_bins: int):
    """NumPy-``histogramdd`` bin assignment on range [lo, hi]: left-inclusive
    uniform bins, right edge folded into the last bin, out-of-range dropped.

    ``width = (hi - lo) / n_bins`` is taken in Python float and applied in
    float32, as the reference does (``_fp.div``: a true division on the
    card too).  Returns ``(bin_idx int32, in_range bool)``.
    """
    raw = torch.floor(div(x - lo, (hi - lo) / n_bins))
    idx = torch.clamp(raw, 0, n_bins - 1).to(torch.int32)
    return idx, (x >= lo) & (x <= hi)
