"""K4: SPFH Darboux angles + binning + histogram on a candidate window.

Counterpart of ``shot_fpfh_tpu/ops/pallas_fpfh_fused.py::spfh_histogram``:
from a feature-first window (``vals (C, F≥6, W)`` rows ``[x y z nx ny nz
...]``, ``dist_inf (C, W)`` with +inf on out-of-radius/invalid lanes) and
the queries' points and normals, the UNNORMALIZED SPFH histograms —
``(C, n_bins³)`` joint, or ``(C, 3·n_bins)`` decorrelated in the reference's
interleaved layout (bin k: α, φ, θ).  The query itself (d == 0) gets no bin;
the caller divides by the neighborhood count, self included.

:func:`spfh_histogram` launches the CUDA kernel (``csrc/spfh_fused.cu``) on
CUDA tensors and runs :func:`spfh_histogram_plain` on CPU tensors.  Counts
are whole numbers, so the two agree exactly unless an angle's last bit moves
it across a bin edge.
"""

from __future__ import annotations

import math

import torch

from .. import _kernels
from .descriptor_bins import darboux_angles
from .histogram import batched_histogram, bin_index, factored_histogram

# a warp's histogram and its 64-slot lane list live in shared memory (48 KB
# without opt-in)
_MAX_SMEM_FLOATS = 48 * 1024 // 4 - 64


def spfh_dim(n_bins: int, decorrelated: bool) -> int:
    return 3 * n_bins if decorrelated else n_bins ** 3


def spfh_from_angles(alpha, phi, theta, valid, n_bins: int, decorrelated: bool):
    """Unnormalized ``(Q, D)`` SPFH from per-neighbor ``(Q, K)`` angles and
    validity, with ``histogramdd`` range semantics (out-of-range dropped)."""
    a_bin, a_in = bin_index(alpha, -1.0, 1.0, n_bins)
    p_bin, p_in = bin_index(phi, -1.0, 1.0, n_bins)
    t_bin, t_in = bin_index(theta, -math.pi / 2, math.pi / 2, n_bins)
    if decorrelated:
        parts = [batched_histogram(b, (valid & in_r).to(torch.float32), n_bins)
                 for b, in_r in ((a_bin, a_in), (p_bin, p_in), (t_bin, t_in))]
        return torch.stack(parts, dim=-1).reshape(alpha.shape[0], 3 * n_bins)
    wgt = (valid & a_in & p_in & t_in).to(torch.float32)
    return factored_histogram(a_bin, p_bin * n_bins + t_bin, wgt, n_bins, n_bins ** 2)


def spfh_histogram_plain(vals, dist_inf, queries, query_normals, n_bins: int,
                         decorrelated: bool):
    """PyTorch twin of the kernel: invalid lanes are selected to zero before
    the arithmetic, so a non-finite padding value never reaches a bin."""
    finite = dist_inf < float("inf")
    rho = torch.where(finite, dist_inf, 0.0)
    valid = finite & (rho > 0)
    dx, dy, dz = (torch.where(finite, vals[:, i, :] - queries[:, i:i + 1], 0.0)
                  for i in range(3))
    nx, ny, nz = (torch.where(finite, vals[:, i, :], 0.0) for i in range(3, 6))
    ux, uy, uz = (query_normals[:, i:i + 1] for i in range(3))
    alpha, phi, theta = darboux_angles(dx, dy, dz, nx, ny, nz, ux, uy, uz,
                                       torch.where(valid, rho, 1.0))
    return spfh_from_angles(alpha, phi, theta, valid, n_bins, decorrelated)


def spfh_histogram(vals: torch.Tensor, dist_inf: torch.Tensor, queries: torch.Tensor,
                   query_normals: torch.Tensor, n_bins: int, decorrelated: bool):
    """Unnormalized SPFH histograms of a window: ``(C, n_bins³)`` joint or
    ``(C, 3·n_bins)`` decorrelated (interleaved)."""
    if vals.device.type == "cpu":
        return spfh_histogram_plain(vals, dist_inf, queries, query_normals, n_bins,
                                    decorrelated)
    tensors = [vals, dist_inf, queries, query_normals]
    device = _kernels.require_cuda(*tensors)
    c, nf, w = vals.shape
    if (nf < 6 or dist_inf.shape != (c, w) or queries.shape != (c, 3)
            or query_normals.shape != (c, 3)):
        raise ValueError(f"bad window shapes {tuple(vals.shape)}, {tuple(dist_inf.shape)}, "
                         f"{tuple(queries.shape)}, {tuple(query_normals.shape)}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("SPFH kernel inputs must be float32")
    d_out = spfh_dim(n_bins, decorrelated)
    if not 0 < d_out <= _MAX_SMEM_FLOATS:
        raise ValueError(f"n_bins={n_bins} gives {d_out} bins; the kernel holds at most "
                         f"{_MAX_SMEM_FLOATS} in shared memory")
    vals, dist_inf, queries, query_normals = (t.contiguous() for t in tensors)
    out = torch.empty((c, d_out), dtype=torch.float32, device=vals.device)
    _kernels.launch("spfh_histogram", device, vals.data_ptr(), dist_inf.data_ptr(),
                    queries.data_ptr(), query_normals.data_ptr(), out.data_ptr(), c, nf, w,
                    n_bins, int(decorrelated),
                    checked=(vals, dist_inf, queries, query_normals, out))
    return out
