"""The table of peaks and the least time of a kernel's work, counted from
shapes, whatever implements it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the
700 W limit): 989 TFLOP/s on bfloat16 tensor cores, 67 TFLOP/s in float32
outside them, 3.35 TB/s of HBM.
"""

from __future__ import annotations

BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(n_ops: float, n_bytes: float, peak_flops: float) -> float:
    """The larger of the operations at the peak and the bytes at the
    memory rate."""
    return max(n_ops / peak_flops, n_bytes / HBM_BYTES_PER_S)


def match_least_seconds(n_scan: int, n_ref: int, dim: int, in_bytes: int = 4,
                        out_bytes_per_row: int = 16) -> float:
    """Nearest-neighbour matching of ``n_scan`` by ``n_ref`` descriptors of
    ``dim`` values: ``2·Ns·Nr·D`` operations at the bfloat16 tensor peak;
    each float32 input value read once, and per scan row an int64 index and
    two float32 distances written once."""
    n_ops = 2.0 * n_scan * n_ref * dim
    n_bytes = (n_scan + n_ref) * dim * in_bytes + n_scan * out_bytes_per_row
    return least_seconds(n_ops, n_bytes, BF16_TENSOR_FLOPS)
