"""Batched symmetric 3x3 eigendecomposition by fixed-sweep cyclic Jacobi.

Port of ``shot_fpfh_tpu.ops.eigh3`` as written (``ops/eigh3.py:27-116``):
scale to unit magnitude, four sweeps of the (0,1), (0,2), (1,2) rotations
with ``θ = ½·atan2(2·a_pq, a_qq − a_pp)``, then an ascending three-element
sorting network.  Keeping the same rotation sequence keeps the eigenvalue
order and the eigenvector signs of the reference, which SHOT frames and
normals depend on.  The SHOT kernel (``csrc/shot_fused.cu``) runs the same
Jacobi per keypoint.
"""

from __future__ import annotations

import torch

from .._fp import atan2, cos, sin

_N_SWEEPS = 4


def _rotate_planes(a, v, p: int, q: int):
    """One Jacobi rotation zeroing A[p, q] on dicts of batched scalars."""
    r = ({0, 1, 2} - {p, q}).pop()
    key = lambda i, j: (i, j) if i <= j else (j, i)  # noqa: E731
    app, aqq, apq = a[key(p, p)], a[key(q, q)], a[key(p, q)]
    apr, aqr = a[key(p, r)], a[key(q, r)]
    theta = 0.5 * atan2(2.0 * apq, aqq - app)
    c = cos(theta)
    s = sin(theta)
    c2, s2, cs = c * c, s * s, c * s
    out = dict(a)
    out[key(p, p)] = c2 * app - 2.0 * cs * apq + s2 * aqq
    out[key(q, q)] = s2 * app + 2.0 * cs * apq + c2 * aqq
    out[key(p, q)] = cs * (app - aqq) + (c2 - s2) * apq
    out[key(p, r)] = c * apr - s * aqr
    out[key(q, r)] = s * apr + c * aqr
    vout = dict(v)
    for row in range(3):
        vp, vq = v[(row, p)], v[(row, q)]
        vout[(row, p)] = c * vp - s * vq
        vout[(row, q)] = s * vp + c * vq
    return out, vout


def eigh3x3(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of symmetric ``[..., 3, 3]`` matrices: eigenvalues
    ascending ``[..., 3]`` and eigenvectors as columns ``[..., 3, 3]`` (the
    ``np.linalg.eigh`` convention)."""
    scale = torch.clamp(a.abs().amax(dim=(-1, -2), keepdim=True), min=1e-30)
    an = a / scale
    planes = {(i, j): an[..., i, j] for i in range(3) for j in range(3) if i <= j}
    zero = torch.zeros_like(planes[(0, 0)])
    one = torch.ones_like(zero)
    v = {(i, j): (one if i == j else zero) for i in range(3) for j in range(3)}
    for _ in range(_N_SWEEPS):
        planes, v = _rotate_planes(planes, v, 0, 1)
        planes, v = _rotate_planes(planes, v, 0, 2)
        planes, v = _rotate_planes(planes, v, 1, 2)

    s0 = scale[..., 0, 0]
    w = [planes[(0, 0)] * s0, planes[(1, 1)] * s0, planes[(2, 2)] * s0]
    cols = [[v[(r, c)] for r in range(3)] for c in range(3)]

    def cswap(i, j):
        swap = w[i] > w[j]
        w[i], w[j] = torch.where(swap, w[j], w[i]), torch.where(swap, w[i], w[j])
        ci = [torch.where(swap, b, a_) for a_, b in zip(cols[i], cols[j])]
        cj = [torch.where(swap, a_, b) for a_, b in zip(cols[i], cols[j])]
        cols[i], cols[j] = ci, cj

    cswap(0, 1)
    cswap(1, 2)
    cswap(0, 1)
    w_out = torch.stack(w, dim=-1)
    v_out = torch.stack([torch.stack(col, dim=-1) for col in cols], dim=-1)
    return w_out, v_out


def pca_eigh(points: torch.Tensor, mask: torch.Tensor | None = None):
    """PCA of (masked) neighborhoods ``[..., K, 3]`` → ``(w, v, barycenter)``;
    covariance mean-centered and divided by the neighbor count (an empty
    neighborhood gives zeros and the identity)."""
    if mask is None:
        count = float(points.shape[-2])
        bary = points.mean(dim=-2)
        centered = points - bary[..., None, :]
        cov = torch.einsum("...ki,...kj->...ij", centered, centered) / count
    else:
        m = mask.to(points.dtype)
        count = torch.clamp(m.sum(-1), min=1.0)
        bary = (points * m[..., None]).sum(-2) / count[..., None]
        centered = (points - bary[..., None, :]) * m[..., None]
        cov = torch.einsum("...ki,...kj->...ij", centered, centered) / count[..., None, None]
    w, v = eigh3x3(cov)
    return w, v, bary
