"""K2: descriptor distance product with a fused top-2 reduction.

Counterpart of ``shot_fpfh_tpu/ops/pallas_match.py::top2_matmul_pallas``:
for each row of ``a``, the nearest and second-nearest valid row of ``b``,
as ``(i1, d1², d2²)``.  Operands are rounded to bf16 by default (f32
otherwise) and every dot accumulates in f32; the norms are taken from the
rounded values, so self-distances cancel exactly.  Invalid refs count as
+inf; ties go to the lower index.

:func:`top2_match` launches the CUDA kernel (``csrc/match.cu``) on CUDA
tensors and runs :func:`top2_match_plain` — the tiled scan of
``registration/matching.py::_top_scan`` — on CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _kernels

_CHUNK = 1024      # scan rows per step of the plain scan
_REF_TILE = 4096   # ref rows per tile of the plain scan


def rounded(x: torch.Tensor, use_bf16: bool) -> torch.Tensor:
    """The operand as the product sees it: bf16-rounded (kept as f32
    values) or f32."""
    x = x.to(torch.float32)
    return x.to(torch.bfloat16).to(torch.float32) if use_bf16 else x


def top2_rows(d2: torch.Tensor):
    """Row-wise ``(i1, d1², d2²)`` of a masked (inf = invalid) squared
    distance tile; ``i1`` is the first minimum."""
    i1 = torch.argmin(d2, dim=-1)
    d1 = torch.gather(d2, 1, i1[:, None])[:, 0]
    cols = torch.arange(d2.shape[1], device=d2.device)[None, :]
    second = torch.where(cols == i1[:, None], torch.full_like(d2, float("inf")), d2)
    return i1, d1, second.min(dim=-1).values


def top2_merge(carry, tile):
    """Merge a tile's ``(i1, d1², d2²)`` (global indices) into the running
    carry; strict ``<`` keeps the earlier tile on ties."""
    ci, cd1, cd2 = carry
    ti, td1, td2 = tile
    better = td1 < cd1
    return (torch.where(better, ti, ci), torch.where(better, td1, cd1),
            torch.minimum(torch.maximum(cd1, td1), torch.minimum(cd2, td2)))


def top2_match_plain(a: torch.Tensor, b: torch.Tensor, b_valid: torch.Tensor,
                     use_bf16: bool = True):
    """PyTorch twin of the kernel: scan-row chunks x ref tiles, each
    distance tile reduced into the per-row top-2 carry."""
    ac, bc = rounded(a, use_bf16), rounded(b, use_bf16)
    an, bn = (ac * ac).sum(-1), (bc * bc).sum(-1)
    inf = float("inf")
    outs = []
    for s in range(0, ac.shape[0], _CHUNK):
        a_c, an_c = ac[s:s + _CHUNK], an[s:s + _CHUNK]
        rows = a_c.shape[0]
        carry = (torch.zeros(rows, dtype=torch.int64, device=a.device),
                 torch.full((rows,), inf, device=a.device),
                 torch.full((rows,), inf, device=a.device))
        for t in range(0, bc.shape[0], _REF_TILE):
            prod = a_c @ bc[t:t + _REF_TILE].T
            d2t = torch.clamp((an_c[:, None] + bn[None, t:t + _REF_TILE]) - 2.0 * prod, min=0.0)
            d2t = torch.where(b_valid[None, t:t + _REF_TILE], d2t, torch.full_like(d2t, inf))
            i1t, d1t, d2t2 = top2_rows(d2t)
            carry = top2_merge(carry, (i1t + t, d1t, d2t2))
        outs.append(carry)
    if not outs:
        empty = torch.zeros(0, device=a.device)
        return empty.long(), empty, empty
    return tuple(torch.cat(parts) for parts in zip(*outs))


def top2_match(a: torch.Tensor, b: torch.Tensor, b_valid: torch.Tensor,
               use_bf16: bool = True):
    """``(i1 (n,) int64, d1² (n,), d2² (n,))`` of each ``a`` row among the
    valid ``b`` rows (inf where no valid ref exists)."""
    if a.device.type == "cpu":
        return top2_match_plain(a, b, b_valid, use_bf16)
    device = _kernels.require_cuda(a, b, b_valid)
    n, dim = a.shape
    m = b.shape[0]
    if b.shape[1] != dim or b_valid.shape != (m,):
        raise ValueError(f"bad shapes a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"b_valid {tuple(b_valid.shape)}")
    cdt = torch.bfloat16 if use_bf16 else torch.float32
    ac = a.to(cdt).contiguous()
    bc = b.to(cdt).contiguous()
    an = (ac.float() ** 2).sum(-1).contiguous()
    bn = (bc.float() ** 2).sum(-1).contiguous()
    valid = b_valid.to(torch.uint8).contiguous()
    i1 = torch.empty(n, dtype=torch.int32, device=a.device)
    d1 = torch.empty(n, dtype=torch.float32, device=a.device)
    d2 = torch.empty(n, dtype=torch.float32, device=a.device)
    _kernels.launch("top2_match", device, ac.data_ptr(), bc.data_ptr(), an.data_ptr(),
                    bn.data_ptr(), valid.data_ptr(), i1.data_ptr(), d1.data_ptr(),
                    d2.data_ptr(), n, m, dim, int(use_bf16))
    return i1.long(), d1, d2
