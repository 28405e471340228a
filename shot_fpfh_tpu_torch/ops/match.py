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

The kernel's grid is (row blocks) x (column splits of ``b``): split ``s``
of ``S`` takes ref tiles ``[s·T/S, (s+1)·T/S)`` of the ``T`` tiles of
``TILE`` refs and yields a partial top-2 per row; the partials are merged in
split order with :func:`top2_merge`'s rule.  :func:`column_splits` picks
``S``.
"""

from __future__ import annotations

import functools

import torch

from .. import _kernels

_CHUNK = 1024      # scan rows per step of the plain scan
_REF_TILE = 4096   # ref rows per tile of the plain scan

TILE = 128                            # rows of a per block, ref rows per tile
K_STEP = {True: 64, False: 8}         # feature step of the bf16 / f32 kernel
BLOCKS_PER_SM = 2                     # blocks the grid aims to keep on each SM


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


def column_splits(n: int, m: int, n_sms: int) -> int:
    """Column splits of the kernel's grid: as many (row block, split)
    blocks as ``BLOCKS_PER_SM`` on each of ``n_sms`` SMs hold in one wave
    (a second, partial wave would double the time), at most one split per
    ref tile."""
    row_blocks = max(1, -(-n // TILE))
    tiles = -(-m // TILE)
    return max(1, min(tiles, BLOCKS_PER_SM * n_sms // row_blocks))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    a = a.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    valid = b_valid.to(torch.bool).contiguous()
    # scratch of the kernel's prep step: both operands rounded and padded
    # with zero columns to its feature step (no change to a dot product or a
    # norm), the squared norms of the rounded rows (+inf for an invalid ref
    # and for the padding up to a whole tile), and the splits' partials
    step = K_STEP[use_bf16]
    width = max(step, -(-dim // step) * step)
    ops = torch.empty((n + m) * width, dtype=torch.bfloat16 if use_bf16 else torch.float32,
                      device=device)
    norms = torch.empty(-(-m // TILE) * TILE + n, dtype=torch.float32, device=device)
    splits = column_splits(n, m, _sm_count(device.index))
    part_i = torch.empty((splits, n), dtype=torch.int32, device=device)
    part_d1 = torch.empty((splits, n), dtype=torch.float32, device=device)
    part_d2 = torch.empty((splits, n), dtype=torch.float32, device=device)
    i1 = torch.empty(n, dtype=torch.int64, device=device)
    d1 = torch.empty(n, dtype=torch.float32, device=device)
    d2 = torch.empty(n, dtype=torch.float32, device=device)
    _kernels.launch("top2_match", device, a.data_ptr(), b.data_ptr(), valid.data_ptr(),
                    ops.data_ptr(), norms.data_ptr(), part_i.data_ptr(), part_d1.data_ptr(),
                    part_d2.data_ptr(), i1.data_ptr(), d1.data_ptr(), d2.data_ptr(), n, m, dim,
                    width, splits, int(use_bf16), checked=(a, b, d1, d2))
    return i1, d1, d2
