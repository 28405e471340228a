"""Port parity: K2 top-2 descriptor matching (plain twin) and the matchers.

Bounds of ``bench.py:317-341``: f32 indices identical and d1² rtol 1e-4;
bf16 index agreement ≥ 0.97 and d1² rtol 2e-3 — against the reference's
tile scan ``_top_scan`` and its TPU kernel ``top2_matmul_pallas`` run
interpreted; some refs invalid, row counts not multiples of the tiles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shot_fpfh_tpu.ops.pallas_match import top2_matmul_pallas
from shot_fpfh_tpu.registration import matching as j_match
from shot_fpfh_tpu_torch import _kernels
from shot_fpfh_tpu_torch.ops import match as match_ops
from shot_fpfh_tpu_torch.ops.match import top2_match
from shot_fpfh_tpu_torch.registration import matching as t_match

# The suite runs several pytest workers side by side on the CPU: one torch
# thread per worker keeps torch's OpenMP pool from oversubscribing the cores
# (it slowed every worker, JAX tests included, by up to 2x).
torch.set_num_threads(1)


@pytest.mark.parametrize("use_bf16", [False, True])
@pytest.mark.parametrize("n,m", [(150, 1024 + 77), (1030, 300)])
def test_k2_plain_matches_reference(rng, use_bf16, n, m):
    a = rng.normal(size=(n, 352)).astype(np.float32)
    b = rng.normal(size=(m, 352)).astype(np.float32)
    valid = rng.uniform(size=m) > 0.05
    before = dict(_kernels.launch_counts)
    ti, td1, td2 = (x.numpy() for x in top2_match(torch.tensor(a), torch.tensor(b),
                                                   torch.tensor(valid), use_bf16))
    assert _kernels.launch_counts == before      # CPU tensors: plain twin
    assert valid[ti].all()
    refs = [j_match._top_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid),
                              use_bf16, True)]
    if n <= 200:  # the interpreted TPU kernel is slow on CPU
        refs.append(top2_matmul_pallas(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid),
                                       use_bf16=use_bf16, interpret=True))
    for ji, jd1, jd2 in refs:
        agree = np.mean(ti == np.asarray(ji))
        assert agree >= (0.97 if use_bf16 else 1.0), agree
        np.testing.assert_allclose(td1, np.asarray(jd1), rtol=2e-3 if use_bf16 else 1e-4)
        same = ti == np.asarray(ji)
        np.testing.assert_allclose(td2[same], np.asarray(jd2)[same],
                                   rtol=2e-3 if use_bf16 else 1e-4)


def test_k2_all_refs_invalid():
    a = torch.randn(5, 352)
    i1, d1, d2 = top2_match(a, torch.randn(7, 352), torch.zeros(7, dtype=torch.bool))
    assert (i1 == 0).all() and torch.isinf(d1).all() and torch.isinf(d2).all()


def _descriptors(rng, n, zero_rows):
    d = np.abs(rng.normal(size=(n, 352))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[zero_rows] = 0.0
    return d


@pytest.mark.parametrize("algo", ["simple", "ratio"])
def test_matchers_match_reference(rng, algo):
    scan = _descriptors(rng, 300, [3, 50])
    ref = np.concatenate([scan[::-1][:250] + 0.01 * rng.normal(size=(250, 352)),
                          _descriptors(rng, 60, [7])]).astype(np.float32)
    if algo == "simple":
        js, jr = j_match.basic_matching(scan, ref)
        ts, tr = t_match.basic_matching(scan, ref, device="cpu")
    else:
        js, jr = j_match.lowe_matching(scan, ref, 0.9)
        ts, tr = t_match.lowe_matching(scan, ref, 0.9, device="cpu")
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tr, jr)
    assert 3 not in ts and 50 not in ts


def _duplicate_laden(rng, n, m, dim=40):
    """Small whole numbers (every product and sum exact in f32, so bf16 and
    f32 give the same exact distances) with repeated ref rows and scan rows
    copied into the refs: many exact ties, first and second place alike."""
    a = rng.integers(-2, 3, size=(n, dim)).astype(np.float32)
    b = rng.integers(-2, 3, size=(m, dim)).astype(np.float32)
    b[m // 3: 2 * (m // 3)] = b[: m // 3]
    b[m - n // 2:] = a[: n // 2]
    b[5:9] = b[m - 1]
    valid = rng.uniform(size=m) > 0.1
    return torch.tensor(a), torch.tensor(b), torch.tensor(valid)


def _split_columns(m, splits):
    """K2's column splits: split s takes ref tiles [s·T/S, (s+1)·T/S)."""
    tiles = -(-m // match_ops.TILE)
    bounds = [tiles * s // splits for s in range(splits + 1)]
    return [(min(m, t0 * match_ops.TILE), min(m, t1 * match_ops.TILE))
            for t0, t1 in zip(bounds, bounds[1:])]


def _top2_split_plain(a, b, valid, use_bf16, splits):
    """The kernel's decomposition with the twin's pieces: per column split,
    the rows' top-2 (``top2_rows``), merged in split order (``top2_merge``)."""
    ac, bc = match_ops.rounded(a, use_bf16), match_ops.rounded(b, use_bf16)
    an, bn = (ac * ac).sum(-1), (bc * bc).sum(-1)
    inf = float("inf")
    carry = (torch.zeros(len(a), dtype=torch.int64), torch.full((len(a),), inf),
             torch.full((len(a),), inf))
    for c0, c1 in _split_columns(len(b), splits):
        if c1 > c0:
            d2 = torch.clamp((an[:, None] + bn[None, c0:c1]) - 2.0 * (ac @ bc[c0:c1].T), min=0.0)
            d2 = torch.where(valid[None, c0:c1], d2, inf)
            i1, d1, second = match_ops.top2_rows(d2)
            carry = match_ops.top2_merge(carry, (i1 + c0, d1, second))
    return carry


@pytest.mark.parametrize("use_bf16", [False, True])
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 13])
def test_k2_split_and_merge_rule_equals_twin(rng, use_bf16, splits):
    """The kernel's decomposition (column splits of whole 128-ref tiles,
    each split's top-2 merged in split order) run with the twin's pieces
    gives the twin's indices and distances exactly, ties included."""
    a, b, valid = _duplicate_laden(rng, 300, 1500)
    got = _top2_split_plain(a, b, valid, use_bf16, splits)
    want = match_ops.top2_match_plain(a, b, valid, use_bf16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the ties are there: refs equal to a scan row are found at distance 0
    assert bool((want[1] == 0).any()) and bool((want[2] == want[1]).any())


@pytest.mark.parametrize("n,m,sms", [(4096, 4096, 132), (6531, 6634, 132), (50_000, 50_000, 132),
                                     (1, 5, 132), (300, 1500, 2), (10, 0, 132)])
def test_k2_column_splits_fill_one_wave(n, m, sms):
    """Splits fill at most one wave of two blocks an SM (at least one
    split, at most one a ref tile) and cover the refs in order, once."""
    splits = match_ops.column_splits(n, m, sms)
    tiles = -(-m // match_ops.TILE)
    row_blocks = -(-n // match_ops.TILE)
    assert 1 <= splits <= max(1, tiles)
    assert splits == 1 or row_blocks * splits <= match_ops.BLOCKS_PER_SM * sms
    cols = _split_columns(m, splits)
    assert len(cols) == splits and cols[0][0] == 0 and cols[-1][1] == m
    assert all(c1 == d0 for (_, c1), (d0, _) in zip(cols, cols[1:]))
    assert all(c0 % match_ops.TILE == 0 for c0, _ in cols)
