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
