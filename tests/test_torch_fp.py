"""Port parity: the port's correctly rounded float32 helpers (``_fp``).

``_fp.sqrt`` is held to the float64 square root rounded once to float32
(exact for float32 inputs) on 10^6 seeded floats, bit for bit; voxel
subsampling, whose representative is the point of least distance to its
voxel's barycenter, is held to JAX's ``grid_subsample`` index for index
on Gaussian clouds whose voxels hold many points each, where a distance
one ulp off changes a representative.
"""

import numpy as np
import pytest
import torch

from shot_fpfh_tpu.core import subsampling as j_sub
from shot_fpfh_tpu_torch import _fp
from shot_fpfh_tpu_torch.core import subsampling as t_sub

# The suite runs several pytest workers side by side on the CPU: one torch
# thread per worker keeps torch's OpenMP pool from oversubscribing the cores
# (it slowed every worker, JAX tests included, by up to 2x).
torch.set_num_threads(1)


def test_sqrt_is_correctly_rounded():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(0.0, 1.0, 500_000),
        np.exp(rng.uniform(-80.0, 80.0, 500_000)),      # every binade of the squares
    ]).astype(np.float32)
    x[:4] = [0.0, 0.009678754, 1.0, np.finfo(np.float32).max]
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    got = _fp.sqrt(torch.tensor(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[1] == np.float32(0.09838066)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grid_subsample_matches_jax_at_large_occupancy(seed):
    """20,000 standard-normal points at voxel 0.2: ~7,900 voxels, the
    central ones holding tens of points."""
    pts = np.random.default_rng(seed).normal(size=(20_000, 3)).astype(np.float32)
    want = np.asarray(j_sub.grid_subsample(pts, 0.2))
    got = t_sub.grid_subsample(pts, 0.2, device="cpu")
    np.testing.assert_array_equal(got, want)
