"""Port parity: RANSAC with injected draws, and ICP.

JAX's PRNG cannot be reproduced by a ``torch.Generator``, so the reference's
own draws (``ransac.py:44-48``) are handed to the port: the best inlier
count must be identical and the transform agree to atol 1e-4.  ICP must run
the same number of iterations and agree to atol 1e-4, on the brute 1-NN
route and on the grid 1-NN route (ref of 20k points or more).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import make_terrain  # noqa: E402
from shot_fpfh_tpu.core.transform import RigidTransform as JTransform  # noqa: E402
from shot_fpfh_tpu.registration import icp as j_icp  # noqa: E402
from shot_fpfh_tpu.registration.ransac import ransac_on_matches as j_ransac  # noqa: E402
from shot_fpfh_tpu_torch.core.transform import RigidTransform  # noqa: E402
from shot_fpfh_tpu_torch.models.normals import compute_normals  # noqa: E402
from shot_fpfh_tpu_torch.registration import icp as t_icp  # noqa: E402
from shot_fpfh_tpu_torch.registration.ransac import ransac_on_matches, sample_draws  # noqa: E402

# The suite runs several pytest workers side by side on the CPU: one torch
# thread per worker keeps torch's OpenMP pool from oversubscribing the cores
# (it slowed every worker, JAX tests included, by up to 2x).
torch.set_num_threads(1)


def _rotation(rng, max_angle):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = rng.uniform(0.5, 1.0) * max_angle
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * k @ k).astype(np.float32)


def test_ransac_with_reference_draws(rng):
    m, n_draws, draw_size = 300, 1500, 4
    scan = rng.uniform(-3, 3, size=(m, 3)).astype(np.float32)
    rot, t = _rotation(rng, 1.0), rng.normal(size=3).astype(np.float32)
    ref = scan @ rot.T + t + 0.01 * rng.normal(size=(m, 3)).astype(np.float32)
    ref[: m // 2] = rng.uniform(-3, 3, size=(m // 2, 3))      # half are outliers
    key = jax.random.key(72)
    keys = jax.random.split(key, n_draws)
    draws = np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, m, shape=(draw_size,), replace=False))(keys))
    j_ratio, j_tf = j_ransac(jnp.asarray(scan), jnp.asarray(ref), key, n_draws=n_draws,
                             draw_size=draw_size, distance_threshold=0.1)
    t_ratio, t_tf = ransac_on_matches(torch.tensor(scan), torch.tensor(ref), draws=draws,
                                      distance_threshold=0.1)
    assert round(float(t_ratio) * m) == round(float(j_ratio) * m)
    np.testing.assert_allclose(t_tf.rotation.numpy(), np.asarray(j_tf.rotation), atol=1e-4)
    np.testing.assert_allclose(t_tf.translation.numpy(), np.asarray(j_tf.translation), atol=1e-4)


def test_sampled_draws_are_distinct_and_seeded():
    a = sample_draws(10, 2000, 4, torch.Generator().manual_seed(3))
    b = sample_draws(10, 2000, 4, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    s = torch.sort(a, dim=1).values
    assert not (s[:, 1:] == s[:, :-1]).any() and int(a.max()) < 10


@pytest.mark.parametrize("kind,n", [("point_to_point", 3000), ("point_to_plane", 21000)])
def test_icp_matches_reference(rng, kind, n):
    scale = 5.0 if n > 20_000 else 2.0
    ref = make_terrain(n, rng, scale=scale, n_bumps=10).astype(np.float64)
    rot, t = _rotation(rng, 0.05), np.array([0.05, -0.03, 0.02])
    scan = (ref - t) @ rot          # ref = rot @ scan + t exactly
    init_rot = np.eye(3, dtype=np.float32)
    init_t = np.zeros(3, np.float32)
    kw = dict(d_max=0.3, voxel_size=0.15, max_iter=30, rms_threshold=1e-4)
    if kind == "point_to_point":
        j = j_icp.icp_point_to_point(scan, ref, JTransform(jnp.asarray(init_rot),
                                                           jnp.asarray(init_t)), **kw)
        tt = t_icp.icp_point_to_point(scan, ref, RigidTransform.from_numpy(init_rot, init_t),
                                      device="cpu", **kw)
    else:
        normals = compute_normals(ref, ref, k=20, device="cpu").numpy()  # one input to both
        j = j_icp.icp_point_to_plane(scan, ref, normals, JTransform(
            jnp.asarray(init_rot), jnp.asarray(init_t)), **kw)
        tt = t_icp.icp_point_to_plane(scan, ref, normals,
                                      RigidTransform.from_numpy(init_rot, init_t),
                                      device="cpu", **kw)
    assert tt.n_iters == j.n_iters
    assert tt.has_converged == j.has_converged
    np.testing.assert_allclose(tt.transform.rotation.numpy(), np.asarray(j.transform.rotation),
                               atol=1e-4)
    np.testing.assert_allclose(tt.transform.translation.numpy(),
                               np.asarray(j.transform.translation), atol=1e-4)
