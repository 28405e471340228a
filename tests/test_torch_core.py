"""Port parity: core geometry and the 3x3 eigensolver.

The same NumPy inputs go through the JAX reference (``shot_fpfh_tpu``) and
its PyTorch port (``shot_fpfh_tpu_torch``); both run on the CPU.
Tolerances: transforms and solvers atol 1e-5; voxel subsampling exact
indices; eigh3x3 eigenvalues rtol 1e-5, eigenvectors atol 1e-4 with the
same signs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shot_fpfh_tpu.core import solvers as j_solvers
from shot_fpfh_tpu.core import subsampling as j_sub
from shot_fpfh_tpu.core import transform as j_tf
from shot_fpfh_tpu.ops import eigh3 as j_eigh
from shot_fpfh_tpu_torch.core import solvers as t_solvers
from shot_fpfh_tpu_torch.core import subsampling as t_sub
from shot_fpfh_tpu_torch.core import transform as t_tf
from shot_fpfh_tpu_torch.ops import eigh3 as t_eigh

# The suite runs several pytest workers side by side on the CPU: one torch
# thread per worker keeps torch's OpenMP pool from oversubscribing the cores
# (it slowed every worker, JAX tests included, by up to 2x).
torch.set_num_threads(1)

ATOL = 1e-5

# the JAX references run compiled, as inside the JAX pipeline: on the CPU,
# op-by-op dispatch of these small functions costs seconds per test
_j_solve_p2p = jax.jit(j_solvers.solve_point_to_point)
_j_solve_p2l = jax.jit(j_solvers.solve_point_to_plane)
_j_eigh3x3 = jax.jit(j_eigh.eigh3x3)


def _rotations(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return np.asarray(jax.jit(j_tf.quaternion_to_matrix)(jnp.asarray(q))), q


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().cpu().numpy(), atol=atol)


@pytest.mark.parametrize("fn", ["quaternion_to_matrix", "matrix_to_quaternion",
                                "euler_xyz_to_matrix"])
def test_conversions(rng, fn):
    rots, q = _rotations(rng, 64)
    arg = {"quaternion_to_matrix": q, "matrix_to_quaternion": rots,
           "euler_xyz_to_matrix": rng.uniform(-3, 3, size=(64, 3)).astype(np.float32)}[fn]
    _close(jax.jit(getattr(j_tf, fn))(jnp.asarray(arg)), getattr(t_tf, fn)(torch.tensor(arg)))


@pytest.mark.parametrize("op", ["apply", "compose", "inverse", "normalize", "angle"])
def test_rigid_transform(rng, op):
    rots, _ = _rotations(rng, 2)
    ts = rng.normal(size=(2, 3)).astype(np.float32)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    ja, jb = (j_tf.RigidTransform(jnp.asarray(rots[i]), jnp.asarray(ts[i])) for i in range(2))
    ta, tb = (t_tf.RigidTransform.from_numpy(rots[i], ts[i]) for i in range(2))
    if op == "apply":
        _close(ja.apply(jnp.asarray(pts)), ta.apply(torch.tensor(pts)))
    elif op == "compose":
        _close((ja @ jb).as_matrix(), (ta @ tb).as_matrix())
    elif op == "inverse":
        _close(ja.inverse().as_matrix(), ta.inverse().as_matrix())
    elif op == "normalize":
        noisy = rots[0] + 1e-3 * rng.normal(size=(3, 3)).astype(np.float32)
        _close(j_tf.RigidTransform(jnp.asarray(noisy), jnp.asarray(ts[0]))
               .normalize_rotation().rotation,
               t_tf.RigidTransform.from_numpy(noisy, ts[0]).normalize_rotation().rotation)
    else:
        _close(j_tf.rotation_angle(jnp.asarray(rots[0]), jnp.asarray(rots[1])),
               t_tf.rotation_angle(torch.tensor(rots[0]), torch.tensor(rots[1])))


@pytest.mark.parametrize("weighted", [False, True])
def test_solve_point_to_point_batched(rng, weighted):
    rots, _ = _rotations(rng, 8)
    src = rng.normal(size=(8, 30, 3)).astype(np.float32)
    dst = (np.einsum("bij,bkj->bki", rots, src) + rng.normal(size=(8, 1, 3))
           + 0.01 * rng.normal(size=src.shape)).astype(np.float32)
    dst[0] = src[0] * np.array([1, 1, -1], np.float32)   # reflection: det<0 fix
    w = (rng.uniform(size=(8, 30)) > 0.3).astype(np.float32) if weighted else None
    jt = _j_solve_p2p(jnp.asarray(src), jnp.asarray(dst), None if w is None else jnp.asarray(w))
    tt = t_solvers.solve_point_to_point(torch.tensor(src), torch.tensor(dst),
                                        None if w is None else torch.tensor(w))
    _close(jt.rotation, tt.rotation)
    _close(jt.translation, tt.translation)
    assert np.all(np.linalg.det(tt.rotation.numpy()) > 0)


def test_solve_point_to_plane_and_rms(rng):
    src = rng.normal(size=(200, 3)).astype(np.float32)
    nrm = rng.normal(size=(200, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    dst = (src + 0.02 * rng.normal(size=src.shape)).astype(np.float32)
    w = (rng.uniform(size=200) > 0.2).astype(np.float32)
    jt = _j_solve_p2l(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(nrm), jnp.asarray(w))
    tt = t_solvers.solve_point_to_plane(torch.tensor(src), torch.tensor(dst),
                                        torch.tensor(nrm), torch.tensor(w))
    _close(jt.rotation, tt.rotation)
    _close(jt.translation, tt.translation)
    j_rms, _ = j_solvers.registration_rms(jnp.asarray(src), jnp.asarray(dst), jt)
    t_rms, _ = t_solvers.registration_rms(torch.tensor(src), torch.tensor(dst), tt)
    _close(j_rms, t_rms)


@pytest.mark.parametrize("n,voxel,seed", [(3000, 0.05, 1), (5000, 0.1, 2), (25000, 0.08, 3)])
def test_grid_subsample_exact(n, voxel, seed):
    from conftest import make_cloud

    pts = make_cloud(n, np.random.default_rng(seed), scale=2.0).astype(np.float32)
    np.testing.assert_array_equal(j_sub.grid_subsample(pts, voxel),
                                  t_sub.grid_subsample(pts, voxel, device="cpu"))
    for j_out, t_out in zip(j_sub.grid_subsample_masked(pts, voxel),
                            t_sub.grid_subsample_masked(pts, voxel, device="cpu")):
        np.testing.assert_array_equal(np.asarray(j_out), t_out.numpy())
    ji, jm, jc = (np.asarray(x) for x in j_sub.voxel_counts_for_representatives(pts, voxel))
    ti, tm, tc = (x.numpy() for x in t_sub.voxel_counts_for_representatives(pts, voxel,
                                                                              device="cpu"))
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_array_equal(jm, tm)
    np.testing.assert_array_equal(jc, tc)


@pytest.mark.parametrize("kind", ["random", "spd", "planar"])
def test_eigh3x3_same_values_and_signs(rng, kind):
    a = rng.normal(size=(256, 3, 3))
    if kind == "random":
        a = (a + np.swapaxes(a, -1, -2)) / 2
    elif kind == "spd":
        a = a @ np.swapaxes(a, -1, -2)
    else:  # near-planar neighborhoods, as SHOT frames and normals see them
        pts = rng.normal(size=(256, 40, 3)) * np.array([1.0, 0.7, 0.01])
        a = np.einsum("bki,bkj->bij", pts, pts) / 40
    a = a.astype(np.float32)
    jw, jv = (np.asarray(x) for x in _j_eigh3x3(jnp.asarray(a)))
    tw, tv = (x.numpy() for x in t_eigh.eigh3x3(torch.tensor(a)))
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-6 * np.abs(jw).max())
    np.testing.assert_allclose(tv, jv, atol=1e-4)


def test_pca_eigh_masked(rng):
    pts = rng.normal(size=(64, 20, 3)).astype(np.float32) * np.array([1, 0.5, 0.05], np.float32)
    mask = rng.uniform(size=(64, 20)) > 0.3
    jw, jv, jb = (np.asarray(x) for x in j_eigh.pca_eigh(jnp.asarray(pts), jnp.asarray(mask)))
    tw, tv, tb = (x.numpy() for x in t_eigh.pca_eigh(torch.tensor(pts), torch.tensor(mask)))
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tv, jv, atol=1e-4)
    np.testing.assert_allclose(tb, jb, atol=ATOL)
