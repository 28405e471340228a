"""Port parity: K1 (SHOT frames + binning + histogram, plain twin) and
single-scale SHOT descriptors.

The JAX side rounds histogram weights to bf16 (``models/shot.py:195-203``,
``pallas_shot_fused.py:58-68``) while the port accumulates f32, so
histograms are held to the flip rule of ``bench.py:309-315``: at most 0.3%
of elements off by more than 5e-3 + 1%, none off by more than 0.1.
Frames atol 5e-4 (``bench.py:377``).
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
from shot_fpfh_tpu.models import shot as j_shot  # noqa: E402
from shot_fpfh_tpu.ops.pallas_shot_fused import shot_binning_histogram as j_kernel  # noqa: E402
from shot_fpfh_tpu_torch import _kernels  # noqa: E402
from shot_fpfh_tpu_torch.models import shot as t_shot  # noqa: E402
from shot_fpfh_tpu_torch.ops.shot_fused import shot_binning_histogram  # noqa: E402

# The suite runs several pytest workers side by side on the CPU: one torch
# thread per worker keeps torch's OpenMP pool from oversubscribing the cores
# (it slowed every worker, JAX tests included, by up to 2x).
torch.set_num_threads(1)

RADIUS = 0.8


def assert_flip_rule(got, want):
    got, want = np.asarray(got), np.asarray(want)
    diff = np.abs(got - want)
    flip = diff > 5e-3 + 1e-2 * np.abs(want)
    assert flip.mean() <= 3e-3, f"flip fraction {flip.mean()}"
    assert diff.max() <= 0.1, f"max diff {diff.max()}"


def surface_window(rng, q=8, w=96):
    """Feature-first windows around keypoints: points spread on a tilted
    surface patch (well-separated covariance eigenvalues), unit normals,
    +inf beyond the radius or on dropped lanes."""
    kp = rng.normal(size=(q, 3)).astype(np.float32)
    axes = np.linalg.qr(rng.normal(size=(q, 3, 3)))[0]
    local = rng.normal(size=(q, w, 3)) * np.array([0.45, 0.3, 0.03])
    pts = (kp[:, None] + np.einsum("qij,qwj->qwi", axes, local)).astype(np.float32)
    nrm = rng.normal(size=(q, w, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    vals = np.moveaxis(np.concatenate([pts, nrm], -1), 1, 2).astype(np.float32)
    d = np.linalg.norm(pts - kp[:, None], axis=-1)
    keep = (d <= RADIUS) & (rng.uniform(size=(q, w)) > 0.1)
    return kp, vals, np.where(keep, d, np.inf).astype(np.float32)


@jax.jit
def _xla_histogram(kp, vals, dist_inf, rfs):
    """The JAX XLA window path's unnormalized histograms for given frames."""
    ok = jnp.isfinite(dist_inf)
    centered = jnp.where(ok[:, None, :], vals[:, :3, :] - kp[:, :, None], 0.0)
    rho = jnp.where(ok, dist_inf, 0.0)
    local = jnp.einsum("qiw,qij->qjw", centered, rfs)
    nrms = jnp.where(ok[:, None, :], vals[:, 3:6, :], 0.0)
    cosine = jnp.clip(jnp.einsum("qiw,qi->qw", nrms, rfs[..., :, 2]), -1, 1)
    return j_shot._shot_accumulate(local[:, 0], local[:, 1], local[:, 2], rho, cosine,
                                   ok & (rho > 0), RADIUS, False, -1)


@pytest.mark.parametrize("own_frames", [True, False])
def test_k1_plain_matches_reference_kernel(rng, own_frames):
    kp, vals, dist_inf = surface_window(rng)
    jkp, jvals, jdist = jnp.asarray(kp), jnp.asarray(vals), jnp.asarray(dist_inf)
    ok = jnp.isfinite(jdist)
    # compiled, as inside the JAX pipeline (op-by-op dispatch costs seconds)
    j_rfs = jax.jit(j_shot._local_rfs_ff, static_argnums=3)(
        jnp.where(ok[:, None, :], jvals[:, :3] - jkp[:, :, None], 0.0),
        jnp.where(ok, jdist, 0.0), ok, RADIUS)
    before = dict(_kernels.launch_counts)
    if own_frames:
        j_hist, j_kernel_rfs = j_kernel(jvals, jdist, jkp, None, RADIUS, interpret=True)
        t_hist, t_rfs = shot_binning_histogram(torch.tensor(vals), torch.tensor(dist_inf),
                                               torch.tensor(kp), None, RADIUS)
        np.testing.assert_allclose(t_rfs.numpy(), np.asarray(j_rfs), atol=5e-4)
        np.testing.assert_allclose(t_rfs.numpy(), np.asarray(j_kernel_rfs), atol=5e-4)
    else:
        j_hist = j_kernel(jvals, jdist, jkp, j_rfs, RADIUS, interpret=True)
        t_hist = shot_binning_histogram(torch.tensor(vals), torch.tensor(dist_inf),
                                        torch.tensor(kp), torch.tensor(np.asarray(j_rfs)),
                                        RADIUS)
    assert _kernels.launch_counts == before      # CPU tensors: plain twin
    assert t_hist.shape == (len(kp), 352) and float(t_hist.sum()) > 0
    assert_flip_rule(t_hist.numpy(), j_hist)
    assert_flip_rule(t_hist.numpy(), _xla_histogram(jkp, jvals, jdist, j_rfs))


@pytest.mark.parametrize("n_support", [22_000, 3_000])
def test_compute_shot_descriptor_both_routes(n_support):
    """Grid window route (K1) above AUTO_GRID_MIN_POINTS, brute k_max-capped
    route below; far-sentinel keypoints give zero descriptors."""
    rng = np.random.default_rng(n_support)
    scale = 5.0 if n_support > 20_000 else 2.0
    pts = make_terrain(n_support, rng, scale=scale, n_bumps=10)
    nrm = rng.normal(size=pts.shape)
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    kp = np.concatenate([pts[rng.choice(n_support, 200, replace=False)],
                         np.full((3, 3), 1e6, np.float32)])
    j_desc, j_rfs = j_shot.compute_shot_descriptor(kp, pts, nrm, 0.5, k_max=256,
                                                   min_neighborhood_size=10)
    t_desc, t_rfs = t_shot.compute_shot_descriptor(kp, pts, nrm, 0.5, k_max=256,
                                                   min_neighborhood_size=10, device="cpu")
    assert_flip_rule(t_desc.numpy(), j_desc)
    np.testing.assert_allclose(t_rfs.numpy(), np.asarray(j_rfs), atol=5e-4)
    assert not t_desc[-3:].any() and bool(t_desc[:-3].any(dim=1).all())


def test_shot_computer_pads_and_subsamples(rng):
    pts = make_terrain(4000, rng, scale=2.0, n_bumps=10)
    nrm = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (4000, 1))
    kp = pts[:130]
    j = j_shot.ShotComputer(min_neighborhood_size=10, k_max=256).compute_descriptor_single_scale(
        pts, nrm, kp, radius=0.5, subsampling_voxel_size=0.05)
    t = t_shot.ShotComputer(min_neighborhood_size=10, k_max=256,
                            device="cpu").compute_descriptor_single_scale(
        pts, nrm, kp, radius=0.5, subsampling_voxel_size=0.05)
    assert t.shape == (130, 352)
    assert_flip_rule(t.numpy(), j)
