"""Port parity: the last names of the JAX package's surface and the
arguments the port once refused.

- ``RigidTransform.identity`` equal to JAX's at batch shapes ``()`` and
  ``(4,)``; ``inv`` within 1e-6 of JAX's.
- ``ops.grid_hash.radius_search_auto`` on both sides of
  ``AUTO_GRID_MIN_POINTS`` (500 and 20,500 points): masks and in-radius
  index sets equal to JAX's.
- ``registration.matching.top2_rows`` / ``top2_merge`` are ``ops.match``'s
  objects, and equal JAX's on a small masked tile.
- ``compute_shot_descriptor(local_rf_neighborhoods=)`` at 2,500 and 20,500
  support points, given JAX's neighborhoods: frames within 5e-4,
  histograms by the flip rule under identical frames (JAX given the port's
  frames); a given ``local_rfs`` wins over the neighborhoods.
- ``ShotComputer(verbose=False)`` through the pipeline and
  ``compute_descriptors(n_procs=4)`` in both packages: the same
  descriptors by the flip rule.
- The kept chunk knobs (``grid_radius_search(query_chunk=)``,
  ``sharded_ransac(draw_chunk=)``) leave the result ``torch.equal``;
  ``shard_rows`` takes only the mesh's axis.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_fpfh import surface  # noqa: E402
from test_torch_shot import assert_flip_rule  # noqa: E402

from shot_fpfh_tpu import pipeline as j_pl  # noqa: E402
from shot_fpfh_tpu.core.transform import RigidTransform as JTransform  # noqa: E402
from shot_fpfh_tpu.models import shot as j_shot  # noqa: E402
from shot_fpfh_tpu.ops import grid_hash as j_grid  # noqa: E402
from shot_fpfh_tpu.ops import neighbors as j_nb  # noqa: E402
from shot_fpfh_tpu.registration import matching as j_match  # noqa: E402
from shot_fpfh_tpu_torch import pipeline as t_pl  # noqa: E402
from shot_fpfh_tpu_torch.core.transform import RigidTransform, euler_xyz_to_matrix  # noqa: E402
from shot_fpfh_tpu_torch.models import shot as t_shot  # noqa: E402
from shot_fpfh_tpu_torch.ops import grid_hash as t_grid  # noqa: E402
from shot_fpfh_tpu_torch.ops import match as t_ops_match  # noqa: E402
from shot_fpfh_tpu_torch.ops.neighbors import Neighborhoods  # noqa: E402
from shot_fpfh_tpu_torch.parallel import mesh as t_mesh  # noqa: E402
from shot_fpfh_tpu_torch.parallel.sharded import sharded_ransac  # noqa: E402
from shot_fpfh_tpu_torch.registration import matching as t_match  # noqa: E402

# one torch thread a pytest worker (the suite runs workers side by side)
torch.set_num_threads(1)


def _from_jax(nbr) -> Neighborhoods:
    """A JAX ``Neighborhoods`` as the port's, on the CPU."""
    return Neighborhoods(torch.as_tensor(np.array(nbr.idx)).long(),
                         torch.as_tensor(np.array(nbr.dist)),
                         torch.as_tensor(np.array(nbr.mask)))


def _in_radius_sets(idx, mask):
    """Each row's in-radius indices, sorted (-1 where masked)."""
    return np.sort(np.where(np.asarray(mask), np.asarray(idx), -1), axis=1)


@pytest.mark.parametrize("batch_shape", [(), (4,)])
def test_identity_equals_jax(batch_shape):
    want = JTransform.identity(jnp.float32, batch_shape)
    got = RigidTransform.identity(torch.float32, batch_shape, device="cpu")
    assert got.rotation.dtype == torch.float32 and got.rotation.device.type == "cpu"
    np.testing.assert_array_equal(got.rotation.numpy(), np.asarray(want.rotation))
    np.testing.assert_array_equal(got.translation.numpy(), np.asarray(want.translation))


def test_inv_matches_jax(rng):
    angles = rng.uniform(-np.pi, np.pi, size=(5, 3)).astype(np.float32)
    rot = euler_xyz_to_matrix(torch.as_tensor(angles))
    t = rng.normal(size=(5, 3)).astype(np.float32)
    got = RigidTransform(rot, torch.as_tensor(t)).inv()
    want = JTransform(jnp.asarray(rot.numpy()), jnp.asarray(t)).inv()
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=1e-6)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation),
                               atol=1e-6)
    back = got @ RigidTransform(rot, torch.as_tensor(t))
    np.testing.assert_allclose(back.rotation.numpy(), np.broadcast_to(np.eye(3), (5, 3, 3)),
                               atol=1e-5)


@pytest.mark.parametrize("n", [500, 20_500])
def test_radius_search_auto_matches_jax(rng, n):
    pts, _ = surface(n, rng, 2.0 * np.sqrt(n / 20_500))
    queries = pts[rng.choice(n, 300, replace=False)]
    radius, k_max = 0.15, 192
    want = j_grid.radius_search_auto(queries, pts, radius, k_max)
    got = t_grid.radius_search_auto(torch.as_tensor(queries), torch.as_tensor(pts), radius,
                                    k_max)
    assert (n >= t_grid.AUTO_GRID_MIN_POINTS) == (n >= j_grid.AUTO_GRID_MIN_POINTS)
    assert int(got.count.max()) < k_max   # no row capped: the sets are whole
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(_in_radius_sets(got.idx, got.mask),
                                  _in_radius_sets(want.idx, want.mask))


def test_matching_top2_helpers_are_ops_match_and_equal_jax(rng):
    assert t_match.top2_rows is t_ops_match.top2_rows
    assert t_match.top2_merge is t_ops_match.top2_merge
    d2 = rng.uniform(0, 4, size=(9, 13)).astype(np.float32)
    d2[rng.uniform(size=d2.shape) < 0.2] = np.inf
    d2[:, 5] = d2[:, 2]     # a tie: the first minimum wins
    got = t_match.top2_rows(torch.as_tensor(d2))
    want = j_match.top2_rows(jnp.asarray(d2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    tile = (torch.as_tensor(rng.integers(0, 50, 9)), *(torch.as_tensor(
        rng.uniform(0, 4, 9).astype(np.float32)) for _ in range(2)))
    got = t_match.top2_merge(got, tile)
    want = j_match.top2_merge(want, tuple(jnp.asarray(x.numpy()) for x in tile))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [2_500, 20_500])
def test_shot_given_frame_neighborhoods_matches_jax(rng, n):
    """Both sides search the ``k_max``-capped neighborhoods (brute at 2,500
    points, the halo-2 grid at 20,500) and take the frames from JAX's own
    neighborhoods, searched at a smaller radius than the bins' (the frames
    still weigh them by the descriptor's radius, as JAX does)."""
    pts, nrm = surface(n, rng, 2.0 * np.sqrt(n / 2_500))
    kp = pts[rng.choice(n, 160, replace=False)]
    radius = 0.5
    rf_nbr = j_nb.radius_search(jnp.asarray(kp), jnp.asarray(pts), 0.3, 256)
    opts = dict(k_max=256, min_neighborhood_size=10)
    _, j_rfs = j_shot.compute_shot_descriptor(kp, pts, nrm, radius,
                                              local_rf_neighborhoods=rf_nbr, **opts)
    t_desc, t_rfs = t_shot.compute_shot_descriptor(kp, pts, nrm, radius,
                                                   local_rf_neighborhoods=_from_jax(rf_nbr),
                                                   device="cpu", **opts)
    np.testing.assert_allclose(t_rfs.numpy(), np.asarray(j_rfs), atol=5e-4)
    # histograms under identical frames: JAX given the port's (they win)
    j_same, j_kept = j_shot.compute_shot_descriptor(kp, pts, nrm, radius,
                                                    local_rfs=jnp.asarray(t_rfs.numpy()),
                                                    local_rf_neighborhoods=rf_nbr, **opts)
    np.testing.assert_array_equal(np.asarray(j_kept), t_rfs.numpy())
    assert (np.abs(t_desc.numpy()).sum(1) > 0).mean() > 0.9
    assert_flip_rule(t_desc.numpy(), j_same)


def test_given_frames_win_over_given_neighborhoods(rng):
    pts, nrm = surface(2_500, rng, 2.0)
    kp = torch.as_tensor(pts[:64])
    nbr = t_grid.radius_search_auto(kp, torch.as_tensor(pts), 0.5, 128)
    empty = Neighborhoods(torch.zeros_like(nbr.idx), nbr.dist, torch.zeros_like(nbr.mask))
    _, rfs = t_shot.compute_shot_descriptor(kp, pts, nrm, 0.5, local_rf_neighborhoods=nbr,
                                            device="cpu")
    flipped = -rfs
    outs = [t_shot.compute_shot_descriptor(kp, pts, nrm, 0.5, local_rfs=flipped,
                                           local_rf_neighborhoods=given, device="cpu")
            for given in (nbr, empty)]
    for desc, frames in outs:
        assert torch.equal(frames, flipped)
        assert torch.equal(desc, outs[0][0])
    # the neighborhoods alone: the empty ones give identity frames
    _, eye = t_shot.compute_shot_descriptor(kp, pts, nrm, 0.5, local_rf_neighborhoods=empty,
                                            device="cpu")
    assert torch.equal(eye, torch.eye(3).expand(64, 3, 3))


def test_pipeline_passes_reference_arguments_like_jax(rng):
    """``verbose`` reaches ``ShotComputer`` through ``**shot_config`` and
    ``compute_descriptors`` drops ``n_procs`` and the verbosity flags, in
    both packages."""
    pts, nrm = surface(2_000, rng, 2.0)
    kp = np.arange(0, 2_000, 10)
    clouds = dict(scan=pts, scan_normals=nrm, ref=pts[::-1].copy(), ref_normals=nrm[::-1].copy())
    j_pipe = j_pl.RegistrationPipeline(**clouds)
    t_pipe = t_pl.RegistrationPipeline(**clouds, device="cpu")
    assert t_shot.ShotComputer(verbose=False).verbose is False
    for pipe in (j_pipe, t_pipe):
        pipe.scan_keypoints, pipe.ref_keypoints = kp, kp.copy()
        pipe.compute_shot_descriptor_single_scale(0.5, min_neighborhood_size=10,
                                                  verbose=False)
    verbose = [np.array(p.scan_descriptors) for p in (t_pipe, j_pipe)]
    for pipe in (j_pipe, t_pipe):
        pipe.compute_descriptors(0.5, "shot_single_scale", min_neighborhood_size=10,
                                 subsample_support=False, force_recompute=True, n_procs=4,
                                 verbose=False)
    assert_flip_rule(*verbose)
    assert_flip_rule(np.array(t_pipe.ref_descriptors), np.array(j_pipe.ref_descriptors))
    # the same as without the reference's arguments
    t_plain = t_pl.RegistrationPipeline(**clouds, device="cpu")
    t_plain.scan_keypoints, t_plain.ref_keypoints = kp, kp.copy()
    t_plain.compute_descriptors(0.5, "shot_single_scale", min_neighborhood_size=10,
                                subsample_support=False)
    assert torch.equal(torch.as_tensor(t_plain.ref_descriptors),
                       torch.as_tensor(t_pipe.ref_descriptors))


@pytest.mark.parametrize("with_values", [False, True])
def test_grid_radius_search_query_chunk_leaves_rows_equal(rng, with_values):
    pts, nrm = surface(3_000, rng, 2.0)
    grid = t_grid.build_grid(pts, 0.2, extras=nrm, device="cpu")
    q = torch.as_tensor(pts[:301])
    outs = [t_grid.grid_radius_search(grid, q, 0.2, 64, query_chunk=c,
                                      with_values=with_values) for c in (None, 512, 37)]
    for out in outs[1:]:
        nbr, vals = out if with_values else (out, None)
        ref_nbr, ref_vals = outs[0] if with_values else (outs[0], None)
        for a, b in ((nbr.idx, ref_nbr.idx), (nbr.dist, ref_nbr.dist),
                     (nbr.mask, ref_nbr.mask)):
            assert torch.equal(a, b)
        if with_values:
            assert torch.equal(vals, ref_vals)


def test_sharded_ransac_draw_chunk_leaves_the_result_equal(rng):
    mesh = t_mesh.make_mesh(device="cpu")
    scan = rng.normal(size=(120, 3)).astype(np.float32)
    rot = euler_xyz_to_matrix(torch.tensor([0.1, -0.2, 0.3])).numpy()
    ref = scan @ rot.T + np.array([0.2, 0.0, -0.1], np.float32)
    ref[::3] += rng.normal(size=ref[::3].shape).astype(np.float32)    # outliers
    draws = torch.as_tensor(rng.integers(0, 120, size=(1000, 4)))
    outs = [sharded_ransac(scan, ref, None, mesh, draws=draws, distance_threshold=0.05,
                           draw_chunk=c) for c in (None, 256, 37)]
    for ratio, tf in outs[1:]:
        assert torch.equal(ratio, outs[0][0])
        assert torch.equal(tf.rotation, outs[0][1].rotation)
        assert torch.equal(tf.translation, outs[0][1].translation)
    assert float(outs[0][0]) > 0.6


def test_shard_rows_takes_only_the_mesh_axis():
    mesh = t_mesh.make_mesh(device="cpu")
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(t_mesh.shard_rows(x, mesh, axis=t_mesh.POINTS_AXIS), x)
    with pytest.raises(ValueError, match="no axis 'wrong'"):
        t_mesh.shard_rows(x, mesh, axis="wrong")
