"""Port parity of the sharded stages (``shot_fpfh_tpu_torch.parallel``) on a
2-rank gloo group on the CPU.

A module-scoped fixture writes every stage's inputs (numpy, seeded) to an
``.npz`` and launches two ranks (``sys.executable -c WORKER``, a ``file://``
store in ``tmp_path``, collectives under a 120 s timeout, so a hang fails).
Each rank runs every sharded stage and writes its results; rank 0 also runs
the port's single-device function on the same inputs.  Each stage is held
two ways:

- (a) to the port's single-device function: equal for the per-row stages
  (SHOT, normals, FPFH, the ring's indices on distinct distances, the
  multiscale indices); RANSAC's count equal with the transform within
  1e-5; ICP within 1e-5 and the same iteration count;
- (b) to JAX's sharded function on a 2-device ``make_mesh`` of
  ``conftest.py``'s virtual CPU mesh, at the tolerances the port's
  single-device tests use for the same function: SHOT by the flip rule
  (frames atol 5e-4, ``tests/test_torch_shot.py``), normals
  ``|n·n'| > 0.999`` for ≥ 99.9% (``tests/test_torch_features.py``), FPFH
  atol 1e-5 (``tests/test_torch_fpfh.py``), the ring's indices exact and
  its distances 1e-4 (``tests/test_sharded.py``), multiscale 1e-5, RANSAC
  with JAX's draws injected: the count equal, the transform 1e-4, ICP 1e-4
  and the same iteration count (``tests/test_torch_registration.py``).

The grid routes run on a 20,500-point support (SHOT, normals, ICP); FPFH's
grid route lowers both packages' ``ops.grid_hash.AUTO_GRID_MIN_POINTS`` to
reach it on 3,000 points.  Every rank must hold the same full results, and
ranks given different branch inputs raise instead of hanging.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from bench import make_terrain  # noqa: E402
from test_torch_shot import assert_flip_rule  # noqa: E402

import shot_fpfh_tpu.ops.grid_hash as j_grid_hash  # noqa: E402
from shot_fpfh_tpu.core.transform import RigidTransform as JTransform  # noqa: E402
from shot_fpfh_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from shot_fpfh_tpu.parallel import sharded as j_sharded  # noqa: E402

# The suite runs several pytest workers side by side on the CPU: one torch
# thread per worker keeps torch's OpenMP pool from oversubscribing the cores
# (it slowed every worker, JAX tests included, by up to 2x).
torch.set_num_threads(1)

RANKS = 2
SHOT_R, SHOT_RF = 0.5, 0.3
FPFH_R, FPFH_GRID_MIN = 0.8, 2000
RANSAC_THR = 0.1
ICP = dict(d_max=0.5, max_iter=12, rms_threshold=1e-6)

WORKER = r'''
import sys
import numpy as np
import torch

torch.set_num_threads(1)
rank, store, inputs, out, repo = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5]
sys.path.insert(0, repo)
from shot_fpfh_tpu_torch.core.transform import RigidTransform
from shot_fpfh_tpu_torch.models import fpfh, normals, shot
from shot_fpfh_tpu_torch.ops import grid_hash
from shot_fpfh_tpu_torch.ops.grid_hash import build_grid
from shot_fpfh_tpu_torch.parallel import make_mesh, sharded
from shot_fpfh_tpu_torch.parallel.mesh import all_gather_rows
from shot_fpfh_tpu_torch.registration import icp, matching, ransac

SHOT_R, SHOT_RF, FPFH_R, FPFH_GRID_MIN, RANSAC_THR = (float(v) for v in sys.argv[6:11])
ICP = dict(d_max=float(sys.argv[11]), max_iter=int(sys.argv[12]),
           rms_threshold=float(sys.argv[13]))
x = dict(np.load(inputs))
mesh = make_mesh(device="cpu", init_method="file://" + store, rank=rank, world_size=2,
                 timeout=120)
assert mesh.devices.size == 2 and mesh.backend == "gloo"
res, ref = {}, {}
npy = lambda t: t.cpu().numpy()

def shot_modes(tag, sup, nrm, kp, **kw):
    desc, rfs = sharded.sharded_shot_descriptors(kp, sup, nrm, SHOT_R, mesh, return_rfs=True,
                                                 **kw)
    res[tag + "_single"] = npy(desc)
    res[tag + "_frames"] = npy(all_gather_rows(rfs, mesh))[:len(kp)]
    res[tag + "_bi"] = npy(sharded.sharded_shot_descriptors(kp, sup, nrm, SHOT_R, mesh,
                                                            rf_radius=SHOT_RF, **kw))
    res[tag + "_shared"] = npy(sharded.sharded_shot_descriptors(
        kp, sup, nrm, SHOT_R * 1.5, mesh, shared_rfs=rfs, **kw))

kw = dict(k_max=128, min_neighborhood_size=5)
shot_modes("shot_brute", x["shot_sup"], x["shot_nrm"], x["shot_kp"], **kw)
shot_modes("shot_grid", x["grid_sup"], x["grid_nrm"], x["grid_kp"], **kw)

res["nrm_k_small"] = npy(sharded.sharded_normals(x["nrm_pts"], x["nrm_pts"], mesh, k=12,
                                                 pre_computed_normals=x["nrm_pre"]))
res["nrm_r_small"] = npy(sharded.sharded_normals(x["nrm_pts"], x["nrm_pts"], mesh,
                                                 radius=0.5, pre_computed_normals=x["nrm_pre"]))
res["nrm_k_large"] = npy(sharded.sharded_normals(x["nrm_q"], x["grid_sup"], mesh, k=12))
res["nrm_r_large"] = npy(sharded.sharded_normals(x["nrm_q"], x["grid_sup"], mesh, radius=0.3,
                                                 pre_computed_normals=x["nrm_q_pre"]))

res["fpfh_brute"] = npy(sharded.sharded_fpfh(x["fpfh_kp"], x["fpfh_pts"], x["fpfh_nrm"],
                                             FPFH_R, mesh, n_bins=5, k_max=96))
saved = grid_hash.AUTO_GRID_MIN_POINTS
grid_hash.AUTO_GRID_MIN_POINTS = int(FPFH_GRID_MIN)
res["fpfh_grid"] = npy(sharded.sharded_fpfh(x["fpfh_grid_kp"], x["fpfh_grid_pts"],
                                            x["fpfh_grid_nrm"], FPFH_R / 2, mesh, n_bins=5))
grid_hash.AUTO_GRID_MIN_POINTS = saved

for tag in ("ring", "tie"):
    r = sharded.ring_match(x[tag + "_a"], x[tag + "_b"], mesh)
    res[tag + "_idx"], res[tag + "_d1"], res[tag + "_d2"] = (npy(v) for v in r)
for recip in (0, 1):
    i, d = sharded.sharded_multiscale_match(x["ms_scan"], x["ms_ref"], mesh,
                                            filter_nonreciprocal=bool(recip))
    res[f"ms{recip}_idx"], res[f"ms{recip}_dist"] = npy(i), npy(d)

ratio, tf = sharded.sharded_ransac(x["ransac_scan"], x["ransac_ref"], None, mesh,
                                   draws=x["ransac_draws"], distance_threshold=RANSAC_THR)
res["ransac"] = np.concatenate([[float(ratio)], npy(tf.rotation).ravel(), npy(tf.translation)])

def icp_case(tag, scan, ref_pts, ref_nrm, p2plane):
    tf, rms, conv, n_it = sharded.sharded_icp(scan, ref_pts, ref_nrm if p2plane else None,
                                              RigidTransform(torch.eye(3), torch.zeros(3)), mesh,
                                              point_to_plane=p2plane, **ICP)
    res[tag] = np.concatenate([npy(tf.rotation).ravel(), npy(tf.translation), [rms, n_it]])

for route in ("brute", "grid"):
    for p2plane in (True, False):
        icp_case(f"icp_{route}_{'plane' if p2plane else 'point'}", x[f"icp_{route}_scan"],
                 x[f"icp_{route}_ref"], x[f"icp_{route}_nrm"], p2plane)

# ranks given different supports pick different routes: every rank raises
sup = x["grid_sup"] if rank == 0 else x["shot_sup"]
try:
    sharded.sharded_shot_descriptors(x["shot_kp"], sup, sup, SHOT_R, mesh, k_max=16)
    res["disagree"] = np.asarray("no error")
except RuntimeError as exc:
    res["disagree"] = np.asarray(str(exc))

if rank == 0:   # the port's single-device functions on the same inputs
    c = lambda a: torch.as_tensor(a)
    for tag, sup, nrm, kp in (("shot_brute", "shot_sup", "shot_nrm", "shot_kp"),
                              ("shot_grid", "grid_sup", "grid_nrm", "grid_kp")):
        desc, rfs = shot.compute_shot_descriptor(x[kp], x[sup], x[nrm], SHOT_R, k_max=128,
                                                 min_neighborhood_size=5, device="cpu")
        ref[tag + "_single"], ref[tag + "_frames"] = npy(desc), npy(rfs)
        computer = shot.ShotComputer(k_max=128, min_neighborhood_size=5, pad_queries_to=1,
                                     device="cpu")
        ref[tag + "_bi"] = npy(computer.compute_descriptor_bi_scale(
            x[sup], x[nrm], x[kp], SHOT_RF, SHOT_R))
        ref[tag + "_shared"] = npy(shot.compute_shot_descriptor(
            x[kp], x[sup], x[nrm], SHOT_R * 1.5, k_max=128, min_neighborhood_size=5,
            local_rfs=rfs, device="cpu")[0])
    nc = normals.compute_normals
    ref["nrm_k_small"] = npy(nc(x["nrm_pts"], x["nrm_pts"], k=12,
                                pre_computed_normals=x["nrm_pre"], device="cpu"))
    ref["nrm_r_small"] = npy(nc(x["nrm_pts"], x["nrm_pts"], radius=0.5,
                                pre_computed_normals=x["nrm_pre"], device="cpu"))
    ref["nrm_k_large"] = npy(nc(x["nrm_q"], x["grid_sup"], k=12, device="cpu"))
    ref["nrm_r_large"] = npy(nc(x["nrm_q"], x["grid_sup"], radius=0.3,
                                pre_computed_normals=x["nrm_q_pre"], device="cpu"))
    ref["fpfh_brute"] = npy(fpfh.compute_fpfh_descriptor(
        x["fpfh_kp"], x["fpfh_pts"], x["fpfh_nrm"], FPFH_R, n_bins=5, k_max=96, device="cpu"))
    grid_hash.AUTO_GRID_MIN_POINTS = int(FPFH_GRID_MIN)
    ref["fpfh_grid"] = npy(fpfh.compute_fpfh_descriptor(
        x["fpfh_grid_kp"], x["fpfh_grid_pts"], x["fpfh_grid_nrm"], FPFH_R / 2, n_bins=5,
        device="cpu"))
    grid_hash.AUTO_GRID_MIN_POINTS = saved
    for tag in ("ring", "tie"):
        idx, d1, d2 = matching.top2_descriptor(
            c(x[tag + "_a"]), c(x[tag + "_b"]), torch.ones(len(x[tag + "_b"]), dtype=torch.bool))
        ref[tag + "_idx"], ref[tag + "_d1"], ref[tag + "_d2"] = npy(idx), npy(d1), npy(d2)
    for recip in (0, 1):
        i, d = matching.multiscale_top1(x["ms_scan"], x["ms_ref"], device="cpu",
                                        filter_nonreciprocal=bool(recip))
        ref[f"ms{recip}_idx"], ref[f"ms{recip}_dist"] = npy(i), npy(d)
    ratio, tf = ransac.ransac_on_matches(c(x["ransac_scan"]), c(x["ransac_ref"]),
                                         draws=x["ransac_draws"], distance_threshold=RANSAC_THR)
    ref["ransac"] = np.concatenate([[float(ratio)], npy(tf.rotation).ravel(),
                                    npy(tf.translation)])
    for route in ("brute", "grid"):
        ref_pts = c(x[f"icp_{route}_ref"])
        grid = build_grid(ref_pts, ICP["d_max"]) if route == "grid" else None
        for p2plane in (True, False):
            out_ = icp.icp_loop(c(x[f"icp_{route}_scan"]), ref_pts,
                                c(x[f"icp_{route}_nrm"]) if p2plane else None,
                                RigidTransform(torch.eye(3), torch.zeros(3)), ICP["d_max"], ICP["max_iter"],
                                ICP["rms_threshold"], grid)
            ref[f"icp_{route}_{'plane' if p2plane else 'point'}"] = np.concatenate([
                npy(out_.transform.rotation).ravel(), npy(out_.transform.translation),
                [float(out_.rms), int(out_.n_iters)]])
np.savez(out, **res, **{"single/" + k: v for k, v in ref.items()})
'''


def _wavy(n, rng, scale):
    """Points on ``z = 0.4 sin x cos 0.7y`` and their exact unit normals."""
    xy = rng.uniform(-scale, scale, size=(n, 2))
    z = 0.4 * np.sin(xy[:, 0]) * np.cos(0.7 * xy[:, 1])
    grad = np.column_stack([-0.4 * np.cos(xy[:, 0]) * np.cos(0.7 * xy[:, 1]),
                            0.28 * np.sin(xy[:, 0]) * np.sin(0.7 * xy[:, 1]),
                            np.ones(n)])
    return (np.column_stack([xy, z]).astype(np.float32),
            (grad / np.linalg.norm(grad, axis=1, keepdims=True)).astype(np.float32))


def _unit(rng, n, tilt=1.0):
    v = rng.normal(size=(n, 3)) * [tilt, tilt, 1.0]
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _rotation(angle, axis):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k).astype(np.float32)


def _inputs(rng) -> dict:
    x = {}
    x["shot_sup"] = make_terrain(1500, rng, scale=2.0, n_bumps=10)
    x["shot_nrm"] = _unit(rng, 1500, 0.3)
    x["shot_kp"] = x["shot_sup"][rng.choice(1500, 37, replace=False)]
    x["grid_sup"] = make_terrain(20_500, rng, scale=5.0, n_bumps=10)
    x["grid_nrm"] = _unit(rng, 20_500, 0.3)
    x["grid_kp"] = np.concatenate([x["grid_sup"][rng.choice(20_500, 62, replace=False)],
                                   np.full((1, 3), 1e6, np.float32)])
    x["nrm_pts"], _ = _wavy(700, rng, 2.0)
    x["nrm_pre"] = rng.normal(size=(700, 3)).astype(np.float32)
    # two sparse queries far off the terrain: their radius holds too few
    # neighbors, so the streaming route's net re-solves them
    x["nrm_q"] = np.concatenate([x["grid_sup"][::67], [[0.0, 0.0, 6.0], [3.0, -2.0, -6.0]]]
                                ).astype(np.float32)
    x["nrm_q_pre"] = _unit(rng, len(x["nrm_q"]))
    x["fpfh_pts"] = (rng.normal(size=(501, 3)) * 2).astype(np.float32)
    x["fpfh_nrm"] = _unit(rng, 501)
    x["fpfh_kp"] = np.arange(0, 501, 7, dtype=np.int32)
    x["fpfh_grid_pts"], _ = _wavy(3000, rng, 3.0)
    x["fpfh_grid_nrm"] = _unit(rng, 3000, 0.3)
    x["fpfh_grid_kp"] = rng.choice(3000, 77, replace=False).astype(np.int32)
    x["ring_a"] = rng.normal(size=(37, 16)).astype(np.float32)
    x["ring_b"] = rng.normal(size=(53, 16)).astype(np.float32)
    # whole numbers: exact distances, so ties are certain
    x["tie_a"] = rng.integers(0, 3, size=(41, 8)).astype(np.float32)
    x["tie_b"] = rng.integers(0, 3, size=(29, 8)).astype(np.float32)
    scan_ms = rng.normal(size=(2, 83, 16)).astype(np.float32)
    ref_ms = rng.normal(size=(2, 97, 16)).astype(np.float32)
    scan_ms[0, :7] = 0.0
    ref_ms[1, 10:25] = 0.0
    x["ms_scan"], x["ms_ref"] = scan_ms, ref_ms
    m = 151
    scan = rng.normal(size=(m, 3)).astype(np.float32)
    ref = scan @ _rotation(0.6, [1, 2, 3]).T + np.float32([0.3, -0.2, 0.5])
    bad = rng.choice(m, 70, replace=False)
    ref[bad] += rng.normal(size=(70, 3)).astype(np.float32) * 4
    x["ransac_scan"], x["ransac_ref"] = scan, ref.astype(np.float32)
    keys = jax.random.split(jax.random.key(72), 512)
    x["ransac_draws"] = np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, m, shape=(4,), replace=False))(keys))
    rot, t = _rotation(0.03, [0.2, -0.3, 1.0]), np.float32([0.04, -0.03, 0.02])
    for route, n, scale in (("brute", 1500, 2.0), ("grid", 20_500, 5.0)):
        pts, nrm = _wavy(n, rng, scale)
        x[f"icp_{route}_ref"], x[f"icp_{route}_nrm"] = pts, nrm
        x[f"icp_{route}_scan"] = (pts[::7] @ rot.T + t).astype(np.float32)
    return x


class _Run:
    """The two ranks' run: started by the fixture, waited on at first use,
    so the JAX references of the first tests overlap it."""

    def __init__(self, tmp: Path, inputs: Path):
        self.outs = [tmp / f"rank{r}.npz" for r in range(RANKS)]
        args = [str(tmp / "store"), str(inputs)]
        consts = [SHOT_R, SHOT_RF, FPFH_R, FPFH_GRID_MIN, RANSAC_THR, ICP["d_max"],
                  ICP["max_iter"], ICP["rms_threshold"]]
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), *args, str(self.outs[r]), str(REPO),
             *map(str, consts)], cwd=tmp, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
        self._results = None

    def results(self) -> list[dict]:
        if self._results is None:
            logs = [p.communicate(timeout=600)[0] for p in self.procs]
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, log[-4000:]
            self._results = [dict(np.load(o)) for o in self.outs]
        return self._results


@pytest.fixture(scope="module")
def inputs():
    return _inputs(np.random.default_rng(11))


@pytest.fixture(scope="module")
def run(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    np.savez(tmp / "inputs.npz", **inputs)
    return _Run(tmp, tmp / "inputs.npz")


@pytest.fixture(scope="module")
def jmesh():
    return j_make_mesh(2)


def _got(run, key):
    return run.results()[0][key], run.results()[0]["single/" + key]


def _assert_normals(got, want):
    dots = np.abs(np.sum(got * want, axis=1))
    assert np.isfinite(got).all() and (dots > 0.999).mean() >= 0.999


@pytest.mark.parametrize("route", ["brute", "grid"])
def test_sharded_shot_matches_single_device_and_jax(run, inputs, jmesh, route):
    sup, nrm, kp = (inputs[f"{route if route == 'grid' else 'shot'}_{k}"]
                    for k in ("sup", "nrm", "kp"))
    kw = dict(k_max=128, min_neighborhood_size=5)
    j_desc, j_rfs = j_sharded.sharded_shot_descriptors(kp, sup, nrm, SHOT_R, jmesh,
                                                       return_rfs=True, **kw)
    j_bi = j_sharded.sharded_shot_descriptors(kp, sup, nrm, SHOT_R, jmesh, rf_radius=SHOT_RF,
                                              **kw)
    j_shared = j_sharded.sharded_shot_descriptors(kp, sup, nrm, SHOT_R * 1.5, jmesh,
                                                  shared_rfs=j_rfs, **kw)
    tag = f"shot_{route}"
    for mode, want in (("single", j_desc), ("bi", j_bi), ("shared", j_shared)):
        got, single = _got(run, f"{tag}_{mode}")
        assert got.shape == (len(kp), 352) and np.abs(got).sum() > 0
        np.testing.assert_array_equal(got, single)
        assert_flip_rule(got, want)
    got, single = _got(run, f"{tag}_frames")
    np.testing.assert_array_equal(got, single)
    np.testing.assert_allclose(got, np.asarray(j_rfs)[:len(kp)], atol=5e-4)


@pytest.mark.parametrize("case", ["k_small", "r_small", "k_large", "r_large"])
def test_sharded_normals_match_single_device_and_jax(run, inputs, jmesh, case):
    flavour, size = case.split("_")
    if size == "small":
        q = c = inputs["nrm_pts"]
        pre = inputs["nrm_pre"]
    else:
        q, c = inputs["nrm_q"], inputs["grid_sup"]
        pre = None if flavour == "k" else inputs["nrm_q_pre"]
    kw = dict(k=12) if flavour == "k" else dict(radius=0.5 if size == "small" else 0.3)
    want = j_sharded.sharded_normals(q, c, jmesh, pre_computed_normals=pre, **kw)
    got, single = _got(run, f"nrm_{case}")
    np.testing.assert_array_equal(got, single)
    _assert_normals(got, np.asarray(want))
    if case == "k_large":   # the two sparse queries: re-solved from their exact k-NN
        from shot_fpfh_tpu_torch.models.normals import _normals_knn

        net = _normals_knn(torch.as_tensor(q[-2:]), torch.as_tensor(c), 12, None)
        np.testing.assert_array_equal(got[-2:], net.numpy())


@pytest.mark.parametrize("route", ["brute", "grid"])
def test_sharded_fpfh_matches_single_device_and_jax(run, inputs, jmesh, route, monkeypatch):
    if route == "brute":
        want = j_sharded.sharded_fpfh(inputs["fpfh_kp"], inputs["fpfh_pts"],
                                      inputs["fpfh_nrm"], FPFH_R, jmesh, n_bins=5, k_max=96)
    else:
        monkeypatch.setattr(j_grid_hash, "AUTO_GRID_MIN_POINTS", FPFH_GRID_MIN)
        want = j_sharded.sharded_fpfh(inputs["fpfh_grid_kp"], inputs["fpfh_grid_pts"],
                                      inputs["fpfh_grid_nrm"], FPFH_R / 2, jmesh, n_bins=5)
    got, single = _got(run, f"fpfh_{route}")
    assert got.shape == (len(inputs[f"fpfh{'' if route == 'brute' else '_grid'}_kp"]), 125)
    np.testing.assert_array_equal(got, single)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("case", ["ring", "tie"])
def test_ring_match_matches_single_device_and_jax(run, inputs, jmesh, case):
    """Two ranks, an odd ref count (the last tile padded); whole-number
    descriptors make ties certain, where the ring's visiting order decides
    the index as JAX's does."""
    res = j_sharded.ring_match(inputs[f"{case}_a"], inputs[f"{case}_b"], jmesh)
    idx, single_idx = _got(run, f"{case}_idx")
    np.testing.assert_array_equal(idx, np.asarray(res.idx))
    for d in ("d1", "d2"):
        got, single = _got(run, f"{case}_{d}")
        np.testing.assert_allclose(got, np.asarray(getattr(res, d)), atol=1e-4)
        np.testing.assert_allclose(got, single, atol=1e-5)
    if case == "ring":
        np.testing.assert_array_equal(idx, single_idx)
    else:   # a tie can only move the index to another ref at the same distance
        b = inputs["tie_b"]
        d_got = np.linalg.norm(inputs["tie_a"] - b[idx], axis=1)
        d_single = np.linalg.norm(inputs["tie_a"] - b[single_idx], axis=1)
        np.testing.assert_array_equal(d_got, d_single)
        assert (idx != single_idx).any(), "no tie crossed a tile: the case tests nothing"


@pytest.mark.parametrize("reciprocal", [0, 1])
def test_sharded_multiscale_match_matches_single_device_and_jax(run, inputs, jmesh,
                                                                 reciprocal):
    j_idx, j_dist = j_sharded.sharded_multiscale_match(
        inputs["ms_scan"], inputs["ms_ref"], jmesh, filter_nonreciprocal=bool(reciprocal))
    idx, single_idx = _got(run, f"ms{reciprocal}_idx")
    dist, single_dist = _got(run, f"ms{reciprocal}_dist")
    np.testing.assert_array_equal(idx, single_idx)
    np.testing.assert_array_equal(idx, np.asarray(j_idx))
    np.testing.assert_allclose(dist, single_dist, atol=1e-5)
    np.testing.assert_allclose(dist, np.asarray(j_dist), atol=1e-5)


def test_sharded_ransac_with_jax_draws(run, inputs, jmesh):
    m = len(inputs["ransac_scan"])
    j_ratio, j_tf = j_sharded.sharded_ransac(
        inputs["ransac_scan"], inputs["ransac_ref"], jax.random.key(72), jmesh,
        n_draws=len(inputs["ransac_draws"]), draw_size=4, distance_threshold=RANSAC_THR)
    got, single = _got(run, "ransac")
    assert round(got[0] * m) == round(single[0] * m) == round(float(j_ratio) * m)
    np.testing.assert_allclose(got[1:], single[1:], atol=1e-5)
    np.testing.assert_allclose(got[1:10], np.asarray(j_tf.rotation).ravel(), atol=1e-4)
    np.testing.assert_allclose(got[10:], np.asarray(j_tf.translation), atol=1e-4)


@pytest.mark.parametrize("route", ["brute", "grid"])
@pytest.mark.parametrize("kind", ["plane", "point"])
def test_sharded_icp_matches_single_device_and_jax(run, inputs, jmesh, route, kind):
    tf, rms, conv, n_iters = j_sharded.sharded_icp(
        inputs[f"icp_{route}_scan"], inputs[f"icp_{route}_ref"],
        inputs[f"icp_{route}_nrm"] if kind == "plane" else None,
        JTransform(jnp.eye(3), jnp.zeros(3)), jmesh, point_to_plane=kind == "plane", **ICP)
    got, single = _got(run, f"icp_{route}_{kind}")
    np.testing.assert_allclose(got[:13], single[:13], atol=1e-5)
    assert got[13] == single[13] == n_iters
    np.testing.assert_allclose(got[:9], np.asarray(tf.rotation).ravel(), atol=1e-4)
    np.testing.assert_allclose(got[9:12], np.asarray(tf.translation), atol=1e-4)


def test_every_rank_holds_the_same_results(run):
    first, second = run.results()
    shared = [k for k in first if not k.startswith("single/") and k != "disagree"]
    assert shared and set(shared) <= set(second)
    for key in shared:
        np.testing.assert_array_equal(first[key], second[key], err_msg=key)


def test_ranks_disagreeing_on_a_branch_raise(run):
    """Rank 0 given a 20k-point support (grid route) and rank 1 a 1,500
    point one (brute route): both raise before the routes' collectives."""
    for res in run.results():
        assert "ranks disagree on the SHOT route" in str(res["disagree"])
