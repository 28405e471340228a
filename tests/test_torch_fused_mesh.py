"""Port parity of the single-program path over a mesh
(``shot_fpfh_tpu_torch.registration.fused.fused_registration_mesh``,
``register_pair(mesh=)``) on a 2-rank gloo group on the CPU.

A module-scoped fixture writes ``tests/test_torch_fused.py``'s pair (a
``make_pair`` terrain, JAX's normals) and JAX's Gumbel noise to an ``.npz``
and launches two ranks (``sys.executable -c WORKER``, a ``file://`` store
in ``tmp_path``, collectives under a 120 s timeout, so a hang fails).  Each
rank runs ``register_pair`` over the mesh in the four descriptor modes
(single-scale, bi-scale and shared-frame multiscale SHOT, FPFH), on the
brute routes and on the grid routes
(``ops.grid_hash.AUTO_GRID_MIN_POINTS`` lowered to reach them on 1,800
points), with the noise injected; rank 0
also runs the port's one-device ``register_pair`` on the same inputs.
Held:

- to the one device: ``n_matches`` and the RANSAC inlier ratio equal, the
  RANSAC transform within 1e-5, ICP within 1e-5 with the same
  convergence;
- to JAX's ``register_pair`` over ``make_mesh(2)`` of ``conftest.py``'s
  virtual CPU mesh (its ``fused_registration_mesh``), SHOT and FPFH on the
  window routes: ``n_matches`` and convergence equal, RANSAC and ICP within
  1e-4 rad / 1e-4 (``tests/test_torch_fused.py``'s bounds);
- every rank holds the same result; rows that do not divide the mesh
  raise JAX's ``ValueError``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_fused import (  # noqa: E402
    FUSED_KW,
    GRID_MIN_POINTS,
    ICP_VOXEL,
    KP_VOXEL,
    MODES,
    PHI,
    RADIUS,
    Pair,
    _angle,
)

from shot_fpfh_tpu.ops import grid_hash as j_grid  # noqa: E402
from shot_fpfh_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from shot_fpfh_tpu.registration import fused as j_fused  # noqa: E402

# The suite runs several pytest workers side by side on the CPU: one torch
# thread per worker keeps torch's OpenMP pool from oversubscribing the cores
# (it slowed every worker, JAX tests included, by up to 2x).
torch.set_num_threads(1)

RANKS = 2
# the brute routes and the grid routes (SG or the SPFH pass: on CPU tensors
# K8 + K1's or K4's twins)
ROUTES = ("brute", "window")
# a result row: RANSAC rotation (9), translation (3), ICP rotation (9),
# translation (3), inlier ratio, n_matches, ICP RMS, converged
ROW = 28

WORKER = r'''
import json
import sys
import numpy as np
import torch

torch.set_num_threads(1)
rank, store, inputs, out, repo, spec = (int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4],
                                        sys.argv[5], json.loads(sys.argv[6]))
sys.path.insert(0, repo)
from shot_fpfh_tpu_torch.ops import grid_hash
from shot_fpfh_tpu_torch.parallel import make_mesh
from shot_fpfh_tpu_torch.registration import fused

x = dict(np.load(inputs))
mesh = make_mesh(device="cpu", init_method="file://" + store, rank=rank, world_size=2,
                 timeout=120)
assert mesh.devices.size == 2 and mesh.backend == "gloo"

def row(res):
    return np.concatenate([res.ransac_transform.rotation.numpy().ravel(),
                           res.ransac_transform.translation.numpy(),
                           res.icp_transform.rotation.numpy().ravel(),
                           res.icp_transform.translation.numpy(),
                           [float(res.ransac_inlier_ratio), int(res.n_matches),
                            float(res.icp_rms), bool(res.icp_converged)]])

res = {}
saved = grid_hash.AUTO_GRID_MIN_POINTS
for mode, kw in spec["modes"].items():
    if kw.get("ms_radii") is not None:
        kw["ms_radii"] = tuple(kw["ms_radii"])
    radius = spec["radius"] * spec["phi"] if mode == "shot_bi_scale" else spec["radius"]
    for route in spec["routes"]:
        grid_hash.AUTO_GRID_MIN_POINTS = saved if route == "brute" else spec["grid_min"]
        call = lambda **m: fused.register_pair(
            x["scan"], x["sn"], x["ref"], x["rn"], keypoint_voxel=spec["kp_voxel"],
            icp_voxel=spec["icp_voxel"], radius=radius, device="cpu",
            gumbel=torch.as_tensor(x["gumbel"]), **spec["fused_kw"], **kw, **m)
        res[f"{mode}/{route}"] = row(call(mesh=mesh))
        if rank == 0:
            res[f"single/{mode}/{route}"] = row(call())
grid_hash.AUTO_GRID_MIN_POINTS = saved
np.savez(out, **res)
'''


@pytest.fixture(scope="module")
def pair():
    return Pair()


class _Run:
    """The two ranks' run: started by the fixture, waited on at first use,
    so the JAX references of the first tests overlap it."""

    def __init__(self, tmp: Path, pair: Pair):
        import json

        np.savez(tmp / "inputs.npz", scan=pair.scan, ref=pair.ref, sn=pair.sn, rn=pair.rn,
                 gumbel=pair.gumbel())
        self.outs = [tmp / f"rank{r}.npz" for r in range(RANKS)]
        spec = json.dumps({"modes": MODES, "radius": RADIUS, "phi": PHI,
                           "grid_min": GRID_MIN_POINTS, "kp_voxel": KP_VOXEL,
                           "icp_voxel": ICP_VOXEL, "fused_kw": FUSED_KW, "routes": ROUTES})
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(tmp / "store"), str(tmp / "inputs.npz"),
             str(self.outs[r]), str(REPO), spec], cwd=tmp, env=env, stdout=subprocess.PIPE,
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
def run(pair, tmp_path_factory):
    return _Run(tmp_path_factory.mktemp("fused_ranks"), pair)


def _fields(row):
    rot = lambda a: a.reshape(3, 3).astype(np.float32)  # noqa: E731
    return dict(ransac_rot=rot(row[:9]), ransac_t=row[9:12], icp_rot=rot(row[12:21]),
                icp_t=row[21:24], ratio=row[24],
                n_matches=int(row[25]), rms=row[26], converged=bool(row[27]))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("mode", list(MODES))
def test_fused_mesh_matches_one_device(run, mode, route):
    got = run.results()[0][f"{mode}/{route}"]
    want = run.results()[0][f"single/{mode}/{route}"]
    assert got.shape == want.shape == (ROW,)
    g, w = _fields(got), _fields(want)
    assert g["n_matches"] == w["n_matches"] > 20
    assert g["ratio"] == w["ratio"]
    assert g["converged"] == w["converged"]
    np.testing.assert_allclose(got[:12], want[:12], atol=1e-5)
    np.testing.assert_allclose(got[12:24], want[12:24], atol=1e-5)


@pytest.mark.parametrize("mode", ["shot", "fpfh"])
def test_fused_mesh_matches_jax_mesh(run, pair, mode):
    """JAX's ``register_pair`` over a 2-device mesh of the virtual CPU
    mesh (``fused_registration_mesh``, noise from ``key(72)``) on the grid
    routes, against the port's window routes on its two ranks, given JAX's noise."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_grid, "AUTO_GRID_MIN_POINTS", GRID_MIN_POINTS)
        want = j_fused.register_pair(pair.scan, pair.sn, pair.ref, pair.rn,
                                     keypoint_voxel=KP_VOXEL, icp_voxel=ICP_VOXEL, radius=RADIUS,
                                     key=jax.random.key(72), mesh=j_make_mesh(RANKS),
                                     **FUSED_KW, **MODES[mode])
    g = _fields(run.results()[0][f"{mode}/window"])
    assert g["n_matches"] == int(want.n_matches) > 20
    assert g["converged"] == bool(want.icp_converged)
    assert g["ratio"] == float(want.ransac_inlier_ratio)
    for name, tf in (("ransac", want.ransac_transform), ("icp", want.icp_transform)):
        assert _angle(g[f"{name}_rot"], tf.rotation) < 1e-4, name
        np.testing.assert_allclose(g[f"{name}_t"], np.asarray(tf.translation), atol=1e-4)


def test_every_rank_holds_the_same_result(run):
    first, second = run.results()
    shared = [k for k in first if not k.startswith("single/")]
    assert len(shared) == len(MODES) * len(ROUTES) and set(shared) <= set(second)
    for key in shared:
        np.testing.assert_array_equal(first[key], second[key], err_msg=key)


@pytest.mark.parametrize("name", ["scan_kp", "ref_kp", "scan_sub"])
def test_rows_must_divide_the_mesh(name):
    """JAX's ``ValueError`` (``fused.py:394-399``), raised before any
    collective: the 2-rank mesh here has no group behind it."""
    from shot_fpfh_tpu_torch.parallel.mesh import Mesh
    from shot_fpfh_tpu_torch.registration.fused import fused_registration_mesh

    rows = {"scan_kp": 8, "ref_kp": 8, "scan_sub": 8, name: 7}
    pts = lambda n: np.zeros((n, 3), np.float32)  # noqa: E731
    mesh = Mesh(0, 2, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match=f"{name} rows \\(7\\) must divide the mesh \\(2\\)"):
        fused_registration_mesh(mesh, pts(rows["scan_kp"]), np.ones(rows["scan_kp"], bool),
                                pts(rows["ref_kp"]), np.ones(rows["ref_kp"], bool), pts(20),
                                pts(20), pts(20), pts(20), pts(rows["scan_sub"]),
                                np.ones(rows["scan_sub"], bool), radius=0.5)
