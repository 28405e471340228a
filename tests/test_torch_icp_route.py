"""ICP's route: IS (``csrc/icp_step.cu``, one launch an iteration) runs the
loop only for CUDA tensors on a grid with a cell-start table, point-to-plane,
with one device's sums; every other case runs ``registration/icp.py::_step``
as it did before IS existed, and counts no kernel iteration.

CPU only (the kernel has no CPU mode): the rule is held on stand-ins for a
card's tensors, and the loop off the route to ``_step`` iterated by hand.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import make_terrain  # noqa: E402
from shot_fpfh_tpu_torch.core.subsampling import grid_subsample  # noqa: E402
from shot_fpfh_tpu_torch.core.transform import RigidTransform  # noqa: E402
from shot_fpfh_tpu_torch.models.normals import compute_normals  # noqa: E402
from shot_fpfh_tpu_torch.ops.grid_hash import build_grid  # noqa: E402
from shot_fpfh_tpu_torch.registration import icp  # noqa: E402
from shot_fpfh_tpu_torch.utils.perf import StageMetrics  # noqa: E402

torch.set_num_threads(1)

_CARD = SimpleNamespace(is_cuda=True)
_TABLE, _NO_TABLE = SimpleNamespace(has_table=True), SimpleNamespace(has_table=False)
_SUMS = object()    # any reduce function


@pytest.mark.parametrize("case, scan, normals, grid, reduce, takes", [
    ("card", _CARD, True, _TABLE, None, True),
    ("cpu_tensors", torch.zeros((4, 3)), True, _TABLE, None, False),
    ("reduce", _CARD, True, _TABLE, _SUMS, False),
    ("point_to_point", _CARD, False, _TABLE, None, False),
    ("no_cell_table", _CARD, True, _NO_TABLE, None, False),
    ("brute_force", _CARD, True, None, None, False),
])
def test_kernel_route_rule(case, scan, normals, grid, reduce, takes):
    assert icp._takes_kernel(scan, object() if normals else None, grid, reduce) is takes


@pytest.fixture(scope="module")
def pair():
    """A 20k-point terrain (the grid route's size) with k=20 normals, the
    scan moved 0.02 rad and 0.03 off it and subsampled at voxel 0.2."""
    rng = np.random.default_rng(3)
    ref = torch.tensor(make_terrain(20_000, rng, scale=4.0, n_bumps=10))
    normals = compute_normals(ref, ref, k=20, device="cpu")
    angle = 0.02
    rot = torch.tensor([[np.cos(angle), -np.sin(angle), 0.0], [np.sin(angle), np.cos(angle), 0.0],
                        [0.0, 0.0, 1.0]], dtype=torch.float32)
    scan = ref @ rot.T + 0.03
    sub = scan[torch.as_tensor(grid_subsample(scan, 0.2, device="cpu"))]
    return sub, ref, normals


def _sum_over_one_shard(sums):
    return tuple(sums)


def _plain_loop(sub, ref, normals, init, d_max, max_iter, thr, grid, weights, reduce):
    """The loop as the port ran it before IS: ``_step`` until ``done``."""
    state = (torch.zeros((), dtype=torch.int32), init.rotation, init.translation,
             torch.full((), float("inf")), torch.zeros((), dtype=torch.bool))
    for _ in range(max_iter):
        state = icp._step(state, sub, ref, normals, d_max, thr, grid, weights, reduce)
        if bool(state[4]):
            break
    return state


@pytest.mark.parametrize("route", ["grid", "no_cell_table", "brute_force", "point_to_point",
                                   "reduce", "padding_weights"])
def test_loop_off_the_kernel_route_runs_the_plain_step(pair, route):
    """Off IS's route the loop is ``_step``'s, bit for bit, and the ICP
    stage's ``icp_kernel_iters`` reads 0."""
    sub, ref, normals = pair
    grid = build_grid(ref, 0.3)
    if route == "no_cell_table":
        far = torch.cat([ref, torch.full((1, 3), 5e3)])
        grid, ref, normals = build_grid(far, 0.3), far, torch.cat([normals, normals[:1]])
        assert not grid.has_table
    elif route == "brute_force":
        grid = None
    nrm = None if route == "point_to_point" else normals
    reduce = _sum_over_one_shard if route == "reduce" else None
    weights = None
    if route == "padding_weights":
        weights = torch.cat([torch.ones(sub.shape[0]), torch.zeros(8)])
        sub = torch.cat([sub, torch.full((8, 3), 1e6)])
    init = RigidTransform.identity(device="cpu")
    metrics = StageMetrics()
    metrics.start("icp[test]")
    got = icp.icp_loop(sub, ref, nrm, init, 0.3, 12, 1e-4, grid=grid, weights=weights,
                       reduce=reduce)
    record = metrics.stop()
    want = _plain_loop(sub, ref, nrm, init, 0.3, 12, 1e-4, grid, weights, reduce)
    assert record["icp_kernel_iters"] == 0
    assert record["spans"]["sync[icp.done]"]["count"] == -(-int(got.n_iters) // icp.ICP_BLOCK)
    assert got.has_converged.dtype == torch.bool
    for a, b in ((got.n_iters, want[0]), (got.transform.rotation, want[1]),
                 (got.transform.translation, want[2]), (got.rms, want[3]),
                 (got.has_converged, want[4])):
        assert torch.equal(a, b)
