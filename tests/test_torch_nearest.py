"""K7's 1-NN mode (``ops/radius_runs.py::nearest``, ``csrc/nearest.cu``):
its plain twin ``nearest_plain`` on the CPU against the window route it
replaced and against JAX's ``grid_nearest_neighbor``.

Cases, at halo 1 and 2 on a 2,500-point Gaussian cloud whose rows 2000–2099
repeat rows 0–99: queries near the cloud, queries on the repeated rows
(exact ties: two rows at distance 0, the first window slot wins), queries
off the grid (empty windows: +inf) and a NaN query.

Tolerances: against the replaced route (``chip_smoke.replaced_nearest``:
K7's twin at radius +inf, the row minimum, two gathers) both outputs ``torch.equal``, the NaN query
included; against JAX, +inf in the same places, the finite distances
within 1e-6 (``tests/test_torch_grid.py``'s bound: JAX sums dx² + dy² + dz²
where the port chains ``fma``, an ulp apart on ~9% of queries) and
indices equal wherever the nearest row is not tied (JAX's window order is
its own).  The kernel itself is
held to the twin with ``torch.equal`` on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import replaced_nearest  # noqa: E402
from shot_fpfh_tpu.ops import grid_hash as j_grid  # noqa: E402
from shot_fpfh_tpu_torch import _kernels  # noqa: E402
from shot_fpfh_tpu_torch.ops import grid_hash as t_grid  # noqa: E402
from shot_fpfh_tpu_torch.ops.radius_runs import first_argmin, nearest, nearest_plain  # noqa: E402

# The suite runs several pytest workers side by side on the CPU: one torch
# thread per worker keeps torch's OpenMP pool from oversubscribing the cores
# (it slowed every worker, JAX tests included, by up to 2x).
torch.set_num_threads(1)

HALOS = [(1, 0.5), (2, 0.25)]        # (halo, cell): both cover 0.5
CASES = ["near", "ties", "off grid", "nan"]


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(11)
    pts = (rng.normal(size=(2500, 3)) * 2.0).astype(np.float32)
    pts[2000:2100] = pts[:100]
    return pts


def _queries(cloud, case):
    rng = np.random.default_rng(CASES.index(case))
    near = (cloud[100:400] + 0.05 * rng.normal(size=(300, 3))).astype(np.float32)
    if case == "near":
        return near
    if case == "ties":
        return np.concatenate([cloud[:100], near[:50]])
    if case == "off grid":
        lo, hi = cloud.min(0), cloud.max(0)
        return np.concatenate([near[:50], [lo - 3.0, hi + 3.0, [1e6, 1e6, 1e6],
                                           [lo[0] - 3.0, 0.0, 0.0]]]).astype(np.float32)
    return np.concatenate([near[:50], [[np.nan, 0.0, 0.0], [0.0, np.nan, np.nan]]]
                          ).astype(np.float32)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("halo,cell", HALOS)
def test_nearest_plain_equals_replaced_route(cloud, halo, cell, case):
    grid = t_grid.build_grid(cloud, cell, halo=halo, device="cpu")
    assert grid.has_table
    q = torch.tensor(_queries(cloud, case))
    before = dict(_kernels.launch_counts)
    got = nearest(grid, q)                       # CPU tensors: the twin
    assert _kernels.launch_counts == before
    want = replaced_nearest(grid, q)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(nearest_plain(grid, q)[1], got[1])
    assert torch.equal(t_grid.grid_nearest_neighbor(grid, q)[1], got[1])
    if case == "ties":   # rows i and 2000 + i at distance 0: the first slot, row i
        assert bool((got[0][:100] == 0).all())
        np.testing.assert_array_equal(got[1][:100].numpy(), np.arange(100))
    if case in ("off grid", "nan"):
        assert not torch.isfinite(got[0][50:]).any()
        assert bool(torch.isfinite(got[0][:50]).all())


@pytest.mark.parametrize("case", ["near", "ties", "off grid"])
@pytest.mark.parametrize("halo,cell", HALOS)
def test_nearest_plain_matches_jax(cloud, halo, cell, case):
    q = _queries(cloud, case)
    jd, ji = (np.asarray(x) for x in j_grid.grid_nearest_neighbor(
        j_grid.build_grid(cloud, cell, halo=halo), jnp.asarray(q)))
    td, ti = (x.numpy() for x in nearest(t_grid.build_grid(cloud, cell, halo=halo, device="cpu"),
                                         torch.tensor(q)))
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    finite = np.isfinite(jd)
    np.testing.assert_allclose(td[finite], jd[finite], rtol=0, atol=1e-6)
    d = np.linalg.norm(q[:, None].astype(np.float64) - cloud[None].astype(np.float64), axis=-1)
    untied = finite & ((d == d.min(1, keepdims=True)).sum(1) == 1)
    np.testing.assert_array_equal(ti[untied], ji[untied])
    assert untied.sum() >= (50 if case != "near" else 300)


def test_grid_without_table_keeps_the_window_route(cloud):
    """Too many cells for a start table: the runs by binary search, K7's
    window and the row minimum, as before."""
    sparse = np.concatenate([cloud, [[5e3, 5e3, 5e3]]]).astype(np.float32)
    grid = t_grid.build_grid(sparse, 0.5, device="cpu")
    assert not grid.has_table
    q = torch.tensor(_queries(cloud, "near"))
    got, want = t_grid.grid_nearest_neighbor(grid, q), replaced_nearest(grid, q)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_first_argmin_takes_the_first_minimum():
    inf = float("inf")
    x = torch.tensor([[3.0, 1.0, 1.0, 2.0], [inf, inf, inf, inf], [0.0, inf, 0.0, 0.0],
                      [inf, 5.0, inf, 5.0]])
    best, pos = first_argmin(x)
    assert torch.equal(best, torch.tensor([1.0, inf, 0.0, 5.0]))
    assert torch.equal(pos, torch.tensor([1, 0, 0, 1]))
    best, pos = first_argmin(torch.zeros((0, 3)))
    assert best.shape == pos.shape == (0,)
