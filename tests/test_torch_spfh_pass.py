"""Port parity: FPFH's SPFH pass on the grid window route
(``ops/spfh_fused.py::spfh_grid``) on the CPU, where it runs its plain
twin (``spfh_grid_plain``: the chunked route over K8's and K4's twins).

The twin against a brute-force oracle over every table row (the same
float32 distances, angles and bins: equal bit for bit, so the windows hold
every neighbor in radius), against JAX's window route (the FPFH parity
tests' rule for two SPFH routes), the far sentinel's zero rows, an empty
query set, the route of a grid without a cell-start table and the
wrapper's shape checks.  The kernel itself is held to the chunked route
bit for bit on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from shot_fpfh_tpu.models import fpfh as j_fpfh
from shot_fpfh_tpu.ops import grid_hash as j_grid
from shot_fpfh_tpu_torch import _kernels
from shot_fpfh_tpu_torch._fp import sqnorm3, sqrt
from shot_fpfh_tpu_torch.models.fpfh import _FAR
from shot_fpfh_tpu_torch.ops import grid_hash as t_grid
from shot_fpfh_tpu_torch.ops import spfh_fused
from shot_fpfh_tpu_torch.ops.descriptor_bins import darboux_angles

# one torch thread per pytest worker (the suite runs several side by side)
torch.set_num_threads(1)

RADIUS = 0.5


@pytest.fixture
def rng():
    return np.random.default_rng(21)


def _terrain(rng, n, scale):
    """A wavy surface with normals near +z (so most angles land in range)."""
    xy = rng.uniform(-scale, scale, size=(n, 2))
    z = 0.3 * np.sin(1.1 * xy[:, 0]) * np.cos(0.8 * xy[:, 1])
    pts = np.column_stack([xy, z]) + rng.normal(scale=0.01, size=(n, 3))
    nrm = rng.normal(size=(n, 3)) * 0.3 + [0.0, 0.0, 1.0]
    return pts.astype(np.float32), (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
                                    ).astype(np.float32)


def _grid(pts, nrm):
    return t_grid.build_grid(pts, RADIUS / 2, extras=nrm, halo=2, device="cpu")


def _oracle(table, qc, qn, radius, decorrelated):
    """The SPFH pass by brute force over every table row: float32 distances
    by the window routes' formula, the twins' angles and bins."""
    pts, nrm = table[:, :3], table[:, 3:6]
    diff = [pts[None, :, i] - qc[:, None, i] for i in range(3)]
    d = sqrt(sqnorm3(*diff))
    inside = d <= torch.tensor(radius, dtype=torch.float32)
    valid = inside & (d > 0)
    dx, dy, dz = (torch.where(valid, v, 0.0) for v in diff)
    nx, ny, nz = (torch.where(valid, nrm[None, :, i], 0.0) for i in range(3))
    alpha, phi, theta = darboux_angles(dx, dy, dz, nx, ny, nz, qn[:, 0:1], qn[:, 1:2],
                                       qn[:, 2:3], torch.where(valid, d, 1.0))
    hist = spfh_fused.spfh_from_angles(alpha, phi, theta, valid, 5, decorrelated)
    return hist / torch.clamp(inside.sum(1), min=1).to(torch.float32)[:, None]


@pytest.mark.parametrize("decorrelated", [False, True])
def test_spfh_pass_twin_equals_brute_force_oracle(rng, decorrelated):
    """Every table row as a query (strided views of the table, as the FPFH
    pass passes them), duplicates of two rows (d = 0 counted, not binned),
    points off the table and a query in a cloud's corner: equal to the
    oracle bit for bit, in chunks smaller than the query set."""
    pts, nrm = _terrain(rng, 2500, 2.0)
    pts[7], nrm[7] = pts[3], nrm[3]
    grid = _grid(pts, nrm)
    table = grid.packed_sorted
    off = torch.tensor(np.column_stack([rng.uniform(-2, 2, (40, 2)),
                                        rng.uniform(-0.5, 0.5, 40)]).astype(np.float32))
    corner = torch.tensor(pts[np.argmin(pts[:, 0] + pts[:, 1])])[None]
    qc = torch.cat([table[:, :3], off, corner])
    qn = torch.cat([table[:, 3:6], torch.tensor([[0.0, 0.0, 1.0]] * 41)])
    before = dict(_kernels.launch_counts)
    got = spfh_fused.spfh_grid(grid, qc, qn, RADIUS, 5, decorrelated)
    assert _kernels.launch_counts == before            # CPU tensors: the plain twin
    assert torch.equal(got, _oracle(table, qc, qn, RADIUS, decorrelated))
    assert torch.equal(spfh_fused.spfh_grid_plain(grid, qc, qn, RADIUS, 5, decorrelated,
                                                  chunk=333), got)
    assert bool(got[:len(pts)].any(1).all())


@pytest.mark.parametrize("decorrelated", [False, True])
def test_spfh_pass_twin_matches_jax_window_route(rng, decorrelated):
    """Every point's SPFH in grid order against JAX's window route, by the
    rule the FPFH tests hold two SPFH routes to."""
    pts, nrm = _terrain(rng, 2600, 2.5)
    jg = j_grid.build_grid(pts, RADIUS / 2, extras=nrm, halo=2)
    tg = _grid(pts, nrm)
    np.testing.assert_array_equal(tg.orig_idx.numpy(), np.asarray(jg.orig_idx))
    want = np.asarray(j_fpfh._spfh_window_sorted(jg, RADIUS, 5, decorrelated,
                                                 chunk=512))[:len(pts)]
    table = tg.packed_sorted
    got = spfh_fused.spfh_grid(tg, table[:, :3], table[:, 3:6], RADIUS, 5, decorrelated).numpy()
    assert got.shape == want.shape
    dd = np.abs(got - want)
    assert (dd > 1e-4).mean() <= 1e-3, (dd.max(), (dd > 1e-4).mean())
    np.testing.assert_allclose(got.sum(axis=1), want.sum(axis=1), atol=1e-3)


@pytest.mark.parametrize("decorrelated", [False, True])
def test_spfh_pass_far_pads_and_empty_queries(rng, decorrelated):
    """Pad queries at the far sentinel (the sharded pass's padding, zero
    normals) get zero rows, the rows beside them are unchanged; an empty
    query set gives a ``(0, D)`` float32 table on every route."""
    pts, nrm = _terrain(rng, 1500, 1.5)
    grid = _grid(pts, nrm)
    table = grid.packed_sorted
    qc = torch.cat([table[:64, :3], torch.full((3, 3), _FAR)])
    qn = torch.cat([table[:64, 3:6], torch.zeros((3, 3))])
    got = spfh_fused.spfh_grid(grid, qc, qn, RADIUS, 5, decorrelated)
    assert not got[-3:].any() and bool(got[:-3].any(1).all())
    alone = spfh_fused.spfh_grid(grid, table[:64, :3], table[:64, 3:6], RADIUS, 5, decorrelated)
    assert torch.equal(got[:-3], alone)
    dim = 15 if decorrelated else 125
    for fn in (spfh_fused.spfh_grid, spfh_fused.spfh_grid_plain, spfh_fused.spfh_window_chunked):
        empty = fn(grid, qc[:0], qn[:0], RADIUS, 5, decorrelated)
        assert empty.shape == (0, dim) and empty.dtype == torch.float32


def test_spfh_pass_without_cell_table_takes_the_chunked_route(rng, monkeypatch):
    """A grid without a cell-start table (one far point: too many cells)
    takes the chunked route, chosen by ``grid.has_table``; a grid with a
    table takes the twin.  The cloud's rows agree between the two grids,
    whose sorted orders are the same."""
    pts, nrm = _terrain(rng, 2000, 1.5)
    far_pts = np.concatenate([pts, [[5e3, 5e3, 5e3]]]).astype(np.float32)
    far_nrm = np.concatenate([nrm, nrm[:1]])
    calls = []
    chunked = spfh_fused.spfh_window_chunked
    monkeypatch.setattr(spfh_fused, "spfh_window_chunked",
                        lambda *a, **k: calls.append(1) or chunked(*a, **k))
    out = {}
    for p, n, table in ((far_pts, far_nrm, False), (pts, nrm, True)):
        grid = _grid(p, n)
        assert grid.has_table == table
        calls.clear()
        t = grid.packed_sorted
        out[table] = (t, spfh_fused.spfh_grid(grid, t[:, :3], t[:, 3:6], RADIUS, 5, False))
        assert len(calls) == (not table)
    assert torch.equal(out[False][0][:-1], out[True][0])
    assert torch.equal(out[False][1][:-1], out[True][1])


def test_spfh_pass_rejects_wrong_shapes(rng):
    pts, nrm = _terrain(rng, 500, 1.0)
    grid = _grid(pts, nrm)
    q = grid.packed_sorted[:10]
    for qc, qn in ((q[:, :2], q[:, 3:6]), (q[:, :3], q[:5, 3:6]), (q[:, :3, None], q[:, 3:6]),
                   (q[:, :3], q[:, 3:5])):
        with pytest.raises(ValueError, match="query shapes"):
            spfh_fused.spfh_grid(grid, qc, qn, RADIUS, 5, False)
