"""Port parity: FPFH's second pass, K7's aggregation mode
(``ops/radius_runs.py::fpfh_aggregate``), on the CPU, where it runs its
plain twin.

The twin against JAX's ``_fpfh_window_aggregate`` on a terrain above
``AUTO_GRID_MIN_POINTS`` (atol 1e-5, the FPFH parity tests' tolerance
against JAX: both sum the same rows in other orders); equal to itself under
other chunkings; against a float64 brute-force oracle on the edge rows (a
keypoint alone in its window, duplicate points, a query off the grid) at
atol 1e-5 with its counts exact; the route of a grid without a cell-start
table; the wrapper's input checks.  The kernel itself is held to the twin
on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shot_fpfh_tpu.models import fpfh as j_fpfh
from shot_fpfh_tpu.ops import grid_hash as j_grid
from shot_fpfh_tpu_torch import _kernels
from shot_fpfh_tpu_torch._fp import sqnorm3, sqrt
from shot_fpfh_tpu_torch.models.fpfh import _FAR
from shot_fpfh_tpu_torch.ops import grid_hash as t_grid
from shot_fpfh_tpu_torch.ops import radius_runs

# one torch thread per pytest worker (the suite runs several side by side)
torch.set_num_threads(1)


def _terrain(rng, n, scale):
    xy = rng.uniform(-scale, scale, size=(n, 2))
    z = 0.3 * np.sin(1.1 * xy[:, 0]) * np.cos(0.8 * xy[:, 1])
    pts = np.column_stack([xy, z]) + rng.normal(scale=0.01, size=(n, 3))
    nrm = rng.normal(size=(n, 3))
    return pts.astype(np.float32), (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
                                    ).astype(np.float32)


def _spfh(rng, n, dim):
    """Rows shaped like SPFH rows: non-negative, each summing to 1."""
    h = rng.uniform(size=(n, dim)) ** 4
    return (h / h.sum(1, keepdims=True)).astype(np.float32)


def _oracle(table, spfh, kp, radius):
    """FPFH's second pass by brute force over every table row: the counts
    (float32 distances by the twins' formula, so a radius tie decides as
    there) and the rows in float64."""
    pts = table[:, :3]
    d = sqrt(sqnorm3(*(pts[None, :, i] - pts[kp, i][:, None] for i in range(3))))
    inside = d <= torch.tensor(radius, dtype=torch.float32)
    wt = torch.where(inside & (d > 0), 1.0 / d.double(), 0.0)
    count = inside.sum(1)
    acc = wt @ spfh.double()
    return spfh[kp].double() + acc / torch.clamp(count, min=1)[:, None], count.to(torch.int32)


@pytest.mark.parametrize("dim", [125, 15])
def test_aggregate_twin_matches_jax(rng, dim):
    """On a terrain above AUTO_GRID_MIN_POINTS, the grid FPFH's halo-2 grid
    of cell r/2: the twin against JAX's window aggregate, and its counts
    against the brute-force count."""
    n, radius = t_grid.AUTO_GRID_MIN_POINTS + 500, 0.25
    pts, nrm = _terrain(rng, n, 4.0)
    jg = j_grid.build_grid(pts, radius / 2, extras=nrm, halo=2)
    tg = t_grid.build_grid(pts, radius / 2, extras=nrm, halo=2, device="cpu")
    assert tg.has_table and jg.has_table
    np.testing.assert_array_equal(tg.orig_idx.numpy(), np.asarray(jg.orig_idx))
    spfh = _spfh(rng, n, dim)
    kp = np.sort(rng.choice(n, 400, replace=False))
    want = np.asarray(j_fpfh._fpfh_window_aggregate(jg, jnp.asarray(spfh),
                                                    jnp.asarray(kp, jnp.int32), radius))
    before = dict(_kernels.launch_counts)
    got, counts = radius_runs.fpfh_aggregate(tg, torch.tensor(spfh), torch.tensor(kp), radius,
                                             return_counts=True)
    assert _kernels.launch_counts == before          # CPU tensors: the twin
    assert got.shape == (400, dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    _, count = _oracle(tg.packed_sorted, torch.tensor(spfh), torch.tensor(kp), radius)
    assert torch.equal(counts, count)
    assert int(counts.min()) > 1


@pytest.mark.parametrize("elems", [1, 3 * 125 * 64])
def test_aggregate_twin_independent_of_chunking(rng, monkeypatch, elems):
    """Chunks of one keypoint (any ``_AGG_ELEMS`` under a window's worth)
    or of a few against one chunk: the counts equal; the rows within 1e-6
    of their largest entry, float32 rounding (the einsum sums a batch of
    one in another order than a batch of 200: 4e-7 seen)."""
    pts, nrm = _terrain(rng, 3000, 1.5)
    grid = t_grid.build_grid(pts, 0.15, extras=nrm, halo=2, device="cpu")
    spfh = torch.tensor(_spfh(rng, 3000, 125))
    kp = torch.tensor(rng.choice(3000, 200, replace=False))
    whole = radius_runs.fpfh_aggregate_plain(grid, spfh, kp, 0.3, return_counts=True)
    monkeypatch.setattr(radius_runs, "_AGG_ELEMS", elems)
    step = max(1, elems // (grid.window_cap * 125))
    assert step < 200
    parts = radius_runs.fpfh_aggregate_plain(grid, spfh, kp, 0.3, return_counts=True)
    assert torch.equal(parts[1], whole[1])
    scale = torch.clamp(whole[0].abs().amax(1, keepdim=True), min=1.0)
    assert float(((parts[0] - whole[0]).abs() / scale).max()) <= 1e-6


def _edge_grid(rng, dim):
    """A 2,000-point surface with its first 50 points repeated (d = 0
    neighbors), one point alone 1.5 away, and, after the build, one table
    row moved to the far sentinel (its window off the grid)."""
    pts, nrm = _terrain(rng, 2000, 1.5)
    pts = np.concatenate([pts, pts[:50], [[1.5 + 1.5, 0.0, 0.0]]]).astype(np.float32)
    nrm = np.concatenate([nrm, nrm[:50], nrm[:1]])
    grid = t_grid.build_grid(pts, 0.15, extras=nrm, halo=2, device="cpu")
    assert grid.has_table
    far = int(torch.nonzero(grid.orig_idx == 1000)[0, 0])
    table = grid.packed_sorted.clone()
    table[far, :3] = _FAR
    grid = dataclasses.replace(grid, packed_sorted=table)
    rows = {"alone": int(torch.nonzero(grid.orig_idx == 2050)[0, 0]), "far": far,
            "duplicate": int(torch.nonzero(grid.orig_idx == 7)[0, 0])}
    return grid, torch.tensor(_spfh(rng, pts.shape[0], dim)), rows


@pytest.mark.parametrize("dim", [125, 15])
def test_aggregate_twin_edge_rows(rng, dim):
    """The twin against the float64 brute-force oracle on every keypoint:
    a keypoint alone in its window and one off the grid keep their own row
    exactly (count 1 and 0); a duplicated point counts its twin (d = 0)
    but does not sum it; Q = 0 gives an empty (0, D)."""
    grid, spfh, rows = _edge_grid(rng, dim)
    kp = torch.cat([torch.arange(0, grid.packed_sorted.shape[0], 9),
                    torch.tensor(list(rows.values()))])
    got, counts = radius_runs.fpfh_aggregate(grid, spfh, kp, 0.3, return_counts=True)
    alone, far, dup = (got.shape[0] - 3 + i for i in range(3))
    # the oracle on every keypoint but the one off the grid, whose window is
    # empty by the window contract (the oracle would count its own row)
    on_grid = torch.arange(got.shape[0]) != far
    want, count = _oracle(grid.packed_sorted, spfh, kp[on_grid], 0.3)
    assert torch.equal(counts[on_grid], count)
    np.testing.assert_allclose(got[on_grid].numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert int(counts[alone]) == 1 and int(counts[far]) == 0
    for i in (alone, far):
        assert torch.equal(got[i], spfh[kp[i]])
    # the duplicate's d = 0 partner is counted (and, by the oracle above,
    # not summed)
    d = sqrt(sqnorm3(*(grid.packed_sorted[:, i] - grid.packed_sorted[kp[dup], i]
                       for i in range(3))))
    assert int((d == 0).sum()) == 2 and int(counts[dup]) == int((d <= 0.3).sum())
    empty = radius_runs.fpfh_aggregate(grid, spfh, kp[:0], 0.3)
    assert empty.shape == (0, dim) and empty.dtype == torch.float32


def test_aggregate_without_cell_table_takes_the_chunked_route(rng, monkeypatch):
    """A grid without a cell-start table (one far point: too many cells)
    takes the chunked route, chosen by ``grid.has_table``; a grid with a
    table does not.  Both equal the oracle."""
    pts, nrm = _terrain(rng, 3000, 1.5)
    far_pts = np.concatenate([pts, [[5e3, 5e3, 5e3]]]).astype(np.float32)
    far_nrm = np.concatenate([nrm, nrm[:1]])
    calls = []
    chunked = radius_runs.fpfh_aggregate_chunked
    monkeypatch.setattr(radius_runs, "fpfh_aggregate_chunked",
                        lambda *a, **k: calls.append(1) or chunked(*a, **k))
    for p, n, table in ((far_pts, far_nrm, False), (pts, nrm, True)):
        grid = t_grid.build_grid(p, 0.15, extras=n, halo=2, device="cpu")
        assert grid.has_table == table
        spfh = torch.tensor(_spfh(rng, p.shape[0], 125))
        kp = torch.arange(0, p.shape[0], 13)
        calls.clear()
        got, counts = radius_runs.fpfh_aggregate(grid, spfh, kp, 0.3, return_counts=True)
        assert len(calls) == (not table)
        want, count = _oracle(grid.packed_sorted, spfh, kp, 0.3)
        assert torch.equal(counts, count)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_aggregate_wrapper_rejects_wrong_inputs(rng):
    pts, nrm = _terrain(rng, 500, 1.0)
    grid = t_grid.build_grid(pts, 0.15, extras=nrm, halo=2, device="cpu")
    spfh = torch.tensor(_spfh(rng, 500, 125))
    kp = torch.arange(10)
    bad = [(spfh.double(), kp), (spfh[:-1], kp), (spfh[:, 0], kp), (spfh[:, :0], kp),
           (spfh, kp.to(torch.int32)), (spfh, kp[None])]
    for s, k in bad:
        with pytest.raises(ValueError):
            radius_runs.fpfh_aggregate(grid, s, k, 0.3)
    no_xyz = dataclasses.replace(grid, packed_sorted=grid.packed_sorted[:, :2])
    with pytest.raises(ValueError):
        radius_runs.fpfh_aggregate(no_xyz, spfh, kp, 0.3)
    # the kernel's launch takes CUDA tensors only
    with pytest.raises(ValueError, match="CUDA"):
        radius_runs._aggregate_launch(grid, spfh, kp, 0.3, False, True)
