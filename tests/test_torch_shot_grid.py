"""SHOT's grid window route (``ops/shot_fused.py::shot_grid``, SG) on the
CPU, where it takes the chunked route over K8's and K1's twins, its plain
twin (``shot_grid_plain``), and its caller
``models/shot.py::_shot_on_grid``.

The twin against JAX's window route (``window_distances`` +
``shot_from_window_ff`` on the same points, grid and keypoints) in K1's
three modes, by the flip rule and the frames' 5e-4, its counts equal to
the in-radius slots of JAX's windows; the counts against a brute count
over every table row (so the windows hold every neighbor in radius); the
far sentinel's zero rows; an empty keypoint set; the wrapper's shape and
dtype checks; and which route ``shot_grid`` takes: its kernel where it
observes CUDA tensors and a cell table (on the CPU by forcing that
predicate, with the twin in the kernel's place), the loop on CPU tensors
and on a grid without a cell table, and SG, not K5, on an xy-row grid with
``SHOT_FPFH_DMA=1`` in the environment.  The
kernel itself is held to the K8 + K1 route bit for bit on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import types

import numpy as np
import pytest
import torch

from test_torch_shot import assert_flip_rule
from shot_fpfh_tpu.models import shot as j_shot
from shot_fpfh_tpu.ops import grid_hash as j_grid
from shot_fpfh_tpu_torch import _kernels
from shot_fpfh_tpu_torch._fp import sqnorm3, sqrt
from shot_fpfh_tpu_torch.models import shot as t_shot
from shot_fpfh_tpu_torch.ops import grid_hash as t_grid
from shot_fpfh_tpu_torch.ops import shot_dma, shot_fused
from shot_fpfh_tpu_torch.utils.perf import StageMetrics

# one torch thread per pytest worker (the suite runs several side by side)
torch.set_num_threads(1)

RADIUS, RF_RADIUS = 0.5, 0.25
MIN_NEIGHBORS = 5
MODES = ["own", "given", "bi_scale"]


@pytest.fixture
def rng():
    return np.random.default_rng(23)


def _terrain(rng, n, scale):
    """A wavy surface with unit normals near +z."""
    xy = rng.uniform(-scale, scale, size=(n, 2))
    z = 0.3 * np.sin(1.1 * xy[:, 0]) * np.cos(0.8 * xy[:, 1])
    pts = np.column_stack([xy, z]) + rng.normal(scale=0.01, size=(n, 3))
    nrm = rng.normal(size=(n, 3)) * 0.3 + [0.0, 0.0, 1.0]
    return (torch.tensor(pts.astype(np.float32)),
            torch.tensor((nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)))


def _grid(pts, nrm, cell=RADIUS / 2, halo=2):
    return t_grid.build_grid(pts, cell, extras=nrm, halo=halo, device="cpu")


def _keypoints(rng, pts, n=150, far=3):
    kp = pts[torch.tensor(rng.choice(pts.shape[0], n, replace=False))]
    return torch.cat([kp, torch.full((far, 3), t_shot._FAR)])


def _mode_args(mode, grid, kp):
    """``(rfs, rf_radius)`` of a mode: given frames are the own-frames
    route's."""
    if mode == "given":
        return shot_fused.shot_grid_plain(grid, kp, RADIUS)[1], None
    return None, RF_RADIUS if mode == "bi_scale" else None


def _assert_equal(got, want):
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _jax_window_route(pts, nrm, kp, rfs, rf_radius):
    """JAX's grid window route on the same points: its halo-2 grid, the
    window of each keypoint with the radius planes, ``shot_from_window_ff``;
    ``(descriptors, frames, count)``, the count being the slots with ``0 <
    d <= radius``."""
    import jax.numpy as jnp

    jg = j_grid.build_grid(pts.numpy(), RADIUS / 2, extras=nrm.numpy(), halo=2)
    jkp = jnp.asarray(kp.numpy())
    vals, d, valid, _ = j_grid.window_distances(jg, jkp)
    dist_inf = jnp.where(valid & (d <= RADIUS), d, jnp.inf)
    rf_dist_inf = (None if rf_radius is None
                   else jnp.where(valid & (d <= rf_radius), d, jnp.inf))
    desc, frames = j_shot.shot_from_window_ff(
        jkp, vals, dist_inf, RADIUS, normalize=True, min_neighborhood_size=MIN_NEIGHBORS,
        local_rfs=None if rfs is None else jnp.asarray(rfs.numpy()),
        rf_dist_inf=rf_dist_inf, rf_radius=rf_radius)
    count = np.sum(np.isfinite(np.asarray(dist_inf)) & (np.asarray(dist_inf) > 0), axis=-1)
    return np.asarray(desc), np.asarray(frames), count


@pytest.mark.parametrize("mode", MODES)
def test_shot_grid_twin_matches_jax_window_route(rng, mode):
    """On CPU tensors ``shot_grid`` launches nothing; the twin
    (``shot_grid_plain``, in chunks of 37 keypoints) equals it, and against
    JAX's window route over the same points and keypoints its counts are
    JAX's in-radius slots, its frames within 5e-4 (given frames: JAX's own,
    kept), its finished descriptors by the flip rule."""
    pts, nrm = _terrain(rng, 3000, 2.0)
    grid = _grid(pts, nrm)
    kp = _keypoints(rng, pts)
    rfs, rf_radius = None, RF_RADIUS if mode == "bi_scale" else None
    if mode == "given":
        rfs = torch.tensor(_jax_window_route(pts, nrm, kp, None, None)[1])
    before = dict(_kernels.launch_counts)
    got = shot_fused.shot_grid(grid, kp, RADIUS, rfs=rfs, rf_radius=rf_radius)
    assert _kernels.launch_counts == before            # CPU tensors: the twins
    _assert_equal(got, shot_fused.shot_grid_plain(grid, kp, RADIUS, rfs, rf_radius, chunk=37))
    hist, frames, count = got
    assert hist.shape == (kp.shape[0], 352) and frames.shape == (kp.shape[0], 3, 3)
    assert count.dtype == torch.int32 and count.shape == (kp.shape[0],)
    assert bool(hist[:-3].any(1).all()) and bool((count[:-3] > MIN_NEIGHBORS).all())
    j_desc, j_frames, j_count = _jax_window_route(pts, nrm, kp, rfs, rf_radius)
    np.testing.assert_array_equal(count.numpy(), j_count)
    np.testing.assert_allclose(frames.numpy(), j_frames, atol=5e-4)
    if mode == "given":
        assert torch.equal(frames, rfs)
    desc = shot_fused.shot_finalize(hist, count, True, MIN_NEIGHBORS)
    assert_flip_rule(desc.numpy(), j_desc)


@pytest.mark.parametrize("mode", MODES)
def test_shot_grid_counts_every_neighbor_in_radius(rng, mode):
    """Each keypoint's count is the number of table rows with ``0 <
    sqrt(ρ²) <= radius`` over the whole table (the route's float32
    distance), so the window holds every neighbor, and a duplicate of the
    keypoint (d = 0) is not counted."""
    pts, nrm = _terrain(rng, 2500, 2.0)
    pts = torch.cat([pts, pts[:4]])
    nrm = torch.cat([nrm, nrm[:4]])
    grid = _grid(pts, nrm)
    kp = torch.cat([pts[:4], _keypoints(rng, pts[4:], n=60, far=0)])
    rfs, rf_radius = _mode_args(mode, grid, kp)
    _, _, count = shot_fused.shot_grid(grid, kp, RADIUS, rfs=rfs, rf_radius=rf_radius)
    table = grid.packed_sorted
    d = sqrt(sqnorm3(*(table[None, :, i] - kp[:, None, i] for i in range(3))))
    brute = ((d <= torch.tensor(RADIUS)) & (d > 0)).sum(1, dtype=torch.int32)
    assert torch.equal(count, brute)


@pytest.mark.parametrize("mode", MODES)
def test_shot_grid_far_pads_get_zero_rows(rng, mode):
    """Keypoints padded at the far sentinel get zero rows, count 0 and the
    identity frame (when frames are computed); the rows beside them are the
    rows without the pads."""
    pts, nrm = _terrain(rng, 2000, 1.5)
    grid = _grid(pts, nrm)
    kp = _keypoints(rng, pts, n=80, far=5)
    rfs, rf_radius = _mode_args(mode, grid, kp)
    hist, frames, count = shot_fused.shot_grid(grid, kp, RADIUS, rfs=rfs, rf_radius=rf_radius)
    assert not hist[-5:].any() and not count[-5:].any()
    if mode != "given":
        assert torch.equal(frames[-5:], torch.eye(3).expand(5, 3, 3))
    alone = shot_fused.shot_grid(grid, kp[:-5], RADIUS,
                                 rfs=None if rfs is None else rfs[:-5], rf_radius=rf_radius)
    _assert_equal((hist[:-5], frames[:-5], count[:-5]), alone)


def test_shot_grid_no_keypoints_launch_nothing(rng):
    """An empty keypoint set gives ``(0, 352)``, ``(0, 3, 3)`` and ``(0,)``
    int32 on every route, and launches nothing."""
    pts, nrm = _terrain(rng, 1500, 1.5)
    grid = _grid(pts, nrm)
    kp = torch.zeros((0, 3))
    before = dict(_kernels.launch_counts)
    for fn in (shot_fused.shot_grid, shot_fused.shot_grid_plain, shot_fused.shot_window_chunked):
        for rfs, rf_radius in ((None, None), (torch.zeros((0, 3, 3)), None), (None, RF_RADIUS)):
            hist, frames, count = fn(grid, kp, RADIUS, rfs=rfs, rf_radius=rf_radius)
            assert hist.shape == (0, 352) and frames.shape == (0, 3, 3)
            assert count.shape == (0,) and count.dtype == torch.int32
    assert _kernels.launch_counts == before


@pytest.mark.parametrize("case", ["kp_2d", "kp_3d", "frames", "kp_f64", "frames_f64",
                                  "no_normals"])
def test_shot_grid_rejects_bad_shapes_and_dtypes(rng, case):
    pts, nrm = _terrain(rng, 500, 1.0)
    grid = _grid(pts, nrm)
    kp, rfs = pts[:10], torch.eye(3).expand(10, 3, 3).contiguous()
    args = {"kp_2d": (grid, kp[:, :2], None), "kp_3d": (grid, kp[:, :, None], None),
            "frames": (grid, kp, rfs[:5]), "kp_f64": (grid, kp.double(), None),
            "frames_f64": (grid, kp, rfs.double()),
            "no_normals": (t_grid.build_grid(pts, RADIUS / 2, halo=2, device="cpu"), kp, None)}
    grid, kp, rfs = args[case]
    with pytest.raises(ValueError):
        shot_fused.shot_grid(grid, kp, RADIUS, rfs=rfs)


def _routes(monkeypatch):
    """Record which route ``_shot_on_grid`` takes: SG's kernel (with the
    twin in its place: ``sg``), the loop (``loop``) or K5 or its twin
    (``k5``, seen by the run wrappers' grid check)."""
    calls = []
    monkeypatch.setattr(shot_fused, "_shot_grid_launch",
                        lambda grid, kp, radius, rfs, rf_radius, violations: calls.append("sg")
                        or shot_fused.shot_grid_plain(grid, kp, radius, rfs, rf_radius,
                                                      violations))
    chunked = shot_fused.shot_window_chunked
    monkeypatch.setattr(shot_fused, "shot_window_chunked",
                        lambda *a, **k: calls.append("loop") or chunked(*a, **k))
    check = shot_dma._check_run_grid
    monkeypatch.setattr(shot_dma, "_check_run_grid",
                        lambda *a: calls.append("k5") or check(*a))
    return calls


def _stage(run):
    metrics = StageMetrics()
    metrics.start("descriptors[test]")
    out = run()
    return out, metrics.stop()


def test_grid_kernel_predicate_observes_device_and_table(rng):
    """SG's kernel is chosen by what the call can observe: keypoints on a
    card and a grid with a cell-start table; CPU tensors and grids without
    a table keep the loop."""
    pts, nrm = _terrain(rng, 800, 1.0)
    grid = _grid(pts, nrm)
    no_table = _grid(torch.cat([pts, torch.full((1, 3), 5e3)]), torch.cat([nrm, nrm[:1]]))
    assert grid.has_table and not no_table.has_table
    card = types.SimpleNamespace(is_cuda=True)
    assert shot_fused._takes_kernel(grid, card)
    assert not shot_fused._takes_kernel(no_table, card)
    assert not shot_fused._takes_kernel(grid, pts[:4])


@pytest.mark.parametrize("mode", MODES)
def test_window_route_takes_sg_where_it_applies(rng, monkeypatch, mode):
    """With SG's predicate holding (forced on the CPU, the twin in the
    kernel's place), ``_shot_on_grid`` makes one ``shot.pass`` span,
    counts one ``grid_passes`` and no ``chunks``, and returns the loop's
    descriptors and frames bit for bit."""
    pts, nrm = _terrain(rng, 2500, 2.0)
    grid = _grid(pts, nrm)
    kp = _keypoints(rng, pts, n=100)
    rfs, rf_radius = _mode_args(mode, grid, kp)

    def run():
        return t_shot._shot_on_grid(grid, kp, rfs, RADIUS, True, 5, rf_radius=rf_radius)

    calls = _routes(monkeypatch)
    want, loop = _stage(run)
    assert calls == ["loop"]
    assert loop["chunks"] == 1 and "grid_passes" not in loop and "shot.pass" not in loop["spans"]
    calls.clear()
    monkeypatch.setattr(shot_fused, "_takes_kernel", lambda grid, kp: True)
    got, stage = _stage(run)
    assert calls == ["sg"]
    _assert_equal(got, want)
    assert stage["grid_passes"] == 1 and stage["chunks"] == 0
    assert stage["spans"]["shot.pass"]["count"] == 1
    assert stage["host_syncs"] == loop["host_syncs"]


def test_window_route_keeps_the_loop_without_a_table(rng, monkeypatch):
    """A grid without a cell-start table takes the loop (its chunks counted)
    even where the keypoints would be on a card."""
    pts, nrm = _terrain(rng, 3000, 2.0)
    far = _grid(torch.cat([pts, torch.full((1, 3), 5e3)]), torch.cat([nrm, nrm[:1]]))
    kp = _keypoints(rng, pts, n=100)
    calls = _routes(monkeypatch)
    monkeypatch.setattr(shot_fused, "_takes_kernel", lambda grid, kp: grid.has_table)
    _, stage = _stage(lambda: t_shot._shot_on_grid(far, kp, None, RADIUS, True, 5))
    assert calls == ["loop"] and stage["chunks"] >= 1
    assert "grid_passes" not in stage


def test_grid_shot_ignores_the_old_run_route_variable(rng, monkeypatch):
    """``SHOT_FPFH_DMA=1`` in the environment selects nothing: SHOT through
    ``compute_shot_descriptor`` on an xy-row grid (the route's threshold
    lowered, SG's predicate forced) still takes SG, once, and neither K5
    nor its twin runs."""
    pts, nrm = _terrain(rng, 3000, 2.0)
    kp = _keypoints(rng, pts, n=100)
    monkeypatch.setenv("SHOT_FPFH_DMA", "1")
    monkeypatch.setattr(t_grid, "AUTO_GRID_MIN_POINTS", 1000)
    grid = _grid(pts, nrm)
    assert shot_dma._xyrow_mode(grid)[0]
    calls = _routes(monkeypatch)
    monkeypatch.setattr(shot_fused, "_takes_kernel", lambda grid, kp: True)
    desc, _ = t_shot.compute_shot_descriptor(kp, pts, nrm, RADIUS, min_neighborhood_size=5,
                                             device="cpu")
    assert calls == ["sg"] and bool(desc.any())
