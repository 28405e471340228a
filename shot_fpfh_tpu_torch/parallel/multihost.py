"""Multi-process registration: ``run_multihost`` and its helpers — port of
``shot_fpfh_tpu.parallel.multihost``.

JAX joins its processes with ``jax.distributed.initialize`` and lays one
mesh over every process's devices.  Here every process is one rank of a
``torch.distributed`` group on one device: :func:`initialize_distributed`
starts the default group over a ``tcp://`` coordinator (rank 0 hosts the
store; the backend is chosen as ``parallel.mesh`` chooses it: NCCL when
every rank has a card of its own, gloo otherwise), and ``make_mesh()`` then
spans the whole launch.  Each process reads its own copy of the input files
(nothing is broadcast) and runs the sharded stages (``sharded.py``), whose
collectives keep the traffic small: gathered result rows, the matching
ring's tiles, RANSAC's count vector and ICP's per-iteration sums.  Every
process returns the same result.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, _init_group, _rank_device, all_gather_rows, make_mesh, replicate

logger = logging.getLogger(__name__)


def run_multihost(
    scan_file_path: str,
    ref_file_path: str,
    *,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    normals_k: int = 20,
    keypoint_voxel: float = 0.25,
    descriptor_choice: str = "shot_single_scale",
    radius: float = 0.5,
    min_neighborhood_size: int = 10,
    k_max_descriptor: int = 256,
    k_max_fpfh: int = 128,
    reject_threshold: float = 0.9,
    n_draws: int = 2000,
    max_inliers_distance: float = 0.1,
    d_max: float = 0.3,
    icp_voxel: float = 0.1,
    max_iter: int = 40,
    rms_threshold: float = 1e-5,
    device=None,
    timeout: float | None = None,
) -> dict:
    """End-to-end registration over every process of a launch (JAX
    ``multihost.py:36-114``).  Every process calls this with its own
    ``process_id``: :func:`initialize_distributed`, a mesh over the whole
    launch, the ``.ply`` files read by each process with normals sharded
    over the mesh, then subsampling keypoints, descriptors, ``ratio``
    matching, RANSAC and point-to-plane ICP through
    ``RegistrationPipeline(mesh=mesh)``.  ``device``: each rank's device
    (default ``cuda``, one card a rank by ``LOCAL_RANK``; ``"cpu"`` for CPU
    ranks); ``timeout``: seconds a collective may wait.  Returns JAX's
    keys, the same on every process; ``n_devices`` is the mesh size (one
    device a process here, where JAX counts every process's devices)."""
    from ..io.ply import get_data
    from ..models.normals import compute_normals
    from ..pipeline import RegistrationPipeline

    initialize_distributed(coordinator_address, num_processes, process_id, device=device,
                           timeout=timeout)
    mesh = make_mesh(device=device, timeout=timeout)    # every rank of the launch
    sharded = mesh if mesh.size > 1 else None

    def normals_callback(q, c, **kw):
        return compute_normals(q, c, mesh=sharded, device=mesh.device, **kw).cpu().numpy()

    scan, scan_normals = get_data(scan_file_path, k=normals_k,
                                  normals_computation_callback=normals_callback)
    ref, ref_normals = get_data(ref_file_path, k=normals_k,
                                normals_computation_callback=normals_callback)

    pipeline = RegistrationPipeline(
        scan=scan, scan_normals=scan_normals, ref=ref, ref_normals=ref_normals,
        k_max_descriptor=k_max_descriptor, k_max_fpfh=k_max_fpfh, device=mesh.device,
        mesh=sharded)
    pipeline.select_keypoints("subsampling", neighborhood_size=keypoint_voxel)
    pipeline.compute_descriptors(
        radius=radius, descriptor_choice=descriptor_choice, subsample_support=False,
        min_neighborhood_size=min_neighborhood_size)
    pipeline.find_descriptors_matches("ratio", reject_threshold=reject_threshold)
    tf_ransac, inlier_ratio = pipeline.run_ransac(
        n_draws=n_draws, draw_size=4, max_inliers_distance=max_inliers_distance)
    tf_icp, rms, converged = pipeline.run_icp(
        "point_to_plane", tf_ransac, d_max=d_max, voxel_size=icp_voxel, max_iter=max_iter,
        rms_threshold=rms_threshold)
    return {
        "process_id": mesh.rank,
        "process_count": dist.get_world_size() if dist.is_initialized() else 1,
        "n_devices": mesh.size,
        "rotation": tf_icp.rotation.cpu().numpy().tolist(),
        "translation": tf_icp.translation.cpu().numpy().tolist(),
        "ransac_inlier_ratio": float(inlier_ratio),
        "icp_rms": float(rms),
        "icp_converged": bool(converged),
        "n_matches": int(len(pipeline.matches[0])),
        "stages": pipeline.metrics.summary(),
    }


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device=None,
    timeout: float | None = None,
) -> None:
    """Start the default process group over ``tcp://coordinator_address``
    as rank ``process_id`` of ``num_processes`` (JAX
    ``multihost.py:117-135``); a no-op for one process or fewer.  The
    backend is ``parallel.mesh``'s rule, from every rank's ``device``
    (default ``cuda``); ``timeout``: seconds a collective may wait.  The
    group is ended at exit (``mesh.shutdown_distributed``)."""
    if num_processes is None or num_processes <= 1:
        logger.info("single-process run: no process group to start")
        return
    _init_group(device, f"tcp://{coordinator_address}", process_id, num_processes, timeout)
    logger.info("distributed: process %d of %d, backend %s", dist.get_rank(),
                dist.get_world_size(), dist.get_backend())


def _process() -> tuple[int, int]:
    """(this process's rank, the number of processes)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_local_keypoint_shard(keypoints):
    """The contiguous block of ``keypoints`` this process is responsible
    for: the ceil-div block of its rank (the last may be short or empty)."""
    p, n_proc = _process()
    per = -(-len(keypoints) // n_proc)
    return keypoints[p * per:(p + 1) * per]


def global_keypoint_array(local_block, mesh: Mesh) -> torch.Tensor:
    """Every rank's block (:func:`host_local_keypoint_shard`) in rank
    order, as one tensor on the rank's device, the same on every rank.  The
    blocks may differ in length: their lengths are gathered first, each
    block padded to the longest, gathered, and the pads dropped."""
    block = replicate(local_block, mesh)
    if mesh.backend is None:
        return block
    n = torch.full((1,), block.shape[0], dtype=torch.int64, device=mesh.device)
    lengths = all_gather_rows(n, mesh).tolist()
    longest = max(lengths)
    if longest == 0:
        return block
    padded = torch.cat([block, block.new_zeros((longest - block.shape[0], *block.shape[1:]))])
    parts = all_gather_rows(padded, mesh).split(longest)
    return torch.cat([part[:k] for part, k in zip(parts, lengths)])


def scaling_report(
    n_keypoints: int = 2048,
    n_support: int = 20000,
    radius: float = 0.9,
    k_max: int = 128,
    device_counts: tuple = (1, 0),
    stage: str = "shot",
    reps: int = 3,
    *,
    device=None,
) -> dict:
    """Items per second of a sharded stage by device count (JAX
    ``multihost.py:154-220``): ``stage`` is ``"shot"``, ``"fpfh"`` or
    ``"matching"``; a count of 1 runs the one-device path on this rank, 0
    the launch's mesh (every rank), and any other count below the launch's
    size raises as ``make_mesh`` does.  Returns ``{n_devices: items/s}``
    and, with two counts, ``"efficiency"``: the larger count's rate over
    the smaller's scaled by the count ratio.  Every rank of the launch must
    call it alike; its numbers mean something only with a card a rank."""
    from .sharded import ring_match, sharded_fpfh, sharded_shot_descriptors

    if stage not in ("shot", "fpfh", "matching"):
        raise ValueError(f"unknown stage {stage!r}")
    rng = np.random.default_rng(0)
    support = rng.normal(size=(n_support, 3)).astype(np.float32) * 4
    normals = rng.normal(size=(n_support, 3))
    normals = (normals / np.linalg.norm(normals, axis=1, keepdims=True)).astype(np.float32)
    keypoints = support[:n_keypoints]
    kp_idx = np.arange(n_keypoints, dtype=np.int32)
    rng2 = np.random.default_rng(1)
    desc_a = rng2.normal(size=(n_keypoints, 352)).astype(np.float32)
    desc_b = rng2.normal(size=(n_keypoints, 352)).astype(np.float32)

    results = {}
    for count in device_counts:
        # one device: a mesh of this rank alone, with no group (its
        # collectives are the identity)
        mesh = (Mesh(0, 1, _rank_device(device, _process()[0]), None) if count == 1
                else make_mesh(count, device=device))
        kp, sup, nrm, idx, a, b = (replicate(x, mesh) for x in (keypoints, support, normals,
                                                                kp_idx, desc_a, desc_b))
        if stage == "shot":
            def run():
                return sharded_shot_descriptors(kp, sup, nrm, radius, mesh, k_max=k_max,
                                                min_neighborhood_size=5)
        elif stage == "fpfh":
            def run():
                return sharded_fpfh(idx, sup, nrm, radius, mesh, n_bins=5, k_max=k_max)
        else:
            def run():
                return ring_match(a, b, mesh)

        run()   # warm-up: kernel builds, allocator growth
        _sync(mesh.device)
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        _sync(mesh.device)
        per_sec = n_keypoints * reps / (time.perf_counter() - t0)
        results[mesh.size] = per_sec
        logger.info("%s, %d device(s): %.0f items/s", stage, mesh.size, per_sec)
    counts = sorted(k for k in results if isinstance(k, int))
    if len(counts) > 1:
        base, top = counts[0], counts[-1]
        eff = results[top] / (results[base] * top / base)
        logger.info("%s scaling efficiency %d->%d devices: %.0f%%", stage, base, top,
                    eff * 100)
        results["efficiency"] = eff
    return results


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
