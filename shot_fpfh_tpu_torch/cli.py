"""Command-line entry point: register two .ply point clouds on one GPU.

Port of ``shot_fpfh_tpu.cli`` (console script ``register_point_clouds_torch``):
load clouds → k-NN normals → keypoints → descriptors (single-, bi- or
multiscale SHOT, or FPFH) → matching → RANSAC → ICP → metrics → aligned
``.ply`` outputs, with per-stage timings and the same YAML config.  When
``--conf_file_path`` gives the exact transform, the matches are checked
against it (the count of incorrect matches is logged) and RANSAC's error is
logged.
``--device`` picks the torch device (default ``cuda``).  Bi-scale SHOT takes
its frames at ``--radius`` and its bins at ``--radius`` × ``--phi``;
multiscale SHOT runs ``--n_scales`` scales at ``--radius`` × ``--phi``^s and,
unless ``--no-share_local_rfs``, shares the first scale's frames.
``--fused`` runs keypoints through ICP as one device call
(``RegistrationPipeline.run_fused``) where the reference's fused program
covers the config, and otherwise warns and stages.  ``--debug_shot`` turns
on the SHOT binning sanity checks (``models.shot.enable_debug_checks``) and
``--debug_nans`` runs the registration under a NaN check
(``utils.debug_nans.NanCheck``, stricter than ``jax_debug_nans``: every op
is checked); both are off again when ``main`` returns or raises.
``--n_devices`` (or the reference's ``--n_procs``) other than 1 builds a
mesh over the ranks of the launch (``parallel.make_mesh``; ``--mesh_axis``
must be ``points``): under ``torchrun --nproc_per_node N ... --n_devices N``
normals, descriptors, matching, RANSAC and ICP shard over the N ranks (with
``--fused``, the single program shards over them:
``registration.fused.fused_registration_mesh``), every rank logs the same
result and rank 0 alone writes the outputs; in a single process the mesh
has one rank and the stages run on one device; in a launch of more than
one rank, ``--n_devices 1`` raises ``ValueError``.
``--normals_computation_k`` is a second name of ``--normals_k`` and
``--disable_progress_bars`` does nothing, as in the reference.  Exit code 0
means the registration was accepted.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import json
import logging
import os
from pathlib import Path

import torch

from .configuration import load_config_from_yaml
from .io.ground_truth import get_transform_from_conf_file
from .io.ply import get_data
from .models.normals import compute_normals
from .models.shot import debug_violation_count, enable_debug_checks
from .parallel import make_mesh
from .parallel.mesh import launch_size
from .pipeline import RegistrationPipeline
from .utils.debug_nans import NanCheck
from .utils.perf import StageMetrics, checkpoint

logger = logging.getLogger(__name__)

_DEFAULT_CONFIG = str(Path(__file__).resolve().parent.parent / "config" / "default.yaml")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="register_point_clouds_torch",
        description="SHOT / FPFH point-cloud registration on a GPU (PyTorch / CUDA)",
    )
    io_group = parser.add_argument_group("I/O")
    io_group.add_argument("--scan_file_path", "-s", type=str,
                          default="./data/bunny/bun045.ply")
    io_group.add_argument("--ref_file_path", "-r", type=str,
                          default="./data/bunny/bun000.ply")
    io_group.add_argument("--conf_file_path", "-c", type=str,
                          default="./data/bunny/bun.conf",
                          help="Stanford .conf ground truth (optional)")
    io_group.add_argument("--config", type=str, default=_DEFAULT_CONFIG)
    io_group.add_argument("--output_dir", type=str, default="./data/results")
    io_group.add_argument("--disable_ply_writing", action="store_true")
    io_group.add_argument("--metrics_json", type=str, default=None,
                          help="Write per-stage metrics to this JSON file")

    kp = parser.add_argument_group("keypoint selection")
    kp.add_argument("--selection_algorithm", type=str, default=None,
                    choices=["random", "iterative", "subsampling", "subsampling_with_density"])
    kp.add_argument("--neighborhood_size", type=float, default=None)
    kp.add_argument("--min_n_neighbors", type=int, default=None)

    desc = parser.add_argument_group("descriptors")
    desc.add_argument("--descriptor_choice", type=str, default=None,
                      choices=["fpfh", "shot_single_scale", "shot_bi_scale", "shot_multiscale"])
    desc.add_argument("--radius", type=float, default=None)
    desc.add_argument("--fpfh_n_bins", type=int, default=None)
    desc.add_argument("--phi", type=float, default=None,
                      help="Ratio of successive SHOT radii (bi-scale, multiscale).")
    desc.add_argument("--rho", type=float, default=None)
    desc.add_argument("--n_scales", type=int, default=None,
                      help="Number of multiscale SHOT scales.")
    desc.add_argument("--min_neighborhood_size", type=int, default=None)

    match = parser.add_argument_group("matching and RANSAC")
    match.add_argument("--matching_algorithm", type=str, default=None,
                       choices=["simple", "double", "ratio", "threshold"])
    match.add_argument("--reject_threshold", type=float, default=None)
    match.add_argument("--threshold_multiplier", type=float, default=None)
    match.add_argument("--n_draws", type=int, default=None)
    match.add_argument("--draw_size", type=int, default=None)
    match.add_argument("--max_inliers_distance", type=float, default=None)
    match.add_argument("--seed", type=int, default=None)

    icp = parser.add_argument_group("ICP")
    icp.add_argument("--icp_type", type=str, default=None,
                     choices=["point_to_point", "point_to_plane"])
    icp.add_argument("--d_max", type=float, default=None)
    icp.add_argument("--voxel_size", type=float, default=None)
    icp.add_argument("--max_iter", type=int, default=None)
    icp.add_argument("--rms_threshold", type=float, default=None)

    compute = parser.add_argument_group("compute")
    compute.add_argument("--device", type=str, default="cuda",
                         help="torch device the stages run on (cuda, cuda:N or cpu)")
    compute.add_argument("--k_max_descriptor", type=int, default=None)
    compute.add_argument("--k_max_fpfh", type=int, default=None)
    compute.add_argument("--normals_k", "--normals_computation_k", type=int, default=None,
                         dest="normals_k",
                         help="Number of neighbors used to compute normals (reference "
                              "name: --normals_computation_k).")
    compute.add_argument("--share_local_rfs", action=argparse.BooleanOptionalAction,
                         default=None,
                         help="Share the first scale's local reference frames across "
                              "multiscale SHOT scales (config default: true).")
    compute.add_argument("--disable_progress_bars", action="store_true",
                         help="Reference-compatibility no-op: the stages have no "
                              "progress bars.")
    compute.add_argument("--state_cache", type=str, default=None,
                         help="npz path: save/resume keypoints+descriptors+matches")
    compute.add_argument("--fused", action="store_const", const=True, default=None)
    compute.add_argument("--debug_nans", action="store_const", const=True, default=None)
    compute.add_argument("--debug_shot", action="store_const", const=True, default=None)
    compute.add_argument("--n_devices", type=int, default=None,
                         help="Ranks of the 1-D mesh the stages shard over (0 = every "
                              "rank of the launch, 1 = one device); launch N ranks with "
                              "torchrun --nproc_per_node N.")
    compute.add_argument("--n_procs", type=int, default=None, dest="n_devices",
                         help="Reference-compatibility alias for --n_devices.")
    compute.add_argument("--mesh_axis", type=str, default=None,
                         help="Name of the mesh axis; must be 'points' (any other value "
                              "is rejected when the mesh is built).")
    return parser.parse_args(argv)


def _fused_refusal(kp_cfg, desc_cfg, match_cfg, compute_cfg) -> str | None:
    """Why ``--fused`` stages instead (the reference CLI's reasons, in its
    order), or None when the fused program covers the config."""
    if kp_cfg.selection_algorithm != "subsampling" or not kp_cfg.neighborhood_size:
        return "keypoint selection must be 'subsampling' with a neighborhood_size"
    if desc_cfg.descriptor_choice not in ("shot_single_scale", "shot_bi_scale",
                                          "shot_multiscale", "shot_multi_scale", "fpfh"):
        return "descriptor must be shot_single_scale/shot_bi_scale/shot_multiscale/fpfh"
    if match_cfg.matching_algorithm not in ("simple", "ratio", "double"):
        return "matching must be simple/ratio/double"
    if (desc_cfg.descriptor_choice in ("shot_multiscale", "shot_multi_scale")
            and not desc_cfg.share_local_rfs):
        return ("the fused multiscale leg always shares first-scale local frames; drop "
                "--no-share_local_rfs")
    if compute_cfg.state_cache:
        return "the fused program has no resumable intermediate state"
    return None


def _file_id(path: str):
    try:
        st = os.stat(path)
        return [path, st.st_size, st.st_mtime_ns]
    except OSError:
        return [path, -1, -1]


def _run_staged(args, pipeline, config, exact_transform):
    """Keypoints, descriptors, matching, RANSAC and ICP as separate stages;
    returns the RANSAC and ICP transforms and the ICP RMS."""
    compute_cfg, kp_cfg, desc_cfg = (config["compute"], config["keypoint_selection"],
                                     config["descriptor"])
    match_cfg, ransac_cfg, icp_cfg = config["matching"], config["ransac"], config["icp"]
    # cache key: every section that determines the cached state, plus the
    # input clouds (a cache of another pair or config is never resumed)
    state_key = hashlib.sha256(json.dumps(
        {"kp": repr(kp_cfg), "desc": repr(desc_cfg), "match": repr(match_cfg),
         "caps": [compute_cfg.k_max_descriptor, compute_cfg.k_max_fpfh,
                  compute_cfg.normals_k],
         "inputs": [_file_id(args.scan_file_path), _file_id(args.ref_file_path)]},
        sort_keys=True).encode()).hexdigest()
    state_resumed = False
    if compute_cfg.state_cache and os.path.exists(compute_cfg.state_cache):
        logger.info("Resuming intermediate state from %s", compute_cfg.state_cache)
        state_resumed = pipeline.load_state(compute_cfg.state_cache, config_key=state_key)

    logger.info(kp_cfg.help_message())
    pipeline.select_keypoints(kp_cfg.selection_algorithm,
                              neighborhood_size=kp_cfg.neighborhood_size,
                              min_n_neighbors=kp_cfg.min_n_neighbors)

    logger.info(desc_cfg.help_message())
    pipeline.compute_descriptors(
        radius=desc_cfg.radius, descriptor_choice=desc_cfg.descriptor_choice,
        fpfh_n_bins=desc_cfg.fpfh_n_bins, phi=desc_cfg.phi, rho=desc_cfg.rho,
        n_scales=desc_cfg.n_scales, subsample_support=desc_cfg.subsample_support,
        normalize=desc_cfg.normalize, share_local_rfs=desc_cfg.share_local_rfs,
        min_neighborhood_size=desc_cfg.min_neighborhood_size)
    if compute_cfg.state_cache and not state_resumed and _writes(pipeline.mesh):
        pipeline.save_state(compute_cfg.state_cache, config_key=state_key)
        logger.info("Saved intermediate state to %s", compute_cfg.state_cache)

    logger.info(match_cfg.help_message())
    pipeline.find_descriptors_matches(match_cfg.matching_algorithm,
                                      reject_threshold=match_cfg.reject_threshold,
                                      threshold_multiplier=match_cfg.threshold_multiplier)
    if exact_transform is not None:
        pipeline.analyze_matches(match_cfg.matching_algorithm, exact_transform)

    logger.info(ransac_cfg.help_message())
    transform_ransac, inlier_ratio = pipeline.run_ransac(
        n_draws=ransac_cfg.n_draws, draw_size=ransac_cfg.draw_size,
        max_inliers_distance=ransac_cfg.max_inliers_distance, seed=ransac_cfg.seed,
        exact_transformation=exact_transform)
    logger.info("RANSAC inlier ratio: %.3f", inlier_ratio)
    logger.info("RANSAC transform:\n%r", transform_ransac)

    logger.info(icp_cfg.help_message())
    transform_icp, rms, converged = pipeline.run_icp(
        icp_cfg.icp_type, transformation_init=transform_ransac, d_max=icp_cfg.d_max,
        voxel_size=icp_cfg.voxel_size, max_iter=icp_cfg.max_iter,
        rms_threshold=icp_cfg.rms_threshold)
    logger.info("ICP RMS: %.4f (converged: %s)", rms, converged)
    logger.info("ICP transform:\n%r", transform_icp)
    return transform_ransac, transform_icp, rms


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    config = load_config_from_yaml(args.config, vars(args))
    compute_cfg = config["compute"]
    with contextlib.ExitStack() as debug:
        if compute_cfg.debug_shot:
            enable_debug_checks(True)
            debug.callback(_end_debug_shot)
        if compute_cfg.debug_nans:
            debug.enter_context(NanCheck())
        return _register(args, config)


def _end_debug_shot() -> None:
    logger.info("SHOT debug checks: %d violations", debug_violation_count())
    enable_debug_checks(False)


def _writes(mesh) -> bool:
    """Whether this process writes the outputs: rank 0 of the mesh, or the
    only process."""
    return mesh is None or mesh.rank == 0


def _build_mesh(compute_cfg, device: str):
    """The mesh the stages shard over (JAX ``cli.py:157-170``): none for
    ``--n_devices 1``; a mesh of one rank degenerates to one device."""
    if compute_cfg.n_devices == 1:
        if launch_size() > 1:    # every rank would register alone and write the outputs
            raise ValueError(f"--n_devices 1 in a launch of {launch_size()} ranks: launch "
                             "one process, or pass --n_devices 0 to shard over the launch")
        return None
    mesh = make_mesh(compute_cfg.n_devices, axis=compute_cfg.mesh_axis, device=device)
    if mesh.devices.size <= 1:
        return None
    logger.info("Sharding pipeline stages over a %d-rank mesh (axis %r, backend %s), "
                "rank %d on %s.", mesh.devices.size, mesh.axis, mesh.backend, mesh.rank,
                mesh.device)
    return mesh


def _normals(query_points, cloud_points, *, device, mesh, metrics, **kwargs):
    return compute_normals(query_points, cloud_points, mesh=mesh, device=device,
                           metrics=metrics, **kwargs).cpu().numpy()


def _register(args, config) -> int:
    """Load, register and write out the pair of ``args`` under ``config``;
    0 when the registration is accepted."""
    compute_cfg = config["compute"]
    mesh = _build_mesh(compute_cfg, args.device)
    device = mesh.device if mesh is not None else torch.device(args.device)
    timer = checkpoint()
    metrics = StageMetrics()

    normals_callback = functools.partial(_normals, device=device, mesh=mesh, metrics=metrics)
    scan, scan_normals = get_data(args.scan_file_path, k=compute_cfg.normals_k,
                                  normals_computation_callback=normals_callback)
    ref, ref_normals = get_data(args.ref_file_path, k=compute_cfg.normals_k,
                                normals_computation_callback=normals_callback)
    timer("Data loading + normals")

    exact_transform = None
    if args.conf_file_path and os.path.exists(args.conf_file_path):
        try:
            exact_transform = get_transform_from_conf_file(
                args.conf_file_path, args.scan_file_path, args.ref_file_path)
        except (KeyError, ValueError) as exc:
            logger.warning("Could not recover ground truth: %s", exc)

    pipeline = RegistrationPipeline(
        scan=scan, scan_normals=scan_normals, ref=ref, ref_normals=ref_normals,
        k_max_descriptor=compute_cfg.k_max_descriptor, k_max_fpfh=compute_cfg.k_max_fpfh,
        metrics=metrics, device=device, mesh=mesh)
    kp_cfg, desc_cfg = config["keypoint_selection"], config["descriptor"]
    match_cfg, ransac_cfg, icp_cfg = config["matching"], config["ransac"], config["icp"]

    use_fused = False
    if compute_cfg.fused:
        reason = _fused_refusal(kp_cfg, desc_cfg, match_cfg, compute_cfg)
        if reason:
            logger.warning("--fused requested but staging instead: %s", reason)
        use_fused = reason is None

    if use_fused:
        logger.info("Fused single-program registration (radius=%s).", desc_cfg.radius)
        ratio = (match_cfg.reject_threshold
                 if match_cfg.matching_algorithm in ("ratio", "double") else 1.0)
        res = pipeline.run_fused(
            keypoint_voxel=kp_cfg.neighborhood_size, icp_voxel=icp_cfg.voxel_size,
            radius=desc_cfg.radius, descriptor_choice=desc_cfg.descriptor_choice,
            phi=desc_cfg.phi, n_scales=desc_cfg.n_scales, fpfh_n_bins=desc_cfg.fpfh_n_bins,
            ratio_threshold=ratio, ransac_threshold=ransac_cfg.max_inliers_distance,
            d_max=icp_cfg.d_max, rms_threshold=icp_cfg.rms_threshold,
            min_neighborhood_size=desc_cfg.min_neighborhood_size,
            n_draws=ransac_cfg.n_draws, draw_size=ransac_cfg.draw_size,
            max_iter=icp_cfg.max_iter, point_to_plane=icp_cfg.icp_type == "point_to_plane",
            seed=ransac_cfg.seed)
        transform_ransac, transform_icp = res.ransac_transform, res.icp_transform
        inlier_ratio, rms = float(res.ransac_inlier_ratio), float(res.icp_rms)
        converged = bool(res.icp_converged)
        logger.info("Fused: %d matches, RANSAC inlier ratio %.3f", int(res.n_matches),
                    inlier_ratio)
        logger.info("RANSAC transform:\n%r", transform_ransac)
        logger.info("ICP RMS: %.4f (converged: %s)", rms, converged)
        logger.info("ICP transform:\n%r", transform_icp)
        timer("Fused registration")
    else:
        transform_ransac, transform_icp, rms = _run_staged(args, pipeline, config,
                                                           exact_transform)

    eval_cfg = config["registration_evaluation"]
    overlap, kp_inliers = pipeline.compute_metrics_post_icp(
        transform_icp, eval_cfg.distance_to_map_threshold)
    accepted = eval_cfg.eval_registration(overlap=overlap, distance_to_map=rms,
                                          inliers=kp_inliers)
    logger.info("Overlap: %.1f%% | keypoint inliers: %.1f%% | registration %s",
                overlap * 100, kp_inliers * 100, "ACCEPTED" if accepted else "REJECTED")
    timer("Metrics")

    if not args.disable_ply_writing and _writes(pipeline.mesh):
        os.makedirs(args.output_dir, exist_ok=True)
        scan_name = Path(args.scan_file_path).stem
        ref_name = Path(args.ref_file_path).stem
        pipeline.write_alignments(
            (f"{args.output_dir}/{scan_name}_on_{ref_name}_post_ransac.ply", transform_ransac),
            (f"{args.output_dir}/{scan_name}_on_{ref_name}_post_icp.ply", transform_icp))
        timer("Writing outputs")

    if args.metrics_json and _writes(pipeline.mesh):
        with open(args.metrics_json, "w") as f:
            json.dump(pipeline.metrics.summary(), f, indent=2)
    return 0 if accepted else 1


if __name__ == "__main__":
    raise SystemExit(main())
