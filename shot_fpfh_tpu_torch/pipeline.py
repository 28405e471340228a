"""End-to-end registration pipeline — port of ``shot_fpfh_tpu.pipeline``.

Holds the scan/ref clouds on the host, memoizes each stage's result
(recomputed only on ``force_recompute``), and runs the stages on
``device`` (default ``cuda``): random, greedy-coverage or voxel keypoints,
single-, bi- or multiscale SHOT or FPFH, nearest / ratio-test / threshold
matching, RANSAC, ICP, the post-ICP metrics, and the ground-truth match
analysis when the exact transform is known; or all of registration in one
device call (:meth:`RegistrationPipeline.run_fused`).  Stage timings go to
``self.metrics``.  With a ``mesh`` of more than one rank
(``parallel.make_mesh``) the descriptors, matching, RANSAC and ICP shard
over it (``parallel.sharded``) on the rank's device, every rank holding the
same results; :meth:`RegistrationPipeline.run_fused` then runs the single
program over it.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Literal

import numpy as np
import torch

from ._device import resolve
from .analysis import get_incorrect_matches, lowe_ratio_split
from .core.transform import RigidTransform, rotation_angle
from .io.ply import write_ply
from .keypoints import (
    select_keypoints_iteratively,
    select_keypoints_subsampling,
    select_keypoints_with_density_threshold,
    select_query_indices_randomly,
)
from .models.fpfh import compute_fpfh_descriptor
from .models.shot import ShotComputer
from .ops.grid_hash import AUTO_GRID_MIN_POINTS, build_grid, grid_nearest_neighbor
from .ops.neighbors import as_f32, nearest_neighbor
from .registration.icp import IcpHostResult, icp_point_to_plane, icp_point_to_point
from .registration.matching import (
    basic_matching,
    lowe_matching,
    match_descriptors,
    threshold_filter,
)
from .registration.ransac import ransac_on_matches
from .utils.perf import StageMetrics, blocking, uploading

logger = logging.getLogger(__name__)

_STATE_ARRAYS = ("scan_keypoints", "ref_keypoints", "scan_descriptors", "ref_descriptors")


@dataclass
class RegistrationPipeline:
    """Descriptor-based registration between two local maps (scan → ref)."""

    scan: np.ndarray
    scan_normals: np.ndarray
    ref: np.ndarray
    ref_normals: np.ndarray

    scan_keypoints: np.ndarray | None = None
    ref_keypoints: np.ndarray | None = None
    scan_descriptors: torch.Tensor | np.ndarray | None = None
    ref_descriptors: torch.Tensor | np.ndarray | None = None
    matches: tuple[np.ndarray, np.ndarray] | None = None

    k_max_descriptor: int = 512
    k_max_fpfh: int = 128
    metrics: StageMetrics = field(default_factory=StageMetrics)
    device: torch.device | str = "cuda"
    # a parallel.Mesh: more than one rank routes the descriptors, matching,
    # RANSAC and ICP through parallel.sharded, on the rank's device (the
    # CLI builds it from --n_devices / --mesh_axis); None: one device
    mesh: object | None = None

    def __post_init__(self):
        self.device = self.mesh.device if self._mesh() is not None else resolve(self.device)

    def _mesh(self):
        if self.mesh is not None and self.mesh.devices.size > 1:
            return self.mesh
        return None

    # ------------------------------------------------------------ keypoints --
    def select_keypoints(
        self,
        selection_algorithm: Literal[
            "random", "iterative", "subsampling", "subsampling_with_density"],
        *, neighborhood_size: float | None = None, min_n_neighbors: int | None = None,
        proportion_picked: float = 0.5, force_recompute: bool = False,
    ) -> None:
        """Keypoints of both clouds: ``random`` draws ``proportion_picked`` of
        each cloud's points from CPU generators seeded 0 (scan) and 1 (ref);
        the other strategies need ``neighborhood_size`` (the greedy radius or
        the voxel size)."""
        if selection_algorithm not in ("random", "iterative", "subsampling",
                                       "subsampling_with_density"):
            raise ValueError("Incorrect keypoint selection algorithm.")
        if selection_algorithm != "random" and neighborhood_size is None:
            raise ValueError(
                f"keypoint selection '{selection_algorithm}' needs "
                "neighborhood_size (CLI: --neighborhood_size)")
        if selection_algorithm == "random" and not 0 <= proportion_picked <= 1:
            raise ValueError("Incorrect proportion passed.")
        self.metrics.start(f"keypoints[{selection_algorithm}]")
        for seed, side in enumerate(("scan", "ref")):
            if getattr(self, f"{side}_keypoints") is None or force_recompute:
                cloud = getattr(self, side)
                if selection_algorithm == "random":
                    kp = select_query_indices_randomly(
                        cloud.shape[0], int(cloud.shape[0] * proportion_picked),
                        generator=torch.Generator().manual_seed(seed))
                elif selection_algorithm == "iterative":
                    kp = select_keypoints_iteratively(cloud, neighborhood_size,
                                                      device=self.device)
                elif selection_algorithm == "subsampling":
                    kp = select_keypoints_subsampling(cloud, neighborhood_size, self.device)
                else:
                    kp = select_keypoints_with_density_threshold(
                        cloud, neighborhood_size, min_n_neighbors, device=self.device)
                setattr(self, f"{side}_keypoints", kp)
        self.metrics.stop(keypoints=len(self.scan_keypoints) + len(self.ref_keypoints))
        for side in ("scan", "ref"):
            logger.info("%d keypoints selected on %s out of %d points.",
                        len(getattr(self, f"{side}_keypoints")), side,
                        getattr(self, side).shape[0])

    # ----------------------------------------------------------- descriptors --
    def _shot_computer(self, **shot_config) -> ShotComputer:
        return ShotComputer(k_max=self.k_max_descriptor, mesh=self._mesh(), device=self.device,
                            **shot_config)

    def compute_shot_descriptor_single_scale(
        self, radius, subsampling_voxel_size=None, force_recompute: bool = False,
        **shot_config,
    ) -> None:
        """Reference API (pipeline.py:132-174): single-scale SHOT of both
        clouds' keypoints; ``shot_config`` goes to :class:`ShotComputer`."""
        computer = self._shot_computer(**shot_config)
        for side in ("scan", "ref"):
            if getattr(self, f"{side}_descriptors") is None or force_recompute:
                cloud, normals, kp = self._side(side)
                setattr(self, f"{side}_descriptors", computer.compute_descriptor_single_scale(
                    cloud, normals, cloud[kp], radius=radius,
                    subsampling_voxel_size=subsampling_voxel_size))

    def compute_shot_descriptor_bi_scale(
        self, local_rf_radius, shot_radius, subsampling_voxel_size=None,
        force_recompute: bool = False, **shot_config,
    ) -> None:
        """Reference API (pipeline.py:176-221): bi-scale SHOT, frames at
        ``local_rf_radius`` and bins at ``shot_radius``."""
        computer = self._shot_computer(**shot_config)
        for side in ("scan", "ref"):
            if getattr(self, f"{side}_descriptors") is None or force_recompute:
                cloud, normals, kp = self._side(side)
                setattr(self, f"{side}_descriptors", computer.compute_descriptor_bi_scale(
                    cloud, normals, cloud[kp], local_rf_radius=local_rf_radius,
                    shot_radius=shot_radius, subsampling_voxel_size=subsampling_voxel_size))

    def compute_shot_descriptor_multiscale(
        self, radii, voxel_sizes=None, weights=None, force_recompute: bool = False,
        **shot_config,
    ) -> None:
        """Reference API (pipeline.py:223-269): multiscale SHOT, one scale
        per radius, concatenated."""
        computer = self._shot_computer(**shot_config)
        for side in ("scan", "ref"):
            if getattr(self, f"{side}_descriptors") is None or force_recompute:
                cloud, normals, kp = self._side(side)
                setattr(self, f"{side}_descriptors", computer.compute_descriptor_multiscale(
                    cloud, normals, cloud[kp], radii=radii, voxel_sizes=voxel_sizes,
                    weights=weights))

    def _side(self, side: str):
        return (getattr(self, side), getattr(self, f"{side}_normals"),
                getattr(self, f"{side}_keypoints"))

    def compute_descriptors(
        self, radius: float,
        descriptor_choice: Literal[
            "fpfh", "shot_single_scale", "shot_bi_scale", "shot_multiscale"
        ] = "shot_single_scale",
        fpfh_n_bins: int = 5, phi: float = 3.0, rho: float = 10.0, n_scales: int = 2,
        subsample_support: bool = True, normalize: bool = True,
        share_local_rfs: bool = True, min_neighborhood_size: int = 100,
        force_recompute: bool = False,
        **_compat,
    ) -> None:
        """Stage dispatcher (reference pipeline.py:271-349; both spellings of
        multiscale are accepted): bi-scale SHOT takes its frames at
        ``radius`` and its bins at ``radius·phi``; multiscale SHOT runs
        ``n_scales`` scales at ``radius·phi^s``, each on a support
        subsampled at its radius / ``rho``.  The reference's other arguments
        (``n_procs``, the verbosity flags) are accepted and dropped."""
        if descriptor_choice == "shot_multi_scale":
            descriptor_choice = "shot_multiscale"
        if descriptor_choice not in ("shot_single_scale", "shot_bi_scale", "shot_multiscale",
                                     "fpfh"):
            raise ValueError("Incorrect descriptor choice")
        self.metrics.start(f"descriptors[{descriptor_choice}]")
        shot_config = dict(normalize=normalize, share_local_rfs=share_local_rfs,
                           min_neighborhood_size=min_neighborhood_size)
        voxel = radius / rho if subsample_support else None
        if descriptor_choice == "shot_single_scale":
            self.compute_shot_descriptor_single_scale(
                radius, subsampling_voxel_size=voxel, force_recompute=force_recompute,
                **shot_config)
        elif descriptor_choice == "shot_bi_scale":
            self.compute_shot_descriptor_bi_scale(
                radius, radius * phi, subsampling_voxel_size=voxel,
                force_recompute=force_recompute, **shot_config)
        elif descriptor_choice == "shot_multiscale":
            radii = radius * phi ** np.arange(n_scales)
            self.compute_shot_descriptor_multiscale(
                list(radii), voxel_sizes=list(radii / rho) if subsample_support else None,
                force_recompute=force_recompute, **shot_config)
        else:
            for side in ("scan", "ref"):
                if getattr(self, f"{side}_descriptors") is None or force_recompute:
                    cloud, normals, kp = self._side(side)
                    setattr(self, f"{side}_descriptors", compute_fpfh_descriptor(
                        kp, cloud, normals, radius=radius, n_bins=fpfh_n_bins,
                        k_max=self.k_max_fpfh, mesh=self._mesh(), device=self.device))
        self.metrics.stop(descriptors=len(self.scan_keypoints) + len(self.ref_keypoints))

    # -------------------------------------------------------------- matching --
    def find_descriptors_matches(
        self, matching_algorithm: Literal["simple", "double", "ratio", "threshold"], *,
        reject_threshold: float = 0.8, threshold_multiplier: float = 10,
        force_recompute: bool = False,
    ) -> None:
        if self.matches is not None and not force_recompute:
            return
        if matching_algorithm not in ("simple", "double", "ratio", "threshold"):
            raise ValueError("Incorrect matching algorithm selection.")
        self.metrics.start(f"matching[{matching_algorithm}]")
        mesh = self._mesh()
        if matching_algorithm == "simple":
            self.matches = basic_matching(self.scan_descriptors, self.ref_descriptors,
                                          device=self.device, mesh=mesh)
        elif matching_algorithm == "threshold":
            self.matches = match_descriptors(
                self.scan_descriptors, self.ref_descriptors, threshold_filter,
                threshold_multiplier=threshold_multiplier, device=self.device, mesh=mesh)
        else:
            self.matches = lowe_matching(self.scan_descriptors, self.ref_descriptors,
                                         reject_threshold, device=self.device, mesh=mesh)
        self.metrics.stop(matches=len(self.matches[0]))

    def analyze_matches(self, matching_algorithm, exact_transformation: RigidTransform):
        """Ground-truth accounting on the matched keypoints' coordinates:
        logs how many matches are incorrect and returns the per-match flags,
        or for ``double`` / ``ratio`` matching the Lowe ratios split into
        correct and incorrect (:mod:`.analysis`)."""
        incorrect = get_incorrect_matches(
            self.scan[self.scan_keypoints[self.matches[0]]],
            self.ref[self.ref_keypoints[self.matches[1]]], exact_transformation,
            device=self.device)
        logger.info("%d incorrect matches out of %d matches and %d descriptors.",
                    incorrect.sum(), len(self.matches[0]), len(self.scan_descriptors))
        if matching_algorithm in ("double", "ratio"):
            return lowe_ratio_split(
                self.scan[self.scan_keypoints], self.ref[self.ref_keypoints],
                exact_transformation, self.scan_descriptors, self.ref_descriptors,
                device=self.device)
        return incorrect

    # ---------------------------------------------------------------- RANSAC --
    def run_ransac(self, *, n_draws: int = 10000, draw_size: int = 4,
                   max_inliers_distance: float = 2, seed: int = 72,
                   exact_transformation: RigidTransform | None = None,
                   draws=None) -> tuple[RigidTransform, float]:
        """RANSAC over the matched keypoints; draws come from a CPU
        generator seeded with ``seed`` (the same on every device and rank),
        or from ``draws`` when given."""
        self.metrics.start("ransac")
        scan_m = as_f32(self.scan[self.scan_keypoints[self.matches[0]]], self.device)
        ref_m = as_f32(self.ref[self.ref_keypoints[self.matches[1]]], self.device)
        generator = torch.Generator().manual_seed(seed)
        mesh = self._mesh()
        if mesh is not None:
            from .parallel.sharded import sharded_ransac

            ratio, transform = sharded_ransac(
                scan_m, ref_m, generator, mesh, draws=draws, n_draws=n_draws,
                draw_size=draw_size, distance_threshold=max_inliers_distance)
        else:
            ratio, transform = ransac_on_matches(
                scan_m, ref_m, generator=generator, draws=draws, n_draws=n_draws,
                draw_size=draw_size, distance_threshold=max_inliers_distance)
        with blocking("ransac.ratio"):
            ratio = float(ratio)
        self.metrics.stop(draws=n_draws)
        if exact_transformation is not None:
            exact = exact_transformation.to(transform.rotation.device)
            logger.info(
                "Norm of the angle between the two rotations: %.2f\n"
                "Norm of the difference between the two translations: %.2f",
                float(rotation_angle(exact.rotation, transform.rotation)),
                float(torch.linalg.norm(exact.translation - transform.translation)))
        return transform, ratio

    # ------------------------------------------------------------------- ICP --
    def run_icp(self, icp_type: Literal["point_to_point", "point_to_plane"],
                transformation_init: RigidTransform, *, d_max: float,
                voxel_size: float = 0.2, max_iter: int = 30,
                rms_threshold: float = 1e-2) -> tuple[RigidTransform, float, bool]:
        if icp_type not in ("point_to_point", "point_to_plane"):
            raise ValueError("Incorrect ICP type selected.")
        self.metrics.start(f"icp[{icp_type}]")
        mesh = self._mesh()
        if mesh is not None:
            from .core.subsampling import grid_subsample
            from .parallel.sharded import sharded_icp

            scan = as_f32(self.scan, self.device)
            sub = torch.as_tensor(grid_subsample(scan, voxel_size), device=scan.device)
            out = IcpHostResult(*sharded_icp(
                scan[sub], self.ref, self.ref_normals if icp_type == "point_to_plane" else None,
                transformation_init, mesh, d_max=d_max, max_iter=max_iter,
                rms_threshold=rms_threshold, point_to_plane=icp_type == "point_to_plane"))
        elif icp_type == "point_to_point":
            out = icp_point_to_point(self.scan, self.ref, transformation_init, d_max=d_max,
                                     voxel_size=voxel_size, max_iter=max_iter,
                                     rms_threshold=rms_threshold, device=self.device)
        else:
            out = icp_point_to_plane(self.scan, self.ref, self.ref_normals,
                                     transformation_init, d_max=d_max,
                                     voxel_size=voxel_size, max_iter=max_iter,
                                     rms_threshold=rms_threshold, device=self.device)
        self.metrics.stop(iterations=out.n_iters)
        logger.info("ICP ran %d/%d iterations (converged: %s).",
                    out.n_iters, max_iter, out.has_converged)
        return out.transform, out.rms, out.has_converged

    # ----------------------------------------------------------------- fused --
    def run_fused(self, *, keypoint_voxel: float, icp_voxel: float, radius: float,
                  descriptor_choice: str = "shot_single_scale", phi: float = 3.0,
                  n_scales: int = 2, fpfh_n_bins: int = 5, ratio_threshold: float = 0.9,
                  ransac_threshold: float = 0.3, d_max: float = 0.3,
                  rms_threshold: float = 1e-4, min_neighborhood_size: int = 10,
                  n_draws: int = 2048, draw_size: int = 4, max_iter: int = 40,
                  point_to_plane: bool = True, seed: int = 72):
        """The whole registration as one device call
        (``registration.fused.register_pair``): keypoints by grid
        subsampling, descriptors, ratio matching, RANSAC and ICP with no
        host round-trip between them but ICP's block reads — the path the
        CLI runs under ``--fused``.

        ``descriptor_choice`` covers the reference's default configs:
        ``shot_single_scale``, ``shot_bi_scale`` (frames at ``radius``, bins
        at ``radius * phi``), ``shot_multiscale`` (scales ``radius * phi**i``
        with shared first-scale frames, concatenated to 352·n_scales
        columns) and ``fpfh``.  With a mesh of more than one rank the
        program shards over it (``registration.fused.fused_registration_mesh``)
        and every rank holds the same result.  Returns the ``FusedResult``;
        the keypoint indices it derived are recorded on the pipeline, so the
        post-ICP metrics see the keypoints the staged path would."""
        from .registration.fused import register_pair

        desc_kwargs = {}
        desc_radius = radius
        if descriptor_choice == "shot_bi_scale":
            desc_kwargs["rf_radius"] = radius
            desc_radius = radius * phi
        elif descriptor_choice in ("shot_multiscale", "shot_multi_scale"):
            desc_kwargs["descriptor"] = "shot_multiscale"
            desc_kwargs["ms_radii"] = tuple(float(radius * phi ** i) for i in range(n_scales))
        elif descriptor_choice == "fpfh":
            desc_kwargs["descriptor"] = "fpfh"
            desc_kwargs["fpfh_n_bins"] = fpfh_n_bins
        elif descriptor_choice != "shot_single_scale":
            raise ValueError(
                f"run_fused does not cover descriptor_choice={descriptor_choice!r}")

        self.metrics.start("fused")
        res = register_pair(
            self.scan, self.scan_normals, self.ref, self.ref_normals,
            keypoint_voxel=keypoint_voxel, icp_voxel=icp_voxel, radius=desc_radius, seed=seed,
            ratio_threshold=ratio_threshold, ransac_threshold=ransac_threshold, d_max=d_max,
            rms_threshold=rms_threshold, k_max=self.k_max_descriptor,
            min_neighborhood_size=min_neighborhood_size, n_draws=n_draws,
            draw_size=draw_size, max_iter=max_iter, point_to_plane=point_to_plane,
            mesh=self._mesh(), device=self.device, **desc_kwargs)
        self.metrics.stop(matches=int(res.n_matches), icp_rms=float(res.icp_rms))
        self.scan_keypoints = res.scan_keypoint_idx
        self.ref_keypoints = res.ref_keypoint_idx
        return res

    # ---------------------------------------------------------------- metrics --
    def compute_metrics_post_icp(self, transformation_icp: RigidTransform,
                                 distance_threshold: float) -> tuple[float, float]:
        """(overlap, keypoint-inlier ratio): the fraction of moved scan
        points, and of moved scan keypoints, within ``distance_threshold`` of
        the ref (keypoints); a grid 1-NN with that cell size above
        ``AUTO_GRID_MIN_POINTS`` targets (exact for a threshold test)."""

        def frac_within(queries: torch.Tensor, targets: torch.Tensor) -> float:
            if targets.shape[0] >= AUTO_GRID_MIN_POINTS:
                dist, _ = grid_nearest_neighbor(
                    build_grid(targets, float(distance_threshold)), queries)
            else:
                dist, _ = nearest_neighbor(queries, targets)
            with blocking("evaluation.share"):
                return float((dist <= distance_threshold).to(torch.float32).mean())

        ref = as_f32(self.ref, self.device)
        moved = transformation_icp.to(ref.device).apply(as_f32(self.scan, ref.device))
        overlap = frac_within(moved, ref)
        with uploading(self.scan_keypoints, ref.device):
            scan_kp = torch.as_tensor(self.scan_keypoints, device=ref.device)
        with uploading(self.ref_keypoints, ref.device):
            ref_kp = torch.as_tensor(self.ref_keypoints, device=ref.device)
        return overlap, frac_within(moved[scan_kp], ref[ref_kp])

    # ---------------------------------------------------- checkpoint/resume --
    def save_state(self, path: str, config_key: str | None = None) -> None:
        """Write keypoints, descriptors and matches to an ``.npz`` with the
        reference's keys, so either package can resume the other's state."""
        state = {}
        for name in _STATE_ARRAYS:
            value = getattr(self, name)
            if value is not None:
                state[name] = (value.cpu().numpy() if isinstance(value, torch.Tensor)
                               else np.asarray(value))
        if self.matches is not None:
            state["matches_scan"] = np.asarray(self.matches[0])
            state["matches_ref"] = np.asarray(self.matches[1])
        if config_key is not None:
            state["config_key"] = np.asarray(config_key)
        np.savez_compressed(path, **state)

    def load_state(self, path: str, config_key: str | None = None) -> bool:
        """Restore a saved state; False (nothing loaded) when it was written
        under a different ``config_key``."""
        data = np.load(path)
        if config_key is not None and "config_key" in data:
            stored = str(data["config_key"])
            if stored != config_key:
                logger.warning(
                    "State cache %s was written under a different pipeline config "
                    "(stored key %s != current %s); ignoring it.",
                    path, stored[:16], config_key[:16])
                return False
        for name in _STATE_ARRAYS:
            if name in data:
                setattr(self, name, data[name])
        if "matches_scan" in data:
            self.matches = (data["matches_scan"], data["matches_ref"])
        return True

    def write_alignments(self, *args: tuple[str, RigidTransform]) -> None:
        """Write (moved scan + ref) stacks with an ``is_scan`` column."""
        is_scan = np.hstack((np.ones(self.scan.shape[0], bool),
                             np.zeros(self.ref.shape[0], bool)))[:, None]
        for file_name, transform in args:
            moved = transform.to("cpu").apply(as_f32(self.scan)).numpy()
            write_ply(file_name, [np.hstack((np.vstack((moved, self.ref)), is_scan))],
                      ["x", "y", "z", "is_scan"])
