"""Three-layer config system: YAML defaults → typed dataclasses → CLI overrides.

Framework-free copy of ``shot_fpfh_tpu.configuration``: the same schema and
the same ``config/default.yaml``, so one YAML file drives both packages.
"""

from __future__ import annotations

import json
import warnings
from abc import ABC, abstractmethod
from dataclasses import asdict, dataclass, fields
from typing import Any, Literal, TypedDict

import yaml


@dataclass
class Config(ABC):
    """Recasts mistyped values with a warning, JSON repr — reference behavior
    (configuration.py:14-41)."""

    def __post_init__(self):
        import typing

        try:
            hints = typing.get_type_hints(type(self))
        except Exception:
            hints = {}
        for field in fields(self):
            value = getattr(self, field.name)
            ftype = hints.get(field.name, field.type)
            try:
                if not isinstance(value, ftype):
                    warnings.warn(
                        f"Config field {field.name!r} should be {ftype} but "
                        f"received {value!r} ({type(value).__name__}); "
                        f"recasting."
                    )
                    setattr(self, field.name, ftype(value))
            except TypeError:
                ...

    def __repr__(self) -> str:
        return json.dumps(asdict(self), indent=2)

    @abstractmethod
    def help_message(self) -> str: ...


@dataclass
class KeypointSelectionConfig(Config):
    selection_algorithm: Literal[
        "random", "iterative", "subsampling", "subsampling_with_density"
    ] = "subsampling_with_density"
    neighborhood_size: float | None = None
    min_n_neighbors: int | None = None

    def help_message(self) -> str:
        return (
            f"Keypoint selection: algorithm={self.selection_algorithm}, "
            f"neighborhood_size={self.neighborhood_size}, "
            f"min_n_neighbors={self.min_n_neighbors}"
        )


@dataclass
class DescriptorConfig(Config):
    radius: float = 3.0
    descriptor_choice: Literal[
        "fpfh", "shot_single_scale", "shot_bi_scale", "shot_multiscale"
    ] = "shot_single_scale"
    fpfh_n_bins: int = 5
    phi: float = 3.0
    rho: float = 10.0
    n_scales: int = 2
    subsample_support: bool = True
    normalize: bool = True
    share_local_rfs: bool = True
    min_neighborhood_size: int = 100
    # n_procs is accepted for reference-config compatibility; this build has
    # no process pool (keypoints are one batch on the device).
    n_procs: int = 8

    def help_message(self) -> str:
        if self.descriptor_choice == "fpfh":
            return (
                f"Descriptors: FPFH, radius={self.radius}, "
                f"bins={self.fpfh_n_bins}^3"
            )
        return (
            f"Descriptors: {self.descriptor_choice}, radius={self.radius}, "
            f"min neighborhood={self.min_neighborhood_size}, "
            f"normalize={self.normalize}, "
            f"subsample_support={self.subsample_support}"
        )


@dataclass
class MatchingConfig(Config):
    matching_algorithm: Literal["simple", "double", "threshold", "ratio"] = "simple"
    reject_threshold: float = 0.8
    threshold_multiplier: float = 10

    def help_message(self) -> str:
        return (
            f"Matching: strategy={self.matching_algorithm}, "
            f"reject_threshold={self.reject_threshold} (double/ratio), "
            f"threshold_multiplier={self.threshold_multiplier} (threshold)"
        )


@dataclass
class RansacConfig(Config):
    n_draws: int = 10000
    draw_size: int = 4
    max_inliers_distance: float = 1.0
    seed: int = 72

    def help_message(self) -> str:
        return (
            f"RANSAC: {self.n_draws} draws of size {self.draw_size}, "
            f"inlier distance <= {self.max_inliers_distance}"
        )


@dataclass
class IcpConfig(Config):
    icp_type: Literal["point_to_point", "point_to_plane"] = "point_to_plane"
    d_max: float = 0.5
    voxel_size: float = 0.2
    max_iter: int = 50
    rms_threshold: float = 1e-3

    def help_message(self) -> str:
        return (
            f"ICP: type={self.icp_type}, max_iter={self.max_iter}, "
            f"rms_threshold={self.rms_threshold}, d_max={self.d_max}, "
            f"voxel_size={self.voxel_size}"
        )


@dataclass
class RegistrationEvaluationConfig(Config):
    overlap_threshold: float = 0.6
    distance_to_map_threshold: float = 0.1
    inliers_threshold: float = 0.5

    def help_message(self) -> str:
        return (
            f"Registration accepted when overlap > "
            f"{self.overlap_threshold * 100:.0f}%, distance to map < "
            f"{self.distance_to_map_threshold:g}, and inlier ratio > "
            f"{self.inliers_threshold:.2f}"
        )

    def eval_registration(self, *, overlap: float, distance_to_map: float, inliers) -> bool:
        return (
            overlap > self.overlap_threshold
            and distance_to_map < self.distance_to_map_threshold
            and inliers > self.inliers_threshold
        )


@dataclass
class ComputeConfig(Config):
    """Device-side knobs with no reference counterpart."""

    k_max_descriptor: int = 512   # neighborhood cap for SHOT/local RFs
    k_max_fpfh: int = 128         # neighborhood cap for SPFH
    normals_k: int = 30           # k-NN size for normal estimation
    mesh_axis: str = "points"     # 1-D mesh axis name for sharded stages
    n_devices: int = 0            # mesh ranks: 0 = every rank of the launch, 1 = one device
    debug_nans: bool = False      # NaN check of every op (debug runs)
    debug_shot: bool = False      # SHOT bin/weight sanity checks (debug runs)
    fused: bool = False           # single-program registration path (one device)
    state_cache: str = ""         # npz path for descriptor checkpoint/resume

    def help_message(self) -> str:
        return (
            f"Compute parameters:\n -- SHOT neighborhood cap: {self.k_max_descriptor}\n"
            f" -- FPFH neighborhood cap: {self.k_max_fpfh}\n"
            f" -- normals k: {self.normals_k}\n -- mesh axis: {self.mesh_axis}"
        )


class PipelineConfig(TypedDict):
    keypoint_selection: KeypointSelectionConfig
    descriptor: DescriptorConfig
    matching: MatchingConfig
    ransac: RansacConfig
    icp: IcpConfig
    registration_evaluation: RegistrationEvaluationConfig
    compute: ComputeConfig


_SECTIONS = {
    "keypoint_selection": KeypointSelectionConfig,
    "descriptor": DescriptorConfig,
    "matching": MatchingConfig,
    "ransac": RansacConfig,
    "icp": IcpConfig,
    "registration_evaluation": RegistrationEvaluationConfig,
    "compute": ComputeConfig,
}


def load_config_from_yaml(
    config_file_path: str, command_line_args: dict[str, Any] | None = None
) -> PipelineConfig:
    """YAML → dataclasses, overridden by non-null CLI values
    (reference configuration.py:227-271).  The ``compute`` section is optional
    in reference-era YAML files."""
    command_line_args = command_line_args or {}

    with open(config_file_path) as f:
        config = yaml.safe_load(f.read())["registration"]

    out = {}
    for name, cls in _SECTIONS.items():
        defaults = dict(config.get(name) or {})
        overrides = {
            k: v for k, v in command_line_args.items() if k in {f.name for f in fields(cls)} and v is not None
        }
        out[name] = cls(**{**defaults, **overrides})
    return out  # type: ignore[return-value]
