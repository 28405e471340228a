from ..ops.descriptor_bins import SHOT_DIM
from .fpfh import compute_fpfh_descriptor, compute_spfh
from .normals import (
    compute_normals,
    compute_pca_based_basic_features,
    compute_pca_based_features,
    compute_sphericity,
    local_pca_with_moments,
)
from .shot import (
    ShotComputer,
    compute_shot_descriptor,
    debug_violation_count,
    enable_debug_checks,
    local_reference_frames,
    shot_from_neighborhoods,
)

__all__ = [
    "compute_fpfh_descriptor",
    "compute_spfh",
    "compute_normals",
    "compute_pca_based_basic_features",
    "compute_pca_based_features",
    "compute_sphericity",
    "local_pca_with_moments",
    "SHOT_DIM",
    "ShotComputer",
    "compute_shot_descriptor",
    "debug_violation_count",
    "enable_debug_checks",
    "local_reference_frames",
    "shot_from_neighborhoods",
]
