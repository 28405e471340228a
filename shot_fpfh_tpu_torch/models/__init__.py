from .fpfh import compute_fpfh_descriptor, compute_spfh
from .normals import (
    compute_normals,
    compute_pca_based_basic_features,
    compute_pca_based_features,
    compute_sphericity,
    local_pca_with_moments,
)
from .shot import ShotComputer, compute_shot_descriptor

__all__ = ["compute_fpfh_descriptor", "compute_spfh", "compute_normals",
           "compute_pca_based_basic_features", "compute_pca_based_features",
           "compute_sphericity", "local_pca_with_moments", "ShotComputer",
           "compute_shot_descriptor"]
