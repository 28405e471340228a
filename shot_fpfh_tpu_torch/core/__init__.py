from .solvers import registration_rms, solve_point_to_plane, solve_point_to_point
from .subsampling import (
    grid_subsample,
    grid_subsample_masked,
    voxel_counts_for_representatives,
)
from .transform import (
    RigidTransform,
    euler_xyz_to_matrix,
    matrix_to_quaternion,
    quaternion_to_matrix,
    rotation_angle,
)

__all__ = [
    "RigidTransform",
    "euler_xyz_to_matrix",
    "matrix_to_quaternion",
    "quaternion_to_matrix",
    "rotation_angle",
    "solve_point_to_point",
    "solve_point_to_plane",
    "registration_rms",
    "grid_subsample",
    "grid_subsample_masked",
    "voxel_counts_for_representatives",
]
