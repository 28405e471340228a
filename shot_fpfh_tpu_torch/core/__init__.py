from .solvers import (
    point_to_plane_normal_eq,
    point_to_point_stats,
    registration_rms,
    solve_point_to_plane,
    solve_point_to_plane_from_normal_eq,
    solve_point_to_point,
    solve_point_to_point_from_stats,
)
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
    "solve_point_to_point_from_stats",
    "point_to_point_stats",
    "solve_point_to_plane",
    "solve_point_to_plane_from_normal_eq",
    "point_to_plane_normal_eq",
    "registration_rms",
    "grid_subsample",
    "grid_subsample_masked",
    "voxel_counts_for_representatives",
]
