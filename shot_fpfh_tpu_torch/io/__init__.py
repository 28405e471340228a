from .ground_truth import (
    get_transform_from_conf_file,
    nn_distance_histogram,
    quaternion_wxyz_to_rotation_matrix,
    read_conf_file,
)
from .ply import get_data, read_ply, write_ply

__all__ = [
    "get_transform_from_conf_file",
    "nn_distance_histogram",
    "quaternion_wxyz_to_rotation_matrix",
    "read_conf_file",
    "get_data",
    "read_ply",
    "write_ply",
]
