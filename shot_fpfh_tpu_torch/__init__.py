"""shot_fpfh_tpu_torch — the PyTorch / CUDA port of ``shot_fpfh_tpu``.

Pairwise rigid registration of two point clouds (normals → keypoints →
SHOT or FPFH descriptors → matching → RANSAC → ICP) on one NVIDIA GPU,
with the hot kernels written by hand in CUDA C++ (``csrc/``): SHOT frames +
binning + histogram, descriptor top-2 matching, the streaming radius
covariance behind normals, and the SPFH histogram over a window or over
the grid's xy-row runs.  On CPU tensors every kernel wrapper runs its plain
PyTorch twin instead.  The public entry points run on ``cuda`` unless
given ``device="cpu"`` or CPU tensors.

Module names mirror ``shot_fpfh_tpu`` so each function's reference sits at
the same relative path.  This package never imports JAX.
"""

import torch as _torch

# Geometry (3x3 eigh, Kabsch SVD, squared-distance expansion) is precision
# critical: TF32 keeps ~3 decimal digits, which breaks near-degenerate
# covariances and distance cancellation.  The JAX reference sets "highest"
# matmul precision for the same reason (shot_fpfh_tpu/__init__.py:15).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .core import (  # noqa: E402
    RigidTransform,
    grid_subsample,
    registration_rms,
    rotation_angle,
    solve_point_to_plane,
    solve_point_to_point,
)
from .ops import knn, nearest_neighbor, radius_count, radius_search  # noqa: E402

# the reference's top-level API, imported on first use so that
# ``import shot_fpfh_tpu_torch`` stays light
_LAZY = {
    "RegistrationPipeline": ("shot_fpfh_tpu_torch.pipeline", "RegistrationPipeline"),
    "load_config_from_yaml": ("shot_fpfh_tpu_torch.configuration", "load_config_from_yaml"),
    "compute_normals": ("shot_fpfh_tpu_torch.models.normals", "compute_normals"),
    "get_transform_from_conf_file": ("shot_fpfh_tpu_torch.io.ground_truth",
                                     "get_transform_from_conf_file"),
    "check_transform": ("shot_fpfh_tpu_torch.analysis", "check_transform"),
    "get_incorrect_matches": ("shot_fpfh_tpu_torch.analysis", "get_incorrect_matches"),
    "plot_distance_hists": ("shot_fpfh_tpu_torch.analysis", "plot_distance_hists"),
    "read_ply": ("shot_fpfh_tpu_torch.io.ply", "read_ply"),
    "write_ply": ("shot_fpfh_tpu_torch.io.ply", "write_ply"),
    "get_data": ("shot_fpfh_tpu_torch.io.ply", "get_data"),
    "checkpoint": ("shot_fpfh_tpu_torch.utils.perf", "checkpoint"),
    "timeit": ("shot_fpfh_tpu_torch.utils.perf", "timeit"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(name)


__version__ = "0.1.0"

__all__ = [
    "RigidTransform",
    "grid_subsample",
    "registration_rms",
    "rotation_angle",
    "solve_point_to_plane",
    "solve_point_to_point",
    "knn",
    "nearest_neighbor",
    "radius_count",
    "radius_search",
]
