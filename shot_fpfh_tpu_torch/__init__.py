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

__version__ = "0.1.0"
