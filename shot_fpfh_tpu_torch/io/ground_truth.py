"""Stanford .conf ground truth — port of ``shot_fpfh_tpu.io.ground_truth``.

``bmesh`` lines carry a translation then a quaternion in ``q3, q0, q1, q2``
order; the scan→ref transform is ``T_ref⁻¹ ∘ T_scan`` with the correct
SE(3) inverse.  :func:`nn_distance_histogram` checks a candidate transform.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve
from ..core.transform import RigidTransform, quaternion_to_matrix
from ..ops.neighbors import as_f32, nearest_neighbor


def quaternion_wxyz_to_rotation_matrix(quaternion) -> np.ndarray:
    """Stanford quaternion order ``(q3, q0, q1, q2)`` → rotation matrix."""
    q3, q0, q1, q2 = quaternion
    q = torch.tensor([q0, q1, q2, q3], dtype=torch.float64)
    return quaternion_to_matrix(q).numpy()


def read_conf_file(file_path: str) -> dict[str, RigidTransform]:
    """Per-mesh transforms of a Stanford 3D Scanning Repository .conf file."""
    transforms = {}
    with open(file_path) as f:
        for line in f:
            parts = line.split(" ")
            if parts[0] != "bmesh":
                continue
            name = parts[1].replace(".ply", "")
            translation = np.array([float(v) for v in parts[2:5]])
            rotation = quaternion_wxyz_to_rotation_matrix([float(v) for v in parts[5:9]])
            transforms[name] = RigidTransform.from_numpy(rotation, translation)
    return transforms


def get_transform_from_conf_file(conf_file_name: str, scan_file_name: str,
                                 ref_file_name: str) -> RigidTransform:
    """Exact scan→ref transform ``T_ref⁻¹ ∘ T_scan``."""
    conf = read_conf_file(conf_file_name)
    ref_key = ref_file_name.split("/")[-1].replace(".ply", "")
    scan_key = scan_file_name.split("/")[-1].replace(".ply", "")
    return conf[ref_key].inverse() @ conf[scan_key]


def nn_distance_histogram(scan, ref, transformation: RigidTransform, bins: int = 100,
                          device=None):
    """``np.histogram`` of the moved scan's 1-NN distances to the ref under
    a candidate transform: the data of the reference's ``check_transform``
    plot (ground_truth_retrieval.py:51-61)."""
    dev = resolve(device, scan)
    moved = transformation.to(dev).apply(as_f32(scan, dev))
    dist, _ = nearest_neighbor(moved, as_f32(ref, dev))
    return np.histogram(dist.cpu().numpy(), bins=bins)
