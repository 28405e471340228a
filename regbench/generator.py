"""The one traffic generator: scan/ref pairs of a synthetic terrain, made
from a mix's parameters (``traffic/<name>.json``) and the run's seed.

The ref is ``points`` points with xy uniform in ``[-extent, extent]²`` and
z a sum of ``amp·sin(fx·x + px)·cos(fy·y + py)`` octaves, plus Gaussian
noise of ``noise`` on every coordinate.  The scan is the ref moved by a
rigid motion, plus its own noise of ``noise``: ``scan = (ref − t) R``, so
the motion that registers the scan onto the ref is ``p ↦ p Rᵀ + t``.  The
motion's magnitudes are fixed by the mix (the rotation angle of
``motion.rotation_angle_of_euler_xyz``, extrinsic x-y-z, and the norm of
``motion.translation_norm_of``); its axis and direction come from the seed.
Every seed therefore gives pairs of the same size and the same motion
magnitude: the seed changes where the points fall, not how much work a
pair is.

Clouds are drawn on ``device`` with a ``torch.Generator`` there in float64,
rounded to float32 (the precision a ``.ply`` of float32 fields holds) and
handed over as float64 host arrays, as ``io.ply.get_data`` hands a file's
points to the pipeline.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Pair:
    """One scan/ref pair and the motion that registers the scan onto it."""

    scan: np.ndarray          # (N, 3) float64 host array (float32 values)
    ref: np.ndarray           # (N, 3) float64 host array (float32 values)
    rotation: np.ndarray      # (3, 3) float64: ref ≈ scan Rᵀ + t
    translation: np.ndarray   # (3,) float64


def euler_xyz(angles) -> np.ndarray:
    """Extrinsic x-y-z Euler angles as a float64 rotation matrix (Rz Ry Rx)."""
    ax, ay, az = (float(a) for a in angles)
    cx, sx, cy, sy, cz, sz = (math.cos(ax), math.sin(ax), math.cos(ay), math.sin(ay),
                              math.cos(az), math.sin(az))
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def rotation_angle(rot: np.ndarray) -> float:
    """The angle of a rotation matrix, in radians."""
    return float(math.acos(max(-1.0, min(1.0, (float(np.trace(rot)) - 1.0) / 2.0))))


def axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rotation by ``angle`` about the unit ``axis`` (Rodrigues)."""
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + math.sin(angle) * k + (1 - math.cos(angle)) * (k @ k)


def pair_seed(seed: int, index: int) -> int:
    """The generator seed of pool pair ``index`` of run seed ``seed``."""
    return (int(seed) * 1_000_003 + 7_919 * int(index) + 1) % (1 << 63)


def make_pair(traffic: dict, seed: int, index: int, device) -> Pair:
    """Pool pair ``index`` of the mix for run seed ``seed``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(pair_seed(seed, index))
    n, extent, noise = int(traffic["points"]), float(traffic["extent"]), float(traffic["noise"])
    f64 = dict(dtype=torch.float64, device=dev)
    xy = (torch.rand((n, 2), generator=gen, **f64) * 2.0 - 1.0) * extent
    z = torch.zeros(n, **f64)
    for amp, fx, px, fy, py in traffic["surface"]:
        z += amp * torch.sin(fx * xy[:, 0] + px) * torch.cos(fy * xy[:, 1] + py)
    ref = torch.cat([xy, z[:, None]], dim=1)
    ref = (ref + noise * torch.randn((n, 3), generator=gen, **f64)).float().double()

    motion = traffic["motion"]
    angle = rotation_angle(euler_xyz(motion["rotation_angle_of_euler_xyz"]))
    t_norm = float(np.linalg.norm(motion["translation_norm_of"]))
    dirs = torch.randn((2, 3), generator=gen, **f64).cpu().numpy()
    axis = dirs[0] / np.linalg.norm(dirs[0])
    rot = axis_angle(axis, angle)
    t = dirs[1] / np.linalg.norm(dirs[1]) * t_norm
    rot_t = torch.as_tensor(rot, **f64)
    t_t = torch.as_tensor(t, **f64)
    scan = (ref - t_t) @ rot_t + noise * torch.randn((n, 3), generator=gen, **f64)
    scan = scan.float().double()
    return Pair(scan=scan.cpu().numpy(), ref=ref.cpu().numpy(), rotation=rot, translation=t)


def make_pool(traffic: dict, seed: int, device) -> list[Pair]:
    """The mix's ``pool`` pairs for run seed ``seed``, cycled through the
    window."""
    return [make_pair(traffic, seed, i, device) for i in range(int(traffic["pool"]))]
