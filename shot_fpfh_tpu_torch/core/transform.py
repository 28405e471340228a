"""SE(3) rigid transforms and quaternion/Euler conversions on tensors.

Port of ``shot_fpfh_tpu.core.transform``: the same conventions (quaternions
``[x, y, z, w]`` scalar last, the correct SE(3) inverse ``(Rᵀ, -Rᵀ t)``,
composition renormalized through quaternion space), with the JAX pytree
replaced by a small frozen dataclass.  Batched transforms (leading axes on
``rotation``/``translation``) are supported by every method.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) ``[..., 4]`` (x, y, z, w) → rotation matrices ``[..., 3, 3]``
    (the quaternion is normalized first)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``[..., 3, 3]`` → quaternions ``[..., 4]`` (x, y, z, w)
    by branchless Shepperd's method (the largest pivot is selected)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], dim=-1)
    qx = torch.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], dim=-1)
    qy = torch.stack([m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20], dim=-1)
    qz = torch.stack([m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01], dim=-1)
    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(pivots, dim=-1)[..., None]
    q = torch.where(best == 0, qw, torch.where(best == 1, qx, torch.where(best == 2, qy, qz)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def euler_xyz_to_matrix(angles: torch.Tensor) -> torch.Tensor:
    """Extrinsic x-y-z Euler angles ``[..., 3]`` → ``R = Rz(c) Ry(b) Rx(a)``
    (scipy ``from_euler("xyz")``)."""
    a, b, c = angles[..., 0], angles[..., 1], angles[..., 2]
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    m = torch.stack(
        [
            cc * cb, cc * sb * sa - sc * ca, cc * sb * ca + sc * sa,
            sc * cb, sc * sb * sa + cc * ca, sc * sb * ca - cc * sa,
            -sb, cb * sa, cb * ca,
        ],
        dim=-1,
    )
    return m.reshape(angles.shape[:-1] + (3, 3))


@dataclasses.dataclass(frozen=True)
class RigidTransform:
    """An SE(3) transform ``p -> R p + t``; methods return new values."""

    rotation: torch.Tensor
    translation: torch.Tensor

    @staticmethod
    def identity(dtype=torch.float32, batch_shape: tuple = (),
                 device=None) -> "RigidTransform":
        """The identity, broadcast to ``batch_shape`` (on ``cuda`` unless
        ``device`` says otherwise)."""
        dev, batch = resolve(device), tuple(batch_shape)
        rot = torch.eye(3, dtype=dtype, device=dev).expand(batch + (3, 3)).contiguous()
        return RigidTransform(rot, torch.zeros(batch + (3,), dtype=dtype, device=dev))

    @staticmethod
    def from_numpy(rotation, translation, device=None,
                   dtype=torch.float32) -> "RigidTransform":
        """From host arrays (e.g. a JAX transform's ``np.asarray`` fields)."""
        return RigidTransform(
            torch.tensor(np.asarray(rotation), dtype=dtype, device=device),
            torch.tensor(np.asarray(translation), dtype=dtype, device=device),
        )

    def to(self, device) -> "RigidTransform":
        return RigidTransform(self.rotation.to(device), self.translation.to(device))

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Apply to ``[..., N, 3]`` points: ``p Rᵀ + t``."""
        return points @ self.rotation.transpose(-1, -2) + self.translation[..., None, :]

    def __matmul__(self, other: "RigidTransform") -> "RigidTransform":
        """Composition ``self ∘ other`` (other first), rotation renormalized."""
        rot = self.rotation @ other.rotation
        t = torch.einsum("...ij,...j->...i", self.rotation, other.translation) + self.translation
        return RigidTransform(rot, t).normalize_rotation()

    def compose(self, other: "RigidTransform") -> "RigidTransform":
        return self @ other

    def inverse(self) -> "RigidTransform":
        """Correct SE(3) inverse ``(Rᵀ, -Rᵀ t)``."""
        rot_t = self.rotation.transpose(-1, -2)
        return RigidTransform(rot_t, -torch.einsum("...ij,...j->...i", rot_t, self.translation))

    def inv(self) -> "RigidTransform":
        return self.inverse()

    def normalize_rotation(self) -> "RigidTransform":
        """Project the rotation back onto SO(3) via quaternion normalization."""
        return RigidTransform(
            quaternion_to_matrix(matrix_to_quaternion(self.rotation)), self.translation)

    def as_matrix(self) -> torch.Tensor:
        """Homogeneous ``[..., 4, 4]`` matrix."""
        batch = self.rotation.shape[:-2]
        top = torch.cat([self.rotation, self.translation[..., :, None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                              device=top.device).expand(batch + (1, 4))
        return torch.cat([top, bottom], dim=-2)

    def __repr__(self) -> str:  # CloudCompare-pasteable, like the reference
        mat = self.as_matrix().detach().cpu().numpy()
        with np.printoptions(suppress=True):
            return str(mat).replace("[", "").replace("]", "")


def rotation_angle(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between two rotations (the registration error metric)."""
    prod = r1 @ r2.transpose(-1, -2)
    cos = (prod.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    return torch.abs(torch.arccos(torch.clamp(cos, -1.0, 1.0)))
