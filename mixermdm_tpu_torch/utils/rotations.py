"""Rotation-representation conversions (6d / matrix / axis-angle /
quaternion) on tensors; counterpart of ``mixermdm_tpu/utils/rotations.py``
(the PyTorch3D-style converters the reference vendors,
rotation_conversions.py).  Quaternions are (w, x, y, z).

The 6d layout is the reference's interleaved one, ``[r00, r10, r01, r11,
r02, r12]`` (its modified converter, rotation_conversions.py:527-528), the
layout of every 262-d motion.  Norms are eps-stabilised, so a zero input
(the output of a fresh zero-init denoiser) stays finite; on a
non-degenerate rotation the values are the reference's.
"""

from __future__ import annotations

import torch

from .quaternions import quaternion_to_matrix


def _safe_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v * torch.rsqrt((v * v).sum(-1, keepdim=True) + eps)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) interleaved 6d -> (..., 3, 3), Gram-Schmidt on the two
    deinterleaved columns."""
    a1, a2 = d6[..., 0::2], d6[..., 1::2]
    b1 = _safe_normalize(a1)
    b2 = _safe_normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): the first two rows, interleaved."""
    return m[..., :2, :].transpose(-1, -2).reshape(m.shape[:-2] + (6,))


def _sin_half_over_angle(angles: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    """sin(angle / 2) / angle, with the Taylor form 1/2 - angle^2 / 48 below
    an angle of 1e-6."""
    small = angles.abs() < 1e-6
    safe = torch.where(small, torch.ones_like(angles), angles)
    return torch.where(small, 0.5 - angles * angles / 48.0, torch.sin(half) / safe)


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    angles = torch.sqrt((axis_angle ** 2).sum(-1, keepdim=True) + 1e-24)
    half = angles * 0.5
    return torch.cat([torch.cos(half), axis_angle * _sin_half_over_angle(angles, half)], dim=-1)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    norms = torch.sqrt((q[..., 1:] ** 2).sum(-1, keepdim=True) + 1e-24)
    half = torch.atan2(norms, q[..., :1])
    return q[..., 1:] / _sin_half_over_angle(2.0 * half, half)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(x, 0.0) + 1e-24)


def _copysign(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(b < 0, -a.abs(), a.abs())


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4), the reference's copysign form
    (rotation_conversions.py:98-120): w >= 0, so axis-angle magnitudes land
    in [0, pi]."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    o0 = 0.5 * _sqrt_positive_part(1.0 + m00 + m11 + m22)
    x = 0.5 * _sqrt_positive_part(1.0 + m00 - m11 - m22)
    y = 0.5 * _sqrt_positive_part(1.0 - m00 + m11 - m22)
    z = 0.5 * _sqrt_positive_part(1.0 - m00 - m11 + m22)
    o1 = _copysign(x, m[..., 2, 1] - m[..., 1, 2])
    o2 = _copysign(y, m[..., 0, 2] - m[..., 2, 0])
    o3 = _copysign(z, m[..., 1, 0] - m[..., 0, 1])
    return torch.stack([o0, o1, o2, o3], dim=-1)


def matrix_to_axis_angle(m: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(m))
