"""Quaternion math on tensors (w, x, y, z convention), the functions the
alignment path needs; counterpart of ``mixermdm_tpu/utils/quaternions.py``."""

from __future__ import annotations

import torch


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4) (the
    two-cross-product form of the reference)."""
    qvec = q[..., 1:].expand(v.shape)
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qbetween(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """Quaternion rotating v0 onto v1, with the reference's 1e-8 stabiliser
    on the scalar part."""
    v = torch.linalg.cross(v0, v1, dim=-1)
    w = (
        torch.sqrt((v0 ** 2).sum(-1, keepdim=True) * (v1 ** 2).sum(-1, keepdim=True) + 1e-24)
        + (v0 * v1).sum(-1, keepdim=True)
        + 1e-8
    )
    return qnormalize(torch.cat([w, v], dim=-1))


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion -> (..., 3, 3) rotation matrix (the JAX
    package's ``quaternion_to_matrix``, 2 / |q|^2 scaled)."""
    w, x, y, z = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1)
    m = torch.stack([
        1 - two_s * (y * y + z * z), two_s * (x * y - z * w), two_s * (x * z + y * w),
        two_s * (x * y + z * w), 1 - two_s * (x * x + z * z), two_s * (y * z - x * w),
        two_s * (x * z - y * w), two_s * (y * z + x * w), 1 - two_s * (x * x + y * y),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))
