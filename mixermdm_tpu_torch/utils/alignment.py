"""Per-step geometry of the mixer chain on (B, T, 262) motions, f32.

Counterpart of the functions of ``mixermdm_tpu/utils/alignment.py`` that the
sampling chain calls: :func:`orthonormalize_rot6d`, :func:`center_person_fast`,
:func:`align_persons_fast` and :func:`align_trajectories`.  They run on the
card as plain tensor code (small elementwise work, no kernel of their own).
"""

from __future__ import annotations

from typing import Optional

import torch

from .constants import FACE_JOINT_INDX
from .quaternions import qbetween, qrot


def _unit(v: torch.Tensor, eps: float) -> torch.Tensor:
    return v / torch.sqrt((v ** 2).sum(-1, keepdim=True) + eps)


# The constant vectors below are built on the tensors' device from their own
# components: a Python-list constant would be a host-to-device copy, which
# synchronises the host with the card once per call inside the DDIM step.

def _xz(v: torch.Tensor) -> torch.Tensor:
    """v with its vertical (y) component zeroed."""
    return torch.stack([v[..., 0], torch.zeros_like(v[..., 1]), v[..., 2]], dim=-1)


def _facing(across: torch.Tensor) -> torch.Tensor:
    """cross(up, across) for up = +y, i.e. (a_z, 0, -a_x), exactly."""
    return torch.stack([across[..., 2], torch.zeros_like(across[..., 1]), -across[..., 0]],
                       dim=-1)


def _plus_z(like: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(like)
    z[..., 2] = 1.0
    return z


def orthonormalize_rot6d(motion: torch.Tensor) -> torch.Tensor:
    """Replace the 126 rot6d dims by their Gram-Schmidt projection (the
    interleaved [r00, r10, r01, r11, r02, r12] on-disk layout)."""
    lead = motion.shape[:-1]
    rot = motion[..., 132:258].reshape(lead + (21, 6))
    a1, a2 = rot[..., 0::2], rot[..., 1::2]
    b1 = a1 * torch.rsqrt((a1 * a1).sum(-1, keepdim=True) + 1e-12)
    a2p = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2p * torch.rsqrt((a2p * a2p).sum(-1, keepdim=True) + 1e-12)
    rot = torch.stack([b1, b2], dim=-1).reshape(lead + (126,))
    return torch.cat([motion[..., :132], rot, motion[..., 258:]], dim=-1)


def center_person_fast(motion: torch.Tensor) -> torch.Tensor:
    """``smpl_to_ih(center_motion(ih_to_smpl(x)))`` on (B, T, 262): floor at
    zero, first root at the XZ origin facing Z+, rotations orthonormalised,
    contacts zeroed (the reference chain's contact-drop quirk)."""
    B, T = motion.shape[:2]
    pos = motion[..., :66].reshape(B, T, 22, 3)
    vel = motion[..., 66:132].reshape(B, T, 22, 3)

    floor = pos[..., 1].amin(dim=(1, 2))
    pos = pos - torch.stack([torch.zeros_like(floor), floor, torch.zeros_like(floor)],
                            -1)[:, None, None, :]
    root_init = pos[:, 0]
    pos = pos - _xz(root_init[:, 0])[:, None, None, :]

    r_hip, l_hip = FACE_JOINT_INDX[:2]
    across = _unit(root_init[:, r_hip] - root_init[:, l_hip], 1e-12)
    forward = _unit(_facing(across), 1e-12)
    root_quat = qbetween(forward, _plus_z(forward))[:, None, None, :]
    pos = qrot(root_quat, pos)
    vel = qrot(root_quat, vel)

    rot = orthonormalize_rot6d(motion)[..., 132:258]
    contacts = motion.new_zeros(B, T, 4)
    return torch.cat([pos.reshape(B, T, 66), vel.reshape(B, T, 66), rot, contacts], dim=-1)


def align_trajectories(t1: torch.Tensor, t2: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Heading quaternion (B, 1, 1, 4) rotating root trajectory t2 onto t1
    (both (B, T, 3)), from the first to the last valid frame."""
    B, T = t1.shape[:2]
    if mask is None:
        v1 = t1[:, -1] - t1[:, 0]
        v2 = t2[:, -1] - t2[:, 0]
    else:
        lengths = mask.reshape(B, T, -1)[..., 0].sum(dim=1).to(torch.long)
        idx = (lengths - 1).clamp(0, T - 1)
        ar = torch.arange(B, device=t1.device)
        v1 = t1[ar, idx] - t1[:, 0]
        v2 = t2[ar, idx] - t2[:, 0]
    v1 = _unit(_xz(v1), 1e-8)
    v2 = _unit(_xz(v2), 1e-8)
    return qbetween(v2, v1)[:, None, None, :]


def align_persons_fast(ref262: torch.Tensor, mov262: torch.Tensor,
                       mask: Optional[torch.Tensor] = None):
    """The mixer's per-step ``ih_to_smpl -> align_motions -> smpl_to_ih`` on
    (B, T, 262) streams.  Returns ``(ref_out, mov_out)``: the moving stream
    position- and heading-aligned onto the reference with contacts zeroed,
    the reference passed through with rotations orthonormalised."""
    B, T = ref262.shape[:2]
    pos_r = ref262[..., :66].reshape(B, T, 22, 3)
    pos_m = mov262[..., :66].reshape(B, T, 22, 3)
    vel_m = mov262[..., 66:132].reshape(B, T, 22, 3)

    pos_m = pos_m + (pos_r[:, 0, 0] - pos_m[:, 0, 0])[:, None, None, :]
    alignment = align_trajectories(pos_r[:, :, 0], pos_m[:, :, 0], mask)
    pos_m = qrot(alignment, pos_m)
    pos_m = pos_m + (pos_r[:, 0, 0] - pos_m[:, 0, 0])[:, None, None, :]
    vel_m = qrot(alignment, vel_m)

    mov_rot = orthonormalize_rot6d(mov262)[..., 132:258]
    mov_out = torch.cat([pos_m.reshape(B, T, 66), vel_m.reshape(B, T, 66), mov_rot,
                         mov262.new_zeros(B, T, 4)], dim=-1)
    return orthonormalize_rot6d(ref262), mov_out
