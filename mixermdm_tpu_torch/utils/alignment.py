"""Geometry of 262-d motions, f32; counterpart of
``mixermdm_tpu/utils/alignment.py``.

The mixer chain's per-step functions: :func:`orthonormalize_rot6d`,
:func:`center_person_fast`, :func:`align_persons_fast` and
:func:`align_trajectories`.  The reference chain the evaluation centres its
persons with (reference alignment.py:11-222): :func:`ih_to_smpl` (262-d
InterHuman -> 205-d SMPL: positions, velocities, 23 axis-angle joints, the
last two zero, contacts), :func:`smpl_to_ih`, :func:`align_motions` and
:func:`center_motion`.  The last two return 201-d tensors, the contacts
dropped, so a following :func:`smpl_to_ih` reads its "contacts" from the
zero hand joints: contacts come out as zeros, as upstream.  All run on the
card as plain tensor code (small elementwise work, no kernel of their own).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from .constants import FACE_JOINT_INDX
from .quaternions import qbetween, qrot
from .rotations import axis_angle_to_matrix, matrix_to_axis_angle, matrix_to_rotation_6d, \
    rotation_6d_to_matrix


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


def _canonical_frame(motion: torch.Tensor):
    """The positions and velocities (B, T, 66 each) of (B, T, >= 132)
    motions with the floor at zero, the first root at the XZ origin, facing
    Z+ at the first frame (reference alignment.py:161-222; the hip and
    facing norms eps-stabilised, so that a zero pose stays finite)."""
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
    return qrot(root_quat, pos).reshape(B, T, 66), qrot(root_quat, vel).reshape(B, T, 66)


def center_person_fast(motion: torch.Tensor) -> torch.Tensor:
    """``smpl_to_ih(center_motion(ih_to_smpl(x)))`` on (B, T, 262): floor at
    zero, first root at the XZ origin facing Z+, rotations orthonormalised,
    contacts zeroed (the reference chain's contact-drop quirk)."""
    pos, vel = _canonical_frame(motion)
    rot = orthonormalize_rot6d(motion)[..., 132:258]
    return torch.cat([pos, vel, rot, motion.new_zeros(motion.shape[:2] + (4,))], dim=-1)


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


def _aligned(motion1: torch.Tensor, motion2: torch.Tensor, mask: Optional[torch.Tensor]):
    """The positions and velocities (B, T, 66 each) of motion2 moved onto
    motion1: the first roots together, the heading of the root trajectory
    turned onto motion1's, the first roots together again (reference
    alignment.py:108-158)."""
    B, T = motion1.shape[:2]
    pos_r = motion1[..., :66].reshape(B, T, 22, 3)
    pos_m = motion2[..., :66].reshape(B, T, 22, 3)
    vel_m = motion2[..., 66:132].reshape(B, T, 22, 3)

    pos_m = pos_m + (pos_r[:, 0, 0] - pos_m[:, 0, 0])[:, None, None, :]
    alignment = align_trajectories(pos_r[:, :, 0], pos_m[:, :, 0], mask)
    pos_m = qrot(alignment, pos_m)
    pos_m = pos_m + (pos_r[:, 0, 0] - pos_m[:, 0, 0])[:, None, None, :]
    return pos_m.reshape(B, T, 66), qrot(alignment, vel_m).reshape(B, T, 66)


def align_persons_fast(ref262: torch.Tensor, mov262: torch.Tensor,
                       mask: Optional[torch.Tensor] = None):
    """The mixer's per-step ``ih_to_smpl -> align_motions -> smpl_to_ih`` on
    (B, T, 262) streams.  Returns ``(ref_out, mov_out)``: the moving stream
    position- and heading-aligned onto the reference with contacts zeroed,
    the reference passed through with rotations orthonormalised."""
    pos_m, vel_m = _aligned(ref262, mov262, mask)
    mov_rot = orthonormalize_rot6d(mov262)[..., 132:258]
    mov_out = torch.cat([pos_m, vel_m, mov_rot, mov262.new_zeros(mov262.shape[:2] + (4,))],
                        dim=-1)
    return orthonormalize_rot6d(ref262), mov_out


def ih_to_smpl(motion: torch.Tensor) -> torch.Tensor:
    """(..., T, 262) InterHuman -> (..., T, 205) SMPL layout: the 21 6d
    rotations as negated axis-angles, two zero hand joints, the contacts."""
    lead = motion.shape[:-1]
    rot6d = motion[..., 132:258].reshape(lead + (21, 6))
    poses = -matrix_to_axis_angle(rotation_6d_to_matrix(rot6d))
    return torch.cat([motion[..., :132], poses.reshape(lead + (63,)),
                      motion.new_zeros(lead + (6,)), motion[..., -4:]], dim=-1)


def smpl_to_ih(motion: torch.Tensor) -> torch.Tensor:
    """(..., T, >= 201) SMPL -> (..., T, 262): 23 axis-angle joints at
    [132:201] (the two hand joints dropped), and the trailing 4 dims as
    contacts, which on the 201-d output of :func:`center_motion` /
    :func:`align_motions` are the zero hand joints (reference
    alignment.py:41-67)."""
    lead = motion.shape[:-1]
    axis_angles = motion[..., 132:201].reshape(lead + (23, 3))
    poses = matrix_to_rotation_6d(axis_angle_to_matrix(-axis_angles))
    return torch.cat([motion[..., :132], poses.reshape(lead + (138,))[..., :126],
                      motion[..., -4:]], dim=-1)


def align_motions(motion1: torch.Tensor, motion2: torch.Tensor,
                  mask: Optional[torch.Tensor] = None):
    """Position- and heading-align motion2 onto motion1, both (B, T, >= 201)
    SMPL; returns ``(motion1, motion2 aligned)``, the second 201-d
    (reference alignment.py:108-158)."""
    pos, vel = _aligned(motion1, motion2, mask)
    return motion1, torch.cat([pos, vel, motion2[..., 132:201]], dim=-1)


@contextlib.contextmanager
def geometry_batch_scope(mesh=None, data_axis: str = "data", model_axis: str = "model"):
    """The JAX package's ``geometry_batch_scope``: there it pins the chain's
    geometry tensors to batch-over-data sharding under a dp x tp mesh, so
    the partitioner does not reshard them along the model axis.  Here every
    rank of a model group holds the same rows whole (the tensor-parallel
    modules give back replicated outputs), so the geometry runs on those
    rows as it is: the scope is the identity, kept so the sampling paths
    read as the JAX package's do."""
    yield


def center_motion(motion: torch.Tensor) -> torch.Tensor:
    """(B, T, >= 201) SMPL -> (B, T, 201) in its canonical frame
    (:func:`_canonical_frame`); contacts dropped (reference
    alignment.py:161-222)."""
    return torch.cat([*_canonical_frame(motion), motion[..., 132:201]], dim=-1)
