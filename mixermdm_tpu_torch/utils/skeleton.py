"""Skeleton forward and inverse kinematics over the HumanML3D chain, and the
retargeting onto a canonical skeleton; counterpart of
``mixermdm_tpu/utils/skeleton.py`` (reference utils/skeleton.py: offsets
:45-64, IK :67-105, FK :108-197, ``uniform_skeleton``:199).  Host-side
numpy, as the data preparation that calls it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import FACE_JOINT_INDX, HML_KINEMATIC_CHAIN, HML_RAW_OFFSETS
from .features import qbetween_np, qinv_np, qmul_np, qrot_np

# The offsets whose lengths give the leg scale: left hip and left knee
# (reference paramUtil L_IDX1 / L_IDX2).
L_IDX1, L_IDX2 = 5, 8


@dataclasses.dataclass
class Skeleton:
    raw_offsets: np.ndarray = dataclasses.field(default_factory=lambda: HML_RAW_OFFSETS.copy())
    kinematic_tree: tuple = HML_KINEMATIC_CHAIN

    def __post_init__(self):
        parents = [0] * len(self.raw_offsets)
        parents[0] = -1
        for chain in self.kinematic_tree:
            for j in range(1, len(chain)):
                parents[chain[j]] = chain[j - 1]
        self.parents = parents
        self.offset: np.ndarray | None = None

    @property
    def njoints(self) -> int:
        return len(self.raw_offsets)

    def offsets_from_joints(self, joints: np.ndarray) -> np.ndarray:
        """The unit offsets scaled by the bone lengths of one pose (J, 3)
        (reference :55-64); kept as the skeleton's offsets."""
        offsets = self.raw_offsets.astype(np.float64).copy()
        for i in range(1, self.njoints):
            offsets[i] = np.linalg.norm(joints[i] - joints[self.parents[i]]) * offsets[i]
        self.offset = offsets
        return offsets

    def inverse_kinematics(self, joints: np.ndarray, face_joint_idx=FACE_JOINT_INDX,
                           smooth_forward: bool = False) -> np.ndarray:
        """(T, J, 3) positions -> (T, J, 4) local quaternions (reference
        :67-105): the root's rotation turns each frame to face Z+ (frame 0
        keeps the identity)."""
        l_hip, r_hip, sdr_r, sdr_l = face_joint_idx
        across = (joints[:, r_hip] - joints[:, l_hip]) + (joints[:, sdr_r] - joints[:, sdr_l])
        across = across / np.sqrt((across ** 2).sum(-1) + 1e-12)[:, None]
        forward = np.cross(np.array([[0, 1, 0]]), across, axis=-1)
        if smooth_forward:
            from scipy.ndimage import gaussian_filter1d

            forward = gaussian_filter1d(forward, 20, axis=0, mode="nearest")
        forward = forward / np.sqrt((forward ** 2).sum(-1) + 1e-12)[..., None]
        target = np.tile(np.array([[0.0, 0.0, 1.0]]), (len(forward), 1))
        root_quat = qbetween_np(forward, target)
        root_quat[0] = np.array([1.0, 0.0, 0.0, 0.0])

        quat_params = np.zeros(joints.shape[:-1] + (4,))
        quat_params[:, 0] = root_quat
        for chain in self.kinematic_tree:
            R = root_quat
            for j in range(len(chain) - 1):
                u = np.tile(self.raw_offsets[chain[j + 1]][None], (len(joints), 1)) \
                    .astype(np.float64)
                v = joints[:, chain[j + 1]] - joints[:, chain[j]]
                v = v / np.sqrt((v ** 2).sum(-1) + 1e-12)[:, None]
                R_loc = qmul_np(qinv_np(R), qbetween_np(u, v))
                quat_params[:, chain[j + 1]] = R_loc
                R = qmul_np(R, R_loc)
        return quat_params

    def forward_kinematics(self, quat_params: np.ndarray, root_pos: np.ndarray,
                           do_root_rotation: bool = True) -> np.ndarray:
        """(T, J, 4) local quaternions + (T, 3) root -> (T, J, 3) positions
        on the skeleton's offsets (reference :130-152)."""
        if self.offset is None:
            raise ValueError("set the offsets first (offsets_from_joints)")
        T = quat_params.shape[0]
        joints = np.zeros(quat_params.shape[:-1] + (3,))
        joints[:, 0] = root_pos
        for chain in self.kinematic_tree:
            R = quat_params[:, 0] if do_root_rotation else np.tile(
                np.array([[1.0, 0, 0, 0]]), (T, 1))
            for i in range(1, len(chain)):
                R = qmul_np(R, quat_params[:, chain[i]])
                offset_vec = np.tile(self.offset[chain[i]][None], (T, 1))
                joints[:, chain[i]] = qrot_np(R, offset_vec) + joints[:, chain[i - 1]]
        return joints


def uniform_skeleton(positions: np.ndarray, target_offsets: np.ndarray | None = None,
                     target_skeleton_path: str | None = None) -> np.ndarray:
    """A motion (T, J, 3) retargeted onto a canonical skeleton (reference
    :199-235): ``target_offsets`` (J, 3), or those of the first pose of the
    raw motion at ``target_skeleton_path``.  The root scaled by the ratio of
    leg lengths, then IK on the source and FK on the target offsets."""
    skel = Skeleton()
    if target_offsets is None:
        if target_skeleton_path is None:
            raise ValueError("need target_offsets or target_skeleton_path")
        example = np.load(target_skeleton_path).reshape(-1, skel.njoints, 3)
        target_offsets = Skeleton().offsets_from_joints(example[0])
    src_offsets = Skeleton().offsets_from_joints(positions[0])
    src_leg = np.abs(src_offsets[L_IDX1]).max() + np.abs(src_offsets[L_IDX2]).max()
    tgt_leg = np.abs(target_offsets[L_IDX1]).max() + np.abs(target_offsets[L_IDX2]).max()
    quat_params = skel.inverse_kinematics(positions)
    skel.offset = np.asarray(target_offsets, np.float64)
    return skel.forward_kinematics(quat_params, positions[:, 0] * (tgt_leg / src_leg))
