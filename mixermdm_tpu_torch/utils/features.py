"""Host-side motion feature pipeline (numpy): raw joints -> 262-d vectors.

This package's own copy of the numpy parts of
``mixermdm_tpu/utils/features.py`` that the InterHuman dataset calls
(reference utils/utils.py: ``process_motion_interhuman``:92,
``swap_left_right``:231, ``rigid_transform``:244).  It runs in the input
pipeline on the CPU, as the reference runs it in ``Dataset.__getitem__``.
"""

from __future__ import annotations

import numpy as np

from .constants import FACE_JOINT_INDX, FID_L, FID_R

TRANS_MATRIX = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]], dtype=np.float64)


def qbetween_np(v0: np.ndarray, v1: np.ndarray) -> np.ndarray:
    v = np.cross(v0, v1)
    w = (np.sqrt((v0 ** 2).sum(axis=-1, keepdims=True) * (v1 ** 2).sum(axis=-1, keepdims=True))
         + (v0 * v1).sum(axis=-1, keepdims=True) + 1e-8)
    q = np.concatenate([w, v], axis=-1)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def qrot_np(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    qvec = q[..., 1:]
    uv = np.cross(qvec, v)
    uuv = np.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qinv_np(q: np.ndarray) -> np.ndarray:
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def qmul_np(q: np.ndarray, r: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    return np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], axis=-1)


def _foot_detect(positions: np.ndarray, thres: float):
    """Foot contacts from squared foot displacement + height (utils.py:128-144)."""
    velfactor = np.array([thres, thres])
    heightfactor = np.array([0.12, 0.05])

    def contacts(fid):
        d2 = ((positions[1:, fid] - positions[:-1, fid]) ** 2).sum(axis=-1)
        h = positions[:-1, fid, 1]
        return ((d2 < velfactor) & (h < heightfactor)).astype(np.float32)

    return contacts(list(FID_L)), contacts(list(FID_R))


def process_motion_interhuman(motion: np.ndarray, feet_thre: float, prev_frames: int,
                              n_joints: int, flip: bool = True):
    """Raw (T, n_joints*3 + rot) -> (T-1, 262) canonical feature vectors, and
    the root quaternion and XZ root position it was canonicalised by
    (utils.py:92-160): floor grounding, XZ origin at the ``prev_frames``
    root, facing Z+, foot contacts, ``[pos | vel | rot6d | contacts]`` with
    the last frame dropped."""
    positions = motion[:, : n_joints * 3].reshape(-1, n_joints, 3)
    rotations = motion[:, n_joints * 3:]
    if flip:
        positions = np.einsum("mn, tjn->tjm", TRANS_MATRIX, positions)
    floor_height = positions.min(axis=0).min(axis=0)[1]
    positions = positions.copy()
    positions[:, :, 1] -= floor_height

    root_pos_init = positions[prev_frames]
    root_pos_init_xz = root_pos_init[0] * np.array([1, 0, 1])
    positions = positions - root_pos_init_xz

    r_hip, l_hip, _, _ = FACE_JOINT_INDX
    across = root_pos_init[r_hip] - root_pos_init[l_hip]
    across = across / np.sqrt((across ** 2).sum(axis=-1) + 1e-12)[..., np.newaxis]
    forward_init = np.cross(np.array([[0, 1, 0]]), across, axis=-1)
    forward_init = forward_init / np.sqrt((forward_init ** 2).sum(axis=-1) + 1e-12)[..., np.newaxis]
    root_quat_init = qbetween_np(forward_init, np.array([[0, 0, 1]]))
    positions = qrot_np(np.ones(positions.shape[:-1] + (4,)) * root_quat_init, positions)

    feet_l, feet_r = _foot_detect(positions, feet_thre)
    joint_positions = positions.reshape(len(positions), -1)
    joint_vels = (positions[1:] - positions[:-1]).reshape(len(positions) - 1, -1)
    data = np.concatenate([joint_positions[:-1], joint_vels, rotations[:-1], feet_l, feet_r],
                          axis=-1)
    return data, root_quat_init, root_pos_init_xz[None]


def swap_left_right(data: np.ndarray, n_joints: int) -> np.ndarray:
    """Mirror a (T, n_joints*3 + k*6) motion left <-> right (utils.py:231-241)."""
    T = data.shape[0]
    positions = data[..., : 3 * n_joints].reshape(T, n_joints, 3).copy()
    rotations = data[..., 3 * n_joints:].reshape(T, -1, 6).copy()
    positions[..., 0] *= -1
    right_chain = [2, 5, 8, 11, 14, 17, 19, 21]
    left_chain = [1, 4, 7, 10, 13, 16, 18, 20]
    tmp = positions[:, right_chain].copy()
    positions[:, right_chain] = positions[:, left_chain]
    positions[:, left_chain] = tmp
    rotations[..., [1, 2, 4]] *= -1
    r_rot = (np.array(right_chain) - 1).tolist()
    l_rot = (np.array(left_chain) - 1).tolist()
    tmp = rotations[:, r_rot].copy()
    rotations[:, r_rot] = rotations[:, l_rot]
    rotations[:, l_rot] = tmp
    return np.concatenate([positions.reshape(T, -1), rotations.reshape(T, -1)], axis=-1)


def rigid_transform(relative: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Person 2 into person 1's frame (utils.py:244-258): ``relative`` is
    [rot_angle_y, tx, tz], ``data`` (..., 262)."""
    data = data.copy()
    lead = data.shape[:-1]
    pos = data[..., : 22 * 3].reshape(lead + (22, 3))
    vel = data[..., 22 * 3: 22 * 6].reshape(lead + (22, 3))
    quat = np.zeros(pos.shape[:-1] + (4,))
    quat[..., 0] = np.cos(relative[0])
    quat[..., 2] = np.sin(relative[0])
    pos = qrot_np(qinv_np(quat), pos)
    pos[..., [0, 2]] += relative[1:3]
    data[..., : 22 * 3] = pos.reshape(lead + (66,))
    data[..., 22 * 3: 22 * 6] = qrot_np(qinv_np(quat), vel).reshape(lead + (66,))
    return data
