"""The base models' training losses: the interaction losses (DM distance
map, JA joint affinity, RO relative facing rotation) and the per-person
geometric losses (VEL velocity, BL bone length, FC foot contact), gated by
``t <= t_bar``; counterpart of ``mixermdm_tpu/diffusion/losses.py``
(reference losses.py:6-314, gaussian_diffusion.py:1367-1415).

Each loss is a function of (prediction, target, mask, timestep mask) that
returns a dict of scalar tensors; the reductions follow the reference's
order (:func:`mix_masked_mse`).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..utils.constants import FACE_JOINT_INDX, GEOMETRIC_LOSS_FIDS, HML_KINEMATIC_CHAIN
from ..utils.normalizer import Normalizer
from ..utils.quaternions import qbetween

INTER_WEIGHTS = {"RO": 0.01, "JA": 3.0, "DM": 3.0}
GEO_WEIGHTS = {"VEL": 30.0, "BL": 10.0, "FC": 30.0}


def _l2(pred, tgt):
    return (pred - tgt) ** 2


def _safe_norm(x, dim=-1, eps=1e-8):
    return torch.sqrt((x ** 2).sum(dim=dim, keepdim=True) + eps)


def seq_masked_mse(pred, tgt, mask):
    """Feature mean, then the mask-weighted mean (losses.py:26-29)."""
    loss = _l2(pred, tgt).mean(dim=-1, keepdim=True)
    return (loss * mask).sum() / (mask.sum() + 1e-7)


def mix_masked_mse(pred, tgt, mask, batch_mask, contact_mask=None, dm_mask=None):
    """The reference's reduction (losses.py:31-41, 167-177): features
    (optionally ``dm_mask``-weighted), then contacts, then time (and
    person), then the batch under the timestep gate ``batch_mask``."""
    if dm_mask is not None:
        loss = (_l2(pred, tgt) * dm_mask).sum(dim=-1, keepdim=True) / (
            dm_mask.sum(dim=-1, keepdim=True) + 1e-7)
    else:
        loss = _l2(pred, tgt).mean(dim=-1, keepdim=True)
    if contact_mask is not None:
        loss = (loss[..., 0] * contact_mask).sum(dim=-1, keepdim=True) / (
            contact_mask.sum(dim=-1, keepdim=True) + 1e-7)
    axes = tuple(range(1, loss.dim()))
    m_axes = tuple(range(1, mask.dim()))
    loss = (loss * mask).sum(dim=axes) / (mask.sum(dim=m_axes) + 1e-7)
    return (loss * batch_mask).sum() / (batch_mask.sum() + 1e-7)


def forward_dir(j):
    """Facing direction of each skeleton (..., J, 3) -> (..., 3): the hip
    vector crossed with the up axis, both normalised with ``_safe_norm``
    (the reference divides by the raw norms, which is NaN on a zero
    prediction)."""
    r_hip, l_hip = FACE_JOINT_INDX[:2]
    across = j[..., r_hip, :] - j[..., l_hip, :]
    across = across / _safe_norm(across)
    y_axis = torch.zeros_like(across)
    y_axis[..., 1] = 1.0
    fwd = torch.linalg.cross(y_axis, across, dim=-1)
    return fwd / _safe_norm(fwd)


def inter_loss(prediction, target, mask, timestep_mask, normalizer: Normalizer,
               nb_joints: int = 22) -> dict:
    """Two-person interaction losses (losses.py:6-129).  ``prediction`` /
    ``target`` (B, T, 2, F) normalised, ``mask`` (B, T, 2, 1)."""
    losses = {"simple": seq_masked_mse(prediction, target, mask)}
    pred, tgt = normalizer.backward(prediction), normalizer.backward(target)
    B, T = pred.shape[:2]
    pred_j = pred[..., :nb_joints * 3].reshape(B, T, 2, nb_joints, 3)
    tgt_j = tgt[..., :nb_joints * 3].reshape(B, T, 2, nb_joints, 3)

    def distance_matrix(j):
        a, b = j[..., 0, :, :], j[..., 1, :, :]
        d = torch.sqrt(((a[..., :, None, :] - b[..., None, :, :]) ** 2).sum(-1) + 1e-12)
        return d.reshape(B, T, 1, nb_joints * nb_joints)

    pred_dm, tgt_dm = distance_matrix(pred_j), distance_matrix(tgt_j)
    dm_mask = (pred_dm < 1.0).to(pred.dtype)
    losses["DM"] = mix_masked_mse(pred_dm, tgt_dm, mask[..., 0:1, :], timestep_mask,
                                  dm_mask=dm_mask) * INTER_WEIGHTS["DM"]
    ja_mask = (tgt_dm < 0.1).to(pred.dtype)
    losses["JA"] = mix_masked_mse(pred_dm, torch.zeros_like(tgt_dm), mask[..., 0:1, :],
                                  timestep_mask, dm_mask=ja_mask) * INTER_WEIGHTS["JA"]

    pred_fwd, tgt_fwd = forward_dir(pred_j), forward_dir(tgt_j)
    pred_rel = qbetween(pred_fwd[..., 0, :], pred_fwd[..., 1, :])
    tgt_rel = qbetween(tgt_fwd[..., 0, :], tgt_fwd[..., 1, :])
    xz = [0, 2]
    losses["RO"] = mix_masked_mse(pred_rel[..., xz], tgt_rel[..., xz], mask[..., 0, :],
                                  timestep_mask) * INTER_WEIGHTS["RO"]
    losses["total"] = losses["simple"] + losses["DM"] + losses["JA"] + losses["RO"]
    return losses


def geometric_loss(prediction, target, mask, timestep_mask, normalizer: Normalizer, name: str,
                   mode: str = "interaction", nb_joints: int = 22) -> dict:
    """Per-person geometric losses (losses.py:133-314): ``prediction`` /
    ``target`` (B, T, F) normalised, ``mask`` (B, T, 1).  In ``individual``
    mode only the simple MSE (losses.py:196-199); ``losses[name]`` is the
    sum of the others."""
    losses = {}
    if mode == "individual":
        losses["simple"] = seq_masked_mse(prediction, target, mask)
    pred, tgt = normalizer.backward(prediction), normalizer.backward(target)
    B, T = pred.shape[:2]
    pred_j = pred[..., :nb_joints * 3].reshape(B, T, nb_joints, 3)
    tgt_j = tgt[..., :nb_joints * 3].reshape(B, T, nb_joints, 3)

    if mode != "individual":
        pred_vel = (pred_j[:, 1:] - pred_j[:, :-1]).reshape(B, T - 1, -1)
        tgt_vel = (tgt_j[:, 1:] - tgt_j[:, :-1]).reshape(B, T - 1, -1)
        losses["VEL"] = mix_masked_mse(pred_vel, tgt_vel, mask[:, :-1],
                                       timestep_mask) * GEO_WEIGHTS["VEL"]

        pairs = [(c[i], c[i + 1]) for c in HML_KINEMATIC_CHAIN for i in range(len(c) - 1)]
        pred_bones = torch.cat([_safe_norm(pred_j[..., a, :] - pred_j[..., b, :])
                                for a, b in pairs], -1)
        tgt_bones = torch.cat([_safe_norm(tgt_j[..., a, :] - tgt_j[..., b, :])
                               for a, b in pairs], -1)
        losses["BL"] = mix_masked_mse(pred_bones, tgt_bones, mask,
                                      timestep_mask) * GEO_WEIGHTS["BL"]

        fids = list(GEOMETRIC_LOSS_FIDS)
        feet_vel = pred_j[:, 1:, fids, :] - pred_j[:, :-1, fids, :]
        feet_h = pred_j[:, :-1, fids, 1]
        velfactor = torch.full((4,), 0.001, device=pred.device)
        heightfactor = torch.tensor([0.12, 0.05, 0.12, 0.05], device=pred.device)
        contact = (((feet_vel ** 2).sum(-1) < velfactor)
                   & (feet_h < heightfactor)).to(pred.dtype)
        losses["FC"] = mix_masked_mse(feet_vel, torch.zeros_like(feet_vel), mask[:, :-1],
                                      timestep_mask, contact_mask=contact) * GEO_WEIGHTS["FC"]

    total = torch.zeros((), device=pred.device)
    for v in losses.values():
        total = total + v
    losses[name] = total
    return losses


def motion_training_losses(model_fn: Callable, s, x_start, t, mask, *, mode: str, t_bar: int,
                           normalizer: Normalizer, noise=None, generator=None) -> dict:
    """The base models' loss (reference MotionDiffusion.training_losses,
    gaussian_diffusion.py:1367-1415): the target normalised, the MSE
    pipeline of :func:`.gaussian.mse_training_losses` (``noise`` or a draw
    from ``generator``), then the geometric losses gated by ``t <= t_bar``.
    ``x_start`` (B, T, F) or (B, T, 2F) raw; ``mask`` (B, T, 2).
    ``mse_per_sample`` (B,) feeds the loss-aware schedule sampler."""
    from .gaussian import mse_training_losses

    B, T = x_start.shape[:2]
    P = 2 if mode == "interaction" else 1
    target = normalizer.forward(x_start.reshape(B, T, P, -1)).reshape(B, T, -1)
    mask4 = mask.reshape(B, T, -1, 1)

    items = mse_training_losses(model_fn, s, target, t, noise=noise, generator=generator)
    pred = items["pred"].reshape(B, T, P, -1)
    tgt = items["target"].reshape(B, T, P, -1)
    timestep_mask = (t <= t_bar).to(x_start.dtype)

    losses = {}
    if mode == "interaction":
        il = inter_loss(pred, tgt, mask4, timestep_mask, normalizer)
        la = geometric_loss(pred[..., 0, :], tgt[..., 0, :], mask4[..., 0, :], timestep_mask,
                            normalizer, "A")
        lb = geometric_loss(pred[..., 1, :], tgt[..., 1, :], mask4[..., 0, :], timestep_mask,
                            normalizer, "B")
        losses.update({f"inter_{k}": v for k, v in il.items()})
        losses.update({f"geo_a_{k}": v for k, v in la.items()})
        losses.update({f"geo_b_{k}": v for k, v in lb.items()})
        losses["total"] = la["A"] + lb["B"] + il["total"]
    else:
        la = geometric_loss(pred[..., 0, :], tgt[..., 0, :], mask4[..., 0, :], timestep_mask,
                            normalizer, "A", mode="individual")
        losses.update({f"geo_a_{k}": v for k, v in la.items()})
        losses["total"] = la["A"]
    losses["mse_per_sample"] = items["mse"]
    return losses
