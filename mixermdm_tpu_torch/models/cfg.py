"""Classifier-free guidance over a stacked batch; counterpart of
``mixermdm_tpu/models/cfg.py`` (reference cfg_sampler.py:5-150).

Each wrapper runs its model(s) once on the cond and uncond rows stacked in
the batch and combines the halves.
"""

from __future__ import annotations

from typing import Callable

import torch


def _cat(t, n: int):
    return None if t is None else torch.cat([t] * n, 0)


def cfg_model(model_fn: Callable, scale: float) -> Callable:
    """``scale * cond + (1 - scale) * uncond`` over a doubled batch, the
    uncond branch's cond zeroed (cfg_sampler.py:5-28).  ``model_fn(x, t,
    mask, cond)``; returns ``fn(x, t, mask, cond)``."""

    def fn(x, timesteps, mask=None, cond=None):
        B = x.shape[0]
        c2 = None if cond is None else torch.cat([cond, torch.zeros_like(cond)], 0)
        out = model_fn(_cat(x, 2), _cat(timesteps, 2), _cat(mask, 2), c2)
        return scale * out[:B] + (1.0 - scale) * out[B:]

    return fn


def cfg_model_x2(mixer_fn: Callable, scale: float, with_influence: bool = False) -> Callable:
    """CFG threading the second latent stream for the Mixer.

    ``mixer_fn(x, x2, t, mask, cond) -> mixed`` (or ``(mixed, (infl1,
    infl2))`` with ``with_influence``, whose conditioned-branch influences
    are passed through).  Returns ``fn(x, x2, t, mask, cond)`` computing
    ``scale * cond + (1 - scale) * uncond`` with the uncond branch's cond
    zeroed.
    """

    def fn(x, x2, timesteps, mask=None, cond=None):
        B = x.shape[0]
        xa = torch.cat([x, x], 0)
        xb = torch.cat([x2, x2], 0)
        t2 = torch.cat([timesteps, timesteps], 0)
        c2 = None if cond is None else torch.cat([cond, torch.zeros_like(cond)], 0)
        m2 = None if mask is None else torch.cat([mask, mask], 0)
        if with_influence:
            out, (infl1, infl2) = mixer_fn(xa, xb, t2, m2, c2)
            return scale * out[:B] + (1.0 - scale) * out[B:], (infl1[:B], infl2[:B])
        out = mixer_fn(xa, xb, t2, m2, c2)
        return scale * out[:B] + (1.0 - scale) * out[B:]

    return fn


def cfg_model_multiple(model_fn: Callable, scale: float, scale_interaction: float,
                       scale_individuals: float, text_dim: int = 768) -> Callable:
    """4x-batch CFG of in2IN's interaction mode (cfg_sampler.py:59-94): the
    full cond, the interaction slice alone, the individual slices alone and
    no cond, combined with the weights ``scale``, ``scale_interaction``,
    ``scale_individuals`` and ``1 - (their sum)``.  At the shipped (3, 3, 1)
    the uncond weight is -6, so one branch's rounding noise reaches the
    output about 7x."""

    def fn(x, timesteps, mask=None, cond=None):
        B = x.shape[0]
        cond_interaction = torch.zeros_like(cond)
        cond_interaction[:, :text_dim] = cond[:, :text_dim]
        cond_individuals = torch.zeros_like(cond)
        cond_individuals[:, text_dim:] = cond[:, text_dim:]
        c4 = torch.cat([cond, cond_interaction, cond_individuals, torch.zeros_like(cond)], 0)
        out = model_fn(_cat(x, 4), _cat(timesteps, 4), _cat(mask, 4), c4)
        return (scale * out[:B] + scale_interaction * out[B:2 * B]
                + scale_individuals * out[2 * B:3 * B]
                + (1.0 - (scale + scale_interaction + scale_individuals)) * out[3 * B:])

    return fn


def dual_mdm_weight_fn(func: str, value: float) -> Callable:
    """DualMDM's t-dependent blend weight of the individual model
    (cfg_sampler.py:108-120), f32 from an f32 timestep tensor."""
    if func == "exp":
        return lambda t: torch.exp(-value * (1000.0 - t))
    if func == "exp-inv":
        return lambda t: 1.0 - torch.exp(-value * (1000.0 - t))
    if func == "lin":
        return lambda t: 1.0 - (1000.0 - t) / 1000.0
    if func == "const":
        return lambda t: torch.full_like(t, float(value))
    raise ValueError(f"unknown weight function {func}")


def cfg_dual_mdm(individual_fn: Callable, interaction_fn: Callable, s_individual: float,
                 s_interaction: float, w_func: str, w_value: float) -> Callable:
    """DualMDM, the fixed-schedule composition baseline (cfg_sampler.py:
    97-150): both frozen denoisers at 2x batch, CFG per model, then
    ``cfg_inter + w(t) * (cfg_ind - cfg_inter)``.  As in the reference the
    weight reads the first row's timestep (:148), on the device (no host
    sync)."""
    w_of_t = dual_mdm_weight_fn(w_func, w_value)

    def fn(x, timesteps, mask=None, cond=None):
        B = x.shape[0]
        x2, t2, m2 = _cat(x, 2), _cat(timesteps, 2), _cat(mask, 2)
        c2 = torch.cat([cond, torch.zeros_like(cond)], 0)
        out_inter = interaction_fn(x2, t2, m2, c2)
        out_ind = individual_fn(x2, t2, m2, c2)
        cfg_inter = out_inter[B:] + s_interaction * (out_inter[:B] - out_inter[B:])
        cfg_ind = out_ind[B:] + s_individual * (out_ind[:B] - out_ind[B:])
        w = w_of_t(timesteps[0].to(torch.float32))
        return cfg_inter + w * (cfg_ind - cfg_inter)

    return fn
