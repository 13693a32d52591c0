"""Classifier-free guidance over a doubled batch; counterpart of
``mixermdm_tpu/models/cfg.py:cfg_model_x2`` (reference cfg_sampler.py:31-56)."""

from __future__ import annotations

from typing import Callable

import torch


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
