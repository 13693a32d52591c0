"""Dual-stream MixerMDM DDIM chain; counterpart of
``mixermdm_tpu/diffusion/mixer_diffusion.py:center_person``,
``process_xstart_dual`` and ``ddim_sample_loop_x2`` (reference
gaussian_diffusion.py:1769-1965, 2031-2062).

Two latents go through the chain: ``img`` in model-1 space (per-person
centred, HumanML3D-normalised) and ``img2`` in model-2 space (InterHuman-
normalised).  The JAX package compiles the chain into one ``lax.scan``; here
it is a Python loop whose step body reads the schedule by device gathers and
makes no host sync.  The last step's branch (``t0 == 0``: no re-
normalisation, so the chain returns raw motion) is decided on the host from
the loop index.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils.alignment import center_person_fast
from ..utils.normalizer import Normalizer
from .gaussian import extract, predict_eps_from_xstart
from .schedule import DiffusionSchedule


def center_person(x: torch.Tensor, align: bool) -> torch.Tensor:
    """ih -> smpl -> centre -> ih per person, contacts zeroed (the fast
    algebraic path)."""
    return center_person_fast(x) if align else x


def process_xstart_dual(mixed: torch.Tensor, last_step: bool, normalizer1: Normalizer,
                        normalizer2: Normalizer, align: bool, nfeats: int = 262):
    """Split the raw-space mixed x0 into the two model spaces; at the last
    step (``t0 == 0``) the normalisation is skipped.  Returns
    ``(pred_xstart, pred_xstart2)``."""
    B, T = mixed.shape[:2]
    both = torch.cat([mixed[..., :nfeats], mixed[..., nfeats:]], 0)
    centred = center_person(both, align)
    if last_step:
        return torch.cat([centred[:B], centred[B:]], dim=-1), mixed
    ab = normalizer1.forward(centred)
    x2 = normalizer2.forward(mixed.reshape(B, T, 2, -1)).reshape(B, T, -1)
    return torch.cat([ab[:B], ab[B:]], dim=-1), x2


def ddim_sample_loop_x2(mixer_fn: Callable, s: DiffusionSchedule, shape: tuple,
                        cond: torch.Tensor, *, mask: Optional[torch.Tensor] = None,
                        normalizer1: Normalizer, normalizer2: Normalizer, align: bool = True,
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None, nfeats: int = 262,
                        collect_influence: bool = False):
    """Deterministic (eta = 0) dual-stream DDIM chain.

    ``mixer_fn(x, x2, t_orig, mask, cond)`` is typically the CFG-wrapped
    mixer (:func:`..models.cfg.cfg_model_x2`) and returns raw-space x0 (and
    ``(infl1, infl2)`` with ``collect_influence``).  The initial noise is
    ``noise`` or a draw from ``generator``; eta = 0 draws nothing else.
    Returns the final ``pred_xstart2`` (raw motion), and with
    ``collect_influence`` the per-step influences stacked on a leading axis.
    """
    device = cond.device
    img = noise if noise is not None else torch.randn(shape, generator=generator, device=device)
    img = img.to(device=device, dtype=torch.float32)
    img2 = img
    B, nd = shape[0], len(shape)
    infl_hist = []
    pred_x2 = None
    for i in reversed(range(s.num_timesteps)):
        t = torch.full((B,), i, dtype=torch.long, device=device)
        t_orig = s.timestep_map[t]
        if collect_influence:
            mixed, infl = mixer_fn(img, img2, t_orig, mask, cond)
            infl_hist.append(infl)
        else:
            mixed = mixer_fn(img, img2, t_orig, mask, cond)
        pred_x, pred_x2 = process_xstart_dual(mixed, i == 0, normalizer1, normalizer2, align,
                                              nfeats)
        eps = predict_eps_from_xstart(s, img, t, pred_x)
        eps2 = predict_eps_from_xstart(s, img2, t, pred_x2)
        alpha_bar_prev = extract(s.alphas_cumprod_prev, t, nd)
        coef = torch.sqrt(1 - alpha_bar_prev)
        img = pred_x * torch.sqrt(alpha_bar_prev) + coef * eps
        img2 = pred_x2 * torch.sqrt(alpha_bar_prev) + coef * eps2
    if collect_influence:
        return pred_x2, (torch.stack([h[0] for h in infl_hist]),
                         torch.stack([h[1] for h in infl_hist]))
    return pred_x2
