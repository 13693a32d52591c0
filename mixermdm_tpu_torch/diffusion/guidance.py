"""Classifier guidance, the DDIM reverse ODE and the inpainting controls;
counterpart of ``mixermdm_tpu/diffusion/guidance.py``.

Reference gaussian_diffusion.py: ``condition_mean``:569 (the
Sohl-Dickstein mean shift), ``condition_score``:584 (Song's score
conditioning), ``ddim_reverse_sample``:908 (the deterministic encode), the
``pre_seq`` prefix inpainting and ``transl_req`` translation pinning of
``p_sample`` (:662-673), and the ``skip_timesteps`` / ``init_image`` warm
start (:1031-1038).  ``cond_fn`` is any callable ``(x, t_orig) -> grad log
p(y | x)``.  Each function takes its noise from the caller.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .gaussian import _initial_latents, extract, predict_eps_from_xstart, \
    predict_xstart_from_eps, q_posterior_mean_variance, q_sample
from .schedule import DiffusionSchedule


def condition_mean(cond_fn: Callable, s: DiffusionSchedule, p_out: dict, x, t):
    """The posterior mean shifted by variance * gradient (reference :569-582)."""
    return p_out["mean"] + p_out["variance"] * cond_fn(x, s.timestep_map[t])


def condition_score(cond_fn: Callable, s: DiffusionSchedule, p_out: dict, x, t) -> dict:
    """The implied score conditioned, x0 and the mean derived again from it
    (reference :584-606)."""
    alpha_bar = extract(s.alphas_cumprod, t, x.dim())
    eps = predict_eps_from_xstart(s, x, t, p_out["pred_xstart"])
    eps = eps - torch.sqrt(1 - alpha_bar) * cond_fn(x, s.timestep_map[t])
    pred_xstart = predict_xstart_from_eps(s, x, t, eps)
    return dict(p_out, pred_xstart=pred_xstart,
                mean=q_posterior_mean_variance(s, pred_xstart, x, t)[0])


def ddim_reverse_step(s: DiffusionSchedule, x, t, pred_xstart):
    """x_t -> x_{t+1} along the deterministic reverse ODE (reference :908-944)."""
    nd = x.dim()
    eps = predict_eps_from_xstart(s, x, t, pred_xstart)
    alpha_bar_next = extract(s.alphas_cumprod_next, t, nd)
    return pred_xstart * torch.sqrt(alpha_bar_next) + torch.sqrt(1 - alpha_bar_next) * eps


def ddim_encode_loop(model_fn: Callable, s: DiffusionSchedule, x0, *,
                     mean_type: str = "start_x"):
    """A clean sample encoded to the chain's last latent: the reverse ODE
    from chain index 0 up."""
    x = x0
    for i in range(s.num_timesteps):
        t = torch.full((x0.shape[0],), i, dtype=torch.long, device=x0.device)
        out = model_fn(x, s.timestep_map[t])
        pred_x0 = out if mean_type == "start_x" else predict_xstart_from_eps(s, x, t, out)
        x = ddim_reverse_step(s, x, t, pred_x0)
    return x


def apply_prefix_inpainting(s: DiffusionSchedule, x, t, pre_seq, noise):
    """The first frames overwritten by ``pre_seq`` (B, T_pre, F) q-sampled
    with ``noise`` to the step's noise level (reference ``p_sample``,
    :662-666)."""
    out = x.clone()
    out[:, : pre_seq.shape[1]] = q_sample(s, pre_seq, t, noise)
    return out


def apply_translation_pinning(s: DiffusionSchedule, x, t, transl_req: Sequence, noise,
                              dims=(0, 2)):
    """The root translation pinned at the requested frames (reference
    :668-673): for each ``(frame, tx, tz)`` of ``transl_req`` and its row of
    ``noise`` (``len(transl_req)``, 2), (tx, tz) q-sampled to batch 0's
    timestep is written to features ``dims`` of that frame in every
    sequence.  The default (0, 2) is the root XZ position of the (B, T,
    262 * P) layout (the reference writes ``x[:, :2, frame]``, the
    indexing of its MDM ancestor's transposed layout)."""
    out = x.clone()
    a = extract(s.sqrt_alphas_cumprod, t, 1)[0]
    b = extract(s.sqrt_one_minus_alphas_cumprod, t, 1)[0]
    for k, (frame, tx, tz) in enumerate(transl_req):
        target = torch.tensor([tx, tz], dtype=x.dtype, device=x.device)
        out[:, frame, list(dims)] = a * target + b * noise[k]
    return out


def warm_start_noise(s: DiffusionSchedule, init_image, noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None, skip_timesteps: int = 0):
    """The warm start (reference :1031-1038): ``init_image`` q-sampled with
    ``noise`` (or a draw from ``generator``) to the first remaining chain
    index, ``num_timesteps - skip_timesteps - 1``; the chains' own
    :func:`.gaussian._initial_latents`."""
    n_eff = s.num_timesteps - int(skip_timesteps)
    return _initial_latents(s, tuple(init_image.shape), init_image.device, n_eff, noise,
                            generator, skip_timesteps, init_image)
