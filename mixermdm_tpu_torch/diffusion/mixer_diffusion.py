"""Dual-stream MixerMDM sampling chains (DDIM and DPM-Solver++) and the
adversarial training losses; counterpart of
``mixermdm_tpu/diffusion/mixer_diffusion.py:center_person``,
``process_xstart_dual``, ``ddim_sample_loop_x2``, ``dpmpp_sample_loop_x2``
and ``mixer_training_losses`` (reference gaussian_diffusion.py:1465-1965,
2031-2062).

Two latents go through the chain: ``img`` in model-1 space (per-person
centred, HumanML3D-normalised) and ``img2`` in model-2 space (InterHuman-
normalised).  The JAX package compiles the chain into one ``lax.scan``; here
it is a Python loop whose step body reads the schedule (and the DPM-Solver++
coefficients) by device gathers and makes no host sync.  The last step's
branch (``t0 == 0``: no re-normalisation, so the chain returns raw motion)
is decided on the host from the loop index.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils.alignment import center_person_fast
from ..utils.normalizer import Normalizer
from .gaussian import _apply_traj_control, _initial_latents, dpmpp_coefficients, extract, \
    predict_eps_from_xstart, q_sample
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


def _mixed_x0(mixer_fn: Callable, s: DiffusionSchedule, img, img2, i: int, mask, cond,
              traj_control, collect_influence: bool, infl_hist: list, normalizer1, normalizer2,
              align: bool, nfeats: int):
    """One step's model call at chain index ``i``: pin the trajectory of
    both latents (``traj_control``), run the mixer, split its raw-space x0
    into the two model spaces.  Returns ``(img, img2, t, pred_x, pred_x2)``
    with the pinned latents and the (B,) timestep."""
    B = img.shape[0]
    t = torch.full((B,), i, dtype=torch.long, device=img.device)
    t_orig = s.timestep_map[t]
    if traj_control is not None:
        img = _apply_traj_control(img, traj_control)
        img2 = _apply_traj_control(img2, traj_control)
    if collect_influence:
        mixed, infl = mixer_fn(img, img2, t_orig, mask, cond)
        infl_hist.append(infl)
    else:
        mixed = mixer_fn(img, img2, t_orig, mask, cond)
    pred_x, pred_x2 = process_xstart_dual(mixed, i == 0, normalizer1, normalizer2, align, nfeats)
    return img, img2, t, pred_x, pred_x2


def _chain_result(pred_x2, infl_hist: list, collect_influence: bool):
    if collect_influence:
        return pred_x2, (torch.stack([h[0] for h in infl_hist]),
                         torch.stack([h[1] for h in infl_hist]))
    return pred_x2


def ddim_sample_loop_x2(mixer_fn: Callable, s: DiffusionSchedule, shape: tuple,
                        cond: torch.Tensor, *, mask: Optional[torch.Tensor] = None,
                        normalizer1: Normalizer, normalizer2: Normalizer, align: bool = True,
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None, nfeats: int = 262,
                        collect_influence: bool = False,
                        traj_control: Optional[torch.Tensor] = None, skip_timesteps: int = 0,
                        init_image: Optional[torch.Tensor] = None):
    """Deterministic (eta = 0) dual-stream DDIM chain.

    ``mixer_fn(x, x2, t_orig, mask, cond)`` is typically the CFG-wrapped
    mixer (:func:`..models.cfg.cfg_model_x2`) and returns raw-space x0 (and
    ``(infl1, infl2)`` with ``collect_influence``).  The initial noise is
    ``noise`` or a draw from ``generator``; eta = 0 draws nothing else.
    Returns the final ``pred_xstart2`` (raw motion), and with
    ``collect_influence`` the per-step influences stacked on a leading axis.

    ``traj_control`` (the reference's ``x_start``, :1874-1882) pins the root
    trajectory dims [0, 2] and [262, 264] of both streams before every
    step.  ``skip_timesteps`` / ``init_image`` warm-start the chain: it
    starts at chain index ``num_timesteps - skip_timesteps - 1`` from the
    init image q-sampled there (see :func:`_initial_latents`).
    """
    device = cond.device
    n_eff = s.num_timesteps - int(skip_timesteps)
    img = _initial_latents(s, shape, device, n_eff, noise, generator, skip_timesteps,
                           init_image)
    img2 = img
    nd = len(shape)
    infl_hist = []
    pred_x2 = None
    for i in reversed(range(n_eff)):
        img, img2, t, pred_x, pred_x2 = _mixed_x0(
            mixer_fn, s, img, img2, i, mask, cond, traj_control, collect_influence, infl_hist,
            normalizer1, normalizer2, align, nfeats)
        eps = predict_eps_from_xstart(s, img, t, pred_x)
        eps2 = predict_eps_from_xstart(s, img2, t, pred_x2)
        alpha_bar_prev = extract(s.alphas_cumprod_prev, t, nd)
        coef = torch.sqrt(1 - alpha_bar_prev)
        img = pred_x * torch.sqrt(alpha_bar_prev) + coef * eps
        img2 = pred_x2 * torch.sqrt(alpha_bar_prev) + coef * eps2
    return _chain_result(pred_x2, infl_hist, collect_influence)


def dpmpp_step(mixer_fn: Callable, s: DiffusionSchedule, coefs: tuple, j: int, img, img2,
               prev_x, prev_x2, cond: torch.Tensor, *, mask: Optional[torch.Tensor] = None,
               normalizer1: Normalizer, normalizer2: Normalizer, align: bool = True,
               nfeats: int = 262, traj_control: Optional[torch.Tensor] = None,
               infl_hist: Optional[list] = None):
    """Step ``j`` of a DPM-Solver++(2M) chain whose coefficient tables
    (:func:`..gaussian.dpmpp_coefficients`) are ``coefs``: chain index
    ``i = len - 1 - j``, the model's x0 of this step and ``prev_x`` /
    ``prev_x2`` of the last one.  Returns ``(img, img2, pred_x, pred_x2)``:
    the next latents and this step's x0 (``pred_x2`` raw motion at
    ``i == 0``).  With ``infl_hist`` the step's influences are appended."""
    sig_ratio, alp_next, phi, c2 = coefs
    i = sig_ratio.shape[0] - 1 - j
    img, img2, _, pred_x, pred_x2 = _mixed_x0(
        mixer_fn, s, img, img2, i, mask, cond, traj_control, infl_hist is not None, infl_hist,
        normalizer1, normalizer2, align, nfeats)
    d = (1.0 + c2[j]) * pred_x - c2[j] * prev_x
    d2 = (1.0 + c2[j]) * pred_x2 - c2[j] * prev_x2
    return (sig_ratio[j] * img - alp_next[j] * phi[j] * d,
            sig_ratio[j] * img2 - alp_next[j] * phi[j] * d2, pred_x, pred_x2)


def dpmpp_sample_loop_x2(mixer_fn: Callable, s: DiffusionSchedule, shape: tuple,
                         cond: torch.Tensor, *, mask: Optional[torch.Tensor] = None,
                         normalizer1: Normalizer, normalizer2: Normalizer, align: bool = True,
                         noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None, nfeats: int = 262,
                         collect_influence: bool = False,
                         traj_control: Optional[torch.Tensor] = None, skip_timesteps: int = 0,
                         init_image: Optional[torch.Tensor] = None):
    """Dual-stream DPM-Solver++(2M) chain (JAX ``dpmpp_sample_loop_x2``): the
    model surface, the per-step trajectory pinning and ``process_xstart_dual``
    of :func:`ddim_sample_loop_x2`, with the second-order multistep update
    of :func:`..gaussian.dpmpp_coefficients` (first order at the first and
    the last step), one :func:`dpmpp_step` per step.  Both streams are one
    joint ODE and share the coefficients, which live on the device and are
    read by index, so a step makes no host sync.  Deterministic:
    ``generator`` is read only for the initial draw.  ``skip_timesteps`` /
    ``init_image`` warm-start both streams as in the DDIM chain."""
    device = cond.device
    n = s.num_timesteps - int(skip_timesteps)
    img = _initial_latents(s, shape, device, n, noise, generator, skip_timesteps, init_image)
    img2 = img
    coefs = dpmpp_coefficients(s, n)
    pred_x, pred_x2 = torch.zeros_like(img), torch.zeros_like(img)
    infl_hist = [] if collect_influence else None
    for j in range(n):
        img, img2, pred_x, pred_x2 = dpmpp_step(
            mixer_fn, s, coefs, j, img, img2, pred_x, pred_x2, cond, mask=mask,
            normalizer1=normalizer1, normalizer2=normalizer2, align=align, nfeats=nfeats,
            traj_control=traj_control, infl_hist=infl_hist)
    return _chain_result(pred_x2, infl_hist, collect_influence)


# ---------------------------------------------------------------------------
# Adversarial training losses (reference :1465-1767)
# ---------------------------------------------------------------------------

def _hinge_weight(mask: torch.Tensor, B: int, T: int) -> torch.Tensor:
    """Per-frame weight of the hinge losses, (B, T, 1), as upstream:
    ``~(mask > 0.5)``, the loss averaged over PADDING frames
    (gaussian_diffusion.py:1503, 1530; the shipped checkpoints were trained
    so; the JAX package's ``hinge_mask_mode="reference"``)."""
    return (~(mask.reshape(B, T, -1)[..., :1] > 0.5)).float()


def d_hinge_loss(pred: torch.Tensor, target: float, weight: torch.Tensor) -> torch.Tensor:
    """relu(1 - target * pred), weighted mean, reduced in f32 (reference
    :1491-1516)."""
    loss = torch.relu(1.0 - target * pred.float()) * weight
    return loss.sum() / (weight.sum() + 1e-8)


def g_hinge_loss(pred: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """-pred, weighted mean, reduced in f32 (reference :1518-1543)."""
    loss = (-pred.float()) * weight
    return loss.sum() / (weight.sum() + 1e-8)


def _balanced_total(l_i1, l_i2, l_I, i_loss_factor: float, I_loss_factor: float, l1: float):
    """mean + l1 * spread of the three weighted losses (reference
    :1660-1672, 1750-1762)."""
    mean = (l_i1 + l_i2 + l_I) / (i_loss_factor * 2 + I_loss_factor)
    penalty = l1 * ((l_i1 - mean) ** 2 + (l_i2 - mean) ** 2
                    + ((l_I / I_loss_factor - mean) ** 2) * I_loss_factor)
    return mean + penalty


def mixer_training_losses(mixer_forward: Callable, disc_i: Callable, disc_I: Callable,
                          s: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor,
                          cond: torch.Tensor, mask: torch.Tensor, *, mode: str,
                          i_loss_factor: float = 1.0, I_loss_factor: float = 2.0,
                          l1: float = 0.1, align: bool = True, normalizer1: Normalizer,
                          normalizer2: Normalizer, cond_slices: dict, nfeats: int = 262,
                          faithful_x2_norm_skip: bool = True,
                          noise: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          compute_dtype: Optional[torch.dtype] = None) -> dict:
    """Hinge-GAN losses of the generator or the discriminator side
    (reference :1545-1767).

    ``mixer_forward`` is :func:`..models.mixer.make_mixer_forward`'s
    function, ``disc_i`` / ``disc_I`` the discriminators (``(x, t, mask,
    cond) -> (B, T, 1)``).  The caller sets train / eval modes and which
    parameters require grad.  Generator step: gradients reach the mixer
    through the discriminators.  Discriminator step: the generator's outputs
    are computed under ``torch.no_grad()``, constants for the step.  The
    discriminators run in ``compute_dtype`` (bf16 on the card, as the
    reference's 16-mixed harness autocasts them); the hinge reductions stay
    f32.  ``noise`` (else a draw from ``generator``) is shared by both
    streams, as upstream.
    """
    B, T = x_start.shape[:2]
    m = mask.reshape(B, T, -1)[..., :1].float()
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator, device=x_start.device)

    # GT into model-1 space (per-person centred, HML3D-normalised).
    xs1_1 = center_person(x_start[..., :nfeats], align)
    xs1_2 = center_person(x_start[..., nfeats:], align)
    x_start1 = torch.cat([normalizer1.forward(xs1_1), normalizer1.forward(xs1_2)], dim=-1)
    # GT into model-2 space: upstream normalises and then discards it (:1590).
    if faithful_x2_norm_skip:
        x_start2 = x_start
    else:
        x_start2 = normalizer2.forward(x_start.reshape(B, T, 2, -1)).reshape(B, T, -1)
    x1_t = q_sample(s, x_start1, t, noise)
    x2_t = q_sample(s, x_start2, t, noise)
    t_orig = s.timestep_map[t]

    generator_step = mode == "generator"
    if mode not in ("generator", "discriminator"):
        raise ValueError(mode)
    with torch.set_grad_enabled(generator_step and torch.is_grad_enabled()):
        model_output, i_output, I_output, (infl1, infl2) = mixer_forward(
            x1_t, t_orig, cond, m, x2_t)
        # Centred for the individual discriminator (:1604-1617).
        mo_i1 = center_person(model_output[..., :nfeats], align)
        mo_i2 = center_person(model_output[..., nfeats:], align)
        io_i1 = center_person(i_output[..., :nfeats], align)
        io_i2 = center_person(i_output[..., nfeats:], align)

    def cut(name):
        a, b = cond_slices[name]
        return cond[:, a:b]

    cond_I, cond_i1, cond_i2 = cut("cond_I"), cut("cond_i1"), cut("cond_i2")
    cd = (lambda a: a.to(compute_dtype)) if compute_dtype is not None else (lambda a: a)
    w = _hinge_weight(mask, B, T)

    # The mean influence weight over valid frames: a reading, never in the
    # total (the curve the reference's harness watches).
    denom = m.sum() * infl1.shape[-1] + 1e-8
    losses = {"influence_mean": ((infl1 * m).sum() + (infl2 * m).sum()).detach() / (2.0 * denom)}

    if generator_step:
        g_i1 = g_hinge_loss(disc_i(cd(mo_i1), t_orig, m, cd(cond_i1)), w) * i_loss_factor
        g_i2 = g_hinge_loss(disc_i(cd(mo_i2), t_orig, m, cd(cond_i2)), w) * i_loss_factor
        g_I = g_hinge_loss(disc_I(cd(model_output), t_orig, m, cd(cond_I)), w) * I_loss_factor
        losses.update(generator_i1=g_i1, generator_i2=g_i2, generator_I=g_I)
        losses["generator_total"] = _balanced_total(g_i1, g_i2, g_I, i_loss_factor,
                                                    I_loss_factor, l1)
        losses["total"] = losses["generator_total"]
        return losses

    def d_pair(disc, real_x, fake_x, c):
        real = d_hinge_loss(disc(cd(real_x), t_orig, m, cd(c)), 1.0, w)
        fake = d_hinge_loss(disc(cd(fake_x), t_orig, m, cd(c)), -1.0, w)
        return (real + fake) / 2

    d_i1 = d_pair(disc_i, io_i1, mo_i1, cond_i1) * i_loss_factor
    d_i2 = d_pair(disc_i, io_i2, mo_i2, cond_i2) * i_loss_factor
    d_I = d_pair(disc_I, I_output, model_output, cond_I) * I_loss_factor
    losses.update(discriminator_i1=d_i1, discriminator_i2=d_i2, discriminator_I=d_I)
    losses["discriminator_total"] = _balanced_total(d_i1, d_i2, d_I, i_loss_factor,
                                                    I_loss_factor, l1)
    losses["total"] = losses["discriminator_total"]
    return losses
