"""The DDPM/DDIM pieces of the sampling chains and the mixer's training;
counterpart of the matching functions of ``mixermdm_tpu/diffusion/gaussian.py``.

The single-stream chains (:func:`ddim_sample_loop`, :func:`dpmpp_sample_loop`)
sample the base models (in2IN, DualMDM, MDM, InterGen); the dual-stream
chains of :mod:`.mixer_diffusion` the mixer.  Both are Python loops whose
step reads the schedule (and the DPM-Solver++ coefficients) by device
gathers and makes no host sync; the JAX package compiles each into one
``lax.scan``.  Only what the base models' configs take is ported: x0
prediction (``MEAN_START_X``), fixed-small variance, no clipping, eta 0.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .schedule import DiffusionSchedule


def extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """arr[t] broadcast to an ndim tensor with a leading batch dim (a device
    gather, no host sync)."""
    return arr[t].reshape(t.shape + (1,) * (ndim - 1))


def predict_eps_from_xstart(s: DiffusionSchedule, x_t, t, pred_xstart):
    nd = x_t.dim()
    return ((extract(s.sqrt_recip_alphas_cumprod, t, nd) * x_t - pred_xstart)
            / extract(s.sqrt_recipm1_alphas_cumprod, t, nd))


def q_sample(s: DiffusionSchedule, x_start, t, noise):
    """Sample q(x_t | x_0) (reference :401-419)."""
    nd = x_start.dim()
    return (extract(s.sqrt_alphas_cumprod, t, nd) * x_start
            + extract(s.sqrt_one_minus_alphas_cumprod, t, nd) * noise)


def _initial_latents(s: DiffusionSchedule, shape: tuple, device, n_eff: int,
                     noise: Optional[torch.Tensor], generator: Optional[torch.Generator],
                     skip_timesteps: int, init_image: Optional[torch.Tensor]) -> torch.Tensor:
    """The chain's starting latent (shared by both streams of the mixer's
    chains): ``noise`` or a draw from ``generator``; for a warm start
    (``skip_timesteps`` or ``init_image``), ``init_image`` (zeros if not
    given) q-sampled to the first remaining timestep ``n_eff - 1`` with that
    same draw as its noise (reference :1031-1038, :1854-1860)."""
    img = noise if noise is not None else torch.randn(shape, generator=generator, device=device)
    img = img.to(device=device, dtype=torch.float32)
    if skip_timesteps and init_image is None:
        init_image = torch.zeros(shape, device=device)
    if init_image is not None:
        t0 = torch.full((shape[0],), n_eff - 1, dtype=torch.long, device=device)
        img = q_sample(s, init_image.to(device=device, dtype=torch.float32), t0, img)
    return img


def _apply_traj_control(img: torch.Tensor, x_start: torch.Tensor) -> torch.Tensor:
    """Pin the root-trajectory dims 0 and 2 (and 262 and 264 of person 2,
    where the motion is that wide) from ``x_start`` (reference :1052-1055).
    The dims are strided slices, so this is a few device copies with no
    index tensor and no host sync."""
    T, D = img.shape[1], img.shape[2]
    out = img.clone()
    for first in (0, 262):
        if first + 2 < D:
            out[:, :, first:first + 3:2] = x_start[:, :T, first:first + 3:2]
        elif first < D:
            out[:, :, first] = x_start[:, :T, first]
    return out


def dpmpp_coefficients(s: DiffusionSchedule, n_eff: int | None = None):
    """DPM-Solver++(2M) coefficient tables of a (respaced) chain, computed
    once per chain on the host in float64 from the schedule's float32
    ``alphas_cumprod`` and returned as float32 tensors on the schedule's device.

    Returns ``(sig_ratio, alp_next, phi, c2)``, each of length ``n_eff``
    (default ``s.num_timesteps``; fewer for a warm-started chain that skips
    the head), indexed by the loop position ``j``, which visits chain index
    ``i = n_eff - 1 - j``; its next point is ``i - 1``, and ``i = -1`` is
    clean data (alpha 1, sigma 0, lambda +inf).  The VP data-prediction
    update (Lu et al., arXiv:2211.01095) is::

        x_next = sig_ratio * x - alp_next * phi * D,
        D      = (1 + c2) * x0_cur - c2 * x0_prev,

    with ``phi = e^{-h} - 1`` and ``c2 = h_j / (2 h_{j-1})``.  The first
    step has no history and the final step is first order (``c2 = 0``),
    which also keeps the chain's raw-space x0 at ``t == 0`` out of the
    multistep correction.
    """
    acp = s.alphas_cumprod.detach().cpu().numpy().astype(np.float64)
    n = acp.shape[0] if n_eff is None else int(n_eff)
    alpha = np.sqrt(acp)
    sigma = np.sqrt(1.0 - acp)
    lam = 0.5 * (np.log(acp) - np.log1p(-acp))
    i_cur = np.arange(n - 1, -1, -1)
    has_next = i_cur > 0
    i_nxt = np.maximum(i_cur - 1, 0)
    sig_ratio = np.where(has_next, sigma[i_nxt], 0.0) / sigma[i_cur]
    alp_next = np.where(has_next, alpha[i_nxt], 1.0)
    with np.errstate(invalid="ignore"):
        h = np.where(has_next, lam[i_nxt] - lam[i_cur], np.inf)
    phi = np.expm1(-h)  # -1 at the clean-data boundary
    c2 = np.zeros(n)
    if n > 1:
        with np.errstate(invalid="ignore"):
            c2[1:] = h[1:] / (2.0 * h[:-1])
    c2[~np.isfinite(c2)] = 0.0
    c2[-1] = 0.0
    return tuple(torch.tensor(a, dtype=torch.float32, device=s.alphas_cumprod.device)
                 for a in (sig_ratio, alp_next, phi, c2))


def ddim_step(s: DiffusionSchedule, x, t, pred_xstart) -> torch.Tensor:
    """Deterministic (eta = 0) DDIM update, eq. 12 (reference :799-849)."""
    nd = x.dim()
    eps = predict_eps_from_xstart(s, x, t, pred_xstart)
    alpha_bar_prev = extract(s.alphas_cumprod_prev, t, nd)
    return pred_xstart * torch.sqrt(alpha_bar_prev) + torch.sqrt(1 - alpha_bar_prev) * eps


def ddim_sample_loop(model_fn: Callable, s: DiffusionSchedule, shape: tuple, *,
                     device=None, noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     traj_control: Optional[torch.Tensor] = None, skip_timesteps: int = 0,
                     init_image: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deterministic (eta = 0) DDIM chain (reference :946-1069; JAX
    ``ddim_sample_loop``).  ``model_fn(x, t_orig)`` returns x0, called at the
    original timestep ``s.timestep_map[t]`` and taken as it is (the x0 of
    ``p_mean_variance``, :445-539, with no clipping).  Returns the last
    step's x0.

    The initial latent is ``noise`` or a draw from ``generator``; eta = 0
    draws nothing else.  ``traj_control`` pins the root-trajectory dims
    before every step; ``skip_timesteps`` / ``init_image`` warm-start the
    chain at chain index ``num_timesteps - skip_timesteps - 1`` from the
    init image q-sampled there (:func:`_initial_latents`).
    """
    device = torch.device(device) if device is not None else s.alphas_cumprod.device
    n_eff = s.num_timesteps - int(skip_timesteps)
    img = _initial_latents(s, shape, device, n_eff, noise, generator, skip_timesteps,
                           init_image)
    pred = None
    for i in reversed(range(n_eff)):
        if traj_control is not None:
            img = _apply_traj_control(img, traj_control)
        t = torch.full((shape[0],), i, dtype=torch.long, device=device)
        pred = model_fn(img, s.timestep_map[t])
        img = ddim_step(s, img, t, pred)
    return pred


def dpmpp_sample_loop(model_fn: Callable, s: DiffusionSchedule, shape: tuple, *,
                      device=None, noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      traj_control: Optional[torch.Tensor] = None, skip_timesteps: int = 0,
                      init_image: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DPM-Solver++(2M) chain in x0 form (JAX ``dpmpp_sample_loop``): the
    model surface, trajectory pinning and warm start of
    :func:`ddim_sample_loop`, the multistep update of
    :func:`dpmpp_coefficients` (first order at the first and the last
    step), its tables on the device and read by index.  Returns the last
    step's x0."""
    device = torch.device(device) if device is not None else s.alphas_cumprod.device
    n = s.num_timesteps - int(skip_timesteps)
    img = _initial_latents(s, shape, device, n, noise, generator, skip_timesteps, init_image)
    sig_ratio, alp_next, phi, c2 = dpmpp_coefficients(s, n)
    prev = torch.zeros_like(img)
    for j in range(n):
        if traj_control is not None:
            img = _apply_traj_control(img, traj_control)
        t = torch.full((shape[0],), n - 1 - j, dtype=torch.long, device=device)
        x0 = model_fn(img, s.timestep_map[t])
        d = (1.0 + c2[j]) * x0 - c2[j] * prev
        img = sig_ratio[j] * img - alp_next[j] * phi[j] * d
        prev = x0
    return prev


def mse_training_losses(model_fn: Callable, s: DiffusionSchedule, x_start, t, *,
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        learned_variance: bool = False) -> dict:
    """The base MSE diffusion loss (reference ``training_losses``
    :1106-1187; JAX ``mse_training_losses``) for x0 prediction:
    ``model_fn(x_t, t_orig)`` on ``x_t`` q-sampled from ``x_start`` with
    ``noise`` (or a draw from ``generator``).  Returns the per-sample
    ``mse`` (B,), ``target`` (= x_start), ``pred``, ``x_t`` and ``loss``.

    The learned-variance branch (the VLB term ``vb``) is not ported (ROADMAP
    Queue 1 item 7, ``vlb.py``); no shipped config learns the variance."""
    if learned_variance:
        raise NotImplementedError("learned-variance training (the vb term of vlb.py) is not "
                                  "ported; see ROADMAP Queue 1 item 7")
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator, device=x_start.device)
    x_t = q_sample(s, x_start, t, noise.to(x_start.dtype))
    pred = model_fn(x_t, s.timestep_map[t])
    mse = ((x_start - pred) ** 2).reshape(x_start.shape[0], -1).mean(dim=-1)
    return {"mse": mse, "target": x_start, "pred": pred, "x_t": x_t, "loss": mse}
