"""The DDPM / DDIM engine: the q and p arithmetic, the sampling chains and
the MSE training loss; counterpart of ``mixermdm_tpu/diffusion/gaussian.py``.

The single-stream chains (:func:`ddim_sample_loop`, :func:`dpmpp_sample_loop`,
:func:`p_sample_loop`) sample the base models (in2IN, DualMDM, MDM,
InterGen); the dual-stream chains of :mod:`.mixer_diffusion` the mixer.  They
are Python loops whose step reads the schedule (and the DPM-Solver++
coefficients) by device gathers and makes no host sync; the JAX package
compiles each into one ``lax.scan``.

Model functions are ``model_fn(x, t_orig) -> output`` with ``t_orig`` the
original (un-respaced) timestep.  Every mean type (x0, epsilon, x_{t-1}) and
variance type (fixed small, fixed large, learned, learned range) of the JAX
package is here; the shipped configs take x0 and fixed small.  There is no
shared RNG: a chain's noise is the caller's (``noise``, ``step_noise``) or
drawn from its ``generator``, and a step function takes its noise as an
argument.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .schedule import DiffusionSchedule

MEAN_START_X = "start_x"
MEAN_EPSILON = "epsilon"
MEAN_PREVIOUS_X = "previous_x"

VAR_FIXED_SMALL = "fixed_small"
VAR_FIXED_LARGE = "fixed_large"
VAR_LEARNED = "learned"
VAR_LEARNED_RANGE = "learned_range"

LEARNED_VAR_TYPES = (VAR_LEARNED, VAR_LEARNED_RANGE)


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


def q_posterior_mean_variance(s: DiffusionSchedule, x_start, x_t, t):
    """Mean, variance and clipped log variance of q(x_{t-1} | x_t, x_0)."""
    nd = x_t.dim()
    mean = (extract(s.posterior_mean_coef1, t, nd) * x_start
            + extract(s.posterior_mean_coef2, t, nd) * x_t)
    return (mean, extract(s.posterior_variance, t, nd),
            extract(s.posterior_log_variance_clipped, t, nd))


def predict_xstart_from_eps(s: DiffusionSchedule, x_t, t, eps):
    nd = x_t.dim()
    return (extract(s.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - extract(s.sqrt_recipm1_alphas_cumprod, t, nd) * eps)


def predict_xstart_from_xprev(s: DiffusionSchedule, x_t, t, xprev):
    """The x0 of a model that predicts x_{t-1} (reference :547-556):
    (xprev - coef2 * x_t) / coef1."""
    nd = x_t.dim()
    return (extract(1.0 / s.posterior_mean_coef1, t, nd) * xprev
            - extract(s.posterior_mean_coef2 / s.posterior_mean_coef1, t, nd) * x_t)


def split_learned_variance(s: DiffusionSchedule, model_output, t, var_type: str):
    """A 2F-channel output -> (prediction, variance, log variance).  The split
    is on the feature (last) axis of the (B, T, F) motion layout (the
    reference, :477-490, splits dim 1 of its image layout).  ``learned``
    takes the second half as the log variance; ``learned_range`` maps it
    from [-1, 1] to a fraction between the clipped posterior log variance
    and log(beta)."""
    model_output, var_values = model_output.chunk(2, dim=-1)
    if var_type == VAR_LEARNED:
        log_variance = var_values
    else:
        nd = model_output.dim()
        min_log = extract(s.posterior_log_variance_clipped, t, nd)
        max_log = extract(s.log_betas, t, nd)
        frac = (var_values + 1.0) / 2.0
        log_variance = frac * max_log + (1.0 - frac) * min_log
    return model_output, torch.exp(log_variance), log_variance


def model_variance(s: DiffusionSchedule, t, ndim: int, var_type: str):
    """(variance, log variance) of a fixed variance type."""
    if var_type == VAR_FIXED_SMALL:
        return (extract(s.posterior_variance, t, ndim),
                extract(s.posterior_log_variance_clipped, t, ndim))
    if var_type == VAR_FIXED_LARGE:
        return (extract(s.fixed_large_variance, t, ndim),
                extract(s.log_fixed_large_variance, t, ndim))
    raise NotImplementedError(var_type)


def _pred_xstart(s: DiffusionSchedule, x, t, model_output, mean_type: str, clip_denoised: bool,
                 denoised_fn: Optional[Callable]):
    """The x0 implied by a model's (mean half of the) output, through
    ``denoised_fn`` and the [-1, 1] clip where asked (reference :497-525)."""
    if mean_type == MEAN_START_X:
        x0 = model_output
    elif mean_type == MEAN_EPSILON:
        x0 = predict_xstart_from_eps(s, x, t, model_output)
    elif mean_type == MEAN_PREVIOUS_X:
        x0 = predict_xstart_from_xprev(s, x, t, model_output)
    else:
        raise NotImplementedError(mean_type)
    if denoised_fn is not None:
        x0 = denoised_fn(x0)
    return x0.clamp(-1.0, 1.0) if clip_denoised else x0


def _model_xstart(model_fn: Callable, s: DiffusionSchedule, x, t, mean_type: str, var_type: str,
                  clip_denoised: bool):
    """The ``pred_xstart`` of :func:`p_mean_variance` alone (a DDIM step needs
    no mean and no variance)."""
    out = model_fn(x, s.timestep_map[t])
    if var_type in LEARNED_VAR_TYPES:
        out = out.chunk(2, dim=-1)[0]
    return _pred_xstart(s, x, t, out, mean_type, clip_denoised, None)


def p_mean_variance(model_fn: Callable, s: DiffusionSchedule, x, t, *,
                    mean_type: str = MEAN_START_X, var_type: str = VAR_FIXED_SMALL,
                    clip_denoised: bool = False, denoised_fn: Optional[Callable] = None) -> dict:
    """p(x_{t-1} | x_t): ``mean``, ``variance``, ``log_variance`` and the x0
    prediction ``pred_xstart`` (reference :445-539).  A model that predicts
    x_{t-1} gives the mean itself; the others give it through
    :func:`q_posterior_mean_variance` of their x0."""
    model_output = model_fn(x, s.timestep_map[t])
    if var_type in LEARNED_VAR_TYPES:
        model_output, variance, log_variance = split_learned_variance(s, model_output, t,
                                                                      var_type)
    else:
        variance, log_variance = model_variance(s, t, x.dim(), var_type)
    pred_xstart = _pred_xstart(s, x, t, model_output, mean_type, clip_denoised, denoised_fn)
    if mean_type == MEAN_PREVIOUS_X:
        mean = model_output
    else:
        mean = q_posterior_mean_variance(s, pred_xstart, x, t)[0]
    return {"mean": mean, "variance": variance, "log_variance": log_variance,
            "pred_xstart": pred_xstart}


def _nonzero_mask(t, ndim: int, dtype):
    return (t != 0).to(dtype).reshape(t.shape + (1,) * (ndim - 1))


def ddpm_step(s: DiffusionSchedule, out: dict, t, noise) -> torch.Tensor:
    """x_{t-1} from :func:`p_mean_variance`'s ``out`` and the step's
    ``noise`` (reference :632-692); no noise at t == 0."""
    mean = out["mean"]
    return mean + _nonzero_mask(t, mean.dim(), mean.dtype) * torch.exp(
        0.5 * out["log_variance"]) * noise


def _draw(step_noise: Optional[Sequence[dict]], j: int, key: str, shape, like: torch.Tensor,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """Loop position ``j``'s noise ``key``: the caller's ``step_noise[j][key]``,
    or a draw from ``generator``."""
    if step_noise is not None:
        return step_noise[j][key].to(device=like.device, dtype=like.dtype)
    return torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)


def _initial_latents(s: DiffusionSchedule, shape: tuple, device, n_eff: int,
                     noise: Optional[torch.Tensor], generator: Optional[torch.Generator],
                     skip_timesteps: int, init_image: Optional[torch.Tensor]) -> torch.Tensor:
    """The chain's starting latent (shared by both streams of the mixer's
    chains): ``noise`` or a draw from ``generator``; for a warm start
    (``skip_timesteps`` or ``init_image``), ``init_image`` (zeros if not
    given) q-sampled to the first remaining timestep ``n_eff - 1`` with that
    same draw as its noise (reference :1031-1038, :1854-1860; JAX
    ``guidance.warm_start_noise``).  In the schedule's dtype (float32, or
    float64 for a replay of a chain)."""
    dtype = s.alphas_cumprod.dtype
    img = noise if noise is not None else torch.randn(shape, generator=generator, device=device)
    img = img.to(device=device, dtype=dtype)
    if skip_timesteps and init_image is None:
        init_image = torch.zeros(shape, device=device, dtype=dtype)
    if init_image is not None:
        t0 = torch.full((shape[0],), n_eff - 1, dtype=torch.long, device=device)
        img = q_sample(s, init_image.to(device=device, dtype=dtype), t0, img)
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


def ddim_step(s: DiffusionSchedule, x, t, pred_xstart, eta: float = 0.0,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DDIM update, eq. 12 (reference :799-849): deterministic at ``eta`` 0
    (no noise read); else with sigma = eta * sqrt((1 - a_prev) / (1 - a)) *
    sqrt(1 - a / a_prev) and the step's ``noise``."""
    nd = x.dim()
    eps = predict_eps_from_xstart(s, x, t, pred_xstart)
    alpha_bar_prev = extract(s.alphas_cumprod_prev, t, nd)
    if eta == 0.0:
        return pred_xstart * torch.sqrt(alpha_bar_prev) + torch.sqrt(1 - alpha_bar_prev) * eps
    alpha_bar = extract(s.alphas_cumprod, t, nd)
    sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
             * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
    mean_pred = (pred_xstart * torch.sqrt(alpha_bar_prev)
                 + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
    return mean_pred + _nonzero_mask(t, nd, x.dtype) * sigma * noise


def ddim_sample_loop(model_fn: Callable, s: DiffusionSchedule, shape: tuple, *,
                     device=None, noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     traj_control: Optional[torch.Tensor] = None, skip_timesteps: int = 0,
                     init_image: Optional[torch.Tensor] = None, eta: float = 0.0,
                     step_noise: Optional[Sequence[dict]] = None,
                     mean_type: str = MEAN_START_X, var_type: str = VAR_FIXED_SMALL,
                     clip_denoised: bool = False,
                     cond_fn: Optional[Callable] = None) -> torch.Tensor:
    """The DDIM chain (reference :946-1069; JAX ``ddim_sample_loop``):
    ``model_fn(x, t_orig)`` at the original timestep ``s.timestep_map[t]``,
    its x0 as :func:`p_mean_variance` takes it.  Returns the last step's x0.

    The initial latent is ``noise`` or a draw from ``generator``; at ``eta``
    0 nothing else is drawn, and with no ``cond_fn`` the step is the x0 and
    the update alone.  At ``eta`` > 0 loop position ``j`` (chain index
    ``n_eff - 1 - j``) takes ``step_noise[j]["x"]`` or a draw.
    ``cond_fn(x, t_orig) -> grad log p(y | x)`` conditions the score every
    step (:func:`.guidance.condition_score`); it takes its gradient itself,
    on ``x`` alone, so the model's call records none.  ``traj_control``
    pins the root-trajectory dims before every step; ``skip_timesteps`` /
    ``init_image`` warm-start the chain at chain index ``num_timesteps -
    skip_timesteps - 1`` from the init image q-sampled there
    (:func:`_initial_latents`).
    """
    if cond_fn is not None:
        from .guidance import condition_score
    device = torch.device(device) if device is not None else s.alphas_cumprod.device
    n_eff = s.num_timesteps - int(skip_timesteps)
    img = _initial_latents(s, shape, device, n_eff, noise, generator, skip_timesteps,
                           init_image)
    pred = None
    for j, i in enumerate(reversed(range(n_eff))):
        if traj_control is not None:
            img = _apply_traj_control(img, traj_control)
        t = torch.full((shape[0],), i, dtype=torch.long, device=device)
        pred = _model_xstart(model_fn, s, img, t, mean_type, var_type, clip_denoised)
        if cond_fn is not None:
            pred = condition_score(cond_fn, s, {"pred_xstart": pred}, img, t)["pred_xstart"]
        step = _draw(step_noise, j, "x", shape, img, generator) if eta else None
        img = ddim_step(s, img, t, pred, eta, step)
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


def p_sample_loop(model_fn: Callable, s: DiffusionSchedule, shape: tuple, *,
                  device=None, noise: Optional[torch.Tensor] = None,
                  step_noise: Optional[Sequence[dict]] = None,
                  generator: Optional[torch.Generator] = None,
                  mean_type: str = MEAN_START_X, var_type: str = VAR_FIXED_SMALL,
                  clip_denoised: bool = False, cond_fn: Optional[Callable] = None,
                  pre_seq: Optional[torch.Tensor] = None, transl_req: Optional[Sequence] = None,
                  transl_dims: tuple = (0, 2)) -> torch.Tensor:
    """The ancestral DDPM chain (reference :694-797; JAX ``p_sample_loop``);
    returns the last latent.

    Before each model call the latent takes the inpainting controls of the
    reference's ``p_sample`` (:662-673) on the (B, T, F) layout:
    ``pre_seq`` (B, T_pre, F) q-sampled to the step's noise level over the
    first frames (:func:`.guidance.apply_prefix_inpainting`), and
    ``transl_req``, a sequence of ``(frame, tx, tz)``, pinned at features
    ``transl_dims`` (:func:`.guidance.apply_translation_pinning`).
    ``cond_fn`` shifts the mean every step (:func:`.guidance.condition_mean`;
    it takes its gradient on ``x`` alone).

    The initial latent is ``noise`` or a draw from ``generator``.  Loop
    position ``j`` (chain index ``num_timesteps - 1 - j``) takes
    ``step_noise[j]``: ``"prefix"`` (the shape of ``pre_seq``), ``"pin"``
    (``len(transl_req)``, 2) and ``"x"`` (the step's noise), each where it
    is used; without ``step_noise`` they are drawn from ``generator`` in
    that order.
    """
    if cond_fn is not None:
        from .guidance import condition_mean
    if pre_seq is not None or transl_req is not None:
        from .guidance import apply_prefix_inpainting, apply_translation_pinning
    device = torch.device(device) if device is not None else s.alphas_cumprod.device
    n = s.num_timesteps
    img = _initial_latents(s, shape, device, n, noise, generator, 0, None)
    if pre_seq is not None:
        pre_seq = pre_seq.to(device=device, dtype=img.dtype)
    for j, i in enumerate(reversed(range(n))):
        t = torch.full((shape[0],), i, dtype=torch.long, device=device)
        if pre_seq is not None:
            prefix = _draw(step_noise, j, "prefix", pre_seq.shape, img, generator)
            img = apply_prefix_inpainting(s, img, t, pre_seq, prefix)
        if transl_req is not None:
            pin = _draw(step_noise, j, "pin", (len(transl_req), 2), img, generator)
            img = apply_translation_pinning(s, img, t, transl_req, pin, dims=transl_dims)
        out = p_mean_variance(model_fn, s, img, t, mean_type=mean_type, var_type=var_type,
                              clip_denoised=clip_denoised)
        if cond_fn is not None:
            out = dict(out, mean=condition_mean(cond_fn, s, out, img, t))
        img = ddpm_step(s, out, t, _draw(step_noise, j, "x", shape, img, generator))
    return img


def mse_training_losses(model_fn: Callable, s: DiffusionSchedule, x_start, t, *,
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        mean_type: str = MEAN_START_X, var_type: str = VAR_FIXED_SMALL,
                        rescale_vb: bool = False) -> dict:
    """The base MSE diffusion loss (reference ``training_losses``
    :1106-1187; JAX ``mse_training_losses``): ``model_fn(x_t, t_orig)`` on
    ``x_t`` q-sampled from ``x_start`` with ``noise`` (or a draw from
    ``generator``).  Returns the per-sample ``mse`` (B,) against the mean
    type's ``target`` (x0, the noise or the posterior mean), ``pred``,
    ``x_t`` and ``loss``.

    With a learned variance the output has 2F channels: the variance half
    trains through the VLB term ``vb`` (:func:`.vlb.vb_terms_bpd`) on the
    mean half detached (the reference's frozen-mean trick, :1145-1160), so
    ``vb`` trains the variance alone; ``rescale_vb`` scales it by
    ``num_timesteps / 1000``, and ``loss`` = mse + vb."""
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator, device=x_start.device)
    noise = noise.to(x_start.dtype)
    x_t = q_sample(s, x_start, t, noise)
    model_output = model_fn(x_t, s.timestep_map[t])
    terms = {}
    if var_type in LEARNED_VAR_TYPES:
        from .vlb import vb_terms_bpd

        model_output, var_values = model_output.chunk(2, dim=-1)
        frozen = torch.cat([model_output.detach(), var_values], dim=-1)
        vb = vb_terms_bpd(lambda _x, _t: frozen, s, x_start, x_t, t, clip_denoised=False,
                          mean_type=mean_type, var_type=var_type)["output"]
        terms["vb"] = vb * (s.num_timesteps / 1000.0) if rescale_vb else vb
    if mean_type == MEAN_START_X:
        target = x_start
    elif mean_type == MEAN_EPSILON:
        target = noise
    elif mean_type == MEAN_PREVIOUS_X:
        target = q_posterior_mean_variance(s, x_start, x_t, t)[0]
    else:
        raise NotImplementedError(mean_type)
    mse = ((target - model_output) ** 2).reshape(x_start.shape[0], -1).mean(dim=-1)
    terms.update({"mse": mse, "target": target, "pred": model_output, "x_t": x_t})
    terms["loss"] = mse + terms["vb"] if "vb" in terms else mse
    return terms
