"""The variational lower bound and likelihood evaluation; counterpart of
``mixermdm_tpu/diffusion/vlb.py``.

Reference gaussian_diffusion.py: ``normal_kl``:173,
``approx_standard_normal_cdf``:201, ``discretized_gaussian_log_likelihood``:208,
``_vb_terms_bpd``:1071, ``_prior_bpd``:1189 and ``calc_bpd_loop``:1207.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from .gaussian import MEAN_START_X, VAR_FIXED_SMALL, extract, p_mean_variance, \
    predict_eps_from_xstart, q_posterior_mean_variance, q_sample
from .schedule import DiffusionSchedule

LOG2 = math.log(2.0)


def mean_flat(x):
    return x.reshape(x.shape[0], -1).mean(dim=-1)


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N1 || N2) elementwise, in nats; either side may be a number."""
    like = next(a for a in (mean1, logvar1, mean2, logvar2) if isinstance(a, torch.Tensor))
    logvar1, logvar2 = (torch.as_tensor(v, dtype=like.dtype, device=like.device)
                        for v in (logvar1, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, means, log_scales):
    """Log-likelihood of a Gaussian discretised to bins of 2/255 on [-1, 1]:
    the lower tail below -0.999, the upper tail above 0.999, the bin's mass
    between, each log clamped at 1e-12."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def vb_terms_bpd(model_fn: Callable, s: DiffusionSchedule, x_start, x_t, t, *,
                 clip_denoised: bool = False, mean_type: str = MEAN_START_X,
                 var_type: str = VAR_FIXED_SMALL) -> dict:
    """One term of the bound in bits: KL(q || p) for t > 0, the decoder's
    negative log-likelihood at t == 0.  Returns ``output`` (B,) and the
    model's ``pred_xstart``."""
    true_mean, _, true_log_var = q_posterior_mean_variance(s, x_start, x_t, t)
    out = p_mean_variance(model_fn, s, x_t, t, mean_type=mean_type, var_type=var_type,
                          clip_denoised=clip_denoised)
    kl = mean_flat(normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"])) / LOG2
    decoder_nll = -discretized_gaussian_log_likelihood(x_start, out["mean"],
                                                       0.5 * out["log_variance"])
    decoder_nll = mean_flat(decoder_nll) / LOG2
    return {"output": torch.where(t == 0, decoder_nll, kl), "pred_xstart": out["pred_xstart"]}


def prior_bpd(s: DiffusionSchedule, x_start):
    """KL(q(x_T | x_0) || N(0, 1)) in bits, per sample."""
    t = torch.full((x_start.shape[0],), s.num_timesteps - 1, dtype=torch.long,
                   device=x_start.device)
    nd = x_start.dim()
    qt_mean = extract(s.sqrt_alphas_cumprod, t, nd) * x_start
    qt_log_var = torch.log1p(-extract(s.alphas_cumprod, t, nd))
    return mean_flat(normal_kl(qt_mean, qt_log_var, 0.0, 0.0)) / LOG2


def calc_bpd_loop(model_fn: Callable, s: DiffusionSchedule, x_start, *,
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  clip_denoised: bool = False) -> dict:
    """The whole bound over every timestep, from chain index
    ``num_timesteps - 1`` down.  Loop position ``j`` q-samples with
    ``noise[j]`` (``noise`` is (num_timesteps, *x_start.shape)) or a draw
    from ``generator``.  Returns ``total_bpd`` and ``prior_bpd`` (B,), and
    ``vb``, ``xstart_mse``, ``mse`` (B, num_timesteps), column ``j`` for
    loop position ``j``."""
    B = x_start.shape[0]
    vb, xstart_mse, mse = [], [], []
    for j, i in enumerate(reversed(range(s.num_timesteps))):
        t = torch.full((B,), i, dtype=torch.long, device=x_start.device)
        eps_true = (noise[j].to(x_start.dtype) if noise is not None else
                    torch.randn(x_start.shape, generator=generator, device=x_start.device,
                                dtype=x_start.dtype))
        x_t = q_sample(s, x_start, t, eps_true)
        out = vb_terms_bpd(model_fn, s, x_start, x_t, t, clip_denoised=clip_denoised)
        vb.append(out["output"])
        xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
        eps = predict_eps_from_xstart(s, x_t, t, out["pred_xstart"])
        mse.append(mean_flat((eps - eps_true) ** 2))
    vb = torch.stack(vb, dim=1)
    pb = prior_bpd(s, x_start)
    return {"total_bpd": vb.sum(dim=1) + pb, "prior_bpd": pb, "vb": vb,
            "xstart_mse": torch.stack(xstart_mse, dim=1), "mse": torch.stack(mse, dim=1)}
