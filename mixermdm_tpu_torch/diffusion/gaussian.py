"""The DDPM/DDIM pieces the dual-stream chain and the mixer's training use;
counterpart of the matching functions of ``mixermdm_tpu/diffusion/gaussian.py``."""

from __future__ import annotations

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
