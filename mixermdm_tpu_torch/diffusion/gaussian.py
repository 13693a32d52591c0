"""The DDPM/DDIM pieces the dual-stream chain and the mixer's training use;
counterpart of the matching functions of ``mixermdm_tpu/diffusion/gaussian.py``."""

from __future__ import annotations

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
