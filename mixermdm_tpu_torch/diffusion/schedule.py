"""Beta schedules, DDIM respacing and the precomputed schedule arrays;
counterpart of ``mixermdm_tpu/diffusion/schedule.py``.  Computed once on the
host in float64 (as the reference) and stored as f32 tensors on the device."""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch


def linear_betas(num_timesteps: int) -> np.ndarray:
    scale = 1000.0 / num_timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, num_timesteps, dtype=np.float64)


def cosine_betas(num_timesteps: int, max_beta: float = 0.999) -> np.ndarray:
    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    return np.array([min(1 - alpha_bar((i + 1) / num_timesteps) / alpha_bar(i / num_timesteps),
                         max_beta) for i in range(num_timesteps)], dtype=np.float64)


def get_named_beta_schedule(name: str, num_timesteps: int) -> np.ndarray:
    if name == "linear":
        return linear_betas(num_timesteps)
    if name == "cosine":
        return cosine_betas(num_timesteps)
    raise NotImplementedError(f"unknown beta schedule: {name}")


def space_timesteps(num_timesteps: int, section_counts) -> list[int]:
    """Sorted original timesteps to keep; ``"ddimN"`` uses DDIM striding."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return sorted(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    elif isinstance(section_counts, int):
        section_counts = [section_counts]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx, all_steps = 0, []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        frac_stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return sorted(set(all_steps))


class DiffusionSchedule(NamedTuple):
    """The per-timestep arrays the DDIM chain reads, indexed by the
    (respaced) timestep; ``timestep_map[i]`` is the original timestep fed to
    the model."""

    betas: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    timestep_map: torch.Tensor  # int64
    sqrt_alphas_cumprod: torch.Tensor           # q_sample (training)
    sqrt_one_minus_alphas_cumprod: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def make_schedule(betas: np.ndarray, use_timesteps: Sequence[int] | None = None,
                  device="cpu") -> DiffusionSchedule:
    betas = np.asarray(betas, dtype=np.float64)
    if not (betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()):
        raise ValueError("betas must be a 1-d array in (0, 1]")
    if use_timesteps is not None:
        use = set(int(t) for t in use_timesteps)
        last, new_betas, timestep_map = 1.0, [], []
        for i, ac in enumerate(np.cumprod(1.0 - betas)):
            if i in use:
                new_betas.append(1.0 - ac / last)
                last = ac
                timestep_map.append(i)
        betas = np.array(new_betas, dtype=np.float64)
    else:
        timestep_map = list(range(len(betas)))
    alphas_cumprod = np.cumprod(1.0 - betas)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])

    def arr(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return DiffusionSchedule(
        betas=arr(betas),
        alphas_cumprod_prev=arr(alphas_cumprod_prev),
        sqrt_recip_alphas_cumprod=arr(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=arr(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        timestep_map=torch.tensor(timestep_map, dtype=torch.long, device=device),
        sqrt_alphas_cumprod=arr(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=arr(np.sqrt(1.0 - alphas_cumprod)),
    )


def named_schedule(beta_scheduler: str, diffusion_steps: int,
                   respacing: str | int | None = None, device="cpu") -> DiffusionSchedule:
    """E.g. ``named_schedule("cosine", 1000, "ddim50")``."""
    betas = get_named_beta_schedule(beta_scheduler, diffusion_steps)
    use = None if respacing is None else space_timesteps(diffusion_steps, respacing)
    return make_schedule(betas, use, device=device)


def resolve_sampler_strategy(cfg) -> tuple:
    """``(sampler_type, strategy)`` from a system config; ``STRATEGY: dpmppN``
    means the DPM-Solver++ sampler over ddim-strided N steps."""
    strategy = cfg.get("STRATEGY", "ddim50")
    sampler = str(cfg.get("SAMPLER_TYPE", "ddim")).lower()
    if isinstance(strategy, str) and strategy.startswith("dpmpp"):
        sampler, strategy = "dpmpp", "ddim" + strategy[len("dpmpp"):]
    if sampler not in ("ddim", "dpmpp"):
        raise ValueError(f"unknown SAMPLER_TYPE {sampler!r}")
    return sampler, strategy
