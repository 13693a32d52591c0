"""Timestep draw for training; counterpart of the uniform sampler of
``mixermdm_tpu/diffusion/samplers.py`` (``uniform_sample``,
``create_named_schedule_sampler``; reference gaussian_diffusion.py:23-86).
The loss-aware sampler is not part of the mixer's training (its config says
``SAMPLER: uniform``) and is not ported."""

from __future__ import annotations

from typing import Optional

import torch


def uniform_sample(generator: Optional[torch.Generator], batch: int, num_timesteps: int,
                   device="cpu") -> torch.Tensor:
    """Uniform t in [0, num_timesteps) (the importance weights are all ones,
    and the mixer's loss discards them, as the reference does)."""
    return torch.randint(0, num_timesteps, (batch,), generator=generator, device=device)


def named_schedule_sampler(name: str, num_timesteps: int):
    """``sample(generator, batch, device) -> t`` for a config's SAMPLER
    name."""
    if name != "uniform":
        raise NotImplementedError(f"schedule sampler {name!r} is not ported (uniform is)")
    return lambda generator, batch, device="cpu": uniform_sample(generator, batch,
                                                                 num_timesteps, device)
