"""Timestep draws for training: uniform, and the loss-second-moment
importance sampler; counterpart of ``mixermdm_tpu/diffusion/samplers.py``
(``uniform_sample``, ``loss_aware_*``, ``create_named_schedule_sampler``;
reference gaussian_diffusion.py:23-175).

The loss-aware history lives in tensors on the training device and is
updated by tensor ops only (no host sync); both trainers discard the
importance weights, as the reference does (``t, _ = sampler.sample(...)``).
"""

from __future__ import annotations

from typing import Optional

import torch


def uniform_sample(generator: Optional[torch.Generator], batch: int, num_timesteps: int,
                   device="cpu") -> torch.Tensor:
    """Uniform t in [0, num_timesteps) (the importance weights are all ones)."""
    return torch.randint(0, num_timesteps, (batch,), generator=generator, device=device)


class UniformSampler:
    """Uniform t with unit weights (reference :70-86); no state."""

    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def sample(self, generator, batch: int, device="cpu"):
        t = uniform_sample(generator, batch, self.num_timesteps, device)
        return t, torch.ones(batch, device=device)

    def update(self, t: torch.Tensor, losses: torch.Tensor) -> None:
        pass

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass


# The loss-aware sampler's history length per timestep and the uniform share
# mixed into its weights (reference :135-160).
HISTORY_SIZE, UNIFORM_PROB = 10, 0.001


class LossSecondMomentSampler:
    """Importance sampling of t by sqrt(E[loss^2]) over the last
    HISTORY_SIZE losses of each timestep, uniform until every timestep's
    history is full (reference :135-175; JAX ``loss_aware_*``).
    ``history`` (T, H) f32 and ``counts`` (T,) live on ``device``."""

    def __init__(self, num_timesteps: int, device="cpu"):
        self.num_timesteps = num_timesteps
        self.history = torch.zeros((num_timesteps, HISTORY_SIZE), device=device)
        self.counts = torch.zeros((num_timesteps,), dtype=torch.long, device=device)

    def weights(self) -> torch.Tensor:
        """(T,) sampling probabilities (reference :149-160)."""
        T, H = self.history.shape
        w = torch.sqrt((self.history ** 2).mean(dim=-1))
        w = w / w.sum()
        w = w * (1 - UNIFORM_PROB) + UNIFORM_PROB / T
        return torch.where((self.counts == H).all(), w, torch.full_like(w, 1.0 / T))

    def sample(self, generator, batch: int, device="cpu"):
        """(t, 1 / (T p[t])) (reference :60-68)."""
        p = self.weights().to(device)
        t = torch.multinomial(p, batch, replacement=True, generator=generator)
        return t, 1.0 / (p.shape[0] * p[t])

    @torch.no_grad()
    def update(self, t: torch.Tensor, losses: torch.Tensor) -> None:
        """Insert each sample's loss into its timestep's history, in batch
        order: a full history shifts left and appends, a filling one takes
        the next free slot (reference :162-175)."""
        H = self.history.shape[1]
        t = t.to(self.history.device)
        losses = losses.detach().to(self.history.device, torch.float32)
        slots = torch.arange(H, device=self.history.device)
        for i in range(t.shape[0]):
            ti, li = t[i], losses[i]
            row, c = self.history[ti], self.counts[ti]
            shifted = torch.cat([row[1:], li[None]])
            filled = torch.where(slots == c, li, row)
            self.history[ti] = torch.where(c == H, shifted, filled)
            self.counts[ti] = torch.clamp(c + 1, max=H)

    def state_dict(self) -> dict:
        return {"history": self.history.clone(), "counts": self.counts.clone()}

    def load_state_dict(self, state: dict) -> None:
        self.history.copy_(state["history"])
        self.counts.copy_(state["counts"])


def create_named_schedule_sampler(name: str, num_timesteps: int, device="cpu"):
    """The sampler a config's ``SAMPLER`` names (reference :23-33):
    "uniform" or "loss-second-moment"."""
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentSampler(num_timesteps, device=device)
    raise NotImplementedError(f"unknown schedule sampler: {name}")


def named_schedule_sampler(name: str, num_timesteps: int):
    """``sample(generator, batch, device) -> t`` for the mixer's loss: the
    named sampler at its initial state, which the mixer never updates (the
    JAX ``_loss_body`` draws from ``_sampler_state0``)."""
    sampler = create_named_schedule_sampler(name, num_timesteps)
    return lambda generator, batch, device="cpu": sampler.sample(generator, batch, device)[0]
