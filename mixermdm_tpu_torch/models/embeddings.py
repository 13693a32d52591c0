"""Positional and timestep embeddings; counterpart of
``mixermdm_tpu/models/embeddings.py`` (reference utils.py:24-55)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .layers import Linear

MAX_LEN = 5000  # table length of the reference buffers (sequence positions, timesteps)


def sinusoidal_table(max_len: int, d_model: int) -> torch.Tensor:
    """The sin/cos table of the reference buffer ``pe``, computed in f64."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.from_numpy(pe.astype(np.float32))


class PositionalEncoding(nn.Module):
    """Adds the sinusoidal table to a (B, T, D) sequence."""

    def __init__(self, d_model: int):
        super().__init__()
        self.register_buffer("pe", sinusoidal_table(MAX_LEN, d_model), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pe[: x.shape[1]].to(x.dtype)


class TimestepEmbedder(nn.Module):
    """MLP(SiLU) over pe[t]; returns (B, D) in ``dtype``."""

    def __init__(self, latent_dim: int):
        super().__init__()
        self.register_buffer("pe", sinusoidal_table(MAX_LEN, latent_dim), persistent=False)
        self.time_embed = nn.Sequential(Linear(latent_dim, latent_dim), nn.SiLU(),
                                        Linear(latent_dim, latent_dim))

    def forward(self, timesteps: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.time_embed(self.pe[timesteps].to(dtype))
