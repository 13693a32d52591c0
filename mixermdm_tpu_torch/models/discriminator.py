"""Timestep- and text-conditioned sequence discriminator with per-frame
logits; counterpart of ``mixermdm_tpu/models/discriminator.py`` (reference
discriminators.py:7-77).  MixerMDM trains two: the individual head (262
features) and the interaction head (524).  Parameter names follow the
reference, so ``weights.export_discriminator`` state dicts load as they are.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .blocks import TransformerBlockSimple
from .embeddings import PositionalEncoding, TimestepEmbedder
from .layers import Linear


class DiscriminatorTransformer(nn.Module):
    def __init__(self, input_feats: int, latent_dim: int = 256, ff_size: int = 512,
                 num_layers: int = 2, num_heads: int = 4, text_emb_dim: int = 768,
                 dropout: float = 0.0):
        super().__init__()
        self.embed_timestep = TimestepEmbedder(latent_dim)
        self.text_embed = Linear(text_emb_dim, latent_dim)
        self.motion_embed = Linear(input_feats, latent_dim)
        self.sequence_pos_encoder = PositionalEncoding(latent_dim)
        self.blocks = nn.ModuleList(
            TransformerBlockSimple(latent_dim, num_heads, ff_size, dropout)
            for _ in range(num_layers))
        self.out = Linear(latent_dim, 1)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, input_feats), timesteps (B,), mask (B, T[, k]) with 1 on
        valid frames, cond (B, text_emb_dim) -> (B, T, 1) logits in x's
        dtype."""
        emb = self.embed_timestep(timesteps, x.dtype) + self.text_embed(cond)
        h = self.sequence_pos_encoder(self.motion_embed(x))
        kpm = None
        if mask is not None:
            m = mask[..., 0] if mask.dim() == 3 else mask
            kpm = ~(m > 0.5)
        for block in self.blocks:
            h = block(h, emb, kpm)
        return self.out(h)
