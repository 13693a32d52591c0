"""InterGen denoiser: weight-shared person streams with cross-person
attention; counterpart of ``mixermdm_tpu/models/intergen.py:InterDenoiser``
(reference intergen.py:215-290).

As in the JAX package (and in :mod:`.in2in`) the two person streams are
stacked into the batch axis (2B) and each layer runs once; the partner
stream is the swapped half of the stack.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .blocks import TransformerBlock
from .embeddings import PositionalEncoding, TimestepEmbedder
from .layers import FinalLayer, Linear


class InterDenoiser(nn.Module):
    """x (B, T, 2F), cond (B, >= text_dim) (the first ``text_dim`` columns
    are read) -> (B, T, 2F)."""

    def __init__(self, input_feats: int, latent_dim: int = 512, ff_size: int = 1024,
                 num_layers: int = 8, num_heads: int = 8, text_dim: int = 768,
                 dropout: float = 0.0):
        super().__init__()
        self.input_feats, self.text_dim = input_feats, text_dim
        self.embed_timestep = TimestepEmbedder(latent_dim)
        self.text_embed = Linear(text_dim, latent_dim)
        self.motion_embed = Linear(input_feats, latent_dim)
        self.sequence_pos_encoder = PositionalEncoding(latent_dim)
        self.blocks = nn.ModuleList(TransformerBlock(latent_dim, num_heads, ff_size, dropout)
                                    for _ in range(num_layers))
        self.out = FinalLayer(latent_dim, input_feats)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                mask: Optional[torch.Tensor] = None, cond: Optional[torch.Tensor] = None):
        B, F = x.shape[0], self.input_feats
        emb = self.embed_timestep(timesteps, x.dtype) + self.text_embed(cond[:, :self.text_dim])
        kpm2 = None
        if mask is not None:
            m = mask[..., 0] if mask.dim() == 3 else mask
            kpm2 = torch.cat([~(m > 0.5)] * 2, 0)
        h = self.sequence_pos_encoder(self.motion_embed(torch.cat([x[..., :F], x[..., F:]], 0)))
        emb2 = torch.cat([emb, emb], 0)
        for block in self.blocks:
            h = block(h, torch.cat([h[B:], h[:B]], 0), emb2, kpm2)
        out = self.out(h)
        return torch.cat([out[:B], out[B:]], dim=-1)
