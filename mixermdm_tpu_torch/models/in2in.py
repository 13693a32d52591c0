"""in2IN denoiser, individual and interaction modes; counterpart of
``mixermdm_tpu/models/in2in.py:In2INDenoiser`` (reference in2in.py:358-463).

As in the JAX package the two person streams of the interaction mode are
stacked into the batch axis (2B) so every layer runs once at double batch;
the cross-person partner is the swapped half of the stack.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .blocks import TransformerBlockDoubleCond
from .embeddings import PositionalEncoding, TimestepEmbedder
from .layers import FinalLayer, Linear

MODES = ("individual", "interaction")


class In2INDenoiser(nn.Module):
    """Text-conditioned motion denoiser.

    * ``individual``:  x (B, T, F), cond (B, text_dim).
    * ``interaction``: x (B, T, 2F), cond (B, 3 * text_dim) ordered [I, i1, i2].

    The dual (DualMDM) modes of the JAX package are not part of the sampling
    path and are not ported yet.
    """

    def __init__(self, input_feats: int, mode: str, latent_dim: int = 512,
                 ff_size: int = 1024, num_layers: int = 8, num_heads: int = 8,
                 text_dim: int = 768):
        super().__init__()
        if mode not in MODES:
            raise NotImplementedError(f"In2INDenoiser mode {mode!r} is not ported (have {MODES})")
        self.input_feats, self.mode, self.text_dim = input_feats, mode, text_dim
        self.embed_timestep = TimestepEmbedder(latent_dim)
        self.text_embed = Linear(text_dim, latent_dim)
        self.motion_embed = Linear(input_feats, latent_dim)
        self.sequence_pos_encoder = PositionalEncoding(latent_dim)
        self.blocks = nn.ModuleList(
            TransformerBlockDoubleCond(mode, latent_dim, num_heads, ff_size)
            for _ in range(num_layers))
        self.out = FinalLayer(latent_dim, input_feats)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                mask: Optional[torch.Tensor] = None, cond: Optional[torch.Tensor] = None):
        B, F, td = x.shape[0], self.input_feats, self.text_dim
        t_emb = self.embed_timestep(timesteps, x.dtype)
        # mask None: no key is masked (the JAX package's all-False mask).
        kpm = None
        if mask is not None:
            m = mask[..., 0] if mask.dim() == 3 else mask
            kpm = ~(m > 0.5)

        if self.mode == "individual":
            emb = t_emb + self.text_embed(cond[:, :td])
            h = self.sequence_pos_encoder(self.motion_embed(x[..., :F]))
            for block in self.blocks:
                h = block(h, None, emb, None, kpm)
            return self.out(h)

        emb_inter = t_emb + self.text_embed(cond[:, :td])
        emb_i1 = t_emb + self.text_embed(cond[:, td:2 * td])
        emb_i2 = t_emb + self.text_embed(cond[:, 2 * td:3 * td])
        h = self.sequence_pos_encoder(self.motion_embed(torch.cat([x[..., :F], x[..., F:]], 0)))
        emb = torch.cat([emb_i1, emb_i2], 0)
        emb_inter2 = torch.cat([emb_inter, emb_inter], 0)
        kpm2 = None if kpm is None else torch.cat([kpm, kpm], 0)
        for block in self.blocks:
            partner = torch.cat([h[B:], h[:B]], 0)
            h = block(h, partner, emb, emb_inter2, kpm2)
        out = self.out(h)
        return torch.cat([out[:B], out[B:]], dim=-1)
