"""in2IN denoiser in its four modes; counterpart of
``mixermdm_tpu/models/in2in.py:In2INDenoiser`` (reference in2in.py:358-463).

As in the JAX package the two person streams are stacked into the batch
axis (2B) so every layer runs once at double batch; in the interaction modes
the cross-person partner is the swapped half of the stack.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .blocks import TransformerBlockDoubleCond
from .embeddings import PositionalEncoding, TimestepEmbedder
from .layers import FinalLayer, Linear

MODES = ("individual", "interaction", "dual_individual", "dual_interaction")


class In2INDenoiser(nn.Module):
    """Text-conditioned motion denoiser.

    * ``individual``:       x (B, T, F), cond (B, text_dim).
    * ``interaction``:      x (B, T, 2F), cond (B, 3 * text_dim) ordered
                            [I, i1, i2].
    * ``dual_interaction``: as ``interaction``, on the first three slices of
                            DualMDM's (B, 5 * text_dim) cond.
    * ``dual_individual``:  x (B, T, 2F), DualMDM's cond, slices [3] and [4]
                            for persons a and b; no cross-attention.  The
                            reference quirk (in2in.py:441-452) is kept: person
                            b's stream is never carried from block to block,
                            so it is only the LAST block applied to its raw
                            embedding, while person a runs the whole stack.
    """

    def __init__(self, input_feats: int, mode: str, latent_dim: int = 512,
                 ff_size: int = 1024, num_layers: int = 8, num_heads: int = 8,
                 text_dim: int = 768):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown In2INDenoiser mode {mode!r} (have {MODES})")
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
        emb_of = lambda i: t_emb + self.text_embed(cond[:, i * td:(i + 1) * td])  # noqa: E731
        # mask None: no key is masked (the JAX package's all-False mask).
        kpm = None
        if mask is not None:
            m = mask[..., 0] if mask.dim() == 3 else mask
            kpm = ~(m > 0.5)

        if self.mode == "individual":
            h = self.sequence_pos_encoder(self.motion_embed(x[..., :F]))
            emb = emb_of(0)
            for block in self.blocks:
                h = block(h, None, emb, None, kpm)
            return self.out(h)

        h = self.sequence_pos_encoder(self.motion_embed(torch.cat([x[..., :F], x[..., F:]], 0)))
        kpm2 = None if kpm is None else torch.cat([kpm, kpm], 0)
        if self.mode == "dual_individual":
            h_a, h_b0 = h[:B], h[B:]
            emb_a, emb_b = emb_of(3), emb_of(4)
            for block in self.blocks[:-1]:
                h_a = block(h_a, None, emb_a, None, kpm)
            # The last block takes person a's stream and person b's raw
            # embedding stacked, one call at 2B rows.
            h = self.blocks[-1](torch.cat([h_a, h_b0], 0), None, torch.cat([emb_a, emb_b], 0),
                                None, kpm2)
        else:  # interaction, dual_interaction
            emb = torch.cat([emb_of(1), emb_of(2)], 0)
            emb_inter = emb_of(0)
            emb_inter2 = torch.cat([emb_inter, emb_inter], 0)
            for block in self.blocks:
                partner = torch.cat([h[B:], h[:B]], 0)
                h = block(h, partner, emb, emb_inter2, kpm2)
        out = self.out(h)
        return torch.cat([out[:B], out[B:]], dim=-1)
