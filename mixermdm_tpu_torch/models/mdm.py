"""MDM denoiser, the single-person Tevet-style transformer encoder;
counterpart of ``mixermdm_tpu/models/mdm.py:MDMDenoiser`` (reference
mdm.py:234-320).

The cond + timestep token goes first in the sequence and its frame is always
valid; the stack is torch's post-norm ``TransformerEncoder`` with GELU and
no zero-attn (:class:`.torch_compat.TorchEncoder`), so on the card its
attention runs the ``attention`` kernel without the zero key, under the key
mask, and its dense layers the ``linear_epilogue`` routes.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .embeddings import PositionalEncoding, TimestepEmbedder
from .layers import Linear
from .torch_compat import TorchEncoder


class MDMDenoiser(nn.Module):
    """x (B, T, F), cond (B, latent_dim) -> (B, T, F).  ``text_dim`` is the
    reference's declared 256, metadata only (the cond is latent_dim wide
    after ``embed_text``)."""

    def __init__(self, input_feats: int, latent_dim: int = 512, ff_size: int = 1024,
                 num_layers: int = 8, num_heads: int = 4, text_dim: int = 256,
                 dropout: float = 0.0):
        super().__init__()
        self.input_feats, self.text_dim = input_feats, text_dim
        self.embed_timestep = TimestepEmbedder(latent_dim)
        self.input_process = Linear(input_feats, latent_dim)
        self.sequence_pos_encoder = PositionalEncoding(latent_dim)
        self.seqTransEncoder = TorchEncoder(latent_dim, num_heads, ff_size, num_layers, dropout)
        self.output_process = Linear(latent_dim, input_feats)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                mask: Optional[torch.Tensor] = None, cond: Optional[torch.Tensor] = None):
        B, T = x.shape[:2]
        cond_tok = (cond + self.embed_timestep(timesteps, x.dtype))[:, None, :]
        h = self.input_process(x)
        if mask is None:
            valid = torch.ones(B, T, dtype=torch.bool, device=x.device)
        else:
            valid = (mask[..., 0] if mask.dim() == 3 else mask) > 0.5
        kpm = ~torch.cat([torch.ones(B, 1, dtype=torch.bool, device=x.device), valid], 1)
        xseq = self.sequence_pos_encoder(torch.cat([cond_tok, h], 1))
        return self.output_process(self.seqTransEncoder(xseq, kpm)[:, 1:])
