"""``nn.TransformerEncoder``-style stack (post-norm, exact GELU) and the CLIP
post-encoder; counterpart of ``mixermdm_tpu/models/torch_compat.py``
(reference in2in.py:25-53, mixermdm.py:244-256)."""

from __future__ import annotations

import torch
from torch import nn

from .layers import Linear, TorchMultiheadAttention


class LayerNormAffine(nn.Module):
    """LayerNorm with learnable weight/bias, eps 1e-5, f32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


class TorchEncoderLayer(nn.Module):
    """One ``nn.TransformerEncoderLayer`` (batch first, post-norm, gelu,
    attention without zero-attn), with its dropouts (attention probabilities,
    attention output, FFN hidden, FFN output) active in training mode only."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dropout: float = 0.0):
        super().__init__()
        self.self_attn = TorchMultiheadAttention(d_model, nhead, add_zero_attn=False,
                                                 dropout=dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNormAffine(d_model)
        self.norm2 = LayerNormAffine(d_model)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, key_padding_mask=None, attn_mask=None):
        x = self.norm1(x + self.dropout(self.self_attn(x, key_padding_mask, attn_mask)))
        h = self.dropout(self.linear1(x, activation="gelu"))
        return self.norm2(x + self.dropout(self.linear2(h)))


class TorchEncoder(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, num_layers: int,
                 dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            TorchEncoderLayer(d_model, nhead, dim_feedforward, dropout)
            for _ in range(num_layers))

    def forward(self, x, key_padding_mask=None, attn_mask=None):
        for layer in self.layers:
            x = layer(x, key_padding_mask, attn_mask)
        return x


class ClipPostEncoder(nn.Module):
    """Two encoder layers + LayerNorm over CLIP token features (returns
    per-token features; EOT pooling happens in the text pipeline)."""

    def __init__(self, d_model: int = 768, num_layers: int = 2, dim_feedforward: int = 2048,
                 nhead: int = 8, dropout: float = 0.1):
        super().__init__()
        # dropout 0.1 as the reference post-encoders (in2in.py:29); the
        # mixer's training encodes its conds in eval mode, as the JAX package
        # does (systems/mixermdm.py: encode_cond), so it never drops there.
        self.encoder = TorchEncoder(d_model, nhead, dim_feedforward, num_layers, dropout)
        self.ln = LayerNormAffine(d_model)
        for layer in self.encoder.layers:  # the conds keep their arithmetic (layers.py)
            layer.self_attn.f32_route = "rows"

    def forward(self, clip_tokens: torch.Tensor) -> torch.Tensor:
        return self.ln(self.encoder(clip_tokens))
