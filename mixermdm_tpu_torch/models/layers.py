"""NN primitives: dense layers, AdaLN, torch-compatible multi-head attention,
the AdaLN-conditioned attention / FFN sub-blocks.

Counterpart of ``mixermdm_tpu/models/layers.py``.  Parameter names follow
the reference PyTorch modules (``nn.MultiheadAttention``'s
``in_proj_weight`` / ``in_proj_bias`` / ``out_proj``, AdaLN's
``emb_layers.1``), so exported state dicts load as they are.

Dispatch (the JAX package's ``_fusable_block``): the sub-blocks always call
the fused entry points of :mod:`..ops`, which run their plain versions for
CPU tensors and their kernels for CUDA tensors (raising on a dtype or shape
the kernels do not take, so float32 on the card runs only inside
``ops.plain_versions()``).

``add_zero_attn``: the reference appends an always-attendable zero key/value
after the input projection; the attention ops do that algebraically.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import fused_attention, fused_ca_block, fused_ffn_block, fused_sa_block, linear


class Linear(nn.Linear):
    """``nn.Linear`` whose product runs on the ``linear_epilogue`` kernel on
    the card; ``zero_init`` marks the reference's ``zero_module`` layers."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 zero_init: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.zero_init = zero_init

    def forward(self, x, activation: Optional[str] = None, residual=None):
        return linear(x, self.weight, self.bias, activation=activation, residual=residual)


def ZeroLinear(in_features: int, out_features: int) -> Linear:
    return Linear(in_features, out_features, zero_init=True)


class AdaLN(nn.Module):
    """Adaptive LayerNorm conditioned on a (B, E) embedding: a zero-init
    SiLU-MLP gives per-batch scale and shift (reference layers.py:3-25)."""

    def __init__(self, latent_dim: int):
        super().__init__()
        self.emb_layers = nn.Sequential(nn.SiLU(), ZeroLinear(latent_dim, 2 * latent_dim))

    def modulation(self, emb: torch.Tensor, dtype: torch.dtype):
        """(scale, shift), each (B, E) in ``dtype``."""
        scale, shift = self.emb_layers(emb).to(dtype).chunk(2, dim=-1)
        return scale, shift


class TorchMultiheadAttention(nn.Module):
    """``nn.MultiheadAttention`` (batch first) with its parameter layout;
    ``forward`` is self-attention, the form the text towers use."""

    def __init__(self, embed_dim: int, num_heads: int, add_zero_attn: bool = True):
        super().__init__()
        self.embed_dim, self.num_heads, self.add_zero_attn = embed_dim, num_heads, add_zero_attn
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)
        bound = embed_dim ** -0.5
        nn.init.uniform_(self.in_proj_weight, -bound, bound)
        nn.init.uniform_(self.in_proj_bias, -bound, bound)

    def forward(self, x: torch.Tensor, key_padding_mask=None, attn_mask=None) -> torch.Tensor:
        B, T, E = x.shape
        H = self.num_heads
        qkv = linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.view(B, T, H, E // H).transpose(1, 2) for t in qkv.split(E, dim=-1))
        out = fused_attention(q, k, v, key_padding_mask, attn_mask, self.add_zero_attn)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, E))


class VanillaSelfAttention(nn.Module):
    """AdaLN-conditioned self-attention (reference layers.py:28-45), as one
    :func:`fused_sa_block` call."""

    def __init__(self, latent_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm = AdaLN(latent_dim)
        self.attention = TorchMultiheadAttention(latent_dim, num_heads)

    def forward(self, x, emb, key_padding_mask=None, residual: bool = False):
        scale, shift = self.norm.modulation(emb, x.dtype)
        a = self.attention
        return fused_sa_block(x, scale, shift, a.in_proj_weight, a.in_proj_bias,
                              a.out_proj.weight, a.out_proj.bias, key_padding_mask,
                              n_heads=self.num_heads, residual=residual)


class VanillaCrossAttention(nn.Module):
    """AdaLN-conditioned cross-attention, x attends to xf (reference
    layers.py:68-88), as one :func:`fused_ca_block` call."""

    def __init__(self, latent_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm = AdaLN(latent_dim)
        self.xf_norm = AdaLN(latent_dim)
        self.attention = TorchMultiheadAttention(latent_dim, num_heads)

    def forward(self, x, xf, emb, key_padding_mask=None, residual: bool = False):
        scale, shift = self.norm.modulation(emb, x.dtype)
        xf_scale, xf_shift = self.xf_norm.modulation(emb, x.dtype)
        a = self.attention
        return fused_ca_block(x, xf, scale, shift, xf_scale, xf_shift, a.in_proj_weight,
                              a.in_proj_bias, a.out_proj.weight, a.out_proj.bias,
                              key_padding_mask, n_heads=self.num_heads, residual=residual)


class FFN(nn.Module):
    """AdaLN-conditioned exact-GELU MLP with a zero-init output (reference
    layers.py:91-106), as one :func:`fused_ffn_block` call."""

    def __init__(self, latent_dim: int, ffn_dim: int):
        super().__init__()
        self.linear1 = Linear(latent_dim, ffn_dim)
        self.linear2 = ZeroLinear(ffn_dim, latent_dim)
        self.norm = AdaLN(latent_dim)

    def forward(self, x, emb, residual: bool = False):
        scale, shift = self.norm.modulation(emb, x.dtype)
        return fused_ffn_block(x, scale, shift, self.linear1.weight, self.linear1.bias,
                               self.linear2.weight, self.linear2.bias, residual=residual)


class FinalLayer(nn.Module):
    """Zero-init output projection (reference layers.py:109-116)."""

    def __init__(self, latent_dim: int, out_dim: int):
        super().__init__()
        self.linear = ZeroLinear(latent_dim, out_dim)

    def forward(self, x):
        return self.linear(x)
