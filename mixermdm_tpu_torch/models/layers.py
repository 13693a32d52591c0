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

W8A8 (the JAX package's ``w8a8_scope`` / ``_w8a8_for``): inside
:func:`w8a8_scope`, the SA, CA and FFN sub-blocks whose width is at least the
gate (:data:`W8A8_MIN_DIM`, :func:`set_w8a8_min_dim`) run their projections as
int8 on bf16 activations, through the ``_q8`` entry points, at the widths
where the JAX package takes its fused blocks (latent % 128 == 0, head dim %
64 == 0, FFN width % 128 == 0; elsewhere it never quantises).  Their int8
weights and scales are non-persistent buffers (derived state, never in a
state dict), quantised from the current weights once and again only after a
weight changed.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from ..ops import (
    fused_attention,
    fused_ca_block,
    fused_ca_block_q8,
    fused_ffn_block,
    fused_ffn_block_q8,
    fused_sa_block,
    fused_sa_block_q8,
    linear,
    quantize_weight,
)

# Width from which the JAX package runs the fused-block projections as int8
# under QUANT_FROZEN (mixermdm_tpu/models/layers.py: _W8A8_MIN_DIM): both
# 1024-d denoisers and the 512-d mixer core.
W8A8_MIN_DIM = 512
_w8a8 = False
_w8a8_min_dim = W8A8_MIN_DIM


def set_w8a8_min_dim(n: int) -> None:
    """Override the int8 width gate (tests and experiments: a tiny model
    is below the shipped gate)."""
    global _w8a8_min_dim
    _w8a8_min_dim = int(n)


@contextlib.contextmanager
def w8a8_scope(enabled: bool = True):
    """Run the gated sub-blocks as int8 inside the block.  Enable-only:
    ``w8a8_scope(False)`` leaves the current state as it is."""
    global _w8a8
    prev = _w8a8
    _w8a8 = prev or bool(enabled)
    try:
        yield
    finally:
        _w8a8 = prev


class Int8Block(nn.Module):
    """A sub-block whose projections run as int8 inside :func:`w8a8_scope`.

    Subclasses name the weights to quantise in :meth:`_int8_sources`; each
    gets the buffers ``<name>_q8`` (int8, torch layout) and ``<name>_scale``
    (f32, one per output row)."""

    def __init__(self, latent_dim: int, fusable: bool):
        super().__init__()
        self.latent_dim = latent_dim
        self.fusable = fusable  # the JAX package fuses (and so may quantise) this block
        self._int8_key = None

    def _int8_sources(self) -> dict:
        raise NotImplementedError

    def runs_int8(self, dtype: torch.dtype) -> bool:
        """Whether a call in ``dtype`` runs as int8 here and now."""
        return (_w8a8 and self.fusable and dtype == torch.bfloat16
                and self.latent_dim >= _w8a8_min_dim)

    def int8_weights(self) -> list:
        """[w8, scale] per source weight, quantised again only if a weight
        was replaced or changed in place since the last call."""
        sources = self._int8_sources()
        key = tuple((w.data_ptr(), w._version) for w in sources.values())
        if key != self._int8_key:
            for name, w in sources.items():
                w8, s = quantize_weight(w)
                self.register_buffer(f"{name}_q8", w8, persistent=False)
                self.register_buffer(f"{name}_scale", s, persistent=False)
            self._int8_key = key
        return [getattr(self, f"{name}_{kind}") for name in sources for kind in ("q8", "scale")]


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


def _attention_fusable(latent_dim: int, num_heads: int) -> bool:
    return latent_dim % 128 == 0 and (latent_dim // num_heads) % 64 == 0


class VanillaSelfAttention(Int8Block):
    """AdaLN-conditioned self-attention (reference layers.py:28-45), as one
    :func:`fused_sa_block` (or :func:`fused_sa_block_q8`) call."""

    def __init__(self, latent_dim: int, num_heads: int):
        super().__init__(latent_dim, _attention_fusable(latent_dim, num_heads))
        self.num_heads = num_heads
        self.norm = AdaLN(latent_dim)
        self.attention = TorchMultiheadAttention(latent_dim, num_heads)

    def _int8_sources(self) -> dict:
        return {"w_qkv": self.attention.in_proj_weight, "w_o": self.attention.out_proj.weight}

    def forward(self, x, emb, key_padding_mask=None, residual: bool = False):
        scale, shift = self.norm.modulation(emb, x.dtype)
        a = self.attention
        if self.runs_int8(x.dtype):
            w8_qkv, s_qkv, w8_o, s_o = self.int8_weights()
            return fused_sa_block_q8(x, scale, shift, w8_qkv, s_qkv, a.in_proj_bias, w8_o, s_o,
                                     a.out_proj.bias, key_padding_mask,
                                     n_heads=self.num_heads, residual=residual)
        return fused_sa_block(x, scale, shift, a.in_proj_weight, a.in_proj_bias,
                              a.out_proj.weight, a.out_proj.bias, key_padding_mask,
                              n_heads=self.num_heads, residual=residual)


class VanillaCrossAttention(Int8Block):
    """AdaLN-conditioned cross-attention, x attends to xf (reference
    layers.py:68-88), as one :func:`fused_ca_block` (or
    :func:`fused_ca_block_q8`) call."""

    def __init__(self, latent_dim: int, num_heads: int):
        super().__init__(latent_dim, _attention_fusable(latent_dim, num_heads))
        self.num_heads = num_heads
        self.norm = AdaLN(latent_dim)
        self.xf_norm = AdaLN(latent_dim)
        self.attention = TorchMultiheadAttention(latent_dim, num_heads)

    def _int8_sources(self) -> dict:
        return {"w_qkv": self.attention.in_proj_weight, "w_o": self.attention.out_proj.weight}

    def forward(self, x, xf, emb, key_padding_mask=None, residual: bool = False):
        scale, shift = self.norm.modulation(emb, x.dtype)
        xf_scale, xf_shift = self.xf_norm.modulation(emb, x.dtype)
        a = self.attention
        if self.runs_int8(x.dtype):
            w8_qkv, s_qkv, w8_o, s_o = self.int8_weights()
            return fused_ca_block_q8(x, xf, scale, shift, xf_scale, xf_shift, w8_qkv, s_qkv,
                                     a.in_proj_bias, w8_o, s_o, a.out_proj.bias,
                                     key_padding_mask, n_heads=self.num_heads,
                                     residual=residual)
        return fused_ca_block(x, xf, scale, shift, xf_scale, xf_shift, a.in_proj_weight,
                              a.in_proj_bias, a.out_proj.weight, a.out_proj.bias,
                              key_padding_mask, n_heads=self.num_heads, residual=residual)


class FFN(Int8Block):
    """AdaLN-conditioned exact-GELU MLP with a zero-init output (reference
    layers.py:91-106), as one :func:`fused_ffn_block` (or
    :func:`fused_ffn_block_q8`) call."""

    def __init__(self, latent_dim: int, ffn_dim: int):
        super().__init__(latent_dim, latent_dim % 128 == 0 and ffn_dim % 128 == 0)
        self.linear1 = Linear(latent_dim, ffn_dim)
        self.linear2 = ZeroLinear(ffn_dim, latent_dim)
        self.norm = AdaLN(latent_dim)

    def _int8_sources(self) -> dict:
        return {"w1": self.linear1.weight, "w2": self.linear2.weight}

    def forward(self, x, emb, residual: bool = False):
        scale, shift = self.norm.modulation(emb, x.dtype)
        if self.runs_int8(x.dtype):
            w8_1, s_1, w8_2, s_2 = self.int8_weights()
            return fused_ffn_block_q8(x, scale, shift, w8_1, s_1, self.linear1.bias, w8_2, s_2,
                                      self.linear2.bias, residual=residual)
        return fused_ffn_block(x, scale, shift, self.linear1.weight, self.linear1.bias,
                               self.linear2.weight, self.linear2.bias, residual=residual)


class FinalLayer(nn.Module):
    """Zero-init output projection (reference layers.py:109-116)."""

    def __init__(self, latent_dim: int, out_dim: int):
        super().__init__()
        self.linear = ZeroLinear(latent_dim, out_dim)

    def forward(self, x):
        return self.linear(x)
