"""NN primitives: dense layers, AdaLN, torch-compatible multi-head attention,
the AdaLN-conditioned attention / FFN sub-blocks.

Counterpart of ``mixermdm_tpu/models/layers.py``.  Parameter names follow
the reference PyTorch modules (``nn.MultiheadAttention``'s
``in_proj_weight`` / ``in_proj_bias`` / ``out_proj``, AdaLN's
``emb_layers.1``), so exported state dicts load as they are.

Dispatch (the JAX package's ``_fusable_block`` and ``fused_scope``): where
no gradient is recorded (grad mode off, or no input and no parameter
requires grad) and no dropout is active, the sub-blocks call the fused entry
points of :mod:`..ops`, which run their plain versions for CPU tensors and
their kernels for CUDA tensors (raising on a dtype or shape the kernels do
not take).  A kernel's output has no ``grad_fn``, so where a gradient is
recorded the sub-blocks take the unfused route instead, as the JAX package
traces its differentiated graph with the fused blocks off: AdaLN in torch
ops, ``F.linear`` on the weight cast to the input's dtype (a differentiable
cast, JAX ``TorchLinear``), and attention through
:func:`..ops.differentiable_attention` (the ``attention`` kernel forward and
the ``attention_bwd`` kernel backward on the card) or, with
:func:`set_train_attention` ``("plain")``, autograd through its plain
version.  Attention with dropout active takes the plain math with dropout,
as the JAX package does (``models/layers.py:376``).  Weights may be f32
master weights under a bf16 input (the trainable subtrees in training):
every route casts them to the input's dtype per call.

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
import torch.nn.functional as F
from torch import nn

from ..ops import (
    differentiable_attention,
    fused_attention,
    fused_attention_plain,
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

# Attention in the differentiated graph (the JAX package's TRAIN_ATTENTION,
# mixermdm_tpu/train/trainer.py:34): "kernel" runs FusedAttention (the
# attention kernel forward, attention_bwd backward) on the card, "plain"
# autograd through the plain version.  The JAX default ("xla") was set from
# a TPU timing, which sets nothing here; the port starts on its kernels.
TRAIN_ATTENTION_CHOICES = ("kernel", "plain")
_train_attention = "kernel"


def set_train_attention(impl: str) -> None:
    """Choose the attention of the differentiated graph: "kernel" or
    "plain" (both explicit; neither is a fallback of the other)."""
    global _train_attention
    if impl not in TRAIN_ATTENTION_CHOICES:
        raise ValueError(f"train attention {impl!r} not in {TRAIN_ATTENTION_CHOICES}")
    _train_attention = impl


def records_grad(module: nn.Module, *inputs) -> bool:
    """Whether autograd records a call of ``module`` on ``inputs``: grad mode
    is on and an input or a parameter requires grad."""
    if not torch.is_grad_enabled():
        return False
    return (any(t is not None and t.requires_grad for t in inputs)
            or any(p.requires_grad for p in module.parameters()))


def cast_to(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    """``t`` in ``dtype`` (the same tensor when it already is)."""
    return t if t is None or t.dtype == dtype else t.to(dtype)


def layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Affine-free LayerNorm, f32 statistics, rounded to x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


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
        w, b = cast_to(self.weight, x.dtype), cast_to(self.bias, x.dtype)
        if not records_grad(self, x, residual):
            return linear(x, w, b, activation=activation, residual=residual)
        y = F.linear(x, w, b)
        if activation == "gelu":
            y = F.gelu(y)
        elif activation is not None:
            raise ValueError(f"unknown activation {activation!r}")
        return y if residual is None else y + residual


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

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """``LN(x) * (1 + scale) + shift`` in torch ops (the unfused route)."""
        scale, shift = self.modulation(emb, x.dtype)
        return layer_norm(x, 1e-6) * (1.0 + scale[:, None]) + shift[:, None]


class TorchMultiheadAttention(nn.Module):
    """``nn.MultiheadAttention`` (batch first) with its parameter layout;
    ``forward`` is self-attention, the form the text towers use.
    ``dropout`` drops attention probabilities in training mode.
    ``f32_route`` pins the f32 attention kernels' route
    (:data:`..ops.attention.F32_ROUTES`; None: the plan picks by shape).
    The text encoders of the generators (the CLIP tower, the post-encoder
    heads) pin ``"rows"``: their outputs condition the sampling, training
    and base-model paths, which keep the arithmetic they had at every batch
    (the plan would take the tiled route for the heads from 8 prompts on,
    the protocol's 96 among them); at random weights a W8A8 step turns
    last-bit changes of its conds into gaps the size of its own rounding
    (``chip_smoke.py`` phase 5d (c), ``STEP_TOL``).  The InterCLIP towers
    take the plan's route."""

    f32_route: Optional[str] = None

    def __init__(self, embed_dim: int, num_heads: int, add_zero_attn: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        self.embed_dim, self.num_heads, self.add_zero_attn = embed_dim, num_heads, add_zero_attn
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)
        bound = embed_dim ** -0.5
        nn.init.uniform_(self.in_proj_weight, -bound, bound)
        nn.init.uniform_(self.in_proj_bias, -bound, bound)

    def dropout_active(self) -> bool:
        return self.training and self.dropout > 0.0

    def forward(self, x: torch.Tensor, key_padding_mask=None, attn_mask=None) -> torch.Tensor:
        return self.attend(x, None, key_padding_mask, attn_mask)

    def attend(self, x, xf=None, key_padding_mask=None, attn_mask=None,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Projections, attention of x to ``xf`` (to x itself when None),
        output projection [+ residual], on the route :func:`records_grad`
        picks."""
        B, T, E = x.shape
        H = self.num_heads
        w, b = cast_to(self.in_proj_weight, x.dtype), cast_to(self.in_proj_bias, x.dtype)
        grad = records_grad(self, x, xf)
        dense = F.linear if grad else linear
        if xf is None:
            q, k, v = dense(x, w, b).split(E, dim=-1)
        else:
            q = dense(x, w[:E], b[:E])
            k, v = dense(xf, w[E:], b[E:]).split(E, dim=-1)
        q, k, v = (t.reshape(B, t.shape[1], H, E // H).transpose(1, 2) for t in (q, k, v))
        if self.dropout_active():
            out = fused_attention_plain(q, k, v, key_padding_mask, attn_mask, self.add_zero_attn,
                                        dropout_p=self.dropout)
        elif not grad:
            out = fused_attention(q, k, v, key_padding_mask, attn_mask, self.add_zero_attn,
                                  route=self.f32_route)
        elif _train_attention == "plain":
            out = fused_attention_plain(q, k, v, key_padding_mask, attn_mask, self.add_zero_attn)
        else:
            out = differentiable_attention(q, k, v, key_padding_mask, attn_mask,
                                           self.add_zero_attn, route=self.f32_route)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, E), residual=residual)


def _attention_fusable(latent_dim: int, num_heads: int) -> bool:
    return latent_dim % 128 == 0 and (latent_dim // num_heads) % 64 == 0


class VanillaSelfAttention(Int8Block):
    """AdaLN-conditioned self-attention (reference layers.py:28-45), as one
    :func:`fused_sa_block` (or :func:`fused_sa_block_q8`) call where no
    gradient is recorded, else unfused."""

    def __init__(self, latent_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__(latent_dim, _attention_fusable(latent_dim, num_heads))
        self.num_heads = num_heads
        self.norm = AdaLN(latent_dim)
        self.attention = TorchMultiheadAttention(latent_dim, num_heads, dropout=dropout)

    def _int8_sources(self) -> dict:
        return {"w_qkv": self.attention.in_proj_weight, "w_o": self.attention.out_proj.weight}

    def forward(self, x, emb, key_padding_mask=None, residual: bool = False):
        a = self.attention
        if records_grad(self, x, emb) or a.dropout_active():
            return a.attend(self.norm(x, emb), None, key_padding_mask,
                            residual=x if residual else None)
        scale, shift = self.norm.modulation(emb, x.dtype)
        if self.runs_int8(x.dtype):
            w8_qkv, s_qkv, w8_o, s_o = self.int8_weights()
            return fused_sa_block_q8(x, scale, shift, w8_qkv, s_qkv, a.in_proj_bias, w8_o, s_o,
                                     a.out_proj.bias, key_padding_mask,
                                     n_heads=self.num_heads, residual=residual)
        c = lambda t: cast_to(t, x.dtype)  # noqa: E731
        return fused_sa_block(x, scale, shift, c(a.in_proj_weight), c(a.in_proj_bias),
                              c(a.out_proj.weight), c(a.out_proj.bias), key_padding_mask,
                              n_heads=self.num_heads, residual=residual)


class VanillaSelfAttentionSimple(nn.Module):
    """Plain-LN self-attention (reference layers.py:48-65; JAX
    ``VanillaSelfAttentionSimple``): LayerNorm without affine, eps 1e-6,
    then multi-head attention with zero-attn.  Never fused, as in the JAX
    package."""

    def __init__(self, latent_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.attention = TorchMultiheadAttention(latent_dim, num_heads, dropout=dropout)

    def forward(self, x, key_padding_mask=None):
        return self.attention(layer_norm(x, 1e-6), key_padding_mask)


class VanillaCrossAttention(Int8Block):
    """AdaLN-conditioned cross-attention, x attends to xf (reference
    layers.py:68-88), as one :func:`fused_ca_block` (or
    :func:`fused_ca_block_q8`) call where no gradient is recorded, else
    unfused."""

    def __init__(self, latent_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__(latent_dim, _attention_fusable(latent_dim, num_heads))
        self.num_heads = num_heads
        self.norm = AdaLN(latent_dim)
        self.xf_norm = AdaLN(latent_dim)
        self.attention = TorchMultiheadAttention(latent_dim, num_heads, dropout=dropout)

    def _int8_sources(self) -> dict:
        return {"w_qkv": self.attention.in_proj_weight, "w_o": self.attention.out_proj.weight}

    def forward(self, x, xf, emb, key_padding_mask=None, residual: bool = False):
        a = self.attention
        if records_grad(self, x, xf, emb) or a.dropout_active():
            return a.attend(self.norm(x, emb), self.xf_norm(xf, emb), key_padding_mask,
                            residual=x if residual else None)
        scale, shift = self.norm.modulation(emb, x.dtype)
        xf_scale, xf_shift = self.xf_norm.modulation(emb, x.dtype)
        if self.runs_int8(x.dtype):
            w8_qkv, s_qkv, w8_o, s_o = self.int8_weights()
            return fused_ca_block_q8(x, xf, scale, shift, xf_scale, xf_shift, w8_qkv, s_qkv,
                                     a.in_proj_bias, w8_o, s_o, a.out_proj.bias,
                                     key_padding_mask, n_heads=self.num_heads,
                                     residual=residual)
        c = lambda t: cast_to(t, x.dtype)  # noqa: E731
        return fused_ca_block(x, xf, scale, shift, xf_scale, xf_shift, c(a.in_proj_weight),
                              c(a.in_proj_bias), c(a.out_proj.weight), c(a.out_proj.bias),
                              key_padding_mask, n_heads=self.num_heads, residual=residual)


class FFN(Int8Block):
    """AdaLN-conditioned exact-GELU MLP with a zero-init output (reference
    layers.py:91-106), as one :func:`fused_ffn_block` (or
    :func:`fused_ffn_block_q8`) call where no gradient is recorded, else
    unfused with dropout on the hidden layer (``linear2(dropout(gelu(
    linear1(x))))``)."""

    def __init__(self, latent_dim: int, ffn_dim: int, dropout: float = 0.0):
        super().__init__(latent_dim, latent_dim % 128 == 0 and ffn_dim % 128 == 0)
        self.linear1 = Linear(latent_dim, ffn_dim)
        self.linear2 = ZeroLinear(ffn_dim, latent_dim)
        self.norm = AdaLN(latent_dim)
        self.dropout = nn.Dropout(dropout)

    def _int8_sources(self) -> dict:
        return {"w1": self.linear1.weight, "w2": self.linear2.weight}

    def forward(self, x, emb, residual: bool = False):
        if records_grad(self, x, emb) or (self.training and self.dropout.p > 0.0):
            h = self.dropout(self.linear1(self.norm(x, emb), activation="gelu"))
            return self.linear2(h, residual=x if residual else None)
        scale, shift = self.norm.modulation(emb, x.dtype)
        if self.runs_int8(x.dtype):
            w8_1, s_1, w8_2, s_2 = self.int8_weights()
            return fused_ffn_block_q8(x, scale, shift, w8_1, s_1, self.linear1.bias, w8_2, s_2,
                                      self.linear2.bias, residual=residual)
        c = lambda t: cast_to(t, x.dtype)  # noqa: E731
        return fused_ffn_block(x, scale, shift, c(self.linear1.weight), c(self.linear1.bias),
                               c(self.linear2.weight), c(self.linear2.bias), residual=residual)


class FinalLayer(nn.Module):
    """Zero-init output projection (reference layers.py:109-116)."""

    def __init__(self, latent_dim: int, out_dim: int):
        super().__init__()
        self.linear = ZeroLinear(latent_dim, out_dim)

    def forward(self, x):
        return self.linear(x)
