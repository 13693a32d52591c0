"""Whole transformer sub-blocks: AdaLN -> multi-head attention or FFN
[-> + x].

Counterparts of ``mixermdm_tpu/ops/fused_block.py``: :func:`fused_sa_block`
(``_sa_block_kernel``), :func:`fused_ca_block` (``_ca_block_kernel``) and
:func:`fused_ffn_block` (``_ffn_kernel``), each with its plain version.

The TPU kernels run one program per batch item with all of E x E resident in
VMEM.  At E = 1024 those weights are 8 MB, far over the 227 KB of shared
memory an H100 block can hold, so on the card each entry point is composed
from three kernels: ``adaln_modulate`` (the LayerNorm + modulation
prologue), ``linear_epilogue`` (Q/K/V as one product on the packed
``in_proj_weight``, the output projection with the residual add fused, the
FFN with GELU fused) and ``attention`` (reading Q/K/V straight out of the
packed projection).  The projections dominate: the blocks are bound by
tensor-core operations.

Weights are in torch layout: ``w_qkv`` is ``nn.MultiheadAttention``'s
``in_proj_weight`` (3E, E), ``w_o`` its ``out_proj.weight`` (E, E);
``w1`` (F, E) and ``w2`` (E, F) are ``nn.Linear`` weights.

W8A8 forms (``quant=True`` in the JAX package: ``_sa_block_kernel_q8``,
``_ca_block_kernel_q8``, ``_ffn_kernel_q8``): :func:`fused_sa_block_q8`,
:func:`fused_ca_block_q8` and :func:`fused_ffn_block_q8` take weights
quantised once by :func:`..quant.quantize_weight` (int8 plus one f32 scale
per output row) and run every projection as ``quant_rows`` ->
``linear_q8``.  They quantise what the JAX kernels quantise, in the same
precision: the modulated input once for Q, K and V (self-attention); the
modulated ``xf`` once for K and V and the modulated ``x`` for Q
(cross-attention); the self-attention output in f32, the cross-attention
output in the compute dtype; the FFN hidden in f32 after ``+ b1`` and the
GELU.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _lib
from .adaln import adaln_modulate, adaln_modulate_plain
from .attention import attention_into, fused_attention_plain
from .linear import linear, linear_plain
from .linear_q8 import linear_q8, linear_q8_plain
from .quant import quant_rows, quant_rows_plain


def _heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, E) -> (B, H, T, D) view."""
    B, T, E = t.shape
    return t.view(B, T, n_heads, E // n_heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D) -> (B, T, H*D)."""
    B, H, T, D = t.shape
    return t.transpose(1, 2).reshape(B, T, H * D)


def _check(name: str, x: torch.Tensor, n_heads: int, E: int) -> None:
    if x.dim() != 3 or x.shape[-1] != E:
        raise ValueError(f"{name}: x must be (B, T, {E}), got {tuple(x.shape)}")
    if E % n_heads:
        raise ValueError(f"{name}: E={E} does not split into {n_heads} heads")


# ------------------------------------------------------------------ SA block

def fused_sa_block_plain(x, scale, shift, w_qkv, b_qkv, w_o, b_o,
                         key_padding_mask=None, *, n_heads: int, zero_attn: bool = True,
                         eps: float = 1e-6, residual: bool = False) -> torch.Tensor:
    E = x.shape[-1]
    xn = adaln_modulate_plain(x, scale, shift, eps)
    q, k, v = linear_plain(xn, w_qkv, b_qkv).split(E, dim=-1)
    a = fused_attention_plain(_heads(q, n_heads), _heads(k, n_heads), _heads(v, n_heads),
                              key_padding_mask, None, zero_attn)
    return linear_plain(_merge(a), w_o, b_o, residual=x if residual else None)


def fused_sa_block(x, scale, shift, w_qkv, b_qkv, w_o, b_o, key_padding_mask=None, *,
                   n_heads: int, zero_attn: bool = True, eps: float = 1e-6,
                   residual: bool = False) -> torch.Tensor:
    """``[x +] MHA(AdaLN(x))`` self-attention: x (B, T, E), scale/shift
    (B, E), key_padding_mask (B, T) bool with True = masked.

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`fused_sa_block_plain`; a CUDA tensor launches
    the kernels or raises.
    """
    if _lib.use_plain(x):
        return fused_sa_block_plain(x, scale, shift, w_qkv, b_qkv, w_o, b_o, key_padding_mask,
                                    n_heads=n_heads, zero_attn=zero_attn, eps=eps,
                                    residual=residual)
    B, T, E = x.shape
    _check("fused_sa_block", x, n_heads, E)
    xn = adaln_modulate(x, scale, shift, eps)
    qkv = linear(xn, w_qkv, b_qkv)                      # (B, T, 3E)
    q, k, v = qkv.split(E, dim=-1)
    out = torch.empty((B, T, E), dtype=x.dtype, device=x.device)
    attention_into(_heads(q, n_heads), _heads(k, n_heads), _heads(v, n_heads),
                   _heads(out, n_heads), key_padding_mask, None, zero_attn)
    y = linear(out, w_o, b_o, residual=x if residual else None)
    _lib.launches["fused_sa_block"] += 1
    return y


# ------------------------------------------------------------------ CA block

def fused_ca_block_plain(x, xf, scale, shift, xf_scale, xf_shift, w_qkv, b_qkv, w_o, b_o,
                         key_padding_mask=None, *, n_heads: int, zero_attn: bool = True,
                         eps: float = 1e-6, residual: bool = False) -> torch.Tensor:
    E = x.shape[-1]
    xn = adaln_modulate_plain(x, scale, shift, eps)
    xfn = adaln_modulate_plain(xf, xf_scale, xf_shift, eps)
    q = linear_plain(xn, w_qkv[:E], b_qkv[:E])
    k, v = linear_plain(xfn, w_qkv[E:], b_qkv[E:]).split(E, dim=-1)
    a = fused_attention_plain(_heads(q, n_heads), _heads(k, n_heads), _heads(v, n_heads),
                              key_padding_mask, None, zero_attn)
    return linear_plain(_merge(a), w_o, b_o, residual=x if residual else None)


def fused_ca_block(x, xf, scale, shift, xf_scale, xf_shift, w_qkv, b_qkv, w_o, b_o,
                   key_padding_mask=None, *, n_heads: int, zero_attn: bool = True,
                   eps: float = 1e-6, residual: bool = False) -> torch.Tensor:
    """``[x +] MHA(q=AdaLN(x), k=v=AdaLN_xf(xf))``: queries from x, keys and
    values from xf with its own modulation; the key mask applies to xf.

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`fused_ca_block_plain`; a CUDA tensor launches
    the kernels or raises.
    """
    if _lib.use_plain(x):
        return fused_ca_block_plain(x, xf, scale, shift, xf_scale, xf_shift, w_qkv, b_qkv,
                                    w_o, b_o, key_padding_mask, n_heads=n_heads,
                                    zero_attn=zero_attn, eps=eps, residual=residual)
    B, T, E = x.shape
    _check("fused_ca_block", x, n_heads, E)
    _check("fused_ca_block", xf, n_heads, E)
    xn = adaln_modulate(x, scale, shift, eps)
    xfn = adaln_modulate(xf, xf_scale, xf_shift, eps)
    q = linear(xn, w_qkv[:E], b_qkv[:E])                 # (B, T, E)
    k, v = linear(xfn, w_qkv[E:], b_qkv[E:]).split(E, dim=-1)   # (B, Tk, 2E)
    out = torch.empty((B, T, E), dtype=x.dtype, device=x.device)
    attention_into(_heads(q, n_heads), _heads(k, n_heads), _heads(v, n_heads),
                   _heads(out, n_heads), key_padding_mask, None, zero_attn)
    y = linear(out, w_o, b_o, residual=x if residual else None)
    _lib.launches["fused_ca_block"] += 1
    return y


# ----------------------------------------------------------------- FFN block

def fused_ffn_block_plain(x, scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
                          w1, b1, w2, b2, *, eps: float = 1e-6,
                          residual: bool = False) -> torch.Tensor:
    xn = x if scale is None else adaln_modulate_plain(x, scale, shift, eps)
    h = linear_plain(xn, w1, b1, activation="gelu")
    return linear_plain(h, w2, b2, residual=x if residual else None)


def fused_ffn_block(x, scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
                    w1, b1, w2, b2, *, eps: float = 1e-6,
                    residual: bool = False) -> torch.Tensor:
    """``[x +] W2 gelu(W1 AdaLN(x) + b1) + b2``; AdaLN is skipped when
    ``scale is None``.

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`fused_ffn_block_plain`; a CUDA tensor launches
    the kernels or raises.
    """
    if _lib.use_plain(x):
        return fused_ffn_block_plain(x, scale, shift, w1, b1, w2, b2, eps=eps,
                                     residual=residual)
    xn = x if scale is None else adaln_modulate(x, scale, shift, eps)
    h = linear(xn, w1, b1, activation="gelu")
    y = linear(h, w2, b2, residual=x if residual else None)
    _lib.launches["fused_ffn_block"] += 1
    return y


# -------------------------------------------------------- W8A8 SA block

def fused_sa_block_q8_plain(x, scale, shift, w8_qkv, s_qkv, b_qkv, w8_o, s_o, b_o,
                            key_padding_mask=None, *, n_heads: int, zero_attn: bool = True,
                            eps: float = 1e-6, residual: bool = False) -> torch.Tensor:
    E = x.shape[-1]
    x8, xs = quant_rows_plain(adaln_modulate_plain(x, scale, shift, eps))
    q, k, v = linear_q8_plain(x8, xs, w8_qkv, s_qkv, b_qkv, dtype=x.dtype).split(E, dim=-1)
    a = fused_attention_plain(_heads(q, n_heads), _heads(k, n_heads), _heads(v, n_heads),
                              key_padding_mask, None, zero_attn, out_dtype=torch.float32)
    a8, as_ = quant_rows_plain(_merge(a))
    return linear_q8_plain(a8, as_, w8_o, s_o, b_o, dtype=x.dtype,
                           residual=x if residual else None)


def fused_sa_block_q8(x, scale, shift, w8_qkv, s_qkv, b_qkv, w8_o, s_o, b_o,
                      key_padding_mask=None, *, n_heads: int, zero_attn: bool = True,
                      eps: float = 1e-6, residual: bool = False) -> torch.Tensor:
    """:func:`fused_sa_block` with int8 projections: ``w8_qkv`` (3E, E) and
    ``w8_o`` (E, E) int8 with their per-row f32 scales ``s_qkv`` (3E,) and
    ``s_o`` (E,).

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`fused_sa_block_q8_plain`; a CUDA tensor launches the kernels or
    raises.
    """
    if _lib.use_plain(x):
        return fused_sa_block_q8_plain(x, scale, shift, w8_qkv, s_qkv, b_qkv, w8_o, s_o, b_o,
                                       key_padding_mask, n_heads=n_heads, zero_attn=zero_attn,
                                       eps=eps, residual=residual)
    B, T, E = x.shape
    _check("fused_sa_block_q8", x, n_heads, E)
    x8, xs = quant_rows(adaln_modulate(x, scale, shift, eps))
    q, k, v = linear_q8(x8, xs, w8_qkv, s_qkv, b_qkv).split(E, dim=-1)
    out = torch.empty((B, T, E), dtype=torch.float32, device=x.device)
    attention_into(_heads(q, n_heads), _heads(k, n_heads), _heads(v, n_heads),
                   _heads(out, n_heads), key_padding_mask, None, zero_attn)
    a8, as_ = quant_rows(out)
    y = linear_q8(a8, as_, w8_o, s_o, b_o, residual=x if residual else None)
    _lib.launches["fused_sa_block_q8"] += 1
    return y


# -------------------------------------------------------- W8A8 CA block

def fused_ca_block_q8_plain(x, xf, scale, shift, xf_scale, xf_shift, w8_qkv, s_qkv, b_qkv,
                            w8_o, s_o, b_o, key_padding_mask=None, *, n_heads: int,
                            zero_attn: bool = True, eps: float = 1e-6,
                            residual: bool = False) -> torch.Tensor:
    E = x.shape[-1]
    x8, xs = quant_rows_plain(adaln_modulate_plain(x, scale, shift, eps))
    f8, fs = quant_rows_plain(adaln_modulate_plain(xf, xf_scale, xf_shift, eps))
    q = linear_q8_plain(x8, xs, w8_qkv[:E], s_qkv[:E], b_qkv[:E], dtype=x.dtype)
    k, v = linear_q8_plain(f8, fs, w8_qkv[E:], s_qkv[E:], b_qkv[E:],
                           dtype=x.dtype).split(E, dim=-1)
    a = fused_attention_plain(_heads(q, n_heads), _heads(k, n_heads), _heads(v, n_heads),
                              key_padding_mask, None, zero_attn)
    a8, as_ = quant_rows_plain(_merge(a))
    return linear_q8_plain(a8, as_, w8_o, s_o, b_o, dtype=x.dtype,
                           residual=x if residual else None)


def fused_ca_block_q8(x, xf, scale, shift, xf_scale, xf_shift, w8_qkv, s_qkv, b_qkv,
                      w8_o, s_o, b_o, key_padding_mask=None, *, n_heads: int,
                      zero_attn: bool = True, eps: float = 1e-6,
                      residual: bool = False) -> torch.Tensor:
    """:func:`fused_ca_block` with int8 projections (weights as in
    :func:`fused_sa_block_q8`).

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`fused_ca_block_q8_plain`; a CUDA tensor launches the kernels or
    raises.
    """
    if _lib.use_plain(x):
        return fused_ca_block_q8_plain(x, xf, scale, shift, xf_scale, xf_shift, w8_qkv, s_qkv,
                                       b_qkv, w8_o, s_o, b_o, key_padding_mask,
                                       n_heads=n_heads, zero_attn=zero_attn, eps=eps,
                                       residual=residual)
    B, T, E = x.shape
    _check("fused_ca_block_q8", x, n_heads, E)
    _check("fused_ca_block_q8", xf, n_heads, E)
    x8, xs = quant_rows(adaln_modulate(x, scale, shift, eps))
    f8, fs = quant_rows(adaln_modulate(xf, xf_scale, xf_shift, eps))
    q = linear_q8(x8, xs, w8_qkv[:E], s_qkv[:E], b_qkv[:E])              # (B, T, E)
    k, v = linear_q8(f8, fs, w8_qkv[E:], s_qkv[E:], b_qkv[E:]).split(E, dim=-1)
    out = torch.empty((B, T, E), dtype=x.dtype, device=x.device)
    attention_into(_heads(q, n_heads), _heads(k, n_heads), _heads(v, n_heads),
                   _heads(out, n_heads), key_padding_mask, None, zero_attn)
    a8, as_ = quant_rows(out)
    y = linear_q8(a8, as_, w8_o, s_o, b_o, residual=x if residual else None)
    _lib.launches["fused_ca_block_q8"] += 1
    return y


# ------------------------------------------------------- W8A8 FFN block

def fused_ffn_block_q8_plain(x, scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
                             w8_1, s_1, b1, w8_2, s_2, b2, *, eps: float = 1e-6,
                             residual: bool = False) -> torch.Tensor:
    xn = x if scale is None else adaln_modulate_plain(x, scale, shift, eps)
    x8, xs = quant_rows_plain(xn)
    h8, hs = quant_rows_plain(linear_q8_plain(x8, xs, w8_1, s_1, b1, activation="gelu"))
    return linear_q8_plain(h8, hs, w8_2, s_2, b2, dtype=x.dtype,
                           residual=x if residual else None)


def fused_ffn_block_q8(x, scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
                       w8_1, s_1, b1, w8_2, s_2, b2, *, eps: float = 1e-6,
                       residual: bool = False) -> torch.Tensor:
    """:func:`fused_ffn_block` with int8 products: ``w8_1`` (F, E) and
    ``w8_2`` (E, F) int8 with per-row f32 scales ``s_1`` (F,) and ``s_2``
    (E,); the hidden stays f32 between them.

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`fused_ffn_block_q8_plain`; a CUDA tensor launches the kernels or
    raises.
    """
    if _lib.use_plain(x):
        return fused_ffn_block_q8_plain(x, scale, shift, w8_1, s_1, b1, w8_2, s_2, b2,
                                        eps=eps, residual=residual)
    xn = x if scale is None else adaln_modulate(x, scale, shift, eps)
    x8, xs = quant_rows(xn)
    h8, hs = quant_rows(linear_q8(x8, xs, w8_1, s_1, b1, activation="gelu"))
    y = linear_q8(h8, hs, w8_2, s_2, b2, residual=x if residual else None)
    _lib.launches["fused_ffn_block_q8"] += 1
    return y
