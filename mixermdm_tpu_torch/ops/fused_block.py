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
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _lib
from .adaln import adaln_modulate, adaln_modulate_plain
from .attention import attention_into, fused_attention_plain
from .linear import linear, linear_plain


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
