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
per output row) and run every projection on ``linear_q8``.  They quantise
what the JAX kernels quantise, in the same precision: the modulated input
once for Q, K and V (self-attention); the modulated ``xf`` once for K and V
and the modulated ``x`` for Q (cross-attention), each in the prologue
itself, ``adaln_modulate_q8`` (LN, modulation, bf16 rounding and
quantisation in one pass, as the TPU kernel does them in one program); the
self-attention output in f32 and the cross-attention output in the compute
dtype in the attention kernel's epilogue, ``attention_q8``; the FFN hidden
in f32 after ``+ b1`` and the GELU in the first product's epilogue
(``linear_q8`` with ``quant_out``); with ``quant_rows`` an FFN input that
is not modulated.  The fused epilogues give ``quant_rows``' bits of the
output they no longer write.

Tensor-parallel forms (``tp=``, a ``parallel.mesh.RowParallel``; bf16,
the JAX package runs no int8 under ``--tp``): the same kernels at the shard
shapes, H/tp heads, the QKV product at N 3E/tp (this rank's heads' rows of
q, k and v, the CA block's q / kv split at E/tp), the FFN's first product
at N F/tp; the output projection and the FFN's second product are the
rank's row-parallel partials (K E/tp and F/tp), summed over the model axis
in f32 by :func:`row_parallel_sum`, and under sequence parallelism the
modulated rows are gathered along T before the first product and the sum
is reduce-scattered along T.

A W8A8 block asks the fused kernel's plan (``attention_q8_plan``,
``gelu_q8_plan``) before it launches anything.  Where the plan refuses the
shape (more heads than a cluster spans, an FFN over 16 tiles of 128, no
cluster that fits the card: :data:`._lib.PLAN_REFUSALS`), the block takes
the unfused pair, the producer kernel writing its output (``attention``
in f32 or bf16, ``linear_q8`` with the f32 GELU) and then ``quant_rows``,
counted as ``attention_q8_pair`` / ``linear_q8_gelu_q8_pair``: the same
bits, one more pass over device memory.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _lib
from . import attention as _attention
from . import linear_q8 as _linear_q8
from .adaln import (
    adaln_modulate,
    adaln_modulate_plain,
    adaln_modulate_q8,
    adaln_modulate_q8_plain,
)
from .attention import attention_into, attention_q8, fused_attention_plain
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


def _fused_attention_q8(B: int, H: int, Tq: int, Tk: int, D: int) -> bool:
    """Whether ``attention_q8``'s plan takes this shape (else the block
    takes the unfused pair)."""
    try:
        _attention.attention_q8_plan(B, H, Tq, Tk, D)
    except _lib.PLAN_REFUSALS:
        return False
    return True


def _fused_gelu_q8(M: int, N: int, K: int) -> bool:
    """Whether the quantising GELU product's plan takes this shape (an
    empty product launches nothing either way)."""
    if M == 0:
        return True
    try:
        _linear_q8.gelu_q8_plan(M, N, K)
    except _lib.PLAN_REFUSALS:
        return False
    return True


def _attention_q8_route(fused: bool, q, k, v, key_padding_mask, zero_attn: bool, out_dtype):
    """The attention output as int8 rows with f32 scales: ``attention_q8``,
    or (``fused`` False) ``attention`` writing ``out_dtype`` and then
    ``quant_rows``, which quantises the same values to the same bits."""
    if fused:
        return attention_q8(q, k, v, key_padding_mask, zero_attn, out_dtype=out_dtype)
    B, H, Tq, D = q.shape
    a = torch.empty((B, Tq, H * D), dtype=out_dtype, device=q.device)
    attention_into(q, k, v, _heads(a, H), key_padding_mask, None, zero_attn)
    _lib.launches["attention_q8_pair"] += 1
    return quant_rows(a)


def row_parallel_sum(partial: torch.Tensor, bias: Optional[torch.Tensor],
                     residual: Optional[torch.Tensor], tp) -> torch.Tensor:
    """A row-parallel product's output from this rank's ``partial`` (its
    slice of the input features, no bias, no residual): the partials summed
    over the model axis in f32 (``tp.reduce``: an all-reduce, or under
    sequence parallelism a reduce-scatter along T), the bias added, rounded
    to the partial's dtype, then the residual added as :func:`linear_plain`
    adds it.  The kernel rounded each partial to bf16 in its epilogue, so on
    the card this is one rounding more than the single-rank product, which
    rounds once after the whole sum."""
    y = tp.reduce(partial.float())
    if bias is not None:
        y = y + bias.float()
    y = y.to(partial.dtype)
    if residual is not None:
        y = (y.float() + residual.float()).to(partial.dtype)
    return y


def _out_projection(a, w_o, b_o, residual, tp, dense=linear):
    """The output projection ``a @ w_o^T + b_o [+ residual]``: one product
    with its epilogue, or under tensor parallelism (``tp``) the rank's
    row-parallel partial and :func:`row_parallel_sum`."""
    if tp is None:
        return dense(a, w_o, b_o, residual=residual)
    return row_parallel_sum(dense(a, w_o, None), b_o, residual, tp)


def _gather(tp, xn: torch.Tensor) -> torch.Tensor:
    """The modulated rows a column-parallel product takes: under sequence
    parallelism gathered along T from the ranks' slices."""
    return xn if tp is None else tp.gather(xn)


def _check(name: str, x: torch.Tensor, n_heads: int, E: int) -> None:
    if x.dim() != 3 or x.shape[-1] != E:
        raise ValueError(f"{name}: x must be (B, T, {E}), got {tuple(x.shape)}")
    if E % n_heads:
        raise ValueError(f"{name}: E={E} does not split into {n_heads} heads")


# ------------------------------------------------------------------ SA block

def fused_sa_block_plain(x, scale, shift, w_qkv, b_qkv, w_o, b_o,
                         key_padding_mask=None, *, n_heads: int, zero_attn: bool = True,
                         eps: float = 1e-6, residual: bool = False, tp=None) -> torch.Tensor:
    E = w_qkv.shape[0] // 3
    xn = _gather(tp, adaln_modulate_plain(x, scale, shift, eps))
    q, k, v = linear_plain(xn, w_qkv, b_qkv).split(E, dim=-1)
    a = fused_attention_plain(_heads(q, n_heads), _heads(k, n_heads), _heads(v, n_heads),
                              key_padding_mask, None, zero_attn)
    return _out_projection(_merge(a), w_o, b_o, x if residual else None, tp, linear_plain)


def fused_sa_block(x, scale, shift, w_qkv, b_qkv, w_o, b_o, key_padding_mask=None, *,
                   n_heads: int, zero_attn: bool = True, eps: float = 1e-6,
                   residual: bool = False, tp=None) -> torch.Tensor:
    """``[x +] MHA(AdaLN(x))`` self-attention: x (B, T, E), scale/shift
    (B, E), key_padding_mask (B, T) bool with True = masked.

    Tensor-parallel form (``tp``, a :class:`..parallel.mesh.RowParallel`):
    ``w_qkv`` / ``b_qkv`` hold this rank's heads' rows of q, then of k, then
    of v (3E/tp, E), ``n_heads`` is their count, ``w_o`` the matching
    columns (E, E/tp); the output projection is row-parallel
    (:func:`row_parallel_sum`).  Under sequence parallelism (``tp.seq``) x
    is this rank's slice of T: the modulated rows are gathered along T
    before the QKV product and the output comes back as this rank's slice.

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`fused_sa_block_plain`; a CUDA tensor launches
    the kernels or raises.
    """
    if _lib.use_plain(x):
        return fused_sa_block_plain(x, scale, shift, w_qkv, b_qkv, w_o, b_o, key_padding_mask,
                                    n_heads=n_heads, zero_attn=zero_attn, eps=eps,
                                    residual=residual, tp=tp)
    E = w_qkv.shape[0] // 3
    _check("fused_sa_block", x, n_heads, w_qkv.shape[1])
    xn = _gather(tp, adaln_modulate(x, scale, shift, eps))
    B, T = xn.shape[:2]
    qkv = linear(xn, w_qkv, b_qkv)                      # (B, T, 3E)
    q, k, v = qkv.split(E, dim=-1)
    out = torch.empty((B, T, E), dtype=x.dtype, device=x.device)
    attention_into(_heads(q, n_heads), _heads(k, n_heads), _heads(v, n_heads),
                   _heads(out, n_heads), key_padding_mask, None, zero_attn)
    y = _out_projection(out, w_o, b_o, x if residual else None, tp)
    _lib.launches["fused_sa_block"] += 1
    return y


# ------------------------------------------------------------------ CA block

def fused_ca_block_plain(x, xf, scale, shift, xf_scale, xf_shift, w_qkv, b_qkv, w_o, b_o,
                         key_padding_mask=None, *, n_heads: int, zero_attn: bool = True,
                         eps: float = 1e-6, residual: bool = False, tp=None) -> torch.Tensor:
    E = w_qkv.shape[0] // 3
    xn = _gather(tp, adaln_modulate_plain(x, scale, shift, eps))
    xfn = adaln_modulate_plain(xf, xf_scale, xf_shift, eps)
    q = linear_plain(xn, w_qkv[:E], b_qkv[:E])
    k, v = linear_plain(xfn, w_qkv[E:], b_qkv[E:]).split(E, dim=-1)
    a = fused_attention_plain(_heads(q, n_heads), _heads(k, n_heads), _heads(v, n_heads),
                              key_padding_mask, None, zero_attn)
    return _out_projection(_merge(a), w_o, b_o, x if residual else None, tp, linear_plain)


def fused_ca_block(x, xf, scale, shift, xf_scale, xf_shift, w_qkv, b_qkv, w_o, b_o,
                   key_padding_mask=None, *, n_heads: int, zero_attn: bool = True,
                   eps: float = 1e-6, residual: bool = False, tp=None) -> torch.Tensor:
    """``[x +] MHA(q=AdaLN(x), k=v=AdaLN_xf(xf))``: queries from x, keys and
    values from xf with its own modulation; the key mask applies to xf.

    Tensor-parallel form (``tp``) as :func:`fused_sa_block`'s: q is the
    first third of this rank's rows of ``w_qkv``, k and v the rest (the
    split at E/tp); under sequence parallelism x is this rank's slice of T
    and xf whole.

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`fused_ca_block_plain`; a CUDA tensor launches
    the kernels or raises.
    """
    if _lib.use_plain(x):
        return fused_ca_block_plain(x, xf, scale, shift, xf_scale, xf_shift, w_qkv, b_qkv,
                                    w_o, b_o, key_padding_mask, n_heads=n_heads,
                                    zero_attn=zero_attn, eps=eps, residual=residual, tp=tp)
    E = w_qkv.shape[0] // 3
    _check("fused_ca_block", x, n_heads, w_qkv.shape[1])
    _check("fused_ca_block", xf, n_heads, w_qkv.shape[1])
    xn = _gather(tp, adaln_modulate(x, scale, shift, eps))
    B, T = xn.shape[:2]
    xfn = adaln_modulate(xf, xf_scale, xf_shift, eps)
    q = linear(xn, w_qkv[:E], b_qkv[:E])                 # (B, T, E)
    k, v = linear(xfn, w_qkv[E:], b_qkv[E:]).split(E, dim=-1)   # (B, Tk, 2E)
    out = torch.empty((B, T, E), dtype=x.dtype, device=x.device)
    attention_into(_heads(q, n_heads), _heads(k, n_heads), _heads(v, n_heads),
                   _heads(out, n_heads), key_padding_mask, None, zero_attn)
    y = _out_projection(out, w_o, b_o, x if residual else None, tp)
    _lib.launches["fused_ca_block"] += 1
    return y


# ----------------------------------------------------------------- FFN block

def fused_ffn_block_plain(x, scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
                          w1, b1, w2, b2, *, eps: float = 1e-6,
                          residual: bool = False, tp=None) -> torch.Tensor:
    xn = _gather(tp, x if scale is None else adaln_modulate_plain(x, scale, shift, eps))
    h = linear_plain(xn, w1, b1, activation="gelu")
    return _out_projection(h, w2, b2, x if residual else None, tp, linear_plain)


def fused_ffn_block(x, scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
                    w1, b1, w2, b2, *, eps: float = 1e-6,
                    residual: bool = False, tp=None) -> torch.Tensor:
    """``[x +] W2 gelu(W1 AdaLN(x) + b1) + b2``; AdaLN is skipped when
    ``scale is None``.  Tensor-parallel form (``tp``): ``w1`` / ``b1`` hold
    this rank's F/tp hidden units, ``w2`` the matching columns (E, F/tp),
    and the second product is row-parallel (:func:`row_parallel_sum`);
    under sequence parallelism x is this rank's slice of T, gathered after
    the modulation.

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`fused_ffn_block_plain`; a CUDA tensor launches
    the kernels or raises.
    """
    if _lib.use_plain(x):
        return fused_ffn_block_plain(x, scale, shift, w1, b1, w2, b2, eps=eps,
                                     residual=residual, tp=tp)
    xn = _gather(tp, x if scale is None else adaln_modulate(x, scale, shift, eps))
    h = linear(xn, w1, b1, activation="gelu")
    y = _out_projection(h, w2, b2, x if residual else None, tp)
    _lib.launches["fused_ffn_block"] += 1
    return y


# -------------------------------------------------------- W8A8 SA block

def fused_sa_block_q8_plain(x, scale, shift, w8_qkv, s_qkv, b_qkv, w8_o, s_o, b_o,
                            key_padding_mask=None, *, n_heads: int, zero_attn: bool = True,
                            eps: float = 1e-6, residual: bool = False) -> torch.Tensor:
    E = x.shape[-1]
    x8, xs = adaln_modulate_q8_plain(x, scale, shift, eps)
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
    _lib.require_cuda_bf16("fused_sa_block_q8", x, scale, shift)  # before the plan asks the card
    fused = _fused_attention_q8(B, n_heads, T, T, E // n_heads)
    x8, xs = adaln_modulate_q8(x, scale, shift, eps)
    q, k, v = linear_q8(x8, xs, w8_qkv, s_qkv, b_qkv).split(E, dim=-1)
    a8, as_ = _attention_q8_route(fused, _heads(q, n_heads), _heads(k, n_heads),
                                  _heads(v, n_heads), key_padding_mask, zero_attn, torch.float32)
    y = linear_q8(a8, as_, w8_o, s_o, b_o, residual=x if residual else None)
    _lib.launches["fused_sa_block_q8"] += 1
    return y


# -------------------------------------------------------- W8A8 CA block

def fused_ca_block_q8_plain(x, xf, scale, shift, xf_scale, xf_shift, w8_qkv, s_qkv, b_qkv,
                            w8_o, s_o, b_o, key_padding_mask=None, *, n_heads: int,
                            zero_attn: bool = True, eps: float = 1e-6,
                            residual: bool = False) -> torch.Tensor:
    E = x.shape[-1]
    x8, xs = adaln_modulate_q8_plain(x, scale, shift, eps)
    f8, fs = adaln_modulate_q8_plain(xf, xf_scale, xf_shift, eps)
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
    _lib.require_cuda_bf16("fused_ca_block_q8", x, xf, scale, shift, xf_scale, xf_shift)
    fused = _fused_attention_q8(B, n_heads, T, xf.shape[1], E // n_heads)
    x8, xs = adaln_modulate_q8(x, scale, shift, eps)
    f8, fs = adaln_modulate_q8(xf, xf_scale, xf_shift, eps)
    q = linear_q8(x8, xs, w8_qkv[:E], s_qkv[:E], b_qkv[:E])              # (B, T, E)
    k, v = linear_q8(f8, fs, w8_qkv[E:], s_qkv[E:], b_qkv[E:]).split(E, dim=-1)
    a8, as_ = _attention_q8_route(fused, _heads(q, n_heads), _heads(k, n_heads),
                                  _heads(v, n_heads), key_padding_mask, zero_attn, x.dtype)
    y = linear_q8(a8, as_, w8_o, s_o, b_o, residual=x if residual else None)
    _lib.launches["fused_ca_block_q8"] += 1
    return y


# ------------------------------------------------------- W8A8 FFN block

def fused_ffn_block_q8_plain(x, scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
                             w8_1, s_1, b1, w8_2, s_2, b2, *, eps: float = 1e-6,
                             residual: bool = False) -> torch.Tensor:
    if scale is None:
        x8, xs = quant_rows_plain(x)
    else:
        x8, xs = adaln_modulate_q8_plain(x, scale, shift, eps)
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
    _lib.require_cuda_bf16("fused_ffn_block_q8", x, scale, shift)  # before the plan asks the card
    fused = _fused_gelu_q8(x.numel() // x.shape[-1], w8_1.shape[0], x.shape[-1])
    x8, xs = quant_rows(x) if scale is None else adaln_modulate_q8(x, scale, shift, eps)
    if fused:
        h8, hs = linear_q8(x8, xs, w8_1, s_1, b1, activation="gelu", quant_out=True)
    else:
        h8, hs = quant_rows(linear_q8(x8, xs, w8_1, s_1, b1, activation="gelu"))
        _lib.launches["linear_q8_gelu_q8_pair"] += 1
    y = linear_q8(h8, hs, w8_2, s_2, b2, residual=x if residual else None)
    _lib.launches["fused_ffn_block_q8"] += 1
    return y
