"""Multi-head attention with torch's ``add_zero_attn`` done algebraically.

Counterpart of ``mixermdm_tpu/ops/attention.py``: :func:`fused_attention`
(the Pallas entry point ``fused_attention`` -> ``_fused_attention_impl`` ->
``_attn_body``), its plain version, and :func:`reference_attention`.

``softmax(Q K^T / sqrt(D) + key_bias + attn_mask) V`` over (B, H, T, D)
tensors.  With ``zero_attn`` the implicit zero key of
``nn.MultiheadAttention(add_zero_attn=True)`` joins the row max and adds
``exp(-max)`` to the denominator; it adds nothing to the numerator.  Masked
keys get a -1e30 bias, so a fully masked row stays finite.

On the card the work goes to the hand-written kernel ``attention``
(``csrc/attention.cu``): one block per (batch, head, 64-query tile), K/V
tiles streamed through shared memory with an online softmax.  Its bound on an
H100 is the larger of the Q/K/V/O bytes over 3.35 TB/s and the 4·B·H·Tq·Tk·D
tensor-core operations over 989 TFLOP/s; at T = 299 neither is reached and
the grid is small, so its time is mostly latency.  A second instantiation
writes f32, for the W8A8 self-attention block, which quantises the attention
output from f32 (``mixermdm_tpu/ops/fused_block.py:140-146``).  f32 inputs
(the CLIP post-encoders) take a third, f32 FMA on the CUDA cores and no
TF32, counted as ``attention_f32``.

The backward (``_fused_attention_bwd_impl`` -> ``_attn_bwd_kernel`` and the
``custom_vjp`` wrappers ``_fa_*``): :func:`attention_bwd` launches the
kernels of ``csrc/attention_bwd.cu`` beside the plain version
:func:`attention_bwd_plain`, and :class:`FusedAttention` is the
``torch.autograd.Function`` whose forward is the ``attention`` kernel and
whose backward is ``attention_bwd`` (their plain versions on the CPU).
:func:`differentiable_attention` picks between it and autograd through
:func:`fused_attention_plain`, as the JAX package's ``fused_attention`` picks
a backward per mask.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _lib

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 96, 128)


def key_bias(key_padding_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(B, Tk) bool, True = masked -> (B, Tk) f32 additive bias."""
    if key_padding_mask is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=key_padding_mask.device)
    return torch.where(key_padding_mask, torch.full_like(zero, NEG_INF), zero)


def fused_attention_plain(q, k, v, key_padding_mask=None, attn_mask=None,
                          zero_attn: bool = True, out_dtype=None,
                          dropout_p: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 logits and softmax, the mask
    as an additive bias, the probabilities rounded to v's dtype before the
    product with v (as the kernel rounds them into its bf16 ``mma`` operand
    and the JAX kernel casts them, ``p.astype(v.dtype)``), f32 product,
    output rounded to ``out_dtype`` (default q's).  ``dropout_p`` > 0 drops
    attention probabilities (the JAX package's training path with attention
    dropout, ``models/layers.py:420-422``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_padding_mask is not None:
        logits = logits + key_bias(key_padding_mask)[:, None, None, :]
    if attn_mask is not None:
        logits = logits + attn_mask.float()
    if zero_attn:
        logits = torch.cat([logits, logits.new_zeros(logits.shape[:-1] + (1,))], dim=-1)
        p = torch.softmax(logits, dim=-1)[..., :-1]
    else:
        p = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        p = F.dropout(p, dropout_p)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(out_dtype or q.dtype)


def reference_attention(q, k, v, key_padding_mask=None, attn_mask=None,
                        zero_attn: bool = True) -> torch.Tensor:
    """The same math in the input dtype, as the JAX package's reference
    (masked logits replaced by -1e30, the zero key appended as a column)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q * scale, k.transpose(-1, -2))
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
    if attn_mask is not None:
        logits = logits + attn_mask
    if zero_attn:
        logits = torch.cat([logits, logits.new_zeros(logits.shape[:-1] + (1,))], dim=-1)
        p = torch.softmax(logits, dim=-1)[..., :-1]
    else:
        p = torch.softmax(logits, dim=-1)
    return torch.matmul(p, v)


def attention_into(q, k, v, out, key_padding_mask=None, attn_mask=None,
                   zero_attn: bool = True) -> torch.Tensor:
    """Launch the ``attention`` kernel on (B, H, T, D) views.

    The views may be strided (the fused blocks pass slices of the packed QKV
    projection) but must have unit stride along D, strides that are multiples
    of 8 elements and 16-byte aligned data.  q, k and v are all bf16 (then
    ``out`` is bf16 or f32) or all f32 (then ``out`` is f32).  Writes ``out``
    and returns it.
    """
    _lib.require_cuda("attention", (torch.bfloat16, torch.float32), q, k, v, out)
    in_f32 = q.dtype == torch.float32
    if k.dtype != q.dtype or v.dtype != q.dtype or (in_f32 and out.dtype != torch.float32):
        raise TypeError(f"attention: q/k/v {q.dtype}/{k.dtype}/{v.dtype} and out {out.dtype} "
                        "must be all bf16 (out bf16 or f32) or all f32")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention: head dim {D} not in {KERNEL_HEAD_DIMS}")
    if k.shape != (B, H, Tk, D) or v.shape != k.shape or out.shape != q.shape:
        raise ValueError(f"attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} out{tuple(out.shape)} do not agree")
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        sb, sh, st, sd = t.stride()
        if sd != 1 or sb % 8 or sh % 8 or st % 8 or t.data_ptr() % 16:
            raise ValueError(f"attention: {name} strides {t.stride()} / alignment "
                             "not taken by the kernel")
        strides += [sb, sh, st]
    kbias = key_bias(key_padding_mask)
    if kbias is not None:
        if kbias.shape != (B, Tk):
            raise ValueError(f"attention: key_padding_mask must be {(B, Tk)}")
        kbias = kbias.to(q.device).contiguous()
    amask = None
    if attn_mask is not None:
        if attn_mask.shape != (Tq, Tk):
            raise ValueError(f"attention: attn_mask must be {(Tq, Tk)}")
        amask = attn_mask.to(device=q.device, dtype=torch.float32).contiguous()
    if B == 0 or H == 0 or Tq == 0:
        return out
    c_strides = (ctypes.c_int64 * 12)(*strides)
    rc = _lib.library().mm_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), c_strides,
        None if kbias is None else kbias.data_ptr(),
        None if amask is None else amask.data_ptr(),
        B, H, Tq, Tk, D, int(bool(zero_attn)), 1.0 / math.sqrt(D), int(in_f32),
        int(out.dtype == torch.float32), _lib.stream_handle(q))
    _lib.check_launch("attention_f32" if in_f32 else "attention", rc)
    return out


def fused_attention(q, k, v, key_padding_mask=None, attn_mask=None,
                    zero_attn: bool = True) -> torch.Tensor:
    """q (B, H, Tq, D), k/v (B, H, Tk, D), key_padding_mask (B, Tk) bool with
    True = masked, attn_mask (Tq, Tk) additive -> (B, H, Tq, D).

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`fused_attention_plain`; a CUDA tensor launches
    the kernel or raises.
    """
    if _lib.use_plain(q):
        return fused_attention_plain(q, k, v, key_padding_mask, attn_mask, zero_attn)
    out = attention_into(q, k, v, torch.empty_like(q, memory_format=torch.contiguous_format),
                         key_padding_mask, attn_mask, zero_attn)
    _lib.launches["fused_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def attention_bwd_plain(q, k, v, key_padding_mask, g, zero_attn: bool = True):
    """Plain PyTorch version of ``attention_bwd`` with the JAX kernel's
    rounding points (``_attn_bwd_kernel``): f32 softmax recomputed with the
    zero key in the max and the denominator; p and ds rounded to the input
    dtype before the products that use them; f32 products; dq, dk, dv
    rounded to the input dtype once."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if key_padding_mask is not None:
        logits = logits + key_bias(key_padding_mask)[:, None, None, :]
    row_max = logits.amax(dim=-1, keepdim=True)
    if zero_attn:
        row_max = torch.clamp_min(row_max, 0.0)
    p = torch.exp(logits - row_max)
    denom = p.sum(dim=-1, keepdim=True)
    if zero_attn:
        denom = denom + torch.exp(-row_max)
    p = p / denom
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    dsum = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - dsum)).to(dt).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def attention_bwd(q, k, v, key_padding_mask, g, zero_attn: bool = True):
    """(dq, dk, dv) of :func:`fused_attention` (no ``attn_mask``) for the
    output gradient ``g``: q, g (B, H, Tq, D), k, v (B, H, Tk, D), all bf16
    or all f32; key_padding_mask (B, Tk) bool with True = masked.

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`attention_bwd_plain`; a CUDA tensor launches the kernels or
    raises.
    """
    if _lib.use_plain(q):
        return attention_bwd_plain(q, k, v, key_padding_mask, g, zero_attn)
    _lib.require_cuda("attention_bwd", (torch.bfloat16, torch.float32), q, k, v, g)
    if not (q.dtype == k.dtype == v.dtype == g.dtype):
        raise TypeError(f"attention_bwd: q/k/v/g dtypes {q.dtype}/{k.dtype}/{v.dtype}/{g.dtype} "
                        "differ")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention_bwd: head dim {D} not in {KERNEL_HEAD_DIMS}")
    if k.shape != (B, H, Tk, D) or v.shape != k.shape or g.shape != q.shape:
        raise ValueError(f"attention_bwd: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} g{tuple(g.shape)} do not agree")
    q, k, v, g = (t.contiguous() for t in (q, k, v, g))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0 or H == 0 or Tq == 0 or Tk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    kbias = key_bias(key_padding_mask)
    if kbias is not None:
        if kbias.shape != (B, Tk):
            raise ValueError(f"attention_bwd: key_padding_mask must be {(B, Tk)}")
        kbias = kbias.to(q.device).contiguous()
    stats = torch.empty((3, B, H, Tq), dtype=torch.float32, device=q.device)
    rc = _lib.library().mm_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), stats.data_ptr(), None if kbias is None else kbias.data_ptr(),
        B, H, Tq, Tk, D, int(bool(zero_attn)), 1.0 / math.sqrt(D),
        int(q.dtype == torch.float32), _lib.stream_handle(q))
    _lib.check_launch("attention_bwd", rc)
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """Attention with the ``attention`` kernel forward and the
    ``attention_bwd`` kernel backward (the JAX ``custom_vjp`` wrappers
    ``_fa_nomask`` / ``_fa_kpm``): saves q, k, v and the mask, recomputes the
    softmax in the backward.  Both halves go through the entry points, so on
    a CPU tensor or inside ``ops.plain_versions()`` it is the plain version
    of the same arithmetic: :func:`fused_attention_plain` forward,
    :func:`attention_bwd_plain` backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, zero_attn):
        ctx.save_for_backward(q, k, v, key_padding_mask)
        ctx.zero_attn = zero_attn
        return fused_attention(q, k, v, key_padding_mask, None, zero_attn)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kpm = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, kpm, g.to(q.dtype), ctx.zero_attn)
        return dq, dk, dv, None, None


def differentiable_attention(q, k, v, key_padding_mask=None, attn_mask=None,
                             zero_attn: bool = True) -> torch.Tensor:
    """Attention that autograd can differentiate: :class:`FusedAttention`;
    with an additive ``attn_mask``, where the JAX package's backward kernel
    raises and its VJP recomputes through XLA (``_fa_am_bwd``,
    ``_fa_both_bwd``), autograd through :func:`fused_attention_plain`."""
    if attn_mask is not None:
        return fused_attention_plain(q, k, v, key_padding_mask, attn_mask, zero_attn)
    return FusedAttention.apply(q, k, v, key_padding_mask, zero_attn)
