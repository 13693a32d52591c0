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
output from f32 (``mixermdm_tpu/ops/fused_block.py:140-146``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

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
                          zero_attn: bool = True, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 logits and softmax, the mask
    as an additive bias, output rounded to ``out_dtype`` (default q's)."""
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
    return torch.matmul(p, v.float()).to(out_dtype or q.dtype)


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
    of 8 elements and 16-byte aligned data.  ``out`` is bf16 or f32.  Writes
    ``out`` and returns it.
    """
    _lib.require_cuda_bf16("attention", q, k, v)
    _lib.require_cuda("attention", (torch.bfloat16, torch.float32), out)
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
        B, H, Tq, Tk, D, int(bool(zero_attn)), 1.0 / math.sqrt(D),
        int(out.dtype == torch.float32), _lib.stream_handle(q))
    _lib.check_launch("attention", rc)
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
