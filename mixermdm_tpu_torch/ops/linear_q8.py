"""Int8 dense layer with a fused dequantisation epilogue:
``y = (x8 . w8^T) * s_row * s_col + b``, then bf16, exact GELU in f32, or
bf16 ``+ residual``.

Kernel ``linear_q8`` (``csrc/linear_q8.cu``) replaces ``_qdot8`` / ``_qdot``
(``mixermdm_tpu/ops/fused_block.py:66-77``), the int8 products of the q8
Pallas block kernels.  At the denoiser shapes it is bound by int8
tensor-core operations (1979 TOP/s dense on an H100 SXM at 700 W).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _lib

_BF16, _GELU_F32, _RESIDUAL = 0, 1, 2


def _rows16(t: torch.Tensor) -> torch.Tensor:
    """``t`` with unit stride along K and 16-byte aligned rows (the kernel's
    16-byte loads), copied only if it has not."""
    if t.stride(1) != 1 or t.stride(0) % 16 or t.data_ptr() % 16:
        return t.clone(memory_format=torch.contiguous_format)
    return t


def linear_q8_plain(x8: torch.Tensor, x_scale: torch.Tensor, w8: torch.Tensor,
                    w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                    activation: Optional[str] = None, residual: Optional[torch.Tensor] = None,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version.  The integer product is exact (float64 holds
    every partial sum of int8 products over K < 2^37; float32 would not above
    2^24), then the kernel's f32 dequantisation ``acc * s_row * s_col + b``.
    With ``activation="gelu"`` the result is f32; otherwise it is rounded to
    ``dtype`` and the residual added in ``dtype``."""
    acc = torch.matmul(x8.double(), w8.double().t()).float()
    y = acc * x_scale.float()[..., None] * w_scale.float()
    if bias is not None:
        y = y + bias.float()
    if activation == "gelu":
        return F.gelu(y)
    if activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    y = y.to(dtype)
    if residual is not None:
        y = (y.float() + residual.float()).to(dtype)
    return y


def linear_q8(x8: torch.Tensor, x_scale: torch.Tensor, w8: torch.Tensor,
              w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
              activation: Optional[str] = None, residual: Optional[torch.Tensor] = None,
              dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x8 (..., K) int8 with x_scale (...), w8 (N, K) int8 with w_scale
    (N,), bias (N,) -> (..., N): f32 with ``activation="gelu"``, else
    ``dtype`` (bf16 on the card), ``+ residual`` when given.

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`linear_q8_plain`; a CUDA tensor launches the kernel or raises.
    """
    if _lib.use_plain(x8):
        return linear_q8_plain(x8, x_scale, w8, w_scale, bias, activation=activation,
                               residual=residual, dtype=dtype)
    if activation not in (None, "gelu"):
        raise ValueError(f"unknown activation {activation!r}")
    if activation is not None and residual is not None:
        raise ValueError("linear_q8: the kernel fuses GELU or a residual, not both")
    if dtype != torch.bfloat16:
        raise TypeError(f"linear_q8: the kernel writes bfloat16 (f32 after GELU), not {dtype}")
    _lib.require_cuda("linear_q8", (torch.int8,), x8, w8)
    _lib.require_cuda("linear_q8", (torch.float32,), x_scale, w_scale)
    _lib.require_cuda_bf16("linear_q8", bias, residual)
    K = x8.shape[-1]
    N = w8.shape[0]
    if w8.dim() != 2 or w8.shape[1] != K:
        raise ValueError(f"linear_q8: weight {tuple(w8.shape)} does not take K={K}")
    if K % 16:
        raise ValueError(f"linear_q8: K={K} is not a multiple of 16")
    lead = x8.shape[:-1]
    if x_scale.shape != lead or w_scale.shape != (N,):
        raise ValueError(f"linear_q8: scales {tuple(x_scale.shape)} / {tuple(w_scale.shape)} "
                         f"are not {tuple(lead)} / ({N},)")
    if bias is not None and bias.shape != (N,):
        raise ValueError(f"linear_q8: bias {tuple(bias.shape)} is not ({N},)")
    x2, w8 = _rows16(x8.reshape(-1, K)), _rows16(w8)
    x_scale, w_scale = x_scale.reshape(-1).contiguous(), w_scale.contiguous()
    bias = None if bias is None else bias.contiguous()
    M = x2.shape[0]
    out_dtype = torch.float32 if activation == "gelu" else dtype
    y = torch.empty(lead + (N,), dtype=out_dtype, device=x8.device)
    if M == 0 or N == 0:
        return y
    epi = _GELU_F32 if activation == "gelu" else _BF16
    res_ptr, ldr = None, 0
    if residual is not None:
        if residual.shape != y.shape:
            raise ValueError(f"linear_q8: residual {tuple(residual.shape)} is not "
                             f"{tuple(y.shape)}")
        residual = residual.reshape(M, N).contiguous()
        res_ptr, ldr, epi = residual.data_ptr(), N, _RESIDUAL
    rc = _lib.library().mm_linear_q8(
        x2.data_ptr(), x2.stride(0), x_scale.data_ptr(), w8.data_ptr(), w8.stride(0),
        w_scale.data_ptr(), None if bias is None else bias.data_ptr(), res_ptr, ldr,
        y.data_ptr(), N, M, N, K, epi, _lib.stream_handle(x8))
    _lib.check_launch("linear_q8", rc)
    return y
