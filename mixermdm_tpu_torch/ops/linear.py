"""Dense layer with a fused epilogue: ``y = x @ W^T + b``, then optionally
exact GELU or ``+ residual``.

Kernel ``linear_epilogue`` (``csrc/linear.cu``) replaces the projection and
FFN matmuls of the Pallas block kernels in ``mixermdm_tpu/ops/fused_block.py``
(and carries every other dense layer of the sampling path on the card).  At
the denoiser shapes it is bound by bf16 tensor-core operations
(989 TFLOP/s dense on an H100 SXM at 700 W).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _lib

_EPILOGUE = {None: 0, "gelu": 1}
_RESIDUAL = 2


def linear_plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 *, activation: Optional[str] = None,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: f32 product and epilogue, rounded to x's dtype,
    then the residual added in x's dtype (the kernel's rounding points)."""
    y = F.linear(x.float(), weight.float(), None if bias is None else bias.float())
    if activation == "gelu":
        y = F.gelu(y)
    elif activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    y = y.to(x.dtype)
    if residual is not None:
        y = (y.float() + residual.float()).to(x.dtype)
    return y


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           *, activation: Optional[str] = None,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., K), weight (N, K) torch layout, bias (N,) -> (..., N).

    A CPU tensor (any tensor inside ``ops.plain_versions()``) and an f32
    tensor take :func:`linear_plain`; a bf16 CUDA tensor launches the kernel,
    anything else raises.
    """
    # f32 stays off the kernel, on the card too: the f32 dense layers (the
    # CLIP post-encoders' projections and FFN) run on XLA in the JAX package,
    # outside any Pallas kernel (mixermdm_tpu/models/layers.py:284), so they
    # take the plain f32 product here, which is not counted as a launch.
    # The kernel stays bf16, the dtype of every projection the Pallas blocks
    # make.
    if _lib.use_plain(x) or x.dtype == torch.float32:
        return linear_plain(x, weight, bias, activation=activation, residual=residual)
    if activation not in _EPILOGUE:
        raise ValueError(f"unknown activation {activation!r}")
    if activation is not None and residual is not None:
        raise ValueError("linear: the kernel fuses GELU or a residual, not both")
    _lib.require_cuda_bf16("linear_epilogue", x, weight, bias, residual)
    K = x.shape[-1]
    N = weight.shape[0]
    if weight.dim() != 2 or weight.shape[1] != K:
        raise ValueError(f"linear: weight {tuple(weight.shape)} does not take K={K}")
    if bias is not None and bias.shape != (N,):
        raise ValueError(f"linear: bias {tuple(bias.shape)} is not ({N},)")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    if weight.stride(1) != 1:
        weight = weight.contiguous()
    bias = None if bias is None else bias.contiguous()
    M = x2.shape[0]
    y = torch.empty(lead + (N,), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    epi = _EPILOGUE[activation]
    res_ptr, ldr = None, 0
    if residual is not None:
        if residual.shape != y.shape:
            raise ValueError(f"linear: residual {tuple(residual.shape)} is not {tuple(y.shape)}")
        residual = residual.reshape(M, N).contiguous()
        res_ptr, ldr, epi = residual.data_ptr(), N, _RESIDUAL
    rc = _lib.library().mm_linear(
        x2.data_ptr(), x2.stride(0), weight.data_ptr(), weight.stride(0),
        None if bias is None else bias.data_ptr(), res_ptr, ldr,
        y.data_ptr(), N, M, N, K, epi, _lib.stream_handle(x))
    _lib.check_launch("linear_epilogue", rc)
    return y
