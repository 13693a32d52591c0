"""AdaLN prologue: ``LN(x) * (1 + scale[b]) + shift[b]``.

Kernel ``adaln_modulate`` (``csrc/adaln.cu``) replaces the LayerNorm and
modulation that open the Pallas block kernels in
``mixermdm_tpu/ops/fused_block.py`` (``_sa_block_kernel``,
``_ca_block_kernel``, ``_ffn_kernel``).  It moves each activation once in and
once out, so on an H100 it is bound by device-memory bytes (3.35 TB/s).
"""

from __future__ import annotations

import torch

from . import _lib


def adaln_modulate_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version: f32 statistics and modulation, one rounding."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * (1.0 + scale.float()[:, None]) + shift.float()[:, None]
    return y.to(x.dtype)


def adaln_modulate(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """x (B, T, E), scale/shift (B, E) -> (B, T, E).

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`adaln_modulate_plain`; a CUDA tensor launches
    the kernel or raises.
    """
    if _lib.use_plain(x):
        return adaln_modulate_plain(x, scale, shift, eps)
    _lib.require_cuda_bf16("adaln_modulate", x, scale, shift)
    B, T, E = x.shape
    if scale.shape != (B, E) or shift.shape != (B, E):
        raise ValueError(f"adaln_modulate: scale/shift must be {(B, E)}, got "
                         f"{tuple(scale.shape)} / {tuple(shift.shape)}")
    if E % 8:
        raise ValueError(f"adaln_modulate: E={E} is not a multiple of 8")
    x, scale, shift = x.contiguous(), scale.contiguous(), shift.contiguous()
    y = torch.empty_like(x)
    rc = _lib.library().mm_adaln_modulate(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
        B * T, T, E, float(eps), _lib.stream_handle(x))
    _lib.check_launch("adaln_modulate", rc)
    return y
