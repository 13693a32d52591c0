"""AdaLN prologue: ``LN(x) * (1 + scale[b]) + shift[b]``, and its W8A8 form.

Kernel ``adaln_modulate`` (``csrc/adaln.cu``) replaces the LayerNorm and
modulation that open the Pallas block kernels in
``mixermdm_tpu/ops/fused_block.py`` (``_sa_block_kernel``,
``_ca_block_kernel``, ``_ffn_kernel``).  Its instantiation
``adaln_modulate_q8`` also quantises the modulated rows as the q8 kernels do
before their first product (``_quant_act``), in the same pass: its output is
the bits of ``quant_rows(adaln_modulate(...))``.  Both move each activation
once in and once out, so on an H100 they are bound by device-memory bytes
(3.35 TB/s).
"""

from __future__ import annotations

import torch

from . import _lib
from .quant import quant_rows_plain

CHUNK = 8                          # bf16 elements of one 16-byte load
MAX_E = 1024                       # the kernel holds a row of at most 1024 in registers


def adaln_modulate_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version: f32 statistics and modulation, one rounding."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * (1.0 + scale.float()[:, None]) + shift.float()[:, None]
    return y.to(x.dtype)


def adaln_modulate_q8_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                            eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``quant_rows_plain(adaln_modulate_plain(...))``."""
    return quant_rows_plain(adaln_modulate_plain(x, scale, shift, eps))


def _check(name: str, x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor):
    """The kernel's arguments: x contiguous and 16-byte aligned, scale and
    shift (B, E) with unit column stride and 16-byte aligned rows (the two
    halves of the modulation's (B, 2E) output pass as they are)."""
    _lib.require_cuda_bf16(name, x, scale, shift)
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, T, E), got {tuple(x.shape)}")
    B, T, E = x.shape
    if scale.shape != (B, E) or shift.shape != (B, E):
        raise ValueError(f"{name}: scale/shift must be {(B, E)}, got "
                         f"{tuple(scale.shape)} / {tuple(shift.shape)}")
    if E % CHUNK or E > MAX_E:
        raise ValueError(f"{name}: E={E} must be a multiple of {CHUNK} and at most {MAX_E}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    mods = []
    for t in (scale, shift):
        if t.stride(1) != 1 or t.data_ptr() % 16 or (t.stride(0) * 2) % 16:
            t = t.clone(memory_format=torch.contiguous_format)
        mods.append(t)
    return x, mods[0], mods[1]


def adaln_modulate(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """x (B, T, E), scale/shift (B, E) -> (B, T, E).

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`adaln_modulate_plain`; a CUDA tensor launches
    the kernel or raises.
    """
    if _lib.use_plain(x):
        return adaln_modulate_plain(x, scale, shift, eps)
    x, scale, shift = _check("adaln_modulate", x, scale, shift)
    B, T, E = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    rc = _lib.library().mm_adaln_modulate(
        x.data_ptr(), scale.data_ptr(), scale.stride(0), shift.data_ptr(), shift.stride(0),
        y.data_ptr(), B, T, E, float(eps), _lib.stream_handle(x))
    _lib.check_launch("adaln_modulate", rc, shape=(B, T, E))
    return y


def adaln_modulate_q8(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                      eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, E), scale/shift (B, E) -> (int8 (B, T, E), f32 scale (B, T)):
    the modulated rows quantised with one scale per row, as ``quant_rows``
    quantises ``adaln_modulate``'s output.

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`adaln_modulate_q8_plain`; a CUDA tensor launches the kernel or
    raises.
    """
    if _lib.use_plain(x):
        return adaln_modulate_q8_plain(x, scale, shift, eps)
    x, scale, shift = _check("adaln_modulate_q8", x, scale, shift)
    B, T, E = x.shape
    x8 = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((B, T), dtype=torch.float32, device=x.device)
    if x8.numel() == 0:
        return x8, s
    rc = _lib.library().mm_adaln_modulate_q8(
        x.data_ptr(), scale.data_ptr(), scale.stride(0), shift.data_ptr(), shift.stride(0),
        x8.data_ptr(), s.data_ptr(), B, T, E, float(eps), _lib.stream_handle(x))
    _lib.check_launch("adaln_modulate_q8", rc, shape=(B, T, E))
    return x8, s
