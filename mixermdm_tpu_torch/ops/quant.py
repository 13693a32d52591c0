"""W8A8 quantisation: symmetric int8 with one f32 scale per row.

Counterparts of ``mixermdm_tpu/ops/fused_block.py``: :func:`quantize_weight`
(``quantize_weight``: one scale per output channel; the JAX weight is
(in, out), the torch weight (out, in), so the scale is per row here) and
:func:`quant_rows` (``_quant_act``: one scale per token), the int8 prologues
of the ``quant=True`` Pallas block kernels.

``s = max(max|x|, 1e-8) / 127`` and ``x8 = clip(round(x / s), -127, 127)``,
with round half to even (``torch.round``, as ``jnp.round``) and a true
division: the divisors are tensors, since PyTorch's CUDA division by a
Python number multiplies by its reciprocal, which can flip an int8 value.

Kernel ``quant_rows`` (``csrc/quant.cu``) quantises activations on the card:
one warp per row, bound by device-memory bytes.  On the W8A8 path it is left
to an FFN input that is not modulated; the other activations are quantised
in their producers' epilogues (``adaln_modulate_q8``, ``attention_q8``,
``linear_q8(..., quant_out=True)``), with its bits.  Weights are quantised once,
when a model is built or cast (:func:`quantize_weight`, plain PyTorch, as
the JAX package quantises them outside its kernels).
"""

from __future__ import annotations

import torch

from . import _lib


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)


def _round_clip(v: torch.Tensor) -> torch.Tensor:
    return torch.round(v).clamp_(-127, 127).to(torch.int8)


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, K) weight in torch layout -> (int8 (N, K), f32 scale (N,)), one
    scale per output channel.  A packed ``in_proj_weight`` (3E, E) gives the
    same rows as separate Q, K and V weights."""
    wf = w.detach().float()
    s = _scale(wf.abs().amax(dim=1))
    return _round_clip(wf / s[:, None]), s


def quant_rows_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: x (..., K) -> (int8 (..., K), f32 scale (...))."""
    xf = x.float()
    s = _scale(xf.abs().amax(dim=-1))
    return _round_clip(xf / s[..., None]), s


def quant_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., K) bf16 or f32 -> (int8 (..., K), f32 scale (...)).

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`quant_rows_plain`; a CUDA tensor launches the kernel or raises.
    """
    if _lib.use_plain(x):
        return quant_rows_plain(x)
    _lib.require_cuda("quant_rows", (torch.bfloat16, torch.float32), x)
    K = x.shape[-1]
    if K % 16:
        raise ValueError(f"quant_rows: K={K} is not a multiple of 16")
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    x8 = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rows = x.numel() // K if K else 0
    if rows == 0:
        return x8, s
    rc = _lib.library().mm_quant_rows(x.data_ptr(), int(x.dtype == torch.float32),
                                      x8.data_ptr(), s.data_ptr(), rows, K,
                                      _lib.stream_handle(x))
    _lib.check_launch("quant_rows", rc)
    return x8, s
