"""Dense layer with a fused epilogue: ``y = x @ W^T + b``, then optionally
exact GELU or ``+ residual``.

Kernel ``linear_epilogue`` (``csrc/linear.cu``) replaces the projection and
FFN matmuls of the Pallas block kernels in ``mixermdm_tpu/ops/fused_block.py``
(and carries every other bf16 dense layer of the sampling path on the card).
It has three routes, chosen here by :func:`gemm_plan` from the shape and
counted each under its own name:

- ``linear_epilogue``: the Hopper main loop of ``csrc/gemm_sm90.cuh`` (TMA,
  an mbarrier ring, ``wgmma``, a persistent grid), for every shape TMA can
  describe with M > 64.  Bound by bf16 tensor-core operations (989 TFLOP/s
  dense on an H100 SXM at 700 W) at the denoiser shapes.
- ``linear_epilogue_skinny``: M <= 64 (the M = 8 modulations and embeddings),
  bound by the read of W (3.35 TB/s).
- ``linear_epilogue_ragged``: what TMA cannot describe (on the main path
  only K = 262, rows of 524 or 1048 bytes): ``wgmma`` on the same shared
  memory layout, tile plan and epilogue, fed by ``cp.async`` copies from
  every thread, as wide as the rows allow (16, 8, 4 or 2 bytes, picked in
  ``csrc/linear.cu:copy_width``).

The route depends on the shape and the alignment alone, never on whether a
launch succeeded.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import _lib

_EPILOGUE = {None: 0, "gelu": 1}
_RESIDUAL = 2
EPILOGUE_NAMES = ("none", "gelu", "residual")

# The TMA route's tiles (csrc/gemm_sm90.cuh): 128 rows (two consumer
# warpgroups of 64) by BN columns, stages of 128 bytes along K.
BM = 128
TILE_BN = (64, 128, 192, 256)
ROW_BYTES = 128
EPI_BYTES = 2 * (64 * 144 + 2 * 256 * 4)  # per consumer warpgroup: staging, bias, scales
SMEM_ALIGN = 1024
SMEM_LIMIT = 232448           # 227 KB, the most a block may ask for
MAX_STAGES = 6
TILE_OVERHEAD = 32            # a tile's fixed cost, in columns of main loop
SKINNY_MAX_M = 64
SKINNY_COLS = 8               # columns of y per skinny block
SKINNY_K_CHUNK = 64           # the skinny route reads K in 128-byte chunks
H100_SMS = 132


def stage_bytes(bn: int) -> int:
    return (BM + bn) * ROW_BYTES


def smem_bytes(bn: int, stages: int) -> int:
    """Dynamic shared memory of the TMA route: the alignment slack, the ring,
    the epilogue's staging and a full / empty mbarrier pair per stage (the
    formula of ``smem_bytes`` in ``csrc/gemm_sm90.cuh``)."""
    return SMEM_ALIGN + stages * stage_bytes(bn) + EPI_BYTES + 2 * stages * 8


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    route: str        # "tma", "skinny" or "ragged"
    bn: int = 0       # tma, ragged: tile width
    stages: int = 0   # tma, ragged: depth of the ring
    grid: int = 0     # blocks launched
    smem: int = 0     # tma, ragged: dynamic shared memory, bytes


def tma_describable(elem_bytes: int, *mats: tuple[int, int]) -> bool:
    """Whether TMA can describe each (base address, row stride in elements)
    matrix: 16-byte aligned base, row stride a multiple of 16 bytes."""
    for ptr, ld in mats:
        if ptr % 16 or (ld * elem_bytes) % 16:
            return False
    return True


@functools.lru_cache(maxsize=1024)
def gemm_plan(M: int, N: int, K: int, tma_ok: bool = True, skinny: bool = True,
              sms: int = H100_SMS) -> GemmPlan:
    """The route and launch shape of one product (M, K) x (N, K)^T, cached
    (the wrappers ask at every launch).

    ``tma_ok``: the operands pass :func:`tma_describable`; without it the
    product takes the ragged route, which fills the TMA route's shared
    memory layout with ``cp.async`` copies and takes the same plan.  With
    ``skinny`` (bf16), M <= 64 and K a multiple of 64 take the skinny route
    (TMA operands only).  Otherwise the tile width that finishes soonest on
    ``sms`` SMs:
    the persistent grid runs ``ceil(tiles / sms)`` rounds of one tile each,
    a tile costing its width plus a fixed overhead; ties go to the wider
    tile.  The ring is as deep as 227 KB allows, at most 6 stages (a stage
    is 128 bytes deep for either operand type).  At K = 262 (5 stages of 64
    elements) all of K fits in the ring at every width but 256.
    """
    if tma_ok and skinny and M <= SKINNY_MAX_M and K % SKINNY_K_CHUNK == 0:
        return GemmPlan("skinny", grid=-(-N // SKINNY_COLS))
    tiles_m = -(-M // BM)
    best = None
    for bn in TILE_BN:
        tiles = tiles_m * -(-N // bn)
        cost = -(-tiles // sms) * (bn + TILE_OVERHEAD)
        if best is None or cost <= best[0]:
            best = (cost, bn, tiles)
    _, bn, tiles = best
    stages = min(MAX_STAGES, (SMEM_LIMIT - SMEM_ALIGN - EPI_BYTES) // (stage_bytes(bn) + 16))
    return GemmPlan("tma" if tma_ok else "ragged", bn, stages, min(tiles, sms),
                    smem_bytes(bn, stages))


_sms: dict = {}


def sm_count(t: torch.Tensor) -> int:
    """SMs of the card ``t`` lies on (132 on an H100 SXM), read once."""
    index = t.device.index
    n = _sms.get(index)
    if n is None:
        n = _sms[index] = torch.cuda.get_device_properties(
            index if index is not None else torch.cuda.current_device()).multi_processor_count
    return n


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
    tensor take :func:`linear_plain`; a bf16 CUDA tensor launches the kernel
    route :func:`gemm_plan` picks, anything else raises.
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
    xp, ldx, wp, ldw = x2.data_ptr(), x2.stride(0), weight.data_ptr(), weight.stride(0)
    plan = gemm_plan(M, N, K, tma_describable(2, (xp, ldx), (wp, ldw)), True, sm_count(x))
    args = (xp, ldx, wp, ldw, None if bias is None else bias.data_ptr(), res_ptr, ldr,
            y.data_ptr(), N, M, N, K, epi)
    lib = _lib.library()
    if plan.route == "tma":
        rc = lib.mm_linear_tma(*args, plan.bn, plan.stages, plan.grid, plan.smem,
                               _lib.stream_handle(x))
        name = "linear_epilogue"
    elif plan.route == "skinny":
        rc = lib.mm_linear_skinny(*args, _lib.stream_handle(x))
        name = "linear_epilogue_skinny"
    else:
        rc = lib.mm_linear_ragged(*args, plan.bn, plan.stages, plan.grid, plan.smem,
                                  _lib.stream_handle(x))
        name = "linear_epilogue_ragged"
    _lib.check_launch(name, rc, shape=(M, K, N, EPILOGUE_NAMES[epi]))
    return y
