"""Int8 dense layer with a fused dequantisation epilogue:
``y = (x8 . w8^T) * s_row * s_col + b``, then bf16, exact GELU in f32, or
bf16 ``+ residual``.

Kernel ``linear_q8`` (``csrc/linear_q8.cu``) replaces ``_qdot8`` / ``_qdot``
(``mixermdm_tpu/ops/fused_block.py:66-77``), the int8 products of the q8
Pallas block kernels.  At the denoiser shapes it is bound by int8
tensor-core operations (1979 TOP/s dense on an H100 SXM at 700 W); it runs
the Hopper main loop of ``csrc/gemm_sm90.cuh`` with the int8 ``wgmma``, its
tile plan from :func:`~.linear.gemm_plan`.

With ``activation="gelu", quant_out=True`` (the W8A8 FFN's first product)
it also quantises the f32 hidden per row, ``_quant_act``
(``fused_block.py:58``), in its epilogue, counted as ``linear_q8_gelu_q8``:
the N-tiles of a row block run as one thread block cluster that exchanges
the rows' partial maxima through distributed shared memory, so the hidden
never reaches device memory (:func:`gelu_q8_plan`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from . import _lib
from .linear import (
    EPILOGUE_NAMES,
    EPI_BYTES,
    MAX_STAGES,
    ROW_BYTES,
    SMEM_ALIGN,
    SMEM_LIMIT,
    gemm_plan,
    sm_count,
)
from .quant import quant_rows_plain

# The quantising GELU product (gemm_gelu_q8_kernel in csrc/gemm_sm90.cuh):
# NC consumer warpgroups of 64 rows (BM = 64 NC), tiles of 128 columns, one
# cluster of at most 16 CTAs (the non-portable size) across the N-tiles of a
# row block.
GELU_Q8_BN = 128
GELU_Q8_WARPGROUPS = (1, 2, 3)
MAX_CLUSTER_CTAS = 16
# A round's cost beside its warpgroups of rows, in warpgroups: the main
# loop's fill, the epilogue's chains and the cluster barrier (fitted to the
# product's times at M = 2392 on an H100, chip_smoke.py phase 3).
GELU_Q8_ROUND_OVERHEAD = 3


def gelu_q8_smem_bytes(nc: int, stages: int) -> int:
    """Dynamic shared memory of the quantising GELU product
    (``gelu_q8_smem_bytes`` in csrc/gemm_sm90.cuh): the alignment slack, the
    ring, per consumer warpgroup the epilogue staging and two buffers of 64
    row partials, the mbarrier pairs."""
    return (SMEM_ALIGN + stages * (64 * nc + GELU_Q8_BN) * ROW_BYTES
            + nc * (EPI_BYTES // 2 + 2 * 64 * 4) + 2 * stages * 8)


@dataclasses.dataclass(frozen=True)
class GeluQ8Plan:
    nc: int            # consumer warpgroups (64 rows each) per CTA
    cluster_ctas: int  # CTAs per cluster: the N-tiles of a row block
    stages: int        # depth of the ring
    clusters: int      # clusters launched; each walks row blocks
    smem: int          # dynamic shared memory per CTA, bytes


@functools.lru_cache(maxsize=None)
def _device_clusters(nc: int, ctas: int, smem: int) -> int:
    """Clusters of this instantiation the card holds at once."""
    n = _lib.library().mm_linear_q8_gelu_q8_clusters(nc, ctas, smem)
    if n < 0:
        raise RuntimeError(f"linear_q8_gelu_q8 clusters: CUDA error {-n}")
    return n


@functools.lru_cache(maxsize=256)
def gelu_q8_plan(M: int, N: int, K: int, nc: Optional[int] = None,
                 max_clusters: Optional[Callable[[int, int, int], int]] = None) -> GeluQ8Plan:
    """The launch shape of the quantising GELU product, cached.

    The cluster spans the ceil(N / 128) tiles of a row block.  Each
    warpgroup count is costed as the rounds of row blocks the clusters the
    card holds at once (``max_clusters(nc, ctas, smem)``,
    ``cudaOccupancyMaxActiveClusters`` on the card) must walk, a round
    costing its warpgroups plus :data:`GELU_Q8_ROUND_OVERHEAD`; the cheapest
    wins, ties to more rows per tile.  ``nc`` forces the warpgroups.  The
    ring is as deep as 227 KB allows, at most 6 stages.  An N over 16 tiles
    raises :class:`~._lib.ShapeRefused`, a card that holds no cluster
    :class:`~._lib.NoClusterFits` (:data:`~._lib.PLAN_REFUSALS`).
    """
    ctas = -(-N // GELU_Q8_BN)
    if ctas > MAX_CLUSTER_CTAS:
        raise _lib.ShapeRefused(f"linear_q8_gelu_q8: N={N} spans more than {MAX_CLUSTER_CTAS} "
                                f"tiles of {GELU_Q8_BN}")
    max_clusters = max_clusters or _device_clusters
    best = None
    for n_wg in (nc,) if nc else GELU_Q8_WARPGROUPS:
        stage = (64 * n_wg + GELU_Q8_BN) * ROW_BYTES
        stages = min(MAX_STAGES, (SMEM_LIMIT - gelu_q8_smem_bytes(n_wg, 0)) // (stage + 16))
        smem = gelu_q8_smem_bytes(n_wg, stages)
        cap = max_clusters(n_wg, ctas, smem)
        if cap < 1:
            continue
        tiles_m = -(-M // (64 * n_wg))
        clusters = min(tiles_m, cap)
        cost = -(-tiles_m // clusters) * (n_wg + GELU_Q8_ROUND_OVERHEAD)
        if best is None or cost <= best[0]:
            best = (cost, GeluQ8Plan(n_wg, ctas, stages, clusters, smem))
    if best is None:
        raise _lib.NoClusterFits(f"linear_q8_gelu_q8: no cluster of the plan fits the card "
                                 f"(M={M}, N={N}, K={K})")
    return best[1]


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


def linear_q8_gelu_q8_plain(x8: torch.Tensor, x_scale: torch.Tensor, w8: torch.Tensor,
                            w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the quantising GELU product: ``quant_rows_plain`` of
    the f32 hidden of :func:`linear_q8_plain` with ``activation="gelu"``."""
    return quant_rows_plain(linear_q8_plain(x8, x_scale, w8, w_scale, bias, activation="gelu"))


def linear_q8(x8: torch.Tensor, x_scale: torch.Tensor, w8: torch.Tensor,
              w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
              activation: Optional[str] = None, residual: Optional[torch.Tensor] = None,
              dtype: torch.dtype = torch.bfloat16, quant_out: bool = False):
    """x8 (..., K) int8 with x_scale (...), w8 (N, K) int8 with w_scale
    (N,), bias (N,) -> (..., N): f32 with ``activation="gelu"``, else
    ``dtype`` (bf16 on the card), ``+ residual`` when given.  With
    ``activation="gelu", quant_out=True``: the f32 hidden quantised per row,
    (int8 (..., N), f32 scales (...)), and no f32 hidden (N <= 2048).

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`linear_q8_plain` (:func:`linear_q8_gelu_q8_plain`); a CUDA tensor
    launches the kernel or raises.
    """
    if quant_out and (activation != "gelu" or residual is not None):
        raise ValueError("linear_q8: quant_out quantises the GELU hidden (activation='gelu', "
                         "no residual)")
    if _lib.use_plain(x8):
        if quant_out:
            return linear_q8_gelu_q8_plain(x8, x_scale, w8, w_scale, bias)
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
    if quant_out:
        return _gelu_q8(x2, x_scale, w8, w_scale, bias, lead, M, N, K)
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
    plan = gemm_plan(M, N, K, True, False, sm_count(x8))  # _rows16: TMA describes both
    rc = _lib.library().mm_linear_q8(
        x2.data_ptr(), x2.stride(0), x_scale.data_ptr(), w8.data_ptr(), w8.stride(0),
        w_scale.data_ptr(), None if bias is None else bias.data_ptr(), res_ptr, ldr,
        y.data_ptr(), N, M, N, K, epi, plan.bn, plan.stages, plan.grid, plan.smem,
        _lib.stream_handle(x8))
    _lib.check_launch("linear_q8", rc, shape=(M, K, N, EPILOGUE_NAMES[epi]))
    return y


def _gelu_q8(x2, x_scale, w8, w_scale, bias, lead, M, N, K):
    """Launch the quantising GELU product on checked, 16-byte-row operands."""
    y8 = torch.empty(lead + (N,), dtype=torch.int8, device=x2.device)
    ys = torch.empty(lead, dtype=torch.float32, device=x2.device)
    if M == 0 or N == 0:
        return y8, ys
    plan = gelu_q8_plan(M, N, K)
    rc = _lib.library().mm_linear_q8_gelu_q8(
        x2.data_ptr(), x2.stride(0), x_scale.data_ptr(), w8.data_ptr(), w8.stride(0),
        w_scale.data_ptr(), None if bias is None else bias.data_ptr(), y8.data_ptr(), N,
        ys.data_ptr(), M, N, K, plan.nc, plan.stages, plan.clusters, plan.smem,
        _lib.stream_handle(x2))
    _lib.check_launch("linear_q8_gelu_q8", rc, shape=(M, K, N, "gelu_q8"))
    return y8, ys
