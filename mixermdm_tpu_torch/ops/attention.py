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
(``csrc/attention.cu``): TMA loads of Q, K and V straight out of strided
views into shared memory, a ring of K/V stages on mbarriers, and ``wgmma``
for both products (S = Q K^T from shared memory, O += P V with P from
registers), 1-3 warpgroups of 64 query rows per block as
:func:`attention_plan` picks for the shape.  Its bound on an H100 is the
larger of the Q/K/V/O bytes over 3.35 TB/s and the 4·B·H·Tq·Tk·D
tensor-core operations over 989 TFLOP/s.  A second instantiation writes f32,
for the W8A8 self-attention block, which quantises the attention output from
f32 (``mixermdm_tpu/ops/fused_block.py:140-146``).  f32 inputs (the CLIP
post-encoders, the InterCLIP towers) take one of two f32 kernels, counted as
``attention_f32``: a warp per query row with f32 FMA on the CUDA cores, or
64 query rows a block with every product on the tensor cores in three TF32
passes, as :func:`attention_f32_plan` picks for the shape.  Given a
``stats`` buffer, any of them also writes
each row's softmax max and denominator (zero key included) for the
backward.  ``attention_q8`` (:func:`attention_q8_into`) is the bf16 kernel
with a quantising epilogue for the W8A8 blocks: the H heads of a query tile
run as one thread block cluster and exchange their rows' partial maxima
through distributed shared memory, so the output leaves as int8 with one f32
scale per row, ``quant_rows``' bits of the output it no longer writes.

The backward (``_fused_attention_bwd_impl`` -> ``_attn_bwd_kernel`` and the
``custom_vjp`` wrappers ``_fa_*``): :func:`attention_bwd` launches the
kernels of ``csrc/attention_bwd.cu`` (``mma.sync`` on the tensor cores: bf16
operands, or f32 in three TF32 passes) from those statistics and the
forward's output, beside the plain version
:func:`attention_bwd_plain`, and :class:`FusedAttention` is the
``torch.autograd.Function`` whose forward is the ``attention`` kernel (with
statistics) and whose backward is ``attention_bwd`` (their plain versions on
the CPU).  :func:`differentiable_attention` picks between it and autograd
through :func:`fused_attention_plain`, as the JAX package's
``fused_attention`` picks a backward per mask.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _lib
from .linear import H100_SMS, sm_count

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 96, 128)

# The bf16 kernel's blocks (csrc/attention.cu): warpgroups of 64 query rows,
# K/V tiles of 64 keys, every tile a set of 64-row slabs 128 bytes deep.
ATTN_ROWS = 64
SLAB_BYTES = ATTN_ROWS * 128
MAX_WARPGROUPS = 3
MAX_STAGES = 3
SMEM_ALIGN = 1024
SMEM_LIMIT = 232448


def attention_smem_bytes(dp: int, nwg: int, stages: int) -> int:
    """Dynamic shared memory of one block (``fwd_smem_bytes`` in
    csrc/attention.cu): Q slabs of every warpgroup, the K/V ring, one
    mbarrier for Q and a full / empty pair per stage."""
    return SMEM_ALIGN + (nwg + 2 * stages) * (dp // 64) * SLAB_BYTES + 8 * (1 + 2 * stages)


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    nwg: int      # warpgroups (64 query rows each) per block
    stages: int   # K/V tiles in flight
    grid: tuple   # (query tiles, H, B)
    smem: int     # dynamic shared memory per block, bytes


@functools.lru_cache(maxsize=None)
def attention_plan(B: int, H: int, Tq: int, Tk: int, D: int,
                   sms: int = H100_SMS) -> AttentionPlan:
    """The bf16 kernel's launch shape, cached (the wrapper asks at every
    launch).  D = 96 runs as 128 (the second slab half zero-filled by TMA).
    The warpgroups per block are the count whose busiest SM has the fewest
    64-row tiles to do, ceil(blocks / sms) x warpgroups, ties to the larger
    block (fewer reads of K and V per query row); the ring is as deep as the
    key tiles, at most 3."""
    dp = 64 if D <= 64 else 128
    best = None
    for nwg in range(1, MAX_WARPGROUPS + 1):
        tiles = -(-Tq // (ATTN_ROWS * nwg))
        cost = -(-(tiles * B * H) // sms) * nwg
        if best is None or cost <= best[0]:
            best = (cost, nwg, tiles)
    _, nwg, tiles = best
    stages = max(1, min(MAX_STAGES, -(-Tk // ATTN_ROWS)))
    return AttentionPlan(nwg, stages, (tiles, H, B), attention_smem_bytes(dp, nwg, stages))


# The f32 kernels' two routes (csrc/attention.cu, csrc/attention_bwd.cu).
# "rows": the forward's warp-per-row kernel (8 query rows a block, K and V
# through 128-key chunks, CUDA-core FMA) and the backward's kernel of 64-row
# tiles streamed one at a time.  "tiled": 64 query rows a block of 4 warps,
# the streamed side in split sub-tiles (16 keys in the forward; 16 rows up
# to D = 96, 8 at D = 128 in the backward) through a two-stage cp.async
# ring, every product on the tensor cores in three TF32 passes.
F32_ROUTES = ("rows", "tiled")
F32_ROWS_PER_BLOCK = 8          # the warp-per-row forward: one warp a row
F32_ROWS_CHUNK = 128            # its keys per chunk
F32_TC_ROWS = 64                # the tiled routes' query (and key) tiles
F32_TC_KEYS = 16                # the tiled forward's keys per streamed tile
F32_TC_STAGES = 2
# The tiled routes take a call whose B x H x ceil(Tq / 64) query tiles are
# at least this many: the measured crossover on an H100 (chip_smoke.py
# phase 3, f32_route_checks).  The tiled forward is slower than the
# warp-per-row kernel at the heads' (2, 8, 77, 96) (32 tiles) and the CLIP
# tower's (2, 12, 77, 64) (48), and faster at (8, 8, 77, 96) (128) and
# every larger shape timed; the backward pair alike at (8, 8, 77, 96).
# The plan picks for speed only: the generators' text encoders, whose
# arithmetic the sampling, training and base-model paths keep bit for bit,
# pin the warp-per-row kernels at every batch
# (models/layers.py: TorchMultiheadAttention.f32_route).
F32_TILED_MIN_TILES = 128
SM_SMEM_BYTES = 233472          # shared memory of an H100 SM
SMEM_PER_BLOCK_RESERVED = 1024  # what the hardware keeps of it for each block


def attention_f32_rows_smem(D: int, Tk: int) -> int:
    """Dynamic shared memory of the warp-per-row forward (``f32_smem_bytes``
    in csrc/attention.cu): a chunk of K and V, the block's 8 query rows
    (rows of D + 4 floats) and their probabilities."""
    kc = min(Tk, F32_ROWS_CHUNK)
    return ((2 * kc + F32_ROWS_PER_BLOCK) * (D + 4) + F32_ROWS_PER_BLOCK * kc) * 4


def attention_f32_tc_smem(D: int) -> int:
    """Dynamic shared memory of the tiled forward (``f32_tc_smem_bytes`` in
    csrc/attention.cu): Q, the two stages of K and V (their TF32 hi parts
    once split), the current tile's lo parts, its key bias."""
    return ((F32_TC_ROWS + (2 * F32_TC_STAGES + 2) * F32_TC_KEYS) * (D + 4) + F32_TC_KEYS) * 4


def attention_bwd_tc_rows(D: int) -> int:
    """Streamed rows per sub-tile of the tiled backward (``tc_rows``)."""
    return 16 if D <= 96 else 8


def attention_bwd_tc_smem(D: int) -> int:
    """Dynamic shared memory of the tiled backward (``tc_smem`` in
    csrc/attention_bwd.cu): two resident 64-row tiles, the two-stage ring of
    the streamed pair, the current sub-tile's lo parts, each stage's query
    statistics."""
    r = attention_bwd_tc_rows(D)
    return ((2 * F32_TC_ROWS + 6 * r) * (D + 4) + 6 * r) * 4


def attention_bwd_rows_smem(D: int) -> int:
    """Dynamic shared memory of the backward's other f32 kernel (``f32_smem``):
    four 64-row tiles and one tile's query statistics."""
    return (4 * F32_TC_ROWS * (D + 4) + 3 * F32_TC_ROWS) * 4


def blocks_per_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes of dynamic shared memory an H100 SM holds."""
    return SM_SMEM_BYTES // (smem + SMEM_PER_BLOCK_RESERVED)


@dataclasses.dataclass(frozen=True)
class F32Plan:
    route: str          # one of F32_ROUTES
    grid: tuple         # (x blocks, H, B)
    threads: int        # per block
    smem: int           # dynamic shared memory per block, bytes
    warps_per_sm: int   # resident warps an SM's shared memory allows


def f32_route(B: int, H: int, Tq: int) -> str:
    """The f32 route of a call (forward and backward alike): "tiled" from
    :data:`F32_TILED_MIN_TILES` query tiles of 64 rows on, else "rows"."""
    return "tiled" if B * H * -(-Tq // F32_TC_ROWS) >= F32_TILED_MIN_TILES else "rows"


@functools.lru_cache(maxsize=None)
def attention_f32_plan(B: int, H: int, Tq: int, Tk: int, D: int,
                       route: Optional[str] = None) -> F32Plan:
    """The launch of the f32 forward (``attention_f32``), cached: the route
    (:func:`f32_route` unless forced) and its grid, block and shared
    memory."""
    route = route or f32_route(B, H, Tq)
    if route == "tiled":
        smem = attention_f32_tc_smem(D)
        return F32Plan(route, (-(-Tq // F32_TC_ROWS), H, B), 128, smem,
                       4 * blocks_per_sm(smem))
    if route != "rows":
        raise ValueError(f"attention_f32: route {route!r} not in {F32_ROUTES}")
    smem = attention_f32_rows_smem(D, Tk)
    return F32Plan(route, (-(-Tq // F32_ROWS_PER_BLOCK), H, B), 32 * F32_ROWS_PER_BLOCK, smem,
                   F32_ROWS_PER_BLOCK * blocks_per_sm(smem))


@functools.lru_cache(maxsize=None)
def attention_bwd_f32_plan(B: int, H: int, Tq: int, Tk: int, D: int,
                           route: Optional[str] = None) -> F32Plan:
    """The launch of the f32 backward's main kernel, cached: query-tile and
    key-tile blocks of 4 warps side by side along x."""
    route = route or f32_route(B, H, Tq)
    if route not in F32_ROUTES:
        raise ValueError(f"attention_bwd: route {route!r} not in {F32_ROUTES}")
    smem = attention_bwd_tc_smem(D) if route == "tiled" else attention_bwd_rows_smem(D)
    grid = (-(-Tq // F32_TC_ROWS) + -(-Tk // F32_TC_ROWS), H, B)
    return F32Plan(route, grid, 128, smem, 4 * blocks_per_sm(smem))


def key_bias(key_padding_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(B, Tk) bool, True = masked -> (B, Tk) f32 additive bias."""
    if key_padding_mask is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=key_padding_mask.device)
    return torch.where(key_padding_mask, torch.full_like(zero, NEG_INF), zero)


def _mask_bytes(name, key_padding_mask, B, Tk, device):
    """The key mask as the kernels read it: (B, Tk) bool, one byte per key,
    contiguous, on the card (True = masked, a -1e30 bias)."""
    if key_padding_mask is None:
        return None
    if key_padding_mask.shape != (B, Tk) or key_padding_mask.dtype != torch.bool:
        raise ValueError(f"{name}: key_padding_mask must be a {(B, Tk)} bool tensor")
    return key_padding_mask.to(device).contiguous()


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


def attention_stats_plain(q, k, key_padding_mask=None, attn_mask=None,
                          zero_attn: bool = True) -> torch.Tensor:
    """Plain version of the statistics the kernels write beside the output:
    (2, B, H, Tq) f32, each row's max of the f32 logits (0 counted when
    ``zero_attn``: the zero key) and its denominator, the sum of
    exp(logit - max) over the keys plus exp(-max) for the zero key.  A row
    with no finite logit gets max 0 and denominator 1, as in the kernels."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_padding_mask is not None:
        logits = logits + key_bias(key_padding_mask)[:, None, None, :]
    if attn_mask is not None:
        logits = logits + attn_mask.float()
    row_max = logits.amax(dim=-1)
    if zero_attn:
        row_max = torch.clamp_min(row_max, 0.0)
    row_max = torch.where(torch.isfinite(row_max), row_max, torch.zeros_like(row_max))
    denom = torch.exp(logits - row_max[..., None]).sum(dim=-1)
    if zero_attn:
        denom = denom + torch.exp(-row_max)
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    return torch.stack([row_max, denom])


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


def view_ok(t: torch.Tensor) -> bool:
    """Whether the kernels take a (B, H, T, D) view: unit stride along D,
    positive (batch, head, row) strides that are multiples of 8 elements,
    16-byte aligned data.  Such a view is what a TMA tensor map describes
    (strides multiples of 16 bytes) and what 16-byte copies read."""
    sb, sh, st, sd = t.stride()
    return (sd == 1 and min(sb, sh, st) > 0 and sb % 8 == 0 and sh % 8 == 0 and st % 8 == 0
            and t.data_ptr() % 16 == 0)


def attention_into(q, k, v, out, key_padding_mask=None, attn_mask=None,
                   zero_attn: bool = True, stats=None, route: Optional[str] = None
                   ) -> torch.Tensor:
    """Launch the ``attention`` kernel on (B, H, T, D) views.

    The views may be strided (the fused blocks pass slices of the packed QKV
    projection) but must have unit stride along D, positive strides that are
    multiples of 8 elements and 16-byte aligned data (what TMA and 16-byte
    copies describe).  q, k and v are all bf16 (then ``out`` is bf16 or f32)
    or all f32 (then ``out`` is f32).  Given ``stats``, a contiguous
    (2, B, H, Tq) f32 tensor, the kernel also writes each row's softmax max
    and denominator into it (see :func:`attention_stats_plain`).  f32
    inputs take the route of :func:`attention_f32_plan`; ``route`` forces
    one (for timing the two side by side).  Writes ``out`` and returns it.
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
        if not view_ok(t):
            raise ValueError(f"attention: {name} strides {t.stride()} / alignment "
                             "not taken by the kernel")
        strides += list(t.stride()[:3])
    if stats is not None:
        _lib.require_cuda("attention", (torch.float32,), stats)
        if stats.device != q.device or stats.shape != (2, B, H, Tq) or not stats.is_contiguous():
            raise ValueError(f"attention: stats must be a contiguous {(2, B, H, Tq)} f32 tensor")
    kpm = _mask_bytes("attention", key_padding_mask, B, Tk, q.device)
    amask = None
    if attn_mask is not None:
        if attn_mask.shape != (Tq, Tk):
            raise ValueError(f"attention: attn_mask must be {(Tq, Tk)}")
        amask = attn_mask.to(device=q.device, dtype=torch.float32).contiguous()
    if B == 0 or H == 0 or Tq == 0:
        return out
    if Tk == 0:  # no key: the output is 0, as the reference's empty sum
        if stats is not None:
            stats[0].zero_()
            stats[1].fill_(1.0)
        return out.zero_()
    tiled, nwg, stages = 0, 0, 0
    if in_f32:
        tiled = int(attention_f32_plan(B, H, Tq, Tk, D, route).route == "tiled")
    else:
        plan = attention_plan(B, H, Tq, Tk, D, sm_count(q))
        nwg, stages = plan.nwg, plan.stages
    c_strides = (ctypes.c_int64 * 12)(*strides)
    rc = _lib.library().mm_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), c_strides,
        None if kpm is None else kpm.data_ptr(),
        None if amask is None else amask.data_ptr(),
        None if stats is None else stats.data_ptr(),
        B, H, Tq, Tk, D, int(bool(zero_attn)), 1.0 / math.sqrt(D), int(in_f32),
        int(out.dtype == torch.float32), tiled, nwg, stages, _lib.stream_handle(q))
    _lib.check_launch("attention_f32" if in_f32 else "attention", rc, shape=(B, H, Tq, Tk, D))
    return out


def fused_attention(q, k, v, key_padding_mask=None, attn_mask=None,
                    zero_attn: bool = True, return_stats: bool = False,
                    route: Optional[str] = None):
    """q (B, H, Tq, D), k/v (B, H, Tk, D), key_padding_mask (B, Tk) bool with
    True = masked, attn_mask (Tq, Tk) additive -> (B, H, Tq, D); with
    ``return_stats`` also the (2, B, H, Tq) f32 row statistics that
    :func:`attention_bwd` reads (:func:`attention_stats_plain`).  ``route``
    pins f32 inputs to one of :data:`F32_ROUTES` (else the plan's).

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`fused_attention_plain`; a CUDA tensor launches
    the kernel or raises.
    """
    if _lib.use_plain(q):
        out = fused_attention_plain(q, k, v, key_padding_mask, attn_mask, zero_attn)
        if not return_stats:
            return out
        return out, attention_stats_plain(q, k, key_padding_mask, attn_mask, zero_attn)
    B, H, Tq, _ = q.shape
    stats = (torch.empty((2, B, H, Tq), dtype=torch.float32, device=q.device)
             if return_stats else None)
    out = attention_into(q, k, v, torch.empty_like(q, memory_format=torch.contiguous_format),
                         key_padding_mask, attn_mask, zero_attn, stats, route)
    _lib.launches["fused_attention"] += 1
    return (out, stats) if return_stats else out


# ---------------------------------------------------------------------------
# The quantising form (W8A8 blocks)
# ---------------------------------------------------------------------------

MAX_CLUSTER_HEADS = 8  # attention_q8 runs the H heads of a query tile as one cluster
Q8_HEAD_DIMS = (64, 128)
# A wave's cost beside its warpgroups of rows, in warpgroups: every CTA runs
# the whole K/V loop whatever its rows (fitted to attention_q8's times at
# T = 299 on an H100, chip_smoke.py phase 3).
Q8_WAVE_OVERHEAD = 4


def attention_q8_plain(q, k, v, key_padding_mask=None, zero_attn: bool = True,
                       out_dtype=torch.float32):
    """Plain version of ``attention_q8``: the attention output of
    :func:`fused_attention_plain` in ``out_dtype`` (f32 for the W8A8
    self-attention block, the compute dtype for the cross-attention block),
    heads merged into (B, Tq, H D), then ``_quant_act`` per row
    (:func:`~.quant.quant_rows_plain`) -> (int8 (B, Tq, H D), f32 (B, Tq))."""
    from .quant import quant_rows_plain

    a = fused_attention_plain(q, k, v, key_padding_mask, None, zero_attn, out_dtype=out_dtype)
    B, H, Tq, D = a.shape
    return quant_rows_plain(a.transpose(1, 2).reshape(B, Tq, H * D))


def attention_q8_into(q, k, v, out8, scale, key_padding_mask=None, zero_attn: bool = True,
                      round_bf16: bool = False):
    """Launch ``attention_q8``: the bf16 ``attention`` kernel whose epilogue
    quantises each output row of the (B, Tq, H D) matrix to int8 with one
    f32 scale, the H heads of a query tile forming one thread block cluster
    that exchanges the rows' partial maxima through distributed shared
    memory.  q, k, v: bf16 (B, H, T, D) views as :func:`attention_into`
    takes them, D in {64, 128}, H <= 8; ``out8``: the int8 (B, H, Tq, D)
    head view of a contiguous (B, Tq, H D) matrix; ``scale``: contiguous
    (B, Tq) f32.  ``round_bf16`` quantises the bf16 rounding of the output
    (what :func:`~.quant.quant_rows` reads of a bf16 output), else its f32
    values.  Writes both and returns them: bit for bit ``quant_rows`` of
    the ``attention`` kernel's output in that dtype.
    """
    _lib.require_cuda_bf16("attention_q8", q, k, v)
    _lib.require_cuda("attention_q8", (torch.int8,), out8)
    _lib.require_cuda("attention_q8", (torch.float32,), scale)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if D not in Q8_HEAD_DIMS or H > MAX_CLUSTER_HEADS:
        raise ValueError(f"attention_q8: head dim {D} not in {Q8_HEAD_DIMS} or {H} heads "
                         f"over the cluster's {MAX_CLUSTER_HEADS}")
    if k.shape != (B, H, Tk, D) or v.shape != k.shape or out8.shape != q.shape:
        raise ValueError(f"attention_q8: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} out8{tuple(out8.shape)} do not agree")
    if out8.stride() != (Tq * H * D, D, H * D, 1):
        raise ValueError("attention_q8: out8 must be the head view of a contiguous "
                         f"{(B, Tq, H * D)} int8 matrix, got strides {out8.stride()}")
    if scale.shape != (B, Tq) or not scale.is_contiguous():
        raise ValueError(f"attention_q8: scale must be a contiguous {(B, Tq)} f32 tensor")
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not view_ok(t):
            raise ValueError(f"attention_q8: {name} strides {t.stride()} / alignment "
                             "not taken by the kernel")
        strides += list(t.stride()[:3])
    strides += list(out8.stride()[:3])
    kpm = _mask_bytes("attention_q8", key_padding_mask, B, Tk, q.device)
    if B == 0 or Tq == 0:
        return out8, scale
    if Tk == 0:
        raise ValueError("attention_q8: no key")
    plan = attention_q8_plan(B, H, Tq, Tk, D)
    rc = _lib.library().mm_attention_q8(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out8.data_ptr(),
        (ctypes.c_int64 * 12)(*strides), None if kpm is None else kpm.data_ptr(),
        scale.data_ptr(), B, H, Tq, Tk, D, int(bool(zero_attn)), 1.0 / math.sqrt(D),
        int(bool(round_bf16)), plan.nwg, plan.stages, _lib.stream_handle(q))
    _lib.check_launch("attention_q8", rc, shape=(B, H, Tq, Tk, D))
    return out8, scale


def attention_q8(q, k, v, key_padding_mask=None, zero_attn: bool = True,
                 out_dtype=torch.float32):
    """q, k, v (B, H, T, D) -> the int8 (B, Tq, H D) attention output and
    its (B, Tq) f32 row scales, quantised from the output in ``out_dtype``
    (f32 or bf16).

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`attention_q8_plain`; a CUDA tensor launches the kernel or raises.
    """
    if _lib.use_plain(q):
        return attention_q8_plain(q, k, v, key_padding_mask, zero_attn, out_dtype)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention_q8: quantises an f32 or bf16 output, not {out_dtype}")
    B, H, Tq, D = q.shape
    out8 = torch.empty((B, Tq, H * D), dtype=torch.int8, device=q.device)
    scale = torch.empty((B, Tq), dtype=torch.float32, device=q.device)
    attention_q8_into(q, k, v, out8.view(B, Tq, H, D).transpose(1, 2), scale,
                      key_padding_mask, zero_attn, round_bf16=out_dtype == torch.bfloat16)
    return out8, scale


@functools.lru_cache(maxsize=None)
def attention_q8_clusters(D: int, H: int, nwg: int, stages: int) -> int:
    """How many ``attention_q8`` clusters (H CTAs each) of this plan the card
    holds at once (``cudaOccupancyMaxActiveClusters``)."""
    n = _lib.library().mm_attention_q8_clusters(D, H, nwg, stages)
    if n < 0:
        raise RuntimeError(f"attention_q8 clusters: CUDA error {-n}")
    return n


@functools.lru_cache(maxsize=None)
def attention_q8_plan(B: int, H: int, Tq: int, Tk: int, D: int, nwg: Optional[int] = None,
                      max_clusters=None) -> AttentionPlan:
    """The launch shape of ``attention_q8``, cached.  A wave is the clusters
    of H CTAs the card holds at once (``max_clusters(D, H, nwg, stages)``,
    :func:`attention_q8_clusters` on the card), not its SMs: clusters of 8
    CTAs of one SM each fill only the GPCs' multiples of 8 SMs (15 clusters,
    120 SMs, on an H100 SXM).  The warpgroups per block are the count whose
    waves cost least, a wave costing its warpgroups plus
    :data:`Q8_WAVE_OVERHEAD`; ties to the larger block.  ``nwg`` forces
    the warpgroups.  A head dim the kernel lacks or more heads than a cluster
    spans raise :class:`~._lib.ShapeRefused`, a card that holds no cluster
    :class:`~._lib.NoClusterFits` (:data:`~._lib.PLAN_REFUSALS`)."""
    if D not in Q8_HEAD_DIMS or H > MAX_CLUSTER_HEADS:
        raise _lib.ShapeRefused(f"attention_q8: head dim {D} not in {Q8_HEAD_DIMS} or {H} "
                                f"heads over the cluster's {MAX_CLUSTER_HEADS}")
    max_clusters = max_clusters or attention_q8_clusters
    dp = 64 if D <= 64 else 128
    stages = max(1, min(MAX_STAGES, -(-Tk // ATTN_ROWS)))
    best = None
    for n in (nwg,) if nwg else range(1, MAX_WARPGROUPS + 1):
        tiles = -(-Tq // (ATTN_ROWS * n))
        cap = max_clusters(D, H, n, stages)
        if cap < 1:
            continue
        cost = -(-(tiles * B) // cap) * (n + Q8_WAVE_OVERHEAD)
        if best is None or cost <= best[0]:
            best = (cost, n, tiles)
    if best is None:
        raise _lib.NoClusterFits(f"attention_q8: no cluster of {H} CTAs fits the card at D={D}")
    _, n, tiles = best
    return AttentionPlan(n, stages, (tiles, H, B), attention_smem_bytes(dp, n, stages))


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def attention_bwd_plain(q, k, v, key_padding_mask, g, zero_attn: bool = True, stats=None,
                        out=None):
    """Plain PyTorch version of ``attention_bwd`` with the JAX kernel's
    rounding points (``_attn_bwd_kernel``): f32 softmax with the zero key in
    the max and the denominator, taken from ``stats`` (the forward's
    (2, B, H, Tq) row max and denominator, as the kernels read them) or, when
    None, recomputed; p and ds rounded to the input dtype before the products
    that use them; f32 products; dq, dk, dv rounded to the input dtype once.
    dsum is rowsum(dp * p), or, given the forward's output ``out``, the
    kernels' rowsum(g * out) (FlashAttention-2's identity; the same sum but
    for the rounding of ``out``)."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if key_padding_mask is not None:
        logits = logits + key_bias(key_padding_mask)[:, None, None, :]
    if stats is not None:
        p = torch.exp(logits - stats[0][..., None]) / stats[1][..., None]
    else:
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
    if out is not None:
        dsum = (gf * out.float()).sum(dim=-1, keepdim=True)
    else:
        dsum = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - dsum)).to(dt).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def attention_bwd(q, k, v, key_padding_mask, g, zero_attn: bool = True, stats=None, out=None,
                  route: Optional[str] = None):
    """(dq, dk, dv) of :func:`fused_attention` (no ``attn_mask``) for the
    output gradient ``g``: q, g (B, H, Tq, D), k, v (B, H, Tk, D), all bf16
    or all f32; key_padding_mask (B, Tk) bool with True = masked.  The
    kernels need two things from the forward
    (``fused_attention(..., return_stats=True)``): ``stats``, the
    (2, B, H, Tq) row statistics, and ``out``, its output (for dsum).

    f32 inputs take the route of :func:`attention_bwd_f32_plan`; ``route``
    forces one (for timing the two side by side).

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`attention_bwd_plain`; a CUDA tensor launches the kernels or
    raises.
    """
    if _lib.use_plain(q):
        return attention_bwd_plain(q, k, v, key_padding_mask, g, zero_attn, stats, out)
    _lib.require_cuda("attention_bwd", (torch.bfloat16, torch.float32), q, k, v, g, out)
    if not (q.dtype == k.dtype == v.dtype == g.dtype) or (out is not None
                                                          and out.dtype != q.dtype):
        raise TypeError(f"attention_bwd: q/k/v/g dtypes {q.dtype}/{k.dtype}/{v.dtype}/{g.dtype} "
                        "and out differ")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention_bwd: head dim {D} not in {KERNEL_HEAD_DIMS}")
    if k.shape != (B, H, Tk, D) or v.shape != k.shape or g.shape != q.shape:
        raise ValueError(f"attention_bwd: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} g{tuple(g.shape)} do not agree")
    if stats is None or out is None:
        raise ValueError("attention_bwd: the kernels read the forward's row statistics and "
                         "output; pass stats and out from fused_attention(..., return_stats=True)")
    _lib.require_cuda("attention_bwd", (torch.float32,), stats)
    if stats.device != q.device or stats.shape != (2, B, H, Tq) or out.shape != q.shape:
        raise ValueError(f"attention_bwd: stats must be {(2, B, H, Tq)} f32 and out "
                         f"{tuple(q.shape)} on {q.device}")
    q, k, v, g, out, stats = (t.contiguous() for t in (q, k, v, g, out, stats))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0 or H == 0 or Tq == 0 or Tk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    kpm = _mask_bytes("attention_bwd", key_padding_mask, B, Tk, q.device)
    dsum = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    in_f32 = q.dtype == torch.float32
    tiled = in_f32 and attention_bwd_f32_plan(B, H, Tq, Tk, D, route).route == "tiled"
    rc = _lib.library().mm_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), out.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), dsum.data_ptr(),
        None if kpm is None else kpm.data_ptr(), B, H, Tq, Tk, D, 1.0 / math.sqrt(D),
        int(in_f32), int(bool(zero_attn)), int(tiled), _lib.stream_handle(q))
    _lib.check_launch("attention_bwd", rc, shape=(B, H, Tq, Tk, D))
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """Attention with the ``attention`` kernel forward and the
    ``attention_bwd`` kernel backward (the JAX ``custom_vjp`` wrappers
    ``_fa_nomask`` / ``_fa_kpm``): saves q, k, v, the mask, the forward's
    row statistics and its output, which the backward reads instead of
    recomputing the softmax's max, denominator and dsum.  Both halves go
    through the entry points, so on a CPU tensor or inside
    ``ops.plain_versions()`` it is the plain version of the same arithmetic:
    :func:`fused_attention_plain` and :func:`attention_stats_plain` forward,
    :func:`attention_bwd_plain` backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, zero_attn, route=None):
        out, stats = fused_attention(q, k, v, key_padding_mask, None, zero_attn,
                                     return_stats=True, route=route)
        ctx.save_for_backward(q, k, v, key_padding_mask, stats, out)
        ctx.zero_attn, ctx.route = zero_attn, route
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kpm, stats, out = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, kpm, g.to(q.dtype), ctx.zero_attn, stats, out,
                                   ctx.route)
        return dq, dk, dv, None, None, None


def differentiable_attention(q, k, v, key_padding_mask=None, attn_mask=None,
                             zero_attn: bool = True, route: Optional[str] = None
                             ) -> torch.Tensor:
    """Attention that autograd can differentiate: :class:`FusedAttention`
    (``route`` as :func:`fused_attention` takes it); with an additive
    ``attn_mask``, where the JAX package's backward kernel raises and its
    VJP recomputes through XLA (``_fa_am_bwd``, ``_fa_both_bwd``), autograd
    through :func:`fused_attention_plain`."""
    if attn_mask is not None:
        return fused_attention_plain(q, k, v, key_padding_mask, attn_mask, zero_attn)
    return FusedAttention.apply(q, k, v, key_padding_mask, zero_attn, route)
