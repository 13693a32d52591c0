"""The four experimental variants of the self-attention block, each one
launch on the card.

Counterparts of ``scripts/exp_kernels.py`` (the kernel experiments of the
JAX package, never shipped), with their names and arguments:

- :func:`sa_variant` (``sa_variant`` -> ``_sa_v_kernel`` /
  ``_sa_v_kernel_q8``, ``pallas_call`` ``:204``): AdaLN + MHA +
  out-projection + residual with one merged (E, 3E) QKV product, ``rows``
  sequences per program and an optional reciprocal-multiply softmax;
- :func:`sa_ablate` (``sa_ablate`` -> ``_sa_abl_kernel`` / ``_abl_q8``,
  ``:433``): the block with LayerNorm, attention or softmax switched off,
  different math, for timing only;
- :func:`sa_headbatch` (``sa_headbatch`` -> ``_sa_hb_kernel`` / ``_hb_q8``,
  ``:595``): all heads in one batched product;
- :func:`sa_int8x` (``sa_int8x`` -> ``_sa_i8x_kernel``, ``:792``): the W8A8
  block with a static activation scale, int8 p.v (p scale 1/127, v one scale
  per sequence) and optionally int8 q.k^T (q and k one scale per sequence).

The first three are one kernel, ``sa_block`` (``csrc/sa_block.cu``); the
fourth is ``sa_block_i8x`` (``csrc/sa_block_i8x.cu``).  A TPU program holds a
whole sequence and the (E, 3E) weight in VMEM; an H100 block holds 227 KB,
so each kernel is one persistent launch of one block per SM (a grid that the
card holds at once: :func:`sa_block_plan`; launched cooperatively, so that
a grid that does not fit is refused) in phases separated by grid-wide
barriers: LayerNorm and modulation (with the per-row int8 quantisation of
``quant``) of the padded rows into device memory, the merged QKV product,
(``sa_block_i8x`` with int8 q.k^T or p.v) the attention's int8 operands,
attention by (sequence, head, 64-row query tile) per warpgroup, the per-row
quantisation of the attention output (``quant``), and the out-projection
with its bias, the cast and the residual.  A block is three warpgroups on
TMA and ``wgmma``: in the products one issues the loads and two take the
128 x 128 tiles (bf16, or s8 with s32 sums) from one ring of stages that
runs through both product phases; in the attention all three take tiles,
each from its own ring of K/V stages (``Tiles`` and ``Walk`` in
``csrc/sa_common.cuh`` hand out the work each one takes).

The sequence is padded as the JAX functions pad it, to Tp = a multiple of
8: the padded rows are modulated (LayerNorm of a zero row is 0, so they
hold ``shift``) and projected, and as keys they carry the -1e30 bias.
Outputs keep the first T rows.

Weights come from the script's four input-major (E, E) matrices through
:func:`sa_weights_from_jax`: the merged (3E, E) ``w_qkv`` and (E, E) ``w_o``
in torch layout, f32 biases (as the JAX functions pass them), and for the
int8 forms the port's :func:`~.quant.quantize_weight` of each (bitwise the
JAX package's per output channel).

Each function has a plain twin built from the port's plain versions
(``adaln_modulate_plain``, ``linear_plain``, ``fused_attention_plain``,
``quant_rows_plain``, ``linear_q8_plain``) and, for the int8 attention of
:func:`sa_int8x`, :func:`int8_attention_plain`.  A CPU tensor (any tensor
inside ``ops.plain_versions()``) takes the plain twin; a CUDA tensor
launches the kernel or raises.  The softmax of the kernels takes its exp
with one ``ex2.approx`` in f32 where the JAX kernels take it in bf16 for
bf16 inputs (see ``ops/attention.py``), and their modulation rounds once to
bf16 where the JAX kernels round twice; the CPU tests compare in f32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Optional

import torch

from . import _lib
from .adaln import MAX_E, adaln_modulate_plain, adaln_modulate_q8_plain
from .attention import fused_attention_plain, key_bias
from .linear import H100_SMS, linear_plain, sm_count
from .linear_q8 import linear_q8_plain
from .quant import quant_rows_plain, quantize_weight

KV_PAD = 8                      # sequence padding multiple (the JAX package's KV_PAD)
HEAD_DIMS = (64, 128)           # instantiated in csrc/sa_block*.cu
E_MULTIPLE = 128                # the products' 128-column tiles
# csrc/sa_common.cuh: a block is three warpgroups; in the product phases one
# produces and two consume 128 x 128 tiles through a ring of GEMM_STAGES
# stages of 128-byte K slabs; in the attention phase all three take tiles
# of 64 query rows, with rings of ATTN_STAGES[D] stages of 32 keys.
THREADS = 384
GEMM_TILE = 128
GEMM_STAGES = 6
ATTN_WARPGROUPS = 3
ATTN_ROWS, ATTN_KEYS = 64, 32
ATTN_STAGES = {64: 6, 128: 3}
EPI_STRIDE = 144                # the products' epilogue staging: 64 rows of 128 + 16 bytes
SMEM_LIMIT = 232448             # 227 KB, the most an H100 block may ask for
V_KEYS = 32                     # sa_block_i8x: int8 v's key blocks (Tv, KEY_POSITION)

# Flags of the kernels' ``flags`` argument (csrc/sa_common.cuh).
F_QUANT, F_RECIP, F_HEADBATCH = 1, 2, 4
F_SKIP_LN, F_SKIP_ATTN, F_SKIP_SOFTMAX = 8, 16, 32
F_ROUND_ATTN, F_RESIDUAL, F_ZERO_ATTN = 64, 128, 256
F_STATIC, F_QPV, F_QQK = 512, 1024, 2048


def padded_len(T: int) -> int:
    return -(-max(T, KV_PAD) // KV_PAD) * KV_PAD


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SAWeights:
    """One SA block's weights in torch layout: ``w_qkv`` (3E, E), ``w_o``
    (E, E) in the compute dtype, f32 biases ``b_qkv`` (3E,) and ``b_o``
    (E,); for the int8 forms also ``w8_qkv`` / ``w8_o`` (int8) with one f32
    scale per output row, ``s_qkv`` / ``s_o``."""
    w_qkv: torch.Tensor
    b_qkv: torch.Tensor
    w_o: torch.Tensor
    b_o: torch.Tensor
    w8_qkv: Optional[torch.Tensor] = None
    s_qkv: Optional[torch.Tensor] = None
    w8_o: Optional[torch.Tensor] = None
    s_o: Optional[torch.Tensor] = None

    def to(self, device) -> "SAWeights":
        return SAWeights(**{f.name: None if getattr(self, f.name) is None
                            else getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})

    def require_int8(self, name: str) -> None:
        if self.w8_qkv is None or self.w8_o is None:
            raise ValueError(f"{name}: the int8 form needs sa_weights_from_jax(..., quant=True)")


def sa_weights_from_jax(wq, bq, wk, bk, wv, bv, wo, bo, *, quant: bool = False,
                        dtype: torch.dtype = torch.float32) -> SAWeights:
    """The script's input-major (E, E) weights and (E,) biases (numpy or
    torch) -> :class:`SAWeights`: ``w_qkv`` is ``concatenate([wq, wk, wv],
    axis=1)`` transposed, ``w_o`` is ``wo`` transposed, both cast to
    ``dtype`` (the JAX functions cast them to the compute dtype); the biases
    stay f32.  With ``quant`` also the int8 forms, quantised from the f32
    weights by :func:`~.quant.quantize_weight` (each column of the JAX
    matrix one scale, as ``quantize_weight`` of the JAX package)."""
    f32 = lambda a: torch.as_tensor(a).float()  # noqa: E731
    w_qkv = torch.cat([f32(wq), f32(wk), f32(wv)], dim=1).t().contiguous()
    w_o = f32(wo).t().contiguous()
    w = SAWeights(w_qkv.to(dtype), torch.cat([f32(bq), f32(bk), f32(bv)]), w_o.to(dtype),
                  f32(bo).clone())
    if quant:
        w.w8_qkv, w.s_qkv = quantize_weight(w_qkv)
        w.w8_o, w.s_o = quantize_weight(w_o)
    return w


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, T, E = t.shape
    return t.reshape(B, T, n_heads, E // n_heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    B, H, T, D = t.shape
    return t.transpose(1, 2).reshape(B, T, H * D)


def _pad(x: torch.Tensor, key_padding_mask: Optional[torch.Tensor]):
    """x padded with zero rows to Tp, and the (B, Tp) key mask (True =
    masked: the padded keys and the caller's)."""
    B, T, E = x.shape
    Tp = padded_len(T)
    xp = torch.cat([x, x.new_zeros(B, Tp - T, E)], dim=1) if Tp > T else x
    kpm = torch.arange(Tp, device=x.device).expand(B, Tp) >= T
    if key_padding_mask is not None:
        kpm = kpm | torch.cat([key_padding_mask.to(device=x.device, dtype=torch.bool),
                               kpm.new_ones(B, Tp - T)], dim=1)
    return xp, kpm


def _attention_plain(q, k, v, kpm, zero_attn, recip, skip_softmax, out_dtype):
    """The block's attention on (B, H, T, D) views: fused_attention_plain
    (``recip``: p times 1/denominator), or with ``skip_softmax`` p = the
    logits (biased by -1e30 at masked keys) cast to v's dtype."""
    if not skip_softmax and not recip:
        return fused_attention_plain(q, k, v, kpm, None, zero_attn, out_dtype=out_dtype)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    logits = logits + key_bias(kpm)[:, None, None, :]
    if skip_softmax:
        p = logits
    else:
        row_max = logits.amax(dim=-1, keepdim=True)
        if zero_attn:
            row_max = row_max.clamp_min(0.0)
        p = torch.exp(logits - row_max)
        denom = p.sum(dim=-1, keepdim=True)
        if zero_attn:
            denom = denom + torch.exp(-row_max)
        p = p * (1.0 / denom)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(out_dtype)


def _block_plain(x, scale, shift, w: SAWeights, key_padding_mask, *, n_heads, zero_attn, eps,
                 residual, quant, recip=False, skip_ln=False, skip_attn=False,
                 skip_softmax=False, round_attn=False):
    """The shared plain composition of sa_variant / sa_ablate / sa_headbatch."""
    B, T, E = x.shape
    cd = x.dtype
    xp, kpm = _pad(x, key_padding_mask)
    if quant:
        w.require_int8("sa_block")
        x8, xs = quant_rows_plain(xp) if skip_ln else adaln_modulate_q8_plain(xp, scale, shift,
                                                                             eps)
        qkv = linear_q8_plain(x8, xs, w.w8_qkv, w.s_qkv, w.b_qkv, dtype=cd)
    else:
        xn = xp if skip_ln else adaln_modulate_plain(xp, scale, shift, eps)
        qkv = linear_plain(xn, w.w_qkv, w.b_qkv)
    q, k, v = qkv.split(E, dim=-1)
    if skip_attn:
        a = v
    else:
        a = _merge(_attention_plain(_heads(q, n_heads), _heads(k, n_heads), _heads(v, n_heads),
                                    kpm, zero_attn, recip, skip_softmax,
                                    torch.float32 if quant else cd))
    res = xp if residual else None
    if quant:
        a8, as_ = quant_rows_plain(a.to(cd) if round_attn else a)
        y = linear_q8_plain(a8, as_, w.w8_o, w.s_o, w.b_o, dtype=cd, residual=res)
    else:
        y = linear_plain(a.to(cd), w.w_o, w.b_o, residual=res)
    return y[:, :T]


def sa_variant_plain(x, scale, shift, w: SAWeights, key_padding_mask=None, *, n_heads: int,
                     rows: int = 1, recip: bool = False, zero_attn: bool = True,
                     eps: float = 1e-6, residual: bool = True, quant: bool = False):
    """Plain version of :func:`sa_variant` (the output does not depend on
    ``rows``; ``quant`` quantises the f32 attention output, as
    ``_sa_v_kernel_q8`` does)."""
    if x.shape[0] % rows:
        raise ValueError(f"sa_variant: B={x.shape[0]} is not a multiple of rows={rows}")
    return _block_plain(x, scale, shift, w, key_padding_mask, n_heads=n_heads,
                        zero_attn=zero_attn, eps=eps, residual=residual, quant=quant,
                        recip=recip)


def sa_ablate_plain(x, scale, shift, w: SAWeights, *, n_heads: int, quant: bool = False,
                    skip_ln: bool = False, skip_attn: bool = False, skip_softmax: bool = False):
    """Plain version of :func:`sa_ablate`: ``skip_ln`` takes x for the
    modulated rows, ``skip_attn`` v for the attention output,
    ``skip_softmax`` the logits cast to the compute dtype for p; ``quant``
    quantises the attention output rounded to the compute dtype."""
    return _block_plain(x, scale, shift, w, None, n_heads=n_heads, zero_attn=True, eps=1e-6,
                        residual=True, quant=quant, skip_ln=skip_ln, skip_attn=skip_attn,
                        skip_softmax=skip_softmax, round_attn=True)


def sa_headbatch_plain(x, scale, shift, w: SAWeights, *, n_heads: int, quant: bool = False):
    """Plain version of :func:`sa_headbatch` (the heads' batched product is
    the per-head loop's arithmetic; ``quant`` as in :func:`sa_ablate`)."""
    return _block_plain(x, scale, shift, w, None, n_heads=n_heads, zero_attn=True, eps=1e-6,
                        residual=True, quant=quant, round_attn=True)


def _seq_scale(t: torch.Tensor) -> torch.Tensor:
    """One scale per sequence of a (B, T, E) tensor: max(max |t|, 1e-8) / 127."""
    amax = t.abs().amax(dim=(1, 2))
    return amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)


def _int_matmul(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """Exact integer product (float64 holds every partial sum), as f32."""
    return torch.matmul(a8.double(), b8.double()).float()


def int8_attention_probs(q, k, key_padding_mask, *, n_heads: int, qqk: bool,
                         zero_attn: bool = True, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The normalised probabilities p (B, H, Tq, Tk) f32 of
    :func:`int8_attention_plain`."""
    D = q.shape[-1] // n_heads
    scale = 1.0 / math.sqrt(D)
    if qqk:
        qs, ks = _seq_scale(q), _seq_scale(k)
        q8 = torch.round(q / qs[:, None, None]).clamp_(-127, 127)
        k8 = torch.round(k / ks[:, None, None]).clamp_(-127, 127)
        acc = _int_matmul(_heads(q8, n_heads), _heads(k8, n_heads).transpose(-1, -2))
        logits = acc * ((qs * ks) * scale)[:, None, None, None]
    else:
        qb, kb = (_heads(t.to(compute_dtype), n_heads).float() for t in (q, k))
        logits = torch.matmul(qb, kb.transpose(-1, -2)) * scale
    if key_padding_mask is not None:
        logits = logits + key_bias(key_padding_mask)[:, None, None, :]
    row_max = logits.amax(dim=-1, keepdim=True)
    if zero_attn:
        row_max = row_max.clamp_min(0.0)
    p = torch.exp(logits - row_max)
    denom = p.sum(dim=-1, keepdim=True)
    if zero_attn:
        denom = denom + torch.exp(-row_max)
    return p / denom


def int8_attention_plain(q, k, v, key_padding_mask, *, n_heads: int, qpv: bool, qqk: bool,
                         zero_attn: bool = True, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of ``sa_block_i8x``'s attention (``_sa_i8x_kernel``'s
    per-head loop, ``scripts/exp_kernels.py:692-741``) on the f32 (B, T, E)
    projections, masked keys True in ``key_padding_mask`` -> (B, Tq, E) f32.

    ``qqk``: q and k quantised with one scale per sequence (max |.| over all
    rows and heads / 127), logits = int32 q8.k8 * (qs * ks * 1/sqrt(D)),
    multiplied left to right; else the logits of q and k cast to
    ``compute_dtype``.  Softmax in f32 with the zero key, p normalised
    before the product (:func:`int8_attention_probs`).  ``qpv``: p8 =
    round(127 p), v quantised with one scale per sequence (:func:`quant_v`),
    output = int32 p8.v8 * (vs / 127); else p and v cast to
    ``compute_dtype``, f32 product."""
    p32 = int8_attention_probs(q, k, key_padding_mask, n_heads=n_heads, qqk=qqk,
                               zero_attn=zero_attn, compute_dtype=compute_dtype)
    if qpv:
        v8, vs = quant_v(v, n_heads)
        out = _int_matmul(torch.round(p32 * 127.0), v8) * (vs / 127.0)[:, None, None, None]
    else:
        out = torch.matmul(p32.to(compute_dtype).float(),
                           _heads(v.to(compute_dtype), n_heads).float())
    return _merge(out)


def quant_v(v: torch.Tensor, n_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """v (B, T, E) f32 -> (its int8 values as f32 by head (B, H, T, D), the
    per-sequence scale (B,)), as the int8 p.v of ``sa_block_i8x``."""
    vs = _seq_scale(v)
    return _heads(torch.round(v / vs[:, None, None]).clamp_(-127, 127), n_heads), vs


# The position of key r of a 32-key block in ``sa_block_i8x``'s int8 v
# (``csrc/sa_block_i8x.cu``: ``key_position``): a thread's logits at keys
# 8 c + 2 t + e fill positions 16 (c // 2) + 4 t + 2 (c % 2) + e of the s8
# wgmma A fragment, so v's keys are stored in that order.
KEY_POSITION = tuple(16 * (r >> 4) + 4 * ((r >> 1) & 3) + 2 * ((r >> 3) & 1) + (r & 1)
                     for r in range(V_KEYS))


def v_keys(Tp: int) -> int:
    """Tv: the keys of each (sequence, head, d) row of ``sa_block_i8x``'s
    int8 v, Tp rounded up to a whole 32-key block."""
    return -(-Tp // V_KEYS) * V_KEYS


def i8x_operands_plain(qkv: torch.Tensor, n_heads: int, *, qqk: bool, qpv: bool,
                       compute_dtype=torch.bfloat16):
    """Plain version of ``sa_block_i8x``'s operand pass, from the f32
    projections (B, Tp, 3E): q and k (B, Tp, E) as int8 with one scale per
    sequence (``qqk``, the values of :func:`int8_attention_probs`), else
    cast to ``compute_dtype``; v cast, or (``qpv``) :func:`quant_v`'s int8
    values laid out (B, H, D, Tv): the keys of a (sequence, head, d)
    contiguous, those of each 32-key block at :data:`KEY_POSITION`, zeros
    past Tp."""
    B, Tp, E3 = qkv.shape
    E = E3 // 3
    q, k, v = qkv.split(E, dim=-1)

    def q8(t):
        s = _seq_scale(t)
        return torch.round(t / s[:, None, None]).clamp_(-127, 127).to(torch.int8)

    qop, kop = (q8(t) if qqk else t.to(compute_dtype) for t in (q, k))
    if not qpv:
        return qop, kop, v.to(compute_dtype)
    v8, _ = quant_v(v, n_heads)
    Tv = v_keys(Tp)
    keys = v8.new_zeros(B, n_heads, E // n_heads, Tv)
    keys[..., :Tp] = v8.transpose(-1, -2)
    pos = torch.tensor([blk + p for blk in range(0, Tv, V_KEYS) for p in KEY_POSITION],
                       device=qkv.device)
    vop = torch.empty_like(keys)
    vop[..., pos] = keys
    return qop, kop, vop.to(torch.int8)


def static_scales(static_as: float) -> tuple[float, float]:
    """(1 / static_as, static_as), each as the f32 the JAX kernel multiplies
    by: the reciprocal is taken in double (Python) and then rounded."""
    import numpy as np

    return float(np.float32(1.0 / static_as)), float(np.float32(static_as))


def sa_int8x_qkv_plain(x, scale, shift, w: SAWeights, *, static_as: Optional[float] = None,
                       eps: float = 1e-6) -> torch.Tensor:
    """The f32 projections (B, Tp, 3E) of :func:`sa_int8x_plain`, padded
    rows included.  ``static_as``: the modulated rows quantised as
    round(xn * (1 / static_as)) and the product dequantised as
    acc * (w_scale * static_as); else one scale per row, as the shipped
    W8A8 block."""
    xp, _ = _pad(x, None)
    if static_as is None:
        x8, xs = adaln_modulate_q8_plain(xp, scale, shift, eps)
        return linear_q8_plain(x8, xs, w.w8_qkv, w.s_qkv, w.b_qkv, dtype=torch.float32)
    inv, sa = static_scales(static_as)
    xn = adaln_modulate_plain(xp, scale, shift, eps).float()
    x8 = torch.round(xn * torch.tensor(inv)).clamp_(-127, 127).to(torch.int8)
    ones = torch.ones(x8.shape[:-1], device=x.device)
    return linear_q8_plain(x8, ones, w.w8_qkv, w.s_qkv * torch.tensor(sa), w.b_qkv,
                           dtype=torch.float32)


def sa_int8x_plain(x, scale, shift, w: SAWeights, key_padding_mask=None, *, n_heads: int,
                   static_as: Optional[float] = None, qpv: bool = False, qqk: bool = False,
                   zero_attn: bool = True, eps: float = 1e-6, residual: bool = True):
    """Plain version of :func:`sa_int8x`.  ``static_as``: the modulated rows
    quantised as round(xn * (1 / static_as)) and the products dequantised as
    acc * (w_scale * static_as); else one scale per row, as the shipped
    W8A8 block.  q, k, v stay f32 (:func:`int8_attention_plain`); the f32
    attention output is quantised per row for the out-projection."""
    w.require_int8("sa_int8x")
    B, T, E = x.shape
    cd = x.dtype
    xp, kpm = _pad(x, key_padding_mask)
    qkv = sa_int8x_qkv_plain(x, scale, shift, w, static_as=static_as, eps=eps)
    q, k, v = qkv.split(E, dim=-1)
    a = int8_attention_plain(q, k, v, kpm, n_heads=n_heads, qpv=qpv, qqk=qqk,
                             zero_attn=zero_attn, compute_dtype=cd)
    a8, as_ = quant_rows_plain(a)
    y = linear_q8_plain(a8, as_, w.w8_o, w.s_o, w.b_o, dtype=cd, residual=xp if residual else None)
    return y[:, :T]


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _occupancy(D: int, i8x: bool) -> int:
    """Blocks of the kernel one SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    fn = _lib.library().mm_sa_block_i8x_occupancy if i8x else _lib.library().mm_sa_block_occupancy
    n = fn(D)
    if n < 0:
        raise RuntimeError(f"sa_block occupancy: CUDA error {-n}")
    return n


def sa_smem_bytes(D: int) -> int:
    """Dynamic shared memory of one block at head dim D
    (``csrc/sa_common.cuh``: ``sa_smem_bytes``, both kernels): the
    swizzle's 1024-byte alignment slack; the ring, the larger of the
    products' (GEMM_STAGES stages of a 128-row slab of each operand, 128
    bytes deep, then each consumer warpgroup's epilogue staging and column
    vectors) and the three warpgroups' attention tiles (a bf16 Q tile,
    ATTN_STAGES[D] K/V stages and the output's staging each); the
    mbarriers."""
    gemm = GEMM_STAGES * 2 * GEMM_TILE * 128 + 2 * (64 * EPI_STRIDE + 2 * GEMM_TILE * 4)
    attn = ATTN_WARPGROUPS * (ATTN_ROWS * 2 * D + ATTN_STAGES[D] * 2 * ATTN_KEYS * 2 * D
                              + ATTN_ROWS * EPI_STRIDE)
    barriers = 2 * GEMM_STAGES + ATTN_WARPGROUPS * (1 + max(ATTN_STAGES.values()))
    return 1024 + max(gemm, attn) + 8 * barriers


@functools.lru_cache(maxsize=256)
def sa_block_plan(E: int, H: int, *, i8x: bool = False, sms: int = H100_SMS,
                  occupancy=None) -> int:
    """The persistent grid, cached: as many blocks as the card holds at once
    (``occupancy(D, i8x)`` per SM, :func:`_occupancy` on the card: one
    block of THREADS threads and :func:`sa_smem_bytes`), so that every
    block reaches each grid-wide barrier; each phase walks its work over
    them (``csrc/sa_common.cuh``: ``Tiles``, ``Walk``), so the grid does not
    depend on B or T.  On an H100 (132 blocks) at T 299 (Tp 304), E 1024,
    H 8: the QKV product's 128 x 128 tiles are 19 x 24 = 456 at B 8 (3.45
    waves), 95 x 24 = 2280 at B 40 (17.3); the out-projection's 152 (1.15)
    and 760 (5.8); the attention's 64-row units, one per warpgroup (396),
    320 (0.81) and 1600 (4.04).  Raises ``RuntimeError``
    before any launch if no block fits an SM.  The launch is cooperative
    besides: a grid the card cannot hold at once is refused instead of
    letting the barrier wait for blocks that never run."""
    per_sm = (occupancy or _occupancy)(E // H, i8x)
    if per_sm < 1:
        raise RuntimeError(f"sa_block: no block of {THREADS} threads with the shared memory "
                           f"of head dim {E // H} fits an SM")
    return sms * per_sm


def _check_args(name, x, scale, shift, w: SAWeights, key_padding_mask, n_heads, quant):
    _lib.require_cuda_bf16(name, x, scale, shift)
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, T, E), got {tuple(x.shape)}")
    B, T, E = x.shape
    if E % n_heads or E // n_heads not in HEAD_DIMS or E % E_MULTIPLE or E > MAX_E:
        raise ValueError(f"{name}: E={E} with {n_heads} heads: the kernel takes head dims "
                         f"{HEAD_DIMS}, E a multiple of {E_MULTIPLE} up to {MAX_E}")
    if scale.shape != (B, E) or shift.shape != (B, E):
        raise ValueError(f"{name}: scale/shift must be {(B, E)}")
    if quant:
        _lib.require_cuda(name, (torch.int8,), w.w8_qkv, w.w8_o)
        _lib.require_cuda(name, (torch.float32,), w.s_qkv, w.s_o, w.b_qkv, w.b_o)
        mats = ((w.w8_qkv, (3 * E, E)), (w.w8_o, (E, E)), (w.s_qkv, (3 * E,)), (w.s_o, (E,)))
    else:
        _lib.require_cuda_bf16(name, w.w_qkv, w.w_o)
        _lib.require_cuda(name, (torch.float32,), w.b_qkv, w.b_o)
        mats = ((w.w_qkv, (3 * E, E)), (w.w_o, (E, E)))
    for t, shape in mats + ((w.b_qkv, (3 * E,)), (w.b_o, (E,))):
        if tuple(t.shape) != shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: weight {tuple(t.shape)} must be a contiguous, "
                             f"16-byte aligned {shape}")
    if x.device != w.b_o.device:
        raise ValueError(f"{name}: x on {x.device}, weights on {w.b_o.device}")
    x = x if x.is_contiguous() and x.data_ptr() % 16 == 0 else x.contiguous()
    mods = []
    for t in (scale, shift):
        if t.stride(1) != 1 or t.data_ptr() % 16 or (t.stride(0) * 2) % 16:
            t = t.contiguous()
        mods.append(t)
    kpm = None
    if key_padding_mask is not None:
        if key_padding_mask.shape != (B, T) or key_padding_mask.dtype != torch.bool:
            raise ValueError(f"{name}: key_padding_mask must be a {(B, T)} bool tensor")
        kpm = key_padding_mask.to(x.device).contiguous()
    return x, mods[0], mods[1], kpm


STAMPS = 8  # csrc/sa_common.cuh kStamps
_stamp_log: Optional[list] = None


def phase_names(flags: int, i8x: bool) -> tuple:
    """The phases of one launch in order, one per grid barrier and the last
    (``csrc/sa_block*.cu``): LayerNorm, the QKV product, (``sa_block_i8x``
    with int8 q.k^T or p.v) the attention's int8 operands, attention, the
    per-row quantisation of the attention output (int8 forms), the
    out-projection."""
    operands = i8x and flags & (F_QQK | F_QPV)
    return ("ln", "qkv") + (("operands",) if operands else ()) + ("attention",) \
        + (("quant_attn",) if i8x or flags & F_QUANT else ()) + ("out",)


@contextlib.contextmanager
def phase_stamps():
    """A reading of the phases' device time: inside the block each launch
    of ``sa_block`` / ``sa_block_i8x`` passes a buffer that its block 0
    stamps with ``%globaltimer`` at the start and after each grid barrier
    (the last slot: the latest block's end), and the yielded list gets one
    ``(phase names, buffer)`` per launch; :func:`phase_ns` reads one.
    Outside the block the kernels get a null pointer, so timed runs carry
    no stamp."""
    global _stamp_log
    prev, _stamp_log = _stamp_log, []
    try:
        yield _stamp_log
    finally:
        _stamp_log = prev


def phase_ns(entry) -> dict:
    """One ``(names, buffer)`` of :func:`phase_stamps` -> ns per phase
    (after a synchronisation)."""
    names, buf = entry
    t = [int(v) for v in buf.tolist()]
    ends = t[1:len(names)] + [t[STAMPS - 1]]
    return {n: e - s for n, s, e in zip(names, t[:len(names)], ends)}


def scratch_layout(B: int, Tp: int, E: int, flags: int, i8x: bool, e2: int):
    """The scratch of the phases, one allocation carved at 256-byte offsets:
    xn, xs, qkv, attn, a8, as, ramax, and ``sa_block_i8x``'s amax and
    attention operands q, k, v (``e2`` the bytes of an activation) ->
    (offsets, None where the form has none; sizes in bytes; total)."""
    M = B * Tp
    quant = bool(flags & F_QUANT)
    op = M * E * e2 if i8x else 0
    qkv, vop = M * 3 * E * (4 if i8x else e2), max(op, B * E * v_keys(Tp)) if i8x else 0
    qop = kop = op
    if i8x and not flags & (F_QQK | F_QPV):
        # sa_block_i8x without int8 operands: no f32 projection, the bf16
        # one packed (M, 3E) in qop
        qkv, qop, kop, vop = 0, 3 * op, 0, 0
    sizes = (M * E * (1 if quant else e2), 4 * M if quant else 0, qkv,
             M * E * (4 if quant else e2), M * E if quant else 0, 4 * M if quant else 0,
             4 * M if quant else 0, 12 * B if i8x else 0, qop, kop, vop)
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total if n else None)
        total += -(-n // 256) * 256
    return offsets, sizes, total


def _launch(name, x, scale, shift, w: SAWeights, kpm, *, n_heads, rows, flags, eps,
            i8x=False, inv_static=0.0, static_as=0.0, intermediates=None):
    B, T, E = x.shape
    D = E // n_heads
    Tp = padded_len(T)
    quant = bool(flags & F_QUANT)
    grid = sa_block_plan(E, n_heads, i8x=i8x, sms=sm_count(x))
    out = torch.empty((B, T, E), dtype=x.dtype, device=x.device)
    offsets, _, total = scratch_layout(B, Tp, E, flags, i8x, x.element_size())
    ws = torch.empty((total,), dtype=torch.uint8, device=x.device)
    scratch = [None if o is None else ws.data_ptr() + o for o in offsets]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    common = (ptr(x), ptr(scale), scale.stride(0), ptr(shift), shift.stride(0),
              ptr(w.w8_qkv if quant else w.w_qkv), ptr(w.b_qkv), ptr(w.s_qkv if quant else None),
              ptr(w.w8_o if quant else w.w_o), ptr(w.b_o), ptr(w.s_o if quant else None),
              ptr(kpm), ptr(out), *scratch[:7])
    lib = _lib.library()
    scale_ = 1.0 / math.sqrt(D)
    stamps = None
    if _stamp_log is not None:
        stamps = torch.zeros((STAMPS,), dtype=torch.int64, device=x.device)
        _stamp_log.append((phase_names(flags, i8x), stamps))
    if i8x:
        rc = lib.mm_sa_block_i8x(*common, *scratch[7:], B, T, Tp, E, n_heads, flags, scale_,
                                 float(eps), inv_static, static_as, ptr(stamps), grid,
                                 _lib.stream_handle(x))
    else:
        rc = lib.mm_sa_block(*common, B, T, Tp, E, n_heads, rows, flags, scale_, float(eps),
                             ptr(stamps), grid, _lib.stream_handle(x))
    _lib.check_launch(name, rc, shape=(B, T, E, n_heads, flags, rows))
    if intermediates is not None:
        intermediates.update(_operands(ws, offsets, B, Tp, E, n_heads, flags, x.dtype))
    return out


def _operands(ws, offsets, B, Tp, E, H, flags, dtype) -> dict:
    """What ``sa_block_i8x``'s launch left in its scratch ``ws`` for the
    attention: ``q``, ``k``, ``v`` (B, Tp, E) as the QKV product's epilogue
    wrote them (f32 where their int8 form is taken from them, q and k with
    ``F_QQK``, v with ``F_QPV``; else the bf16 operands), the int8
    operands of the operand pass (``q8``, ``k8`` (B, Tp, E) with ``F_QQK``;
    ``v8`` (B, H, D, Tv) with ``F_QPV``, :func:`i8x_operands_plain`'s
    layout), and the f32 attention rows ``attn`` (B, Tp, E)."""
    D = E // H

    def buf(i, dt, *shape):
        n = math.prod(shape) * torch.empty((), dtype=dt).element_size()
        return ws.narrow(0, offsets[i], n).view(dt).view(*shape)

    qqk, qpv = bool(flags & F_QQK), bool(flags & F_QPV)
    out = {"attn": buf(3, torch.float32, B, Tp, E)}
    if not qqk and not qpv:
        out["q"], out["k"], out["v"] = buf(8, dtype, B, Tp, 3 * E).split(E, dim=-1)
        return out
    f32 = buf(2, torch.float32, B, Tp, 3 * E).split(E, dim=-1)
    for j, (name, exact) in enumerate((("q", qqk), ("k", qqk), ("v", qpv))):
        out[name] = f32[j] if exact else buf(8 + j, dtype, B, Tp, E)
    if qqk:
        out["q8"], out["k8"] = (buf(8 + j, torch.int8, B, Tp, E) for j in (0, 1))
    if qpv:
        out["v8"] = buf(10, torch.int8, B, H, D, v_keys(Tp))
    return out


def sa_variant(x, scale, shift, w: SAWeights, key_padding_mask=None, *, n_heads: int,
               rows: int = 1, recip: bool = False, zero_attn: bool = True, eps: float = 1e-6,
               residual: bool = True, quant: bool = False) -> torch.Tensor:
    """``[x +] out_proj(MHA(AdaLN(x)))``: x (B, T, E), scale/shift (B, E),
    key_padding_mask (B, T) bool (True = masked), weights from
    :func:`sa_weights_from_jax` (``quant``: its int8 form).  ``rows``
    sequences per attention work unit (B % rows == 0; the output does not
    depend on it); ``recip`` multiplies by 1/denominator once per row.

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`sa_variant_plain`; a CUDA tensor launches ``sa_block`` or raises.
    """
    if _lib.use_plain(x):
        return sa_variant_plain(x, scale, shift, w, key_padding_mask, n_heads=n_heads, rows=rows,
                                recip=recip, zero_attn=zero_attn, eps=eps, residual=residual,
                                quant=quant)
    if rows < 1 or x.shape[0] % rows:
        raise ValueError(f"sa_variant: B={x.shape[0]} is not a multiple of rows={rows}")
    x, scale, shift, kpm = _check_args("sa_variant", x, scale, shift, w, key_padding_mask,
                                       n_heads, quant)
    flags = ((F_QUANT if quant else 0) | (F_RECIP if recip else 0)
             | (F_RESIDUAL if residual else 0) | (F_ZERO_ATTN if zero_attn else 0))
    return _launch("sa_block", x, scale, shift, w, kpm, n_heads=n_heads, rows=rows, flags=flags,
                   eps=eps)


def sa_ablate(x, scale, shift, w: SAWeights, *, n_heads: int, quant: bool = False,
              skip_ln: bool = False, skip_attn: bool = False,
              skip_softmax: bool = False) -> torch.Tensor:
    """The block with pieces switched off (different math, for timing):
    ``skip_ln`` (xn = x), ``skip_attn`` (the attention output is v),
    ``skip_softmax`` (p = the logits cast to bf16; padded keys carry -1e30).

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`sa_ablate_plain`; a CUDA tensor launches ``sa_block`` or raises.
    """
    if _lib.use_plain(x):
        return sa_ablate_plain(x, scale, shift, w, n_heads=n_heads, quant=quant, skip_ln=skip_ln,
                               skip_attn=skip_attn, skip_softmax=skip_softmax)
    x, scale, shift, _ = _check_args("sa_ablate", x, scale, shift, w, None, n_heads, quant)
    flags = ((F_QUANT | F_ROUND_ATTN if quant else 0) | F_RESIDUAL | F_ZERO_ATTN
             | (F_SKIP_LN if skip_ln else 0) | (F_SKIP_ATTN if skip_attn else 0)
             | (F_SKIP_SOFTMAX if skip_softmax else 0))
    return _launch("sa_block", x, scale, shift, w, None, n_heads=n_heads, rows=1, flags=flags,
                   eps=1e-6)


def sa_headbatch(x, scale, shift, w: SAWeights, *, n_heads: int,
                 quant: bool = False) -> torch.Tensor:
    """The block with the attention phase scheduled one work unit per
    (sequence, query tile), walking all heads (the JAX kernel's batched
    product over a head axis).

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`sa_headbatch_plain`; a CUDA tensor launches ``sa_block`` or
    raises.
    """
    if _lib.use_plain(x):
        return sa_headbatch_plain(x, scale, shift, w, n_heads=n_heads, quant=quant)
    x, scale, shift, _ = _check_args("sa_headbatch", x, scale, shift, w, None, n_heads, quant)
    flags = (F_QUANT | F_ROUND_ATTN if quant else 0) | F_RESIDUAL | F_ZERO_ATTN | F_HEADBATCH
    return _launch("sa_block", x, scale, shift, w, None, n_heads=n_heads, rows=1, flags=flags,
                   eps=1e-6)


def sa_int8x(x, scale, shift, w: SAWeights, key_padding_mask=None, *, n_heads: int,
             static_as: Optional[float] = None, qpv: bool = False, qqk: bool = False,
             zero_attn: bool = True, eps: float = 1e-6, residual: bool = True,
             intermediates: Optional[dict] = None) -> torch.Tensor:
    """The W8A8 block with the int8 levers (:func:`sa_int8x_plain`):
    ``static_as`` a calibrated activation scale for the QKV product,
    ``qpv`` int8 p.v, ``qqk`` int8 q.k^T.  ``intermediates``, a dict, gets
    what the launch wrote for its attention (the card only; the launch is
    the one without it): q, k, v, their int8 forms and the attention rows
    (:func:`_operands`), so that a check can hold the operand pass against
    :func:`i8x_operands_plain` and the attention alone against
    :func:`int8_attention_plain` on the same q, k, v.

    A CPU tensor (any tensor inside ``ops.plain_versions()``) takes
    :func:`sa_int8x_plain`; a CUDA tensor launches ``sa_block_i8x`` or
    raises.
    """
    if _lib.use_plain(x):
        return sa_int8x_plain(x, scale, shift, w, key_padding_mask, n_heads=n_heads,
                              static_as=static_as, qpv=qpv, qqk=qqk, zero_attn=zero_attn,
                              eps=eps, residual=residual)
    w.require_int8("sa_int8x")
    x, scale, shift, kpm = _check_args("sa_int8x", x, scale, shift, w, key_padding_mask,
                                       n_heads, True)
    flags = (F_QUANT | (F_RESIDUAL if residual else 0) | (F_ZERO_ATTN if zero_attn else 0)
             | (F_STATIC if static_as is not None else 0) | (F_QPV if qpv else 0)
             | (F_QQK if qqk else 0))
    inv, sa = static_scales(static_as) if static_as is not None else (0.0, 0.0)
    return _launch("sa_block_i8x", x, scale, shift, w, kpm, n_heads=n_heads, rows=1,
                   flags=flags, eps=eps, i8x=True, inv_static=inv, static_as=sa,
                   intermediates=intermediates)
