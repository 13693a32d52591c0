"""The host side of the port's attention kernels (``attention`` with its
TMA + ``wgmma`` forward, ``attention_bwd``): the forward's launch plan at
every main-path shape, the views the fused blocks hand it, and the plan's
agreement with the constants of ``csrc/attention.cu`` and
``csrc/attention_bwd.cu``.

Nothing here needs a card or a compiler: a plan the card would refuse (too
much shared memory, a view TMA cannot describe) would otherwise show only on
the card, where ``chip_smoke.py`` runs the kernels at these shapes.
"""

import os
import re

import pytest
import torch

from mixermdm_tpu_torch.ops import _lib
from mixermdm_tpu_torch.ops import attention as attn

H100_SMS = 132
SMEM_227K = 227 * 1024

# (B, H, Tq, Tk, D): the denoisers (8 sequences of 299 frames, 8 heads of
# 128) and the mixer (8 of 64) per DDIM step; the CLIP tower (2 prompts x 77
# tokens, 12 heads of 64); the discriminators in training (8 x 300, 4 heads
# of 64); the smoke test's key-padding shapes.
MAIN_PATH_SHAPES = [(8, 8, 299, 299, 128), (8, 8, 299, 299, 64), (2, 12, 77, 77, 64),
                    (8, 4, 300, 300, 64), (4, 8, 131, 299, 128), (4, 8, 131, 131, 96)]


def _src(name):
    with open(os.path.join(_lib.CSRC_DIR, name)) as f:
        return f.read()


def _constexpr(text, name):
    """The value of ``name`` in a ``constexpr int a = ..., name = ...;``."""
    m = re.search(rf"constexpr int (?:[^;]*, )?{name} = ([^;,]+)[;,]", text)
    assert m, name
    return m.group(1).strip()


@pytest.mark.parametrize("B,H,Tq,Tk,D", MAIN_PATH_SHAPES,
                         ids=[f"B{b}-H{h}-T{tq}x{tk}-D{d}" for b, h, tq, tk, d in MAIN_PATH_SHAPES])
def test_main_path_shape_plan(B, H, Tq, Tk, D):
    plan = attn.attention_plan(B, H, Tq, Tk, D, H100_SMS)
    assert 1 <= plan.nwg <= attn.MAX_WARPGROUPS
    assert 1 <= plan.stages <= attn.MAX_STAGES and plan.stages <= -(-Tk // attn.ATTN_ROWS)
    # Every query row in exactly one block, no block without rows.
    rows = attn.ATTN_ROWS * plan.nwg
    assert plan.grid == (-(-Tq // rows), H, B)
    assert (plan.grid[0] - 1) * rows < Tq
    dp = 64 if D <= 64 else 128
    assert plan.smem == attn.attention_smem_bytes(dp, plan.nwg, plan.stages) <= SMEM_227K
    # The card's largest block fits whatever the plan picks.
    assert attn.attention_smem_bytes(128, attn.MAX_WARPGROUPS, attn.MAX_STAGES) <= SMEM_227K


def test_plan_fills_the_card():
    """The warpgroups per block are the count whose busiest SM has the
    fewest 64-row tiles to do; at the denoiser shape that is one wave of
    2 x 8 x 8 = 128 blocks of 3 warpgroups on 132 SMs."""
    for B, H, Tq, Tk, D in MAIN_PATH_SHAPES:
        plan = attn.attention_plan(B, H, Tq, Tk, D, H100_SMS)

        def cost(nwg):
            return -(-(-(-Tq // (64 * nwg)) * B * H) // H100_SMS) * nwg

        assert cost(plan.nwg) == min(cost(n) for n in range(1, attn.MAX_WARPGROUPS + 1))
    plan = attn.attention_plan(8, 8, 299, 299, 128, H100_SMS)
    assert (plan.nwg, plan.grid) == (3, (2, 8, 8))


@pytest.mark.parametrize("E,H", [(1024, 8), (512, 8)])
def test_packed_qkv_views_are_taken(E, H):
    """The fused blocks hand the kernel Q, K and V as strided views of the
    packed (B, T, 3E) projection, and the output as a view of (B, T, E):
    TMA describes them (unit stride along D, strides multiples of 16 bytes,
    aligned data) for bf16, and so does a contiguous (B, H, T, D) tensor."""
    from mixermdm_tpu_torch.ops.fused_block import _heads

    B, T = 2, 299
    qkv = torch.empty(B, T, 3 * E, dtype=torch.bfloat16)
    out = torch.empty(B, T, E, dtype=torch.bfloat16)
    for t in (*qkv.split(E, dim=-1), out):
        assert attn.view_ok(_heads(t, H))
    assert attn.view_ok(torch.empty(B, H, T, E // H, dtype=torch.bfloat16))
    # Refused: a stride along D, a row stride of 4 elements, an offset of one
    # element (8 bytes off 16).
    assert not attn.view_ok(torch.empty(B, H, T, 128)[..., ::2])
    assert not attn.view_ok(torch.empty(B, H, 128, T).transpose(2, 3))
    assert not attn.view_ok(torch.empty(B, T, 3 * E, dtype=torch.bfloat16)[..., 4:4 + E]
                            .view(B, T, H, E // H).transpose(1, 2))


def test_plan_constants_match_the_kernel():
    """The Python plan and csrc/attention.cu describe one layout, and every
    backward kernel's shared memory fits a block."""
    src = _src("attention.cu")
    assert int(_constexpr(src, "kRows")) == attn.ATTN_ROWS
    assert _constexpr(src, "kSlabBytes") == "kRows * 128" and attn.SLAB_BYTES == 64 * 128
    assert int(_constexpr(src, "kMaxWarpgroups")) == attn.MAX_WARPGROUPS
    assert int(_constexpr(src, "kMaxStages")) == attn.MAX_STAGES
    assert ("sm90::kSmemAlign + (nwg + 2 * stages) * (dp / 64) * kSlabBytes + 8 * (1 + 2 * stages)"
            in src)
    gemm = _src("gemm_sm90.cuh")
    assert int(_constexpr(gemm, "kSmemAlign")) == attn.SMEM_ALIGN
    assert int(_constexpr(gemm, "kSmemLimit")) == attn.SMEM_LIMIT == SMEM_227K
    # Every warpgroup count has a launch case and an init of its limit.
    for nwg in range(1, attn.MAX_WARPGROUPS + 1):
        assert f"case {nwg}: return launch_bf16<DP, {nwg}>" in src
        for dp in (64, 128):
            assert f"set_fwd_smem<{dp}, {nwg}>()" in src
    # The f32 forward: whole 128-key chunks of K and V, 8 query rows.
    assert int(_constexpr(src, "kF32Chunk")) == 128 and int(_constexpr(src, "kF32Rows")) == 8
    f32_fwd = ((2 * 128 + 8) * (128 + 4) + 8 * 128) * 4
    assert "((2 * kc + kF32Rows) * (d + 4) + kF32Rows * kc) * 4" in src and f32_fwd <= SMEM_227K
    # The backward: 64-row tiles, bf16 rows of D + 8 (six tiles and the
    # statistics), f32 rows of D + 4 (four tiles and the statistics; two
    # blocks to an SM up to D = 96).
    bwd = _src("attention_bwd.cu")
    assert "return 6 * mma_tile_elems(d) * 2 + 2 * 3 * BT * 4;" in bwd
    assert "return (4 * f32_tile_floats(d) + 3 * BT) * 4;" in bwd
    assert int(_constexpr(bwd, "BT")) == 64
    for d in (64, 96, 128):
        assert 6 * 64 * (d + 8) * 2 + 2 * 3 * 64 * 4 <= SMEM_227K
        assert (4 * 64 * (d + 4) + 3 * 64) * 4 <= SMEM_227K
    assert 2 * (4 * 64 * (96 + 4) + 3 * 64) * 4 <= 228 * 1024
    # Both attention libraries set their limits when the library loads.
    assert {"mm_attention_init", "mm_attention_bwd_init"} <= set(_lib.INIT_FUNCTIONS)



def _h100_q8_clusters(D, H, nwg, stages):
    """Clusters of 8 CTAs an H100 SXM holds at once (chip_smoke.py phase 3):
    15 at one CTA to an SM, 30 where two fit (one warpgroup at D = 64)."""
    return 30 if (D == 64 and nwg == 1) else 15


@pytest.mark.parametrize("D,nwg", [(128, 2), (64, 1)])
def test_attention_q8_plan_counts_waves_of_clusters(D, nwg):
    """The W8A8 blocks' shapes (8 sequences of 299 frames, 8 heads): the
    quantising attention's plan counts waves in clusters, not SMs."""
    plan = attn.attention_q8_plan(8, 8, 299, 299, D, max_clusters=_h100_q8_clusters)
    assert plan.nwg == nwg and plan.grid == (-(-299 // (64 * nwg)), 8, 8)
    assert plan.smem == attn.attention_smem_bytes(D, plan.nwg, plan.stages) <= SMEM_227K
    assert attn.attention_q8_plan(8, 8, 299, 299, D, nwg=3,
                                  max_clusters=_h100_q8_clusters).nwg == 3


def test_attention_q8_constants_match_the_kernel():
    src = _src("attention.cu")
    assert int(_constexpr(src, "kMaxClusterHeads")) == attn.MAX_CLUSTER_HEADS
    assert "cudaLaunchAttributeClusterDimension" in src and "attr->val.clusterDim.y = p.H;" in src
    for out in ("kOutBf16", "kOutF32", "kOutQ8F32", "kOutQ8Bf16"):
        assert f"case {out}: return launch_out<DP, NWG, {out}>" in src
