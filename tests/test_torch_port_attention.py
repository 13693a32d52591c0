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

import numpy as np
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
    # The f32 forward's two routes.  Warp-per-row: whole 128-key chunks of K
    # and V, 8 query rows.  Tiled: 64 query rows of 4 warps, a ring of two
    # 16-key stages (hi parts) and one stage's lo parts, rows of D + 4.
    assert int(_constexpr(src, "kF32Chunk")) == attn.F32_ROWS_CHUNK == 128
    assert int(_constexpr(src, "kF32Rows")) == attn.F32_ROWS_PER_BLOCK == 8
    assert "((2 * kc + kF32Rows) * (d + 4) + kF32Rows * kc) * 4" in src
    assert attn.attention_f32_rows_smem(128, 301) == ((2 * 128 + 8) * (128 + 4) + 8 * 128) * 4
    assert int(_constexpr(src, "kTcRows")) == attn.F32_TC_ROWS == 64
    assert int(_constexpr(src, "kTcThreads")) == 128
    assert int(_constexpr(src, "kTcKeys")) == attn.F32_TC_KEYS == 16
    assert int(_constexpr(src, "kTcStages")) == attn.F32_TC_STAGES == 2
    assert "((kTcRows + (2 * kTcStages + 2) * kTcKeys) * (d + 4) + kTcKeys) * 4" in src
    assert attn.attention_f32_tc_smem(128) == ((64 + 6 * 16) * 132 + 16) * 4 == 84544
    # The route flag the launcher reads (an argument of its own), a launch
    # case and a shared-memory limit set at load for every head dim.
    assert "int in_f32, int out_f32, int f32_tiled, int nwg" in src
    assert "if (f32_tiled == 1) switch (D)" in src
    for line in ("case 64: return launch_f32_tc<64>(p, s);",
                 "case 96: return launch_f32_tc<96>(p, s);",
                 "default: return launch_f32_tc<128>(p, s);"):
        assert line in src
    for d in (64, 96, 128):
        assert f"attention_f32_tc_kernel<{d}>, attr, f32_tc_smem_bytes({d})" in src
    # The backward: 64-row tiles, bf16 rows of D + 8 (six tiles and the
    # statistics); f32 rows of D + 4: four tiles and the statistics (the
    # kernel that streams whole tiles), or two resident tiles, a ring of two
    # stages of two split sub-tiles (16 rows to D = 96, 8 at 128), the
    # current sub-tile's lo parts and each stage's statistics (tiled).
    bwd = _src("attention_bwd.cu")
    assert "return 6 * mma_tile_elems(d) * 2 + 2 * 3 * BT * 4;" in bwd
    assert "return (4 * f32_tile_floats(d) + 3 * BT) * 4;" in bwd
    assert "return ((2 * BT + 6 * tc_rows(d)) * (d + 4) + 6 * tc_rows(d)) * 4;" in bwd
    assert "constexpr int tc_rows(int d) { return d <= 96 ? 16 : 8; }" in bwd
    assert int(_constexpr(bwd, "BT")) == 64 == attn.F32_TC_ROWS
    assert "if (f32 && route == 1)" in bwd and "attn_bwd_f32_tc_kernel<D>, a, tc_smem(D)" in bwd
    for d in (64, 96, 128):
        r = 16 if d <= 96 else 8
        assert attn.attention_bwd_tc_rows(d) == r
        assert attn.attention_bwd_tc_smem(d) == ((2 * 64 + 6 * r) * (d + 4) + 6 * r) * 4
        assert attn.attention_bwd_rows_smem(d) == (4 * 64 * (d + 4) + 3 * 64) * 4
        assert 6 * 64 * (d + 8) * 2 + 2 * 3 * 64 * 4 <= SMEM_227K
        assert attn.attention_bwd_rows_smem(d) <= SMEM_227K
        # The tiled backward: two blocks to an SM at every head dim.
        assert attn.blocks_per_sm(attn.attention_bwd_tc_smem(d)) >= 2
    assert attn.attention_bwd_tc_smem(128) == 93120
    assert 2 * (4 * 64 * (96 + 4) + 3 * 64) * 4 <= 228 * 1024
    # One block to an SM for the other f32 backward kernel at D 128.
    assert attn.blocks_per_sm(attn.attention_bwd_rows_smem(128)) == 1
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


# (B, H, Tq, Tk, D) of every f32 attention launch on the port's paths: the
# post-encoder heads (sampling at B 2, serve at B 10, the base models' CFG
# batches up to 16 prompts, training at B 4 and 8) and the f32 CLIP tower;
# the InterCLIP towers in evaluation (InterHuman B 96, HumanML3D persons
# B 64) and in train-evaluator (B 32).
F32_HEAD_SHAPES = [(2, 8, 77, 77, 96), (2, 12, 77, 77, 64), (4, 8, 77, 77, 96),
                   (8, 8, 77, 77, 96), (10, 8, 77, 77, 96), (16, 8, 77, 77, 96)]
F32_TOWER_SHAPES = [(96, 8, 301, 301, 128), (96, 8, 77, 77, 96), (64, 8, 301, 301, 128),
                    (64, 8, 77, 77, 96), (32, 8, 301, 301, 128), (32, 8, 77, 77, 96)]


@pytest.mark.parametrize("B,H,Tq,Tk,D", F32_HEAD_SHAPES + F32_TOWER_SHAPES,
                         ids=[f"B{b}-H{h}-T{tq}-D{d}" for b, h, tq, _, d in
                              F32_HEAD_SHAPES + F32_TOWER_SHAPES])
def test_f32_plan_at_main_path_shapes(B, H, Tq, Tk, D):
    """The f32 forward's and backward's plans: the tiled routes from the
    measured crossover of 128 query tiles of 64 rows on (the towers, and the
    heads' shape from B 8), the warp-per-row kernels below it (the heads at
    B 2 and 4, the CLIP tower); the towers with at least 8 warps resident
    on an SM, every block within 227 KB.  The heads' arithmetic is kept by
    their pin, not by the plan (test_generators_text_encoders_pin_the_rows_route)."""
    fwd = attn.attention_f32_plan(B, H, Tq, Tk, D)
    bwd = attn.attention_bwd_f32_plan(B, H, Tq, Tk, D)
    tower = (B, H, Tq, Tk, D) in F32_TOWER_SHAPES
    tiles = B * H * -(-Tq // 64)
    assert attn.F32_TILED_MIN_TILES == 128
    assert fwd.route == bwd.route == ("tiled" if tiles >= 128 else "rows")
    assert fwd.route == "tiled" or not tower
    assert fwd.smem <= SMEM_227K and bwd.smem <= SMEM_227K
    assert bwd.grid == (-(-Tq // 64) + -(-Tk // 64), H, B) and bwd.threads == 128
    if fwd.route == "tiled":
        assert fwd.grid == (-(-Tq // 64), H, B) and fwd.threads == 128
        assert fwd.warps_per_sm >= 8 and bwd.warps_per_sm >= 8
    else:
        assert fwd.grid == (-(-Tq // 8), H, B) and fwd.threads == 256
    # Either route can be forced (phase 3 times the two side by side).
    for route in attn.F32_ROUTES:
        assert attn.attention_f32_plan(B, H, Tq, Tk, D, route).route == route
        assert attn.attention_bwd_f32_plan(B, H, Tq, Tk, D, route).route == route
    with pytest.raises(ValueError):
        attn.attention_f32_plan(B, H, Tq, Tk, D, "wgmma")


def _skipped_tiles(kpm, zero_attn, tile):
    """The tiled kernels' rule (csrc/attention.cu, attention_bwd.cu) on the
    host: for each batch, the key tiles of ``tile`` keys passed over, those
    whose keys are all masked, where the row max is finite: the zero key is
    on or the batch has an unmasked key."""
    B, Tk = kpm.shape
    out = []
    for b in range(B):
        row = kpm[b]
        ok = zero_attn or bool((~row).any())
        out.append([j for j in range(-(-Tk // tile)) if ok and bool(row[j * tile:(j + 1) * tile].all())])
    return out


def _mask(B, T, kind, gen):
    kpm = torch.zeros(B, T, dtype=torch.bool)
    lens = torch.randint(3, T - 5, (B,), generator=gen)
    if kind in ("tail", "all one"):
        kpm = torch.arange(T)[None, :] > lens[:, None]
    if kind == "middle":
        kpm[:, 17:58] = True
        kpm[1, 60:] = True
    if kind == "all one":
        kpm[1] = True
    return kpm


@pytest.mark.parametrize("kind,zero_attn", [("tail", False), ("tail", True), ("middle", False),
                                            ("middle", True), ("all one", False),
                                            ("all one", True)])
def test_tile_skip_rule_is_exact(kind, zero_attn):
    """Passing over the key tiles the rule names changes nothing: there p =
    exp(logit - max) / den is exactly 0 in the plain version in f32 (so dk
    and dv are 0 there), and the plain arithmetic with those keys removed
    equals the plain version on every key within 1e-7 relative (max |diff|
    / max |plain| of the output, the statistics, dq, dk, dv).  The plain
    versions run in float64 for that comparison (``Tensor.float`` widened
    to double), so that what it measures is the rule and not f32 sums over
    rows of two lengths.  A batch whose keys are all masked, without the
    zero key, is never passed over: there the reference spreads p evenly
    over the masked keys."""
    gen = torch.Generator().manual_seed(7)
    B, H, T, D = 3, 2, 75, 16
    q, k, v, g = (torch.randn(B, H, T, D, generator=gen) for _ in range(4))
    kpm = _mask(B, T, kind, gen)
    stats32 = attn.attention_stats_plain(q, k, kpm, None, zero_attn)
    logits = torch.matmul(q, k.transpose(-1, -2)) / D ** 0.5
    logits = logits + attn.key_bias(kpm)[:, None, None, :]
    p_full = torch.exp(logits - stats32[0][..., None]) / stats32[1][..., None]
    q, k, v, g = (t.double() for t in (q, k, v, g))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "float", torch.Tensor.double)
        full = attn.fused_attention_plain(q, k, v, kpm, None, zero_attn)
        stats = attn.attention_stats_plain(q, k, kpm, None, zero_attn)
        dq, dk, dv = attn.attention_bwd_plain(q, k, v, kpm, g, zero_attn, stats, full)
        _compare_skipped(q, k, v, g, kpm, zero_attn, kind, full, stats, (dq, dk, dv), p_full)
    if kind == "all one" and not zero_attn:
        # What passing over them would do: no key left, p = 0, not 1 / Tk.
        assert full[1].abs().max() > 0 and stats[1, 1].eq(T).all()


def _compare_skipped(q, k, v, g, kpm, zero_attn, kind, full, stats, grads, p_full):
    B, _, T, _ = q.shape
    dq, dk, dv = grads
    for tile in (attn.F32_TC_KEYS, attn.attention_bwd_tc_rows(128), attn.F32_TC_ROWS):
        skipped = _skipped_tiles(kpm, zero_attn, tile)
        if kind == "all one" and not zero_attn:
            assert skipped[1] == []
        if kind != "tail" or zero_attn:
            assert any(skipped), (kind, zero_attn, tile)
        for b in range(B):
            keep = torch.ones(T, dtype=torch.bool)
            for j in skipped[b]:
                keep[j * tile:(j + 1) * tile] = False
            sl = slice(b, b + 1)
            if not keep.any():  # only the zero key left: what the kernels write
                assert full[sl].abs().max().item() == 0.0 and dq[sl].abs().max().item() == 0.0
                assert stats[0, sl].eq(0).all() and stats[1, sl].eq(1).all()
            qb, gb = q[sl], g[sl]
            kb, vb, mb = k[b:b + 1][..., keep, :], v[b:b + 1][..., keep, :], kpm[b:b + 1, keep]
            if not keep.any():
                continue
            out = attn.fused_attention_plain(qb, kb, vb, mb, None, zero_attn)
            st = attn.attention_stats_plain(qb, kb, mb, None, zero_attn)
            gq, gk, gv = attn.attention_bwd_plain(qb, kb, vb, mb, gb, zero_attn, st, out)
            for got, want in ((out, full[sl]), (st[0], stats[0, sl]),
                              (st[1], stats[1, sl]), (gq, dq[sl]),
                              (gk, dk[b:b + 1][..., keep, :]), (gv, dv[b:b + 1][..., keep, :])):
                assert _rel(got, want) <= 1e-7, (kind, zero_attn, tile, b)
            if (~keep).any():  # p = 0 there: dk = dv = 0 exactly
                p = p_full[b][..., ~keep]
                assert p.abs().max().item() == 0.0
                assert dk[b][..., ~keep, :].abs().max().item() == 0.0
                assert dv[b][..., ~keep, :].abs().max().item() == 0.0


def _rel(got, want):
    """max |got - want| / max |want| (0 for two zero tensors)."""
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / scale if scale else (got - want).abs().max().item()


def _tf32_rna(x):
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, to nearest,
    ties away from zero."""
    u = x.astype(np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_three_tf32_passes_are_as_close_as_f32_fma():
    """The tiled kernels' products (csrc/tf32.cuh) in numpy at D 128: x =
    hi + lo, both cvt.rna TF32; each mma.sync adds an 8-term sum of exact
    TF32 products (lo.hi, then hi.lo, then hi.hi) to an f32 accumulator.
    Against float64, its error is within that of an f32 FMA chain (the
    warp-per-row route's products) at D 128; one TF32 pass is ~1000 times
    farther, which is why the f32 path cannot take it (F32_TOL 1e-5)."""
    rng = np.random.default_rng(0)
    n, D = 2048, 128
    a = rng.standard_normal((n, D)).astype(np.float32)
    b = rng.standard_normal((n, D)).astype(np.float32)
    exact = (a.astype(np.float64) * b).sum(1)
    scale = np.abs(a.astype(np.float64) * b).sum(1)

    def split(x):
        hi = _tf32_rna(x)
        return hi, _tf32_rna(x - hi)

    (ah, al), (bh, bl) = split(a), split(b)
    fma = np.zeros(n, np.float32)
    for d in range(D):  # one rounding a term (an FMA: the product exact)
        fma = (fma + a[:, d].astype(np.float64) * b[:, d]).astype(np.float32)
    three, one = np.zeros(n, np.float32), np.zeros(n, np.float32)
    for k0 in range(0, D, 8):
        blk = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            three = (three + (x[:, blk].astype(np.float64) * y[:, blk]).sum(1)).astype(np.float32)
        one = (one + (ah[:, blk].astype(np.float64) * bh[:, blk]).sum(1)).astype(np.float32)
    err = {name: np.abs(v - exact) / scale for name, v in
           (("fma", fma), ("3xtf32", three), ("1xtf32", one))}
    assert err["3xtf32"].max() <= err["fma"].max() and err["3xtf32"].max() < 2.0 ** -22
    assert err["3xtf32"].mean() <= 1.1 * err["fma"].mean()
    assert err["1xtf32"].max() > 500 * err["3xtf32"].max()
    # The split is exact in f32 and each part fits 11 significant bits.
    assert np.array_equal(ah.astype(np.float64) + al, ah + al)
    for part in (ah, al):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()



def test_generators_text_encoders_pin_the_rows_route():
    """The text encoders that condition the sampling, training and
    base-model paths (the CLIP tower's blocks, the post-encoder heads) keep
    the warp-per-row f32 kernel at every batch; the InterCLIP towers take
    the plan's route (the tiled one at their shapes)."""
    from mixermdm_tpu_torch.eval.interclip import build_interclip
    from mixermdm_tpu_torch.models.clip_text import ClipResBlock
    from mixermdm_tpu_torch.models.layers import TorchMultiheadAttention
    from mixermdm_tpu_torch.models.torch_compat import ClipPostEncoder

    assert TorchMultiheadAttention.f32_route is None
    assert ClipResBlock(64, 2).attn.f32_route == "rows"
    post = ClipPostEncoder(d_model=64, num_layers=2, dim_feedforward=64, nhead=2)
    assert [layer.self_attn.f32_route for layer in post.encoder.layers] == ["rows", "rows"]
    clip = build_interclip("interaction", tiny=True, device="cpu", seed=0)
    routes = {m.f32_route for m in clip.modules() if isinstance(m, TorchMultiheadAttention)}
    assert routes == {None}
