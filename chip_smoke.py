#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mixermdm_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printing its wall-clock seconds:

1. the card's name and power limit (``nvidia-smi``);
2. build of the CUDA kernels from ``mixermdm_tpu_torch/csrc`` (plain nvcc);
3. each kernel and each entry point against its plain PyTorch version on
   the card, at the shapes of the sampling and training paths (bf16, W8A8,
   f32 attention, the attention backward; the three routes of
   ``linear_epilogue`` and ``linear_q8`` at every main-path shape): max
   abs/rel error and tolerance, kernel / plain / library times (CUDA-graph
   replays; for the backward, the forward that writes the row statistics
   plus the backward, against SDPA forward + backward, with the backward
   alone beside it; for ``adaln_modulate_q8``, the unfused
   ``adaln_modulate`` + ``quant_rows`` pair beside it; it is held bitwise to
   the plain quantisation of ``adaln_modulate``'s rows and, within one int8
   step, to its plain composition; ``attention_q8`` and the quantising GELU
   product ``linear_q8_gelu_q8`` likewise, bitwise to ``quant_rows`` of the
   unfused kernel's output, beside the unfused pair and with every
   warpgroup count of their plans), the eager time and
   the host's microseconds per call, and the card's bound for the same work;
3b. the one-launch SA blocks of the kernel experiments (``sa_block``:
   ``sa_variant`` rows 1 / 2 with and without the reciprocal softmax,
   ``sa_headbatch``, ``sa_ablate``'s five skip sets, bf16 and W8A8;
   ``sa_block_i8x``: ``sa_int8x``'s four lever sets) against their plain
   versions at (8, 299, 1024) and (40, 299, 1024), H 8, and at B 8 with
   keys masked; at B 8 timed beside the shipped composition and the bound;
   int8 p.v also held on the kernel's own q, k, v (the witness of its
   limit); the W8A8 blocks at shapes their fused plan refuses (16 heads;
   FFN 4096) through the unfused pair; then ``python -m
   mixermdm_tpu_torch.scripts.exp_kernels`` in each of its modes, which
   times B 40, with the launch counts of that run;
4. the sampling path at full published width (two 1024-d in2IN denoisers,
   the 512-d mixer, the ViT-L/14 text tower with its f32 post-encoder heads;
   T = 299, CFG 3.5, mixing mode 4, random weights from a seed), on the
   shipped config's W8A8 path (``QUANT_FROZEN: true``) and on the bf16 path
   of the same weights: the text conds, both denoisers and one CFG mixer step
   on the kernels against the plain versions (and against f32), the launch
   counts of one W8A8 and one bf16 step against the counts read off the
   modules;
5. for each sampling path the whole chain (DDIM-50) through
   ``MixerMDMSystem.generate_cond`` and ``sample``, with the launch counts of
   that run and the GEMM launches by (route, M, K, N, epilogue), per request
   for the text and per DDIM step for the chain;
5b. the inference surface at full width, on the three released-layout
   checkpoint files written from that system: they load back bit for bit
   into a system of another seed (int8 buffers and one W8A8 step too);
   ``infer-mixermdm`` runs in-process on them (DPM-Solver++ 25 with 5 steps
   skipped, trajectory control, a warm start, decomposed prompts), counted;
   one DPM-Solver++ step on the kernels against the plain versions; and
   ``serve`` answers in-process at B 10, T 299, DDIM-50, W8A8 (seeded
   requests reproducible and equal to a direct ``sample``, unseeded ones
   coalesced, malformed ones refused);
5c. the base-model systems at full published width (in2IN interaction,
   individual and DualMDM: 1024-d, 8 layers, 8 heads, FF 2048, ViT-L/14;
   MDM: 512-d, 8 layers, 4 heads, FF 1024, ViT-B/32; InterGen: 1024-d, 8
   layers, 8 heads, FF 2048): per family one network at the CFG batch and
   two CFG steps against the plain versions (and f32), two W8A8 steps of
   in2IN interaction; their released files written and loaded back bit for
   bit; ``infer-in2in`` (three modes, B 2, T 210, DDIM-50, the dual run with
   trajectory control and a warm start) and ``infer-mdm`` (B 2, T 196)
   in-process on them, counted, no plain version chosen; one CFG mixer step
   of ``build_mixer_system`` with MDM as MODEL1 and InterGen as MODEL2;
6. adversarial training at full width (``configs/models/MixerMDM.yaml``,
   ``configs/train/MixerMDM.yaml``, B = 8, T = 300): the gradients of one G
   and one D step on the kernels against the plain versions (and against
   f32), all three gaps printed before any is held, the training CLI
   (``cli/train_mixermdm``) for 4 fit steps on a
   synthetic InterHuman fixture with the launch counts of that run, the
   frozen networks bitwise unchanged, and seconds per fit step with the
   differentiated attention on the kernels and on the plain versions;
7. one JSON line per kernel and entry point, then the result line.

Any failure exits nonzero and prints no result line.  The script imports
nothing of JAX or of the JAX package.

``python -m mixermdm_tpu_torch.scripts.grad_seeds`` runs phase 6's
gradient check at several seeds, with a diagnosis of its gaps.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import faulthandler
import json
import math
import subprocess
import sys
import time

BUDGET_S = 1100          # hard stop, under the 1200 s limit of a run
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM at 700 W
H100_INT8_OPS = 1979e12   # dense int8 tensor-core peak
H100_F32_FLOPS = 67e12    # f32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12

PROMPTS = [
    ("two people shake hands and then hug", "a person reaches out and hugs",
     "a person raises an arm and hugs"),
    ("one person pushes the other who stumbles back",
     "a person pushes forward with both hands", "a person stumbles backwards"),
]


class SmokeFailure(RuntimeError):
    pass


def phase(name):
    print(f"== {name}", flush=True)
    return time.time()


def done(t0):
    print(f"   phase seconds: {time.time() - t0:.1f}", flush=True)


def _events_ms(run, n):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def timed(fn, reps=20, warmup=3):
    """Mean milliseconds per call of eager back-to-back calls (CUDA events):
    the device timeline, which the host's launch cost fills where a call's
    kernels are shorter than its Python and launch overhead."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return _events_ms(fn, reps)


def host_us(fn, reps=200, warmup=3):
    """Host microseconds per eager call: ``reps`` calls timed on the host's
    clock without a synchronisation in between (kernels queue on the card),
    so at the shapes where a call's kernels are short this is the Python and
    launch overhead each call adds to a host-bound eager loop."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def graph_timed(fn, reps=10, replays=5):
    """Mean device milliseconds per call: ``reps`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events, so no host
    overhead is in the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, replays) / reps


def bound_ms(n_bytes, flops, peak_flops=H100_BF16_FLOPS):
    t_bytes = n_bytes / H100_BYTES_PER_S
    t_ops = flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def kernel_checks(gen):
    """Yield one result dict per check."""
    import torch
    import torch.nn.functional as F

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.ops import _lib, attention as attn_mod

    dev = torch.device("cuda")
    bf = torch.bfloat16

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(bf)

    def compare(name, kernel, plain, tol, n_bytes, flops, library=None, kind=None,
                peak=H100_BF16_FLOPS, **shape):
        out_k = kernel()
        torch.cuda.synchronize()
        out_p = plain()
        diff = (out_k.float() - out_p.float()).abs()
        ref_scale = max(out_p.float().abs().max().item(), 1e-6)
        max_abs = diff.max().item()
        finite = bool(torch.isfinite(out_k.float()).all().item())
        ok = finite and max_abs <= tol * ref_scale
        b_ms, b_by = bound_ms(n_bytes, flops, peak)
        res = {
            "check": name, "kind": kind, "shape": shape, "max_abs_err": max_abs,
            "max_rel_err": max_abs / ref_scale, "tol_rel": tol, "ok": ok,
            "ms": graph_timed(kernel), "plain_ms": graph_timed(plain),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if library is None else graph_timed(library),
            "eager_ms": timed(kernel), "host_us": host_us(kernel),
        }
        print("   " + json.dumps(res), flush=True)
        return res

    # The least time one launch takes in a graph replay, read beside the
    # short kernels' times: a one-element add_.
    tiny = torch.zeros(1, device=dev)
    print(f"   graph-replay floor, one-element add_: {graph_timed(lambda: tiny.add_(1)):.5f} ms",
          flush=True)

    # --- attention kernel, through the fused_attention entry point ---------
    def attn_case(name, B, H, Tq, Tk, D, zero_attn, causal=False, kpm_rows=(), tol=2e-2,
                  kpm_tail=False):
        q, k, v = rnd(B, H, Tq, D), rnd(B, H, Tk, D), rnd(B, H, Tk, D)
        kpm = None
        if kpm_rows or kpm_tail:
            kpm = torch.zeros(B, Tk, dtype=torch.bool, device=dev)
            kpm[:, Tk - Tk // 5:] = True          # padded tail
            for r in kpm_rows:
                kpm[r] = True                      # fully masked key rows
        amask = torch.triu(torch.full((Tq, Tk), float("-inf"), device=dev), 1) if causal else None

        bias = torch.zeros(B, 1, Tq, Tk + int(zero_attn), device=dev, dtype=bf)
        if kpm is not None:
            bias[..., :Tk] += attn_mod.key_bias(kpm)[:, None, None, :].to(bf)
        if amask is not None:
            bias[..., :Tk] += amask.to(bf)
        kz = torch.cat([k, k.new_zeros(B, H, 1, D)], 2) if zero_attn else k
        vz = torch.cat([v, v.new_zeros(B, H, 1, D)], 2) if zero_attn else v
        flops = 4 * B * H * Tq * Tk * D
        n_bytes = 2 * (2 * B * H * Tq * D + 2 * B * H * Tk * D) + (4 * B * Tk if kpm is not None else 0) \
            + (4 * Tq * Tk if causal else 0)
        return compare(
            name, lambda: ops.fused_attention(q, k, v, kpm, amask, zero_attn),
            lambda: ops.fused_attention_plain(q, k, v, kpm, amask, zero_attn),
            tol, n_bytes, flops,
            library=lambda: F.scaled_dot_product_attention(q, kz, vz, attn_mask=bias),
            kind="attention", B=B, H=H, Tq=Tq, Tk=Tk, D=D, zero_attn=zero_attn,
            causal=causal, masked_rows=list(kpm_rows))

    results = []
    # CLIP ViT-L/14 tower: encode_cond runs it once per text field and
    # head, on the 2 prompts: (2, 12 heads of 64, 77), causal.
    results.append(attn_case("attention clip tower", 2, 12, 77, 77, 64, False, causal=True))
    # CLIP post-encoder after each tower call: 8 heads of 96.
    results.append(attn_case("attention post-encoder D=96", 2, 8, 77, 77, 96, False))
    # Denoisers (D=128) and mixer core (D=64) at T=299, zero-attn.
    results.append(attn_case("attention denoiser D=128", 8, 8, 299, 299, 128, True))
    results.append(attn_case("attention mixer D=64", 8, 8, 299, 299, 64, True))
    # Key padding with a fully masked row, with and without zero-attn;
    # Tq != Tk and a T that is a multiple of nothing.
    results.append(attn_case("attention kpm + masked row, zero-attn", 4, 8, 131, 299, 128, True,
                             kpm_rows=(1,)))
    results.append(attn_case("attention kpm + masked row, no zero-attn", 4, 8, 131, 131, 96,
                             False, kpm_rows=(2,)))

    # --- adaln_modulate ---------------------------------------------------
    # scale and shift as the blocks pass them: the two halves of the
    # modulation's (B, 2E) output.
    for B, T, E in ((8, 299, 1024), (8, 299, 512), (3, 131, 1024)):
        x = rnd(B, T, E)
        sc, sh = rnd(B, 2 * E, std=0.2).chunk(2, dim=-1)
        results.append(compare(
            f"adaln_modulate E={E} T={T}", lambda: ops.adaln_modulate(x, sc, sh),
            lambda: ops.adaln_modulate_plain(x, sc, sh), 2e-2,
            2 * (2 * B * T * E + 2 * B * E), 8 * B * T * E, kind="adaln_modulate",
            peak=H100_F32_FLOPS, B=B, T=T, E=E))

    # --- linear_epilogue, each route at its main-path shapes ---------------
    # The yardstick is one F.linear call (the product and the bias, not the
    # GELU or the residual of the epilogue), timed here and never called by
    # the port.
    from mixermdm_tpu_torch.ops.linear import gemm_plan, tma_describable

    def lin_case(name, M, K, N, act=None, res=False, tol=2e-2, ldx=None):
        # ldx: x is the view x[:, :K] of an (M, ldx) tensor.
        x = rnd(M, ldx or K)[:, :K]
        w, b = rnd(N, K, std=K ** -0.5), rnd(N, std=0.1)
        r = rnd(M, N) if res else None
        n_bytes = 2 * (M * K + N * K + N + M * N * (2 if res else 1))
        plan = gemm_plan(M, N, K, tma_ok=tma_describable(2, (x.data_ptr(), x.stride(0)),
                                                          (w.data_ptr(), w.stride(0))))
        route = {"tma": "linear_epilogue", "skinny": "linear_epilogue_skinny",
                 "ragged": "linear_epilogue_ragged"}[plan.route]
        return compare(
            name, lambda: ops.linear(x, w, b, activation=act, residual=r),
            lambda: ops.linear_plain(x, w, b, activation=act, residual=r), tol,
            n_bytes, 2 * M * N * K, library=lambda: F.linear(x, w, b), kind=route,
            M=M, K=K, N=N, activation=act, residual=res, tile=plan.bn or None,
            row_bytes=2 * x.stride(0))

    M = 8 * 299
    # The block products: denoisers (E = 1024, F = 2048) and mixer (E = 512,
    # F = 1024), at 8 sequences of 299 frames.
    results.append(lin_case("linear QKV E=1024", M, 1024, 3072))
    results.append(lin_case("linear FFN1 gelu E=1024", M, 1024, 2048, act="gelu"))
    results.append(lin_case("linear FFN2 +residual E=1024", M, 2048, 1024, res=True))
    results.append(lin_case("linear out-proj +residual E=1024", M, 1024, 1024, res=True))
    results.append(lin_case("linear QKV E=512", M, 512, 1536))
    results.append(lin_case("linear out-proj +residual E=512", M, 512, 512, res=True))
    results.append(lin_case("linear FFN1 gelu E=512", M, 512, 1024, act="gelu"))
    results.append(lin_case("linear FFN2 +residual E=512", M, 1024, 512, res=True))
    # Dense layers outside the blocks.
    results.append(lin_case("linear final N=262", M, 1024, 262))
    results.append(lin_case("linear influence head N=23", M, 512, 23))
    results.append(lin_case("linear clip c_fc", 2 * 77, 768, 3072))
    # The skinny route: the M = 8 layers (AdaLN modulations ZeroLinear(E, 2E)
    # on the (B, E) embedding, time and text embeddings).
    results.append(lin_case("linear skinny M=8 K=1024 N=2048", 8, 1024, 2048))
    results.append(lin_case("linear skinny M=8 K=512 N=1024", 8, 512, 1024))
    results.append(lin_case("linear skinny M=8 K=1024 N=1024", 8, 1024, 1024))
    # The ragged route: motion_embed, K = 262, at every main-path shape: the
    # interaction denoiser (a torch.cat of 262-wide rows, 524 bytes apart),
    # the individual denoiser (the view x[..., :262] of 524-wide rows, 1048
    # bytes apart), the mixer (N = 512), the discriminators (N = 256, T =
    # 300); an M that is no multiple of the tile (3 x 131); and rows only
    # 2-byte aligned (K = 263), which the route copies element by element.
    results.append(lin_case("linear motion_embed K=262", M, 262, 1024))
    results.append(lin_case("linear motion_embed K=262 strided x", M, 262, 1024, ldx=524))
    results.append(lin_case("linear motion_embed K=262 N=512", M, 262, 512))
    results.append(lin_case("linear motion_embed K=262 N=256", 8 * 300, 262, 256))
    results.append(lin_case("linear motion_embed K=262 M=393", 3 * 131, 262, 1024))
    results.append(lin_case("linear ragged K=263 (2-byte rows)", M, 263, 1024))

    # --- the four entry points: fused blocks ---------------------------------
    def block_params(E, F_=None):
        p = {"w_qkv": rnd(3 * E, E, std=E ** -0.5), "b_qkv": rnd(3 * E, std=0.1),
             "w_o": rnd(E, E, std=E ** -0.5), "b_o": rnd(E, std=0.1)}
        if F_:
            p.update(w1=rnd(F_, E, std=E ** -0.5), b1=rnd(F_, std=0.1),
                     w2=rnd(E, F_, std=F_ ** -0.5), b2=rnd(E, std=0.1))
        return p

    def sa_case(B, T, E, H, residual, kpm_tail=False, label=""):
        x, sc, sh = rnd(B, T, E), rnd(B, E, std=0.2), rnd(B, E, std=0.2)
        p = block_params(E)
        kpm = None
        if kpm_tail:
            kpm = torch.zeros(B, T, dtype=torch.bool, device=dev)
            kpm[:, T - T // 4:] = True
        args = (x, sc, sh, p["w_qkv"], p["b_qkv"], p["w_o"], p["b_o"], kpm)
        kw = dict(n_heads=H, residual=residual)
        n_bytes = 2 * (2 * B * T * E + 2 * B * E + 4 * E * E + 4 * E)
        flops = 2 * B * T * E * 4 * E + 4 * B * T * T * E
        return compare(f"fused_sa_block E={E} T={T} residual={residual}{label}",
                       lambda: ops.fused_sa_block(*args, **kw),
                       lambda: ops.fused_sa_block_plain(*args, **kw), 3e-2, n_bytes, flops,
                       kind="fused_sa_block", B=B, T=T, E=E, H=H, residual=residual,
                       key_padding=kpm_tail)

    def ca_case(B, T, E, H, residual, label=""):
        x, xf = rnd(B, T, E), rnd(B, T, E)
        mods = [rnd(B, E, std=0.2) for _ in range(4)]
        p = block_params(E)
        args = (x, xf, *mods, p["w_qkv"], p["b_qkv"], p["w_o"], p["b_o"], None)
        kw = dict(n_heads=H, residual=residual)
        n_bytes = 2 * (3 * B * T * E + 4 * B * E + 4 * E * E + 4 * E)
        flops = 2 * B * T * E * 4 * E + 4 * B * T * T * E
        return compare(f"fused_ca_block E={E} T={T} residual={residual}{label}",
                       lambda: ops.fused_ca_block(*args, **kw),
                       lambda: ops.fused_ca_block_plain(*args, **kw), 3e-2, n_bytes, flops,
                       kind="fused_ca_block", B=B, T=T, E=E, H=H, residual=residual)

    def ffn_case(B, T, E, F_, residual, modulate=True, label=""):
        x = rnd(B, T, E)
        sc, sh = (rnd(B, E, std=0.2), rnd(B, E, std=0.2)) if modulate else (None, None)
        p = block_params(E, F_)
        args = (x, sc, sh, p["w1"], p["b1"], p["w2"], p["b2"])
        n_bytes = 2 * (2 * B * T * E + (2 * B * E if modulate else 0) + 2 * E * F_ + F_ + E)
        return compare(f"fused_ffn_block E={E} F={F_} residual={residual} adaln={modulate}{label}",
                       lambda: ops.fused_ffn_block(*args, residual=residual),
                       lambda: ops.fused_ffn_block_plain(*args, residual=residual), 3e-2,
                       n_bytes, 4 * B * T * E * F_, kind="fused_ffn_block",
                       B=B, T=T, E=E, F=F_, residual=residual, adaln=modulate)

    results.append(sa_case(8, 299, 1024, 8, True))
    results.append(sa_case(8, 299, 1024, 8, False, kpm_tail=True))
    results.append(sa_case(8, 299, 512, 8, True))
    results.append(sa_case(3, 131, 512, 8, False))
    results.append(ca_case(8, 299, 1024, 8, True))
    results.append(ca_case(8, 299, 512, 8, False))
    results.append(ca_case(3, 131, 1024, 8, True))
    results.append(ffn_case(8, 299, 1024, 2048, True))
    results.append(ffn_case(8, 299, 512, 1024, False))
    results.append(ffn_case(3, 131, 1024, 2048, True, modulate=False))

    results += q8_checks(gen, compare, block_params, rnd)
    results += train_kernel_checks(gen, compare)

    # The base models' shapes (phase 5c), drawn after every earlier check so
    # that those keep their inputs.  MDM's encoder: no zero-attn, D = 128,
    # the cond token + 196 frames, B 2 with CFG, under a key mask (the
    # kernel's softmax starts at (-inf, 0) here, not the zero key's (0, 1));
    # the ViT-B/32 tower of MDM's text: causal, 8 heads of 64, 2 x B rows.
    results.append(attn_case("attention MDM encoder D=128 kpm, no zero-attn", 4, 4, 197, 197,
                             128, False, kpm_tail=True))
    results.append(attn_case("attention ViT-B/32 tower", 4, 8, 77, 77, 64, False, causal=True))
    # MDM's encoder at B 2 with CFG: 4 x 197 rows (the cond token + 196
    # frames); its input_process at 4 x 196 rows of the HumanML3D-width
    # motion the configs give (K = 262, the ragged route).
    M_MDM = 4 * 197
    results.append(lin_case("linear MDM QKV K=512", M_MDM, 512, 1536))
    results.append(lin_case("linear MDM FFN1 gelu K=512", M_MDM, 512, 1024, act="gelu"))
    results.append(lin_case("linear MDM FFN2 K=1024", M_MDM, 1024, 512))
    results.append(lin_case("linear MDM input_process K=262", 4 * 196, 262, 512))
    # The in2IN blocks at the infer-in2in window, T 210, B 2: the
    # interaction mode's 4-way CFG (16 person-stacked rows); dual's 2-way CFG
    # (8) and the individual mode's (4).
    T_IN2IN = 210
    for rows in (16, 8, 4):
        label = f" B={rows}"
        results.append(sa_case(rows, T_IN2IN, 1024, 8, True, label=label))
        if rows == 16:
            results.append(ca_case(rows, T_IN2IN, 1024, 8, True, label=label))
        results.append(ffn_case(rows, T_IN2IN, 1024, 2048, True, label=label))
    _lib.reset_launch_counts()  # comparison launches do not count
    return results


def _bf16_ulps(got, want):
    """max |got - want| in units of one bf16 rounding of ``want`` (2^-8 of
    its binade, the least nonzero step being that of 2^-126)."""
    import torch

    want = want.float()
    _, exp = torch.frexp(want.abs().clamp_min(2.0 ** -126))
    ulp = torch.ldexp(torch.ones_like(want), exp - 8)
    return ((got.float() - want).abs() / ulp).max().item()


# adaln_modulate_q8 against its plain composition: the rounding of a
# modulated value may fall to the other bf16 neighbour where the kernel's
# f32 statistics differ from torch's reductions in the last ulp, moving its
# int8 value by one; a scale moves only if the row's amax does, by at most
# one bf16 step (2^-7 relative).
Q8_INT8_ERR = 1
Q8_DIFFER_SHARE = 1e-4
Q8_SCALE_REL = 2.0 ** -7


def q8_checks(gen, compare, block_params, rnd):
    """The W8A8 kernels and entry points against their plain versions, at
    the shapes of the QUANT_FROZEN sampling path (8 sequences of 299 frames,
    E = 1024 / 512)."""
    import torch

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.ops import attention as attn_mod

    dev = torch.device("cuda")
    results = []
    M = 8 * 299

    # --- quant_rows: int8 values and scales bitwise equal -------------------
    for dt, K in ((torch.bfloat16, 1024), (torch.bfloat16, 512), (torch.float32, 2048),
                  (torch.float32, 1024), (torch.float32, 512)):
        x = torch.randn(M, K, generator=gen, device=dev).to(dt)
        x8, xs = ops.quant_rows(x)
        torch.cuda.synchronize()
        with ops.plain_versions():
            p8, ps = ops.quant_rows(x)
        err8 = (x8.int() - p8.int()).abs().max().item()
        errs = (xs - ps).abs().max().item()
        n_bytes = M * K * (x.element_size() + 1) + 4 * M
        b_ms, b_by = bound_ms(n_bytes, 4 * M * K, H100_F32_FLOPS)
        res = {
            "check": f"quant_rows {str(dt)[6:]} M={M} K={K}", "kind": "quant_rows",
            "shape": {"M": M, "K": K, "dtype": str(dt)[6:]}, "max_abs_err": float(err8),
            "max_scale_err": errs, "tol": "bitwise", "ok": err8 == 0 and errs == 0,
            "ms": graph_timed(lambda: ops.quant_rows(x)),
            "plain_ms": graph_timed(lambda: ops.quant_rows_plain(x)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "eager_ms": timed(lambda: ops.quant_rows(x)),
            "host_us": host_us(lambda: ops.quant_rows(x)),
        }
        print("   " + json.dumps(res), flush=True)
        results.append(res)

    # --- adaln_modulate_q8, held twice on the same inputs: bitwise against
    # quant_rows_plain of adaln_modulate's rows (the quantisation is exact),
    # and against the plain composition adaln_modulate_q8_plain, which
    # rounds rows the kernel's statistics may put one f32 ulp apart to the
    # other bf16 neighbour: at most Q8_INT8_ERR off per int8 value, at most
    # Q8_DIFFER_SHARE of them off, scales within Q8_SCALE_REL.  The row's
    # max_abs_err is the distance to the plain composition.  Timed beside
    # the unfused pair of kernels it replaces, adaln_modulate then quant_rows
    for B, T, E in ((8, 299, 1024), (8, 299, 512), (3, 131, 1024)):
        x = rnd(B, T, E)
        sc, sh = rnd(B, 2 * E, std=0.2).chunk(2, dim=-1)
        x8, xs = ops.adaln_modulate_q8(x, sc, sh)
        torch.cuda.synchronize()
        k8, ks = ops.quant_rows_plain(ops.adaln_modulate(x, sc, sh))
        c8, cs_ = ops.adaln_modulate_q8_plain(x, sc, sh)
        rows_err8 = (x8.int() - k8.int()).abs().max().item()
        rows_errs = (xs - ks).abs().max().item()
        err8 = (x8.int() - c8.int()).abs().max().item()
        differ = (x8 != c8).float().mean().item()
        scale_rel = ((xs - cs_).abs() / cs_).max().item()
        ok = (rows_err8 == 0 and rows_errs == 0 and err8 <= Q8_INT8_ERR
              and differ <= Q8_DIFFER_SHARE and scale_rel <= Q8_SCALE_REL)
        n_bytes = 2 * B * T * E + 2 * 2 * B * E + B * T * E + 4 * B * T
        b_ms, b_by = bound_ms(n_bytes, 12 * B * T * E, H100_F32_FLOPS)
        kern = lambda: ops.adaln_modulate_q8(x, sc, sh)  # noqa: E731
        res = {
            "check": f"adaln_modulate_q8 E={E} T={T}", "kind": "adaln_modulate_q8",
            "shape": {"B": B, "T": T, "E": E}, "max_abs_err": float(err8),
            "int8_differ": differ, "max_scale_rel_err": scale_rel,
            "tol": {"max_int8_err": Q8_INT8_ERR, "int8_differ": Q8_DIFFER_SHARE,
                    "max_scale_rel_err": Q8_SCALE_REL},
            "vs_kernel_rows": {"max_int8_err": rows_err8, "max_scale_err": rows_errs,
                               "tol": "bitwise"},
            "ok": ok,
            "ms": graph_timed(kern),
            "plain_ms": graph_timed(lambda: ops.adaln_modulate_q8_plain(x, sc, sh)),
            "pair_ms": graph_timed(lambda: ops.quant_rows(ops.adaln_modulate(x, sc, sh))),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "eager_ms": timed(kern), "host_us": host_us(kern),
        }
        print("   " + json.dumps(res), flush=True)
        results.append(res)

    # --- linear_q8: f32 out to 1e-5 of max |plain|, bf16 out within one
    # bf16 rounding per element --------------------------------------------
    def q8_case(name, K, N, act=None, res=False):
        x8, xs = ops.quant_rows(torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16))
        w8, ws = ops.quantize_weight(rnd(N, K, std=K ** -0.5))
        b = rnd(N, std=0.1)
        r = rnd(M, N) if res else None
        run = lambda: ops.linear_q8(x8, xs, w8, ws, b, activation=act, residual=r)  # noqa: E731
        plain = lambda: ops.linear_q8_plain(x8, xs, w8, ws, b, activation=act,  # noqa: E731
                                            residual=r)
        out_k = run()
        torch.cuda.synchronize()
        out_p = plain()
        max_abs = (out_k.float() - out_p.float()).abs().max().item()
        rel = max_abs / max(out_p.float().abs().max().item(), 1e-6)
        if act == "gelu":
            ok, tol = rel <= 1e-5, "1e-5 of max |plain|"
        else:
            ulps = _bf16_ulps(out_k, out_p)
            ok, tol = ulps <= 1.0, f"one bf16 rounding per element (read {ulps:.3g})"
        out_bytes = M * N * (4 if act == "gelu" else 2)
        n_bytes = M * K + N * K + 4 * (M + N) + 2 * N + out_bytes + (2 * M * N if res else 0)
        b_ms, b_by = bound_ms(n_bytes, 2 * M * N * K, H100_INT8_OPS)
        w8t = w8.t()
        try:  # the library's int8 product (no dequantisation), a yardstick only
            library_ms = graph_timed(lambda: torch._int_mm(x8, w8t))
        except RuntimeError as e:
            print(f"   torch._int_mm at M={M} K={K} N={N} not timed: {e}", flush=True)
            library_ms = None
        result = {
            "check": name, "kind": "linear_q8",
            "shape": {"M": M, "K": K, "N": N, "activation": act, "residual": res},
            "max_abs_err": max_abs, "max_rel_err": rel, "tol": tol, "ok": bool(ok),
            "ms": graph_timed(run), "plain_ms": graph_timed(plain),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "eager_ms": timed(run), "host_us": host_us(run),
        }
        print("   " + json.dumps(result), flush=True)
        return result

    results.append(q8_case("linear_q8 QKV E=1024", 1024, 3072))
    results.append(q8_case("linear_q8 FFN1 gelu f32 E=1024", 1024, 2048, act="gelu"))
    results.append(q8_case("linear_q8 FFN2 +residual E=1024", 2048, 1024, res=True))
    results.append(q8_case("linear_q8 out-proj +residual E=1024", 1024, 1024, res=True))
    results.append(q8_case("linear_q8 QKV E=512", 512, 1536))
    results.append(q8_case("linear_q8 out-proj +residual E=512", 512, 512, res=True))
    results.append(q8_case("linear_q8 FFN1 gelu f32 E=512", 512, 1024, act="gelu"))
    results.append(q8_case("linear_q8 FFN2 +residual E=512", 1024, 512, res=True))
    results += fused_q8_checks(gen, rnd)

    # --- attention, f32 output (the W8A8 self-attention block) --------------
    for D in (128, 64):
        q, k, v = (rnd(8, 8, 299, D) for _ in range(3))
        out = torch.empty(8, 8, 299, D, device=dev)
        kern = lambda: attn_mod.attention_into(q, k, v, out, None, None, True)  # noqa: E731
        results.append(compare(
            f"attention f32 out D={D}", kern,
            lambda: ops.fused_attention_plain(q, k, v, None, None, True,
                                              out_dtype=torch.float32),
            2e-2, 2 * 3 * 8 * 8 * 299 * D + 4 * 8 * 8 * 299 * D, 4 * 8 * 8 * 299 * 299 * D,
            kind="attention", B=8, H=8, Tq=299, Tk=299, D=D, zero_attn=True, out="f32"))

    # --- the three q8 entry points -------------------------------------------
    def q8w(p, *names):
        return [t for n in names for t in (*ops.quantize_weight(p["w" + n]), p["b" + n])]

    def eq_ops(B, T, E, F_=None):
        """int8 GEMM ops counted at half a bf16 op (the int8 peak is twice
        the bf16 one), plus the bf16 attention ops."""
        if F_:
            return 2 * B * T * E * F_
        return B * T * E * 4 * E + 4 * B * T * T * E

    def sa_q8(B, T, E, H, residual, kpm_tail=False):
        x, sc, sh = rnd(B, T, E), rnd(B, E, std=0.2), rnd(B, E, std=0.2)
        p = block_params(E)
        kpm = None
        if kpm_tail:
            kpm = torch.zeros(B, T, dtype=torch.bool, device=dev)
            kpm[:, T - T // 4:] = True
        args = (x, sc, sh, *q8w(p, "_qkv", "_o"), kpm)
        kw = dict(n_heads=H, residual=residual)
        n_bytes = 2 * 2 * B * T * E + 2 * 2 * B * E + 4 * E * E + 4 * 4 * E + 2 * 4 * E
        return compare(f"fused_sa_block_q8 E={E} T={T} residual={residual}",
                       lambda: ops.fused_sa_block_q8(*args, **kw),
                       lambda: ops.fused_sa_block_q8_plain(*args, **kw), 3e-2, n_bytes,
                       eq_ops(B, T, E), kind="fused_sa_block_q8", B=B, T=T, E=E, H=H,
                       residual=residual, key_padding=kpm_tail)

    def ca_q8(B, T, E, H, residual):
        x, xf = rnd(B, T, E), rnd(B, T, E)
        mods = [rnd(B, E, std=0.2) for _ in range(4)]
        p = block_params(E)
        args = (x, xf, *mods, *q8w(p, "_qkv", "_o"), None)
        kw = dict(n_heads=H, residual=residual)
        n_bytes = 2 * 3 * B * T * E + 2 * 4 * B * E + 4 * E * E + 4 * 4 * E + 2 * 4 * E
        return compare(f"fused_ca_block_q8 E={E} T={T} residual={residual}",
                       lambda: ops.fused_ca_block_q8(*args, **kw),
                       lambda: ops.fused_ca_block_q8_plain(*args, **kw), 3e-2, n_bytes,
                       eq_ops(B, T, E), kind="fused_ca_block_q8", B=B, T=T, E=E, H=H,
                       residual=residual)

    def ffn_q8(B, T, E, F_, residual):
        x, sc, sh = rnd(B, T, E), rnd(B, E, std=0.2), rnd(B, E, std=0.2)
        p = block_params(E, F_)
        args = (x, sc, sh, *q8w(p, "1", "2"))
        n_bytes = 2 * 2 * B * T * E + 2 * 2 * B * E + 2 * E * F_ + 6 * (F_ + E)
        return compare(f"fused_ffn_block_q8 E={E} F={F_} residual={residual}",
                       lambda: ops.fused_ffn_block_q8(*args, residual=residual),
                       lambda: ops.fused_ffn_block_q8_plain(*args, residual=residual), 3e-2,
                       n_bytes, eq_ops(B, T, E, F_), kind="fused_ffn_block_q8",
                       B=B, T=T, E=E, F=F_, residual=residual)

    results.append(sa_q8(8, 299, 1024, 8, True))
    results.append(sa_q8(8, 299, 1024, 8, False, kpm_tail=True))
    results.append(sa_q8(8, 299, 512, 8, True))
    results.append(ca_q8(8, 299, 1024, 8, True))
    results.append(ca_q8(8, 299, 512, 8, True))
    results.append(ffn_q8(8, 299, 1024, 2048, True))
    results.append(ffn_q8(8, 299, 512, 1024, True))
    return results


# The fused quantising epilogues against their plain compositions, on the
# dequantised values x8 * s, max |diff| / max |plain|: the unfused kernel's
# own limit against its plain version (attention 2e-2, the int8 GELU
# product 1e-5) plus one int8 step (1 / 127 of a row's amax), by which a
# value on a rounding boundary may move.
FUSED_Q8_TOL = {"attention_q8": 2e-2 + 1 / 127, "linear_q8_gelu_q8": 1e-5 + 1 / 127}


def fused_q8_checks(gen, rnd):
    """``attention_q8`` and the quantising GELU product (``linear_q8_gelu_q8``)
    at the six shapes where the W8A8 step quantised with ``quant_rows``
    before: int8 values and scales bitwise ``quant_rows`` of the unfused
    kernel's output on the same inputs, and the dequantised values against
    the plain composition (:data:`FUSED_Q8_TOL`); timed beside the unfused
    pair they replace (the producer kernel, then ``quant_rows``), with every
    warpgroup count of the plan forced beside the one it picks (rows per
    block: the plan's choice rests on these readings), and a ragged case of
    each (not timed)."""
    import importlib

    import torch

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.ops import attention as attn_mod

    lq = importlib.import_module("mixermdm_tpu_torch.ops.linear_q8")
    dev = torch.device("cuda")
    results = []

    def forced(module, plan_name, knob, values, plan_args, kern, pair):
        """The kernel's ms with each value of one knob of its plan forced,
        on the same inputs, and whether its output is still the unfused
        kernel's bits."""
        orig = getattr(module, plan_name)
        r8, rs = pair()
        out = {}
        try:
            for value in values:
                setattr(module, plan_name, lambda *a, _v=value: orig(*a, **{knob: _v}))
                o8, os_ = kern()
                torch.cuda.synchronize()
                out[value] = {"ms": graph_timed(kern),
                              "plan": dataclasses.asdict(getattr(module, plan_name)(*plan_args)),
                              "bitwise_vs_unfused_kernel": bool(torch.equal(o8, r8)
                                                                and torch.equal(os_, rs))}
        finally:
            setattr(module, plan_name, orig)
        return out

    def held(name, kind, got, pair, plain, n_bytes, ops_, peak, timing, **shape):
        (k8, ks), (r8, rs), (p8, ps) = got, pair, plain
        torch.cuda.synchronize()
        bit8 = (k8.int() - r8.int()).abs().max().item()
        bits = (ks - rs).abs().max().item()
        deq_k, deq_p = k8.float() * ks[..., None], p8.float() * ps[..., None]
        deq = ((deq_k - deq_p).abs().max() / deq_p.abs().max().clamp_min(1e-30)).item()
        ok = bit8 == 0 and bits == 0 and deq <= FUSED_Q8_TOL[kind] and bool(
            torch.isfinite(ks).all())
        b_ms, b_by = bound_ms(n_bytes, ops_, peak)
        res = {
            "check": name, "kind": kind, "shape": shape,
            "max_abs_err": float((k8.int() - p8.int()).abs().max().item()),
            "int8_differ": (k8 != p8).float().mean().item(), "dequant_rel_err": deq,
            "tol": {"vs_unfused_kernel": "bitwise", "dequant_rel_err": FUSED_Q8_TOL[kind]},
            "vs_unfused_kernel": {"max_int8_err": bit8, "max_scale_err": bits}, "ok": ok,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        }
        if timing:
            kern, pair_fn, plain_fn = timing
            res.update({"ms": graph_timed(kern), "pair_ms": graph_timed(pair_fn),
                        "plain_ms": graph_timed(plain_fn), "eager_ms": timed(kern),
                        "host_us": host_us(kern)})
        print("   " + json.dumps(res), flush=True)
        return res

    # --- attention_q8: Q, K, V as the blocks pass them (slices of a packed
    # projection); the SA form quantises the f32 output, the CA form its bf16
    # rounding.
    def attn_q8(name, B, T, H, D, out_dtype, kpm_rows=(), time_it=True):
        E = H * D
        qkv = rnd(B, T, 3 * E)
        q, k, v = (t.view(B, T, H, D).transpose(1, 2) for t in qkv.split(E, dim=-1))
        kpm = None
        if kpm_rows:
            kpm = torch.zeros(B, T, dtype=torch.bool, device=dev)
            kpm[:, T - T // 4:] = True
            for r in kpm_rows:
                kpm[r] = True
        unfused = torch.empty(B, T, E, dtype=out_dtype, device=dev)

        def pair():
            attn_mod.attention_into(q, k, v, unfused.view(B, T, H, D).transpose(1, 2), kpm,
                                    None, True)
            return ops.quant_rows(unfused)

        kern = lambda: ops.attention_q8(q, k, v, kpm, True, out_dtype=out_dtype)  # noqa: E731
        plain = lambda: ops.attention_q8_plain(q, k, v, kpm, True,  # noqa: E731
                                               out_dtype=out_dtype)
        plan = attn_mod.attention_q8_plan(B, H, T, T, D)
        clusters = attn_mod.attention_q8_clusters(D, H, plan.nwg, plan.stages)
        n_bytes = 2 * 3 * B * T * E + B * T * E + 4 * B * T + (B * T if kpm is not None else 0)
        res = held(name, "attention_q8", kern(), pair(), plain(), n_bytes, 4 * B * T * T * E,
                   H100_BF16_FLOPS, (kern, pair, plain) if time_it else None, B=B, H=H, Tq=T,
                   Tk=T, D=D, out=str(out_dtype)[6:], masked_rows=list(kpm_rows),
                   plan={"nwg": plan.nwg, "stages": plan.stages, "ctas": plan.grid[0] * H * B,
                         "clusters_at_once": clusters})
        if time_it:
            res["by_nwg"] = forced(attn_mod, "attention_q8_plan", "nwg",
                                   range(1, attn_mod.MAX_WARPGROUPS + 1), (B, H, T, T, D),
                                   kern, pair)
            res["ok"] = res["ok"] and all(r["bitwise_vs_unfused_kernel"]
                                          for r in res["by_nwg"].values())
            print("   " + json.dumps({"check": name, "by_nwg": res["by_nwg"]}), flush=True)
        return res

    M = 8 * 299
    results.append(attn_q8("attention_q8 SA f32 D=128", 8, 299, 8, 128, torch.float32))
    results.append(attn_q8("attention_q8 SA f32 D=64", 8, 299, 8, 64, torch.float32))
    results.append(attn_q8("attention_q8 CA bf16 D=128", 8, 299, 8, 128, torch.bfloat16))
    results.append(attn_q8("attention_q8 CA bf16 D=64", 8, 299, 8, 64, torch.bfloat16))
    results.append(attn_q8("attention_q8 T=131 key padding + masked row", 3, 131, 8, 128,
                           torch.bfloat16, kpm_rows=(1,), time_it=False))

    # --- the quantising GELU product (FFN1 of the W8A8 FFN blocks) ----------
    def gelu_q8(name, M_, K, N, time_it=True):
        x8, xs = ops.quant_rows(torch.randn(M_, K, generator=gen, device=dev).to(torch.bfloat16))
        w8, ws = ops.quantize_weight(rnd(N, K, std=K ** -0.5))
        b = rnd(N, std=0.1)
        kern = lambda: ops.linear_q8(x8, xs, w8, ws, b, activation="gelu",  # noqa: E731
                                     quant_out=True)
        pair = lambda: ops.quant_rows(ops.linear_q8(x8, xs, w8, ws, b,  # noqa: E731
                                                    activation="gelu"))
        plain = lambda: ops.linear_q8_gelu_q8_plain(x8, xs, w8, ws, b)  # noqa: E731
        plan = lq.gelu_q8_plan(M_, N, K)
        n_bytes = M_ * K + N * K + 4 * (M_ + N) + 2 * N + M_ * N + 4 * M_
        res = held(name, "linear_q8_gelu_q8", kern(), pair(), plain(), n_bytes, 2 * M_ * N * K,
                   H100_INT8_OPS, (kern, pair, plain) if time_it else None, M=M_, K=K, N=N,
                   plan=dataclasses.asdict(plan))
        if time_it:
            res["by_nc"] = forced(lq, "gelu_q8_plan", "nc", lq.GELU_Q8_WARPGROUPS,
                                  (M_, N, K), kern, pair)
            res["ok"] = res["ok"] and all(r["bitwise_vs_unfused_kernel"]
                                          for r in res["by_nc"].values())
            print("   " + json.dumps({"check": name, "by_nc": res["by_nc"]}), flush=True)
        return res

    results.append(gelu_q8("linear_q8_gelu_q8 FFN1 E=1024", M, 1024, 2048))
    results.append(gelu_q8("linear_q8_gelu_q8 FFN1 E=512", M, 512, 1024))
    results.append(gelu_q8("linear_q8_gelu_q8 M=393 N=1040 (ragged)", 393, 1024, 1040,
                           time_it=False))
    return results


# f32 attention is held at ~1e-5 of max |plain|: f32 FMA on both sides, only
# the order of the sums differs (no TF32 anywhere: set in main()).
F32_TOL = 1e-5
# attention_bwd in bf16 against its plain version (the same rounding points:
# p and ds rounded to bf16, as the JAX kernel rounds them), max |diff| / max
# |plain|: only the order of the f32 sums differs, which flips a rounding
# now and then.  Readings on an H100: 0.0006-0.0014.  The witness holds the
# kernel's distance from the f32 gradients (torch.autograd.grad through the
# plain forward in f32) to at most 1.5 x the plain version's.
BWD_BF16_TOL = 1e-2
# The forward's row statistics (max, denominator) against their plain version
# (f32 logits on both sides; the kernel's exp is ex2.approx, ~2^-22), max
# |diff| / max |plain| of each.
STATS_TOL = 1e-5


def train_kernel_checks(gen, compare):
    """The kernels of the training path: the f32-input ``attention`` (the
    text heads) and ``attention_bwd`` (G step: discriminators in bf16, the
    mixer's head in f32), each against its plain version."""
    import torch
    import torch.nn.functional as F

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.ops import attention as attn_mod

    dev = torch.device("cuda")
    results = []

    def rnd(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    # --- attention, f32 inputs ----------------------------------------------
    for name, (B, H, T, D, causal) in (("attention f32 post-encoder D=96", (2, 8, 77, 96, False)),
                                        ("attention f32 clip tower D=64", (2, 12, 77, 64, True))):
        q, k, v = rnd(B, H, T, D), rnd(B, H, T, D), rnd(B, H, T, D)
        am = torch.triu(torch.full((T, T), float("-inf"), device=dev), 1) if causal else None
        n_bytes = 4 * 4 * B * H * T * D + (4 * T * T if causal else 0)
        results.append(compare(
            name, lambda: ops.fused_attention(q, k, v, None, am, False),
            lambda: ops.fused_attention_plain(q, k, v, None, am, False), F32_TOL, n_bytes,
            4 * B * H * T * T * D,
            library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am),
            kind="attention_f32", peak=H100_F32_FLOPS, B=B, H=H, Tq=T, Tk=T, D=D,
            zero_attn=False, causal=causal))

    # --- attention_bwd -------------------------------------------------------
    # What autograd runs (ops.FusedAttention): the forward that also writes
    # the row statistics, then the backward from them and the forward's
    # output.  The row's ms times that pair, against SDPA forward + backward;
    # the backward alone stands beside it.
    def bwd_case(name, dt, B, H, T, D, zero_attn, kpm_tail, masked_rows=(), time_it=True):
        q, k, v, g = (rnd(B, H, T, D, dt=dt) for _ in range(4))
        kpm = None
        if kpm_tail or masked_rows:
            kpm = torch.zeros(B, T, dtype=torch.bool, device=dev)
            if kpm_tail:
                kpm[:, T - T // 5:] = True
            for r in masked_rows:
                kpm[r] = True                      # every key of one sequence masked
        out, stats = ops.fused_attention(q, k, v, kpm, None, zero_attn, return_stats=True)
        kern = lambda: ops.attention_bwd(q, k, v, kpm, g, zero_attn, stats, out)  # noqa: E731
        plain = lambda: ops.attention_bwd_plain(q, k, v, kpm, g, zero_attn, stats,  # noqa: E731
                                                out)

        def pair():
            o, st = ops.fused_attention(q, k, v, kpm, None, zero_attn, return_stats=True)
            return ops.attention_bwd(q, k, v, kpm, g, zero_attn, st, o)

        def plain_pair():
            o = ops.fused_attention_plain(q, k, v, kpm, None, zero_attn)
            st = attn_mod.attention_stats_plain(q, k, kpm, None, zero_attn)
            return ops.attention_bwd_plain(q, k, v, kpm, g, zero_attn, st, o)

        got = kern()
        torch.cuda.synchronize()
        want = plain()
        # The forward's statistics against their plain version (f32 logits).
        stats_p = attn_mod.attention_stats_plain(q, k, kpm, None, zero_attn)
        stats_err = max(((stats[i] - stats_p[i]).abs().max()
                         / stats_p[i].abs().max().clamp_min(1e-30)).item() for i in range(2))
        # The f32 truth: torch.autograd.grad through the plain forward on the
        # inputs widened to f32 (no custom backward involved).
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        out_f = ops.fused_attention_plain(*leaves, kpm, None, zero_attn)
        want_f = torch.autograd.grad(out_f, leaves, g.float())
        # The JAX kernel's dsum = rowsum(dp * p) with p recomputed: a reading
        # of what the identity rowsum(g * o) moves.
        exact = ops.attention_bwd_plain(q, k, v, kpm, g, zero_attn)

        def rel(a, b):
            return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

        f32 = dt == torch.float32
        errs = {n: {"vs_plain": rel(a, b), "vs_f32_autograd": rel(a, c),
                    "plain_vs_f32_autograd": rel(b, c), "vs_plain_recomputed": rel(a, x)}
                for n, a, b, c, x in zip(("dq", "dk", "dv"), got, want, want_f, exact)}
        tol = F32_TOL if f32 else BWD_BF16_TOL
        ok = all(e["vs_plain"] <= tol for e in errs.values()) and stats_err <= STATS_TOL
        if f32:
            ok = ok and all(e["vs_f32_autograd"] <= tol for e in errs.values())
        else:  # witness: no farther from the f32 gradients than the plain version
            ok = ok and all(
                e["vs_f32_autograd"] <= WITNESS_RATIO * max(e["plain_vs_f32_autograd"], 1e-6)
                for e in errs.values())
        ok = ok and all(bool(torch.isfinite(t.float()).all()) for t in got)
        # The pair's bound: q, k, v read and o written by the forward (and
        # the statistics); q, k, v, g, o read and dq, dk, dv written by the
        # backward; 2 + 5 products of 2 * B*H*T*T*D operations.
        e = q.element_size()
        pair_bytes = 12 * B * H * T * D * e + 8 * B * H * T + (2 * B * T if kpm is not None else 0)
        b_ms, b_by = bound_ms(pair_bytes, 7 * 2 * B * H * T * T * D,
                              H100_F32_FLOPS if f32 else H100_BF16_FLOPS)
        bwd_b_ms, _ = bound_ms(8 * B * H * T * D * e + 8 * B * H * T,
                               5 * 2 * B * H * T * T * D,
                               H100_F32_FLOPS if f32 else H100_BF16_FLOPS)
        res = {
            "check": name, "kind": "attention_bwd",
            "shape": {"B": B, "H": H, "Tq": T, "Tk": T, "D": D, "dtype": str(dt)[6:],
                      "zero_attn": zero_attn, "key_padding": kpm_tail,
                      "masked_rows": list(masked_rows)},
            "max_abs_err": max(((a.float() - b.float()).abs().max().item())
                               for a, b in zip(got, want)),
            "max_rel_err": max(e["vs_plain"] for e in errs.values()),
            "errors": errs, "tol_rel": tol, "stats_rel_err": stats_err, "stats_tol": STATS_TOL,
            "witness": None if f32 else
            f"vs_f32_autograd <= {WITNESS_RATIO} x plain_vs_f32_autograd",
            "ok": bool(ok),
        }
        if time_it:
            kz = torch.cat([k, k.new_zeros(B, H, 1, D)], 2) if zero_attn else k
            vz = torch.cat([v, v.new_zeros(B, H, 1, D)], 2) if zero_attn else v
            bias = torch.zeros(B, 1, T, kz.shape[2], device=dev, dtype=dt)
            if kpm is not None:
                bias[..., :T] += ops.attention.key_bias(kpm)[:, None, None, :].to(dt)
            lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, kz, vz))

            def library():  # SDPA forward + backward with the zero key appended
                o = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=bias)
                return torch.autograd.grad(o, (lq, lk, lv), g)

            res.update({
                "ms": graph_timed(pair), "timing": "forward with statistics + backward",
                "bwd_ms": graph_timed(kern), "plain_ms": graph_timed(plain_pair),
                "bound_ms": b_ms, "bound_by": b_by, "bwd_bound_ms": bwd_b_ms,
                # The yardstick read as every other row's is (captured in a
                # CUDA graph after a warm-up on a side stream, then
                # replayed), and eager beside it.
                "library_ms": graph_timed(library),
                "library_timing": "CUDA-graph replay (autograd)",
                "library_eager_ms": timed(library), "eager_ms": timed(pair),
                "host_us": host_us(kern), "pair_host_us": host_us(pair),
            })
        print("   " + json.dumps(res), flush=True)
        return res

    # G step: the discriminators' attention (bf16, 4 heads of 64, T = 300,
    # zero-attn, key padding) and the mixer head's (f32, 8 heads of 96).
    results.append(bwd_case("attention_bwd bf16 discriminator", torch.bfloat16, 8, 4, 300, 64,
                            True, True))
    results.append(bwd_case("attention_bwd f32 post-encoder", torch.float32, 8, 8, 77, 96,
                            False, False))
    # A sequence whose keys are all masked, with and without the zero key,
    # in both dtypes (small: checks, not timed).
    for dt, D in ((torch.bfloat16, 64), (torch.float32, 96)):
        for zero_attn in (True, False):
            results.append(bwd_case(
                f"attention_bwd {str(dt)[6:]} fully masked row zero_attn={zero_attn}", dt,
                3, 2, 45, D, zero_attn, True, masked_rows=(1,), time_it=False))
    return results


# --------------------------------------------------------------------------
# Phase 3b: the SA-block variants of the kernel experiments
# --------------------------------------------------------------------------

# sa_block and sa_block_i8x against their plain versions (the port's plain
# compositions, ops/sa_variants.py), max |diff| / max |plain| over the finite
# values (the ablation without softmax puts 1e30-sized values in rows whose
# padded keys reach them); the non-finite values must agree in place.  The
# kernels round where the shipped blocks' kernels round (bf16 projections
# and output, bf16 p), so they are held as those blocks are (3e-2); int8
# p and v move a value on a rounding boundary by one step where the f32
# logits differ in their last bits.  Readings on an H100 before the limit
# was written: 0 to 0.007 (sa_block), 0.003 to 0.005 (sa_block_i8x with the
# static scale alone).
SA_TOL = 3e-2
# Beside it, the block's update (output - x, the attention term without the
# residual that sets max |out|) on ||diff|| / ||plain|| over the finite
# values, which a systematic error in a few percent of the values moves
# where the max-abs ratio does not.  Readings on an H100 before the limit
# was kept: 0-0.0068 (W8A8 sa_block the largest; int8 p.v 0.0012-0.0029).
SA_L2_TOL = 1e-2
# sa_block_i8x with int8 p.v: p8 = round(127 p), and at T 299 the typical
# probability (127 / 299 = 0.42 of a step, spread by the logits) lies next to
# the 0.5 rounding boundary, so where q, k or v differ in their last bits
# (the modulated rows' int8 rounding, the product's order) p8 flips between
# 0 and 1 at some keys.  Each flip moves an attention output by v / 127 and
# can move its row's int8 scale, so whole output rows shift by a step.  So
# the block is held on 6e-2, and each stage on its own, on every run: the
# projections against the plain ones (SA_TOL); the attention on the
# kernel's own q, k, v, where every integer sum p8.v8 of the kernel may
# differ from the plain one only by what the keys whose 127 p lies within
# SA_FLIP_REL (relative) of a rounding boundary can move it; the tail
# (quantised attention, out-projection, residual) against the plain tail on
# the kernel's attention (SA_TOL).  Readings on an H100 (the kernel
# experiments' data, B 8 with and without masked keys, B 40): block
# 0.0116-0.0302; attention 0-247 of 2.4-12.2 million sums differ, all
# explained at a width of 1e-6 (125 unexplained at 1e-7), attention rel-L2
# 0-0.0010; tail 0, bit for bit.  A denominator without the zero key, 1 /
# 300 off, would move 127 p by about 1e-3 at every key.
SA_QPV_TOL = 6e-2
SA_FLIP_REL = 1e-5
SA_SHAPES = ((8, 299, 1024, 8), (40, 299, 1024, 8))  # the SA blocks' shape; the script's
SA_TIMED_B = 8  # B 40 is timed by the experiment script's own run


def _finite_rel(got, want):
    """max |got - want| / max |want| over the finite values of ``want``; inf
    where the non-finite values differ in place or value."""
    import torch

    got, want = got.float(), want.float()
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)) or not torch.equal(got[~fin], want[~fin]):
        return math.inf, math.inf
    max_abs = (got - want)[fin].abs().max().item()
    return max_abs, max_abs / max(want[fin].abs().max().item(), 1e-6)


def _update_l2(got, want, x):
    """||got - want|| / ||want - x|| over the finite values of ``want``."""
    import torch

    got, want = got.double(), want.double()  # the ablation without softmax reaches 1e30
    fin = torch.isfinite(want) & torch.isfinite(got)
    d = (got - want)[fin].norm().item()
    return d / max((want - x.double())[fin].norm().item(), 1e-12)


def _qpv_witness(sv, mid, kpm, H, T, qqk):
    """The int8 p.v of sa_block_i8x on its own q, k, v (``mid``, from the
    launch) against the plain product: the integer sums p8.v8 of both, how
    many differ, and how many differ by more than the keys whose 127 p lies
    within SA_FLIP_REL (relative) of a rounding boundary can move them (each
    such key moves a sum by at most |v8|)."""
    import torch

    E = mid["qkv"].shape[-1] // 3
    q, k, v = mid["qkv"].split(E, dim=-1)
    p = sv.int8_attention_probs(q, k, kpm, n_heads=H, qqk=qqk)
    v8, vs = sv.quant_v(v, H)
    step = (vs / 127.0)[:, None, None, None]
    ours = sv._heads(mid["attn"], H) / step
    acc_ours = torch.round(ours)
    t = p * 127.0
    acc_plain = sv._int_matmul(torch.round(t), v8)
    d = (acc_ours - acc_plain)[:, :, :T].abs()
    near = (t - torch.floor(t) - 0.5).abs() <= SA_FLIP_REL * t
    reach = torch.matmul(near.float(), v8.abs())[:, :, :T]
    a_ours, a_plain = acc_ours[:, :, :T] * step, acc_plain[:, :, :T] * step
    return {
        "values": d.numel(), "differ": int((d > 0).sum()),
        "max_steps": float(d.max()), "near_boundary_keys": int(near[:, :, :T].sum()),
        "unexplained": int((d > reach).sum()),
        "off_grid": float((ours - acc_ours).abs().max()),
        "attn_rel_l2": float((a_ours - a_plain).norm() / a_plain.norm().clamp_min(1e-12)),
    }


def _key_mask(B, T, device):
    """Sequences of falling lengths T, ..., about T / 2, and the last one
    with every key masked (as the sampling path's padded batches)."""
    import torch

    lengths = [T - (b * T) // (2 * B) for b in range(B - 1)] + [0]
    kpm = torch.arange(T, device=device)[None, :] >= torch.tensor(lengths, device=device)[:, None]
    return kpm, sum(lengths)


def sa_variant_phase(seed):
    """Every configuration of ``sa_block`` (sa_variant rows 1 / 2 x recip x
    bf16 / W8A8; sa_headbatch; sa_ablate's five skip sets) and of
    ``sa_block_i8x`` (sa_int8x's four lever sets) against its plain version
    at the SA blocks' shape (8, 299, 1024), H 8, and at the kernel
    experiments' B 40; at B 8 also with keys masked (sa_variant, sa_int8x),
    and there graph-replay ms beside the shipped composition
    (fused_sa_block / fused_sa_block_q8 on the same inputs) and the H100's
    bound, and host us per eager call.  The int8 p.v configurations also
    hold the kernel's attention alone against the plain one on the kernel's
    q, k, v (:func:`_qpv_witness`) and the block's tail (quantised attention,
    out-projection, residual) against the plain tail on the kernel's
    attention.  Then the W8A8 blocks at shapes whose fused plan refuses them
    (16 heads; F 4096) through the unfused pair, against their plain
    versions.  Then the slice's path: the experiment script
    (``python -m mixermdm_tpu_torch.scripts.exp_kernels``) in each of its
    modes at B 40, which times B 40, with the launch counts of that run.
    Returns (results, counts)."""
    import torch

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.ops import _lib
    from mixermdm_tpu_torch.ops import sa_variants as sv
    from mixermdm_tpu_torch.scripts import exp_kernels as ek

    results = []
    for B, T, E, H in SA_SHAPES:
        timed = B == SA_TIMED_B
        inp = ek.make_inputs(B, T, E, H, seed=seed)
        w = ek.weights(inp)
        st = ek.static_scale(inp)
        args = (inp.x, inp.scale, inp.shift, w)
        flops = ek.cost_flops(B, T, E)
        shipped = {q: (graph_timed(ek.shipped_block(inp, q)),
                       host_us(ek.shipped_block(inp, q), reps=50)) if timed else (None, None)
                   for q in (False, True)}
        kpm, n_keys = _key_mask(B, T, inp.x.device)
        masks = (("", inp.kpm, B * T),) + ((" masked", kpm, n_keys),) * timed
        cases = [(f"rows={r} recip={int(c)}{m}", "sa_block", q, {}, mask,
                  lambda r=r, c=c, q=q, mask=mask, plain=False: (
                      sv.sa_variant_plain if plain else sv.sa_variant)(
                      *args, mask, n_heads=H, rows=r, recip=c, quant=q))
                 for m, mask, _ in masks for r in (1, 2) for c in (False, True)
                 for q in (False, True) if not m or not c]
        for q in (False, True):
            cases.append(("headbatch", "sa_block", q, {}, None,
                          lambda q=q, plain=False: (sv.sa_headbatch_plain if plain else
                                                    sv.sa_headbatch)(*args, n_heads=H, quant=q)))
            for name, sk in ek.ABLATIONS:
                cases.append((f"ablate {name}", "sa_block", q, sk, None,
                              lambda q=q, sk=sk, plain=False: (sv.sa_ablate_plain if plain else
                                                               sv.sa_ablate)(
                                  *args, n_heads=H, quant=q, **sk)))
        for m, mask, _ in masks:
            for name, levers in ek.LEVERS:
                kw = ek.lever_kwargs(levers, st)
                cases.append((name + m, "sa_block_i8x", True, kw, mask,
                              lambda kw=kw, mask=mask, plain=False, **more: (
                                  sv.sa_int8x_plain if plain else sv.sa_int8x)(
                                  *args, mask, n_heads=H, **kw, **more)))
        outs = {}
        for name, kernel, quant, kw, mask, run in cases:
            qpv = kw.get("qpv", False)
            mid = {} if qpv else None
            got = outs[name, quant] = run(intermediates=mid) if qpv else run()
            torch.cuda.synchronize()
            want = run(plain=True)
            max_abs, rel = _finite_rel(got, want)
            l2 = _update_l2(got, want, inp.x)
            keys = B * T if mask is None else int((~mask).sum())
            bound, by = ek.bound(B, T, E, quant=quant, qqk=kw.get("qqk", False), qpv=qpv,
                                 skip_attn=kw.get("skip_attn", False), keys=keys)
            tol = SA_QPV_TOL if qpv else SA_TOL
            ok = rel <= tol and l2 <= SA_L2_TOL
            res = {
                "check": f"{kernel} {name} {'w8a8' if quant else 'bf16'} B={B}", "kind": kernel,
                "shape": {"B": B, "T": T, "E": E, "H": H, "quant": quant, "masked_keys":
                          B * T - keys, **kw},
                "max_abs_err": max_abs, "max_rel_err": rel, "tol_rel": tol,
                "update_rel_l2": l2, "tol_l2": SA_L2_TOL,
                "bound_ms": bound, "bound_by": by, "library_ms": None,
                "ms": None, "shipped_ms": shipped[quant][0], "shipped_host_us": shipped[quant][1],
                "host_us": None, "plain_ms": None,
            }
            if qpv:
                # Each stage alone: the projections, the attention on the
                # kernel's q, k, v, and the tail on the kernel's attention
                # (the plain tail: quant_rows, linear_q8 with bias and cast,
                # + x).
                _, kp = sv._pad(inp.x, mask)
                qkv = sv.sa_int8x_qkv_plain(*args, static_as=kw.get("static_as"))
                res["qkv_rel_err"] = _finite_rel(mid["qkv"], qkv)[1]
                res["witness"] = wit = _qpv_witness(sv, mid, kp, H, T, kw.get("qqk", False))
                a8, as_ = sv.quant_rows_plain(mid["attn"])
                tail = sv.linear_q8_plain(a8, as_, w.w8_o, w.s_o, w.b_o, dtype=inp.x.dtype,
                                          residual=sv._pad(inp.x, None)[0])[:, :T]
                res["tail_rel_err"] = _finite_rel(got, tail)[1]
                ok = (ok and res["qkv_rel_err"] <= SA_TOL and wit["unexplained"] == 0
                      and res["tail_rel_err"] <= SA_TOL)
            if timed and keys == B * T:
                res["ms"] = ms = graph_timed(run)
                res["tflops"] = flops / ms / 1e9
                res["host_us"] = host_us(run, reps=50)
                if name in ("rows=1 recip=0", "static + int8 attn"):
                    res["plain_ms"] = graph_timed(lambda: run(plain=True), reps=2, replays=2)
            res["ok"] = ok
            print("   " + json.dumps(res), flush=True)
            results.append(res)
        # The attention schedule does not reach the values: rows 1 and 2, and
        # the head-batched walk, give the same bits (bf16; the W8A8
        # head-batched form quantises the bf16 rounding, as its JAX kernel).
        same = {f"rows=2 vs rows=1 {'w8a8' if q else 'bf16'}":
                torch.equal(outs["rows=2 recip=0", q], outs["rows=1 recip=0", q])
                for q in (False, True)}
        same["headbatch vs rows=1 bf16"] = torch.equal(outs["headbatch", False],
                                                       outs["rows=1 recip=0", False])
        res = {"check": f"sa_block schedule B={B}", "kind": "sa_block", "bitwise": same,
               "ok": all(same.values())}
        print("   " + json.dumps(res), flush=True)
        results.append(res)

    # The W8A8 blocks where the fused plan refuses: 16 heads of 64 (SA, CA),
    # F 4096 (FFN), through attention / linear_q8 + quant_rows.
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape, std=1.0: (torch.randn(*shape, generator=gen, device="cuda")  # noqa: E731
                                   * std).to(torch.bfloat16)
    B, T, E = 8, 299, 1024
    q8w = lambda n, k: (*ops.quantize_weight(rnd(n, k, std=k ** -0.5)), rnd(n, std=0.1))  # noqa: E731
    x, xf = rnd(B, T, E), rnd(B, T, E)
    mods = [rnd(B, E, std=0.2) for _ in range(4)]
    wsa = (*q8w(3 * E, E), *q8w(E, E))
    wffn = (*q8w(4096, E), *q8w(E, 4096))
    for name, route, kern, plain in (
        ("fused_sa_block_q8 H=16", "attention_q8_pair",
         lambda: ops.fused_sa_block_q8(x, *mods[:2], *wsa, n_heads=16, residual=True),
         lambda: ops.fused_sa_block_q8_plain(x, *mods[:2], *wsa, n_heads=16, residual=True)),
        ("fused_ca_block_q8 H=16", "attention_q8_pair",
         lambda: ops.fused_ca_block_q8(x, xf, *mods, *wsa, n_heads=16, residual=True),
         lambda: ops.fused_ca_block_q8_plain(x, xf, *mods, *wsa, n_heads=16, residual=True)),
        ("fused_ffn_block_q8 F=4096", "linear_q8_gelu_q8_pair",
         lambda: ops.fused_ffn_block_q8(x, *mods[:2], *wffn, residual=True),
         lambda: ops.fused_ffn_block_q8_plain(x, *mods[:2], *wffn, residual=True)),
    ):
        _lib.reset_launch_counts()
        got = kern()
        torch.cuda.synchronize()
        routed = dict(_lib.launches)
        max_abs, rel = _finite_rel(got, plain())
        ok = rel <= 3e-2 and routed.get(route, 0) == 1 and routed.get("quant_rows", 0) >= 1
        res = {"check": f"{name} (unfused pair)", "kind": route, "max_abs_err": max_abs,
               "max_rel_err": rel, "tol_rel": 3e-2, "launches": routed, "ok": ok,
               "ms": graph_timed(kern)}
        print("   " + json.dumps(res), flush=True)
        results.append(res)
    _lib.reset_launch_counts()  # comparison launches do not count

    # The slice's path: the experiment script in each mode, counted; its
    # records are the B 40 times.
    for argv in ([], ["--quant"], ["--headbatch"], ["--headbatch", "--quant"], ["--ablate"],
                 ["--ablate", "--quant"], ["--int8attn"]):
        print(f"   exp_kernels {' '.join(argv)}", flush=True)
        records = ek.run(argv)
        if records is None:
            raise SmokeFailure(f"exp_kernels {argv} failed")
        print("   " + json.dumps({"check": f"exp_kernels {' '.join(argv)}".strip(),
                                  "B": ek.SHAPE["B"], "records": records}), flush=True)
    counts = dict(_lib.launches)
    print("   exp_kernels launches: " + json.dumps(counts), flush=True)
    return results, counts


# --------------------------------------------------------------------------
# Phase 4: the sampling path at full width
# --------------------------------------------------------------------------

# Kernel path against plain path inside the sampling path, same inputs, bf16.
# The networks (text conds, both denoisers) are held on max |diff| / max |plain|.
# The whole CFG mixer step is held on ||diff|| / ||plain||, for two reasons:
# its raw-space x0 goes through the per-joint Gram-Schmidt of the 6d
# rotations, which normalises near-zero vectors of a random-weight model, so
# a few elements swing by O(1) on bf16 noise; and CFG (s = 3.5) forms
# s * cond - (s - 1) * uncond, which scales independent branch errors by
# sqrt(s^2 + (s - 1)^2) = 4.3.  0.1 allows 2.3% of network noise per branch.
# The limit was set after two readings on an H100 (rel(max) 0.65, rel(fro)
# 0.036); the witness below tests the explanation on every run.
NET_TOL = 5e-2
STEP_TOL = 1e-1
# The conds (bf16 CLIP towers, f32 post-encoder heads) on the kernels against
# the plain versions, max |diff| / max |plain|.  With bf16 heads the limit was
# 0.05 (reading 0.0178).  With the heads in f32 the readings on an H100 were
# 0.0165-0.0174 (rel(fro) 0.0097), the towers' bf16 noise; the limit is set
# at 1.7x that, and the witness below holds the kernel path to the plain
# path's distance from an all-f32 encode (readings 0.0083 vs 0.0084).
COND_TOL = 3e-2
# Witness for STEP_TOL: the same step in f32 (same weights, plain versions).
# The kernels and the plain versions round at the same points (bf16 operands,
# f32 accumulation, one rounding per output), so if the step's gap above is
# bf16 noise amplified by CFG and Gram-Schmidt, the kernel path lies about as
# far from f32 as the plain bf16 path does.  A kernel fault adds its own error
# on top; the kernel path's gap may be at most 1.5 x the plain path's.
WITNESS_RATIO = 1.5


def _gaps(a, b):
    """(max |a - b|, that over max |b|, ||a - b|| / ||b||)."""
    a, b = a.float(), b.float()
    max_abs = (a - b).abs().max().item()
    rel_max = max_abs / max(b.abs().max().item(), 1e-6)
    rel_fro = ((a - b).norm() / b.norm().clamp_min(1e-6)).item()
    return max_abs, rel_max, rel_fro


def _agree(name, a, b, tol, metric, what="kernels vs plain"):
    """Print the gaps of ``a`` to ``b``; fail unless rel(metric) <= tol
    (with ``tol=None``, only that it is finite).  Returns rel(fro)."""
    max_abs, rel_max, rel_fro = _gaps(a, b)
    value = rel_max if metric == "max" else rel_fro
    ok = math.isfinite(value) and (tol is None or value <= tol)
    held = "a reading, held finite" if tol is None else f"held on rel({metric}) <= {tol:.4g}"
    print(f"   {name}, {what}: max_abs_err {max_abs:.4g}, rel(max) {rel_max:.4g}, "
          f"rel(fro) {rel_fro:.4g}; {held}: {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SmokeFailure(f"{name}: {what} disagree")
    return rel_fro


@contextlib.contextmanager
def _quant(system, on: bool):
    """Sample ``system`` on its W8A8 path (on) or its bf16 path (off); the
    weights and the int8 buffers stay as they are."""
    prev, system.quant_frozen = system.quant_frozen, on
    try:
        yield
    finally:
        system.quant_frozen = prev


def _block_counts(nets):
    """(SA, CA, FFN blocks, modulated FFN blocks) of ``nets``."""
    from mixermdm_tpu_torch.models import layers

    n = collections.Counter(type(m).__name__ for net in nets for m in net.modules()
                            if isinstance(m, layers.Int8Block))
    ffn_mod = sum(1 for net in nets for m in net.modules()
                  if isinstance(m, layers.FFN) and m.norm is not None)
    return n["VanillaSelfAttention"], n["VanillaCrossAttention"], n["FFN"], ffn_mod


def _expected_launches(nets, label):
    """The block kernels one call of ``nets`` launches on the W8A8 or the
    bf16 path, read off their modules.  Per W8A8 call: the int8 products of
    each block, the FFN's first one with the quantising GELU epilogue
    (linear_q8_gelu_q8); the attention of each SA and CA block with its
    quantising epilogue (attention_q8); the quantising prologue for the
    input of each SA block, both inputs of each CA block and each modulated
    FFN input; quant_rows only for an FFN input that is not modulated.  The
    bf16 path runs the same blocks on the bf16 kernels."""
    sa, ca, ffn, ffn_mod = _block_counts(nets)
    if label == "W8A8":
        return {"linear_q8": 2 * sa + 3 * ca + ffn, "linear_q8_gelu_q8": ffn,
                "attention_q8": sa + ca, "quant_rows": ffn - ffn_mod,
                "adaln_modulate_q8": sa + 2 * ca + ffn_mod, "adaln_modulate": 0,
                "fused_sa_block_q8": sa, "fused_ca_block_q8": ca, "fused_ffn_block_q8": ffn,
                "fused_sa_block": 0, "fused_ca_block": 0, "fused_ffn_block": 0}
    return {"linear_q8": 0, "linear_q8_gelu_q8": 0, "attention_q8": 0, "quant_rows": 0,
            "adaln_modulate_q8": 0, "adaln_modulate": sa + 2 * ca + ffn_mod,
            "fused_sa_block_q8": 0, "fused_ca_block_q8": 0, "fused_ffn_block_q8": 0,
            "fused_sa_block": sa, "fused_ca_block": ca, "fused_ffn_block": ffn}


def sample_phase(seed):
    import torch

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.cli.infer_mixermdm import build_system
    from mixermdm_tpu_torch.models import layers

    t0 = time.time()
    system = build_system(None, device="cuda", seed=seed, zero_init_std=0.02)
    torch.cuda.synchronize()
    print(f"   built full-width system in {time.time() - t0:.1f} s: "
          f"{sum(p.numel() for p in system.parameters()) / 1e6:.1f} M parameters, "
          f"compute dtype {system.compute_dtype}, QUANT_FROZEN {system.quant_frozen}",
          flush=True)
    if not system.quant_frozen:
        raise SmokeFailure("the shipped config should sample with QUANT_FROZEN on")
    batch = {
        "text_interaction": [p[0] for p in PROMPTS],
        "text_individual1": [p[1] for p in PROMPTS],
        "text_individual2": [p[2] for p in PROMPTS],
    }
    B, T = len(PROMPTS), 299

    def both(fn):
        k = fn()
        with ops.plain_versions():
            p = fn()
        return k, p

    # The text conds, both denoisers at the step's (CFG x person) batch, and
    # one CFG mixer step, on the kernels and on the plain versions; the
    # networks and the step in bf16 and under W8A8.  The conds come from bf16
    # towers and f32 heads; the f32 twin (every network f32, plain versions)
    # is the witness for them and for the step.
    twin = copy.deepcopy(system).cast_(None)  # f32 networks never run int8
    cond, cond_p = both(lambda: system.generate_cond(batch))
    with ops.plain_versions():
        cond_f = twin.generate_cond(batch)
    _agree("text conds (3 bf16 towers + f32 heads)", cond, cond_p, COND_TOL, "max")
    gap_p = _agree("text conds", cond_p, cond_f, None, "max", "plain vs f32")
    _agree("text conds", cond, cond_f, WITNESS_RATIO * gap_p, "fro",
           f"kernels vs f32 (at most {WITNESS_RATIO} x plain vs f32)")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.randn(B, T, 2 * system.nfeats, generator=gen, device="cuda")
    t = torch.full((B,), 979, dtype=torch.long, device="cuda")
    bf = system.compute_dtype
    with torch.inference_mode():
        x1 = torch.cat([x[..., :system.nfeats], x[..., system.nfeats:]] * 2, 0).to(bf)
        t4 = torch.cat([t] * 4)
        c1 = torch.randn(4 * B, system.text_dim, generator=gen, device="cuda").to(bf)
        c2 = torch.randn(2 * B, 3 * system.text_dim, generator=gen, device="cuda").to(bf)
        d1 = system.model1.denoisers["individual"]
        d2 = system.model2.denoisers["interaction"]
        nets = {}
        for label, scope in (("bf16", contextlib.nullcontext), ("W8A8", layers.w8a8_scope)):
            with scope():
                _agree(f"individual denoiser (8 x 1024-d), {label}",
                       *both(lambda: d1(x1, t4, None, c1)), NET_TOL, "max")
                out_k, out_p = both(lambda: d2(torch.cat([x, x]).to(bf), t4[:2 * B], None, c2))
                _agree(f"interaction denoiser (8 x 1024-d), {label}", out_k, out_p, NET_TOL,
                       "max")
                nets[label] = out_k
    # A reading beside the W8A8 kernels-vs-plain gap above: with random
    # weights int8 moves a denoiser about as far as the int8 rounding flips
    # between kernels and plain versions do, so it is no gate; the step
    # check and the launch counts below are.
    _agree("interaction denoiser", nets["W8A8"], nets["bf16"], None, "fro",
           "W8A8 vs bf16 kernels")
    step = lambda: system.cfg_mixer_step(x, x, t, cond)  # noqa: E731
    with ops.plain_versions():
        step_f = twin.cfg_mixer_step(x, x, t, cond)
    del twin
    torch.cuda.empty_cache()
    steps = {}
    for label, on in (("bf16", False), ("W8A8", True)):
        with _quant(system, on):
            step_k, step_p = both(step)
        name = f"one CFG mixer step, {label}"
        gap = _agree(name, step_k, step_p, STEP_TOL, "fro")
        gap_p = _agree(name, step_p, step_f, None, "fro", f"plain {label} vs f32")
        _agree(name, step_k, step_f, WITNESS_RATIO * gap_p, "fro",
               f"kernels vs f32 (at most {WITNESS_RATIO} x plain {label} vs f32)")
        steps[label] = (step_k, gap)

    # Int8 engaged: the W8A8 step lies farther from the bf16 step of the same
    # weights than the W8A8 kernels lie from their plain versions, and one
    # step launches each kernel as often as the blocks, read off the
    # modules, say (below).
    _agree("one CFG mixer step", steps["W8A8"][0], steps["bf16"][0], None, "fro",
           "W8A8 vs bf16 kernels")
    q8_vs_bf16 = _gaps(steps["W8A8"][0], steps["bf16"][0])[2]
    if not q8_vs_bf16 > steps["W8A8"][1]:
        raise SmokeFailure(f"W8A8 step within {q8_vs_bf16:.4g} of the bf16 step: int8 did not run")
    nets = (system.model1, system.model2, system.core)
    sa, ca, ffn, ffn_mod = _block_counts(nets)
    expected = {label: _expected_launches(nets, label) for label in ("W8A8", "bf16")}
    for label, on in (("W8A8", True), ("bf16", False)):
        with _quant(system, on):
            ops.reset_launch_counts()
            step()
            torch.cuda.synchronize()
        got = {k: int(ops.launches.get(k, 0)) for k in expected[label]}
        print(f"   launches in one {label} step: {json.dumps(got)}; from the modules "
              f"({sa} SA, {ca} CA, {ffn} FFN blocks, {ffn_mod} of them modulated): "
              f"{json.dumps(expected[label])}", flush=True)
        if got != expected[label]:
            raise SmokeFailure(f"{label} step launches differ from the count read off the modules")

    # Where one step's time goes: the eager device timeline against the same
    # step's kernels replayed as one CUDA graph (no host work in between).
    for label, on in (("bf16", False), ("W8A8", True)):
        with _quant(system, on):
            eager = timed(step, reps=5, warmup=1)
            replay = graph_timed(step, reps=1, replays=5)
        print(f"   one CFG mixer step, {label} (B={B}, T={T}): eager {eager:.3f} ms, CUDA-graph "
              f"replay {replay:.3f} ms; device idle in eager {1 - replay / eager:.3f}",
              flush=True)

    return system, batch


def sample_main_paths(system, batch, seed):
    """The main paths, counted: text encoding + the whole DDIM chain, on the
    bf16 path and on the shipped W8A8 path."""
    import torch

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.ops import _lib

    B, T = len(PROMPTS), 299
    counts = {}
    for label, on in (("bf16", False), ("W8A8", True)):
        with _quant(system, on):
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            cond = system.generate_cond(batch)
            torch.cuda.synchronize()
            t1 = time.time()
            text_shapes = collections.Counter(_lib.launch_shapes)
            out = system.sample(cond, T,
                                generator=torch.Generator(device="cuda").manual_seed(seed))
            torch.cuda.synchronize()
            t2 = time.time()
            counts[label] = dict(ops.launches)
            chain_shapes = collections.Counter(_lib.launch_shapes) - text_shapes
        n_steps = system.sample_schedule.num_timesteps
        # The GEMM launches by (route, M, K, N, epilogue): per request for the
        # text, per DDIM step for the chain.
        hist = [{"route": k[0], "M": k[1], "K": k[2], "N": k[3], "epilogue": k[4],
                 "text": text_shapes.get(k, 0), "per_ddim_step": chain_shapes.get(k, 0) / n_steps}
                for k in sorted(set(text_shapes) | set(chain_shapes))]
        print(f"   GEMM launches in the {label} path by shape: {json.dumps(hist)}", flush=True)
        print(f"   {label} path: generate_cond {t1 - t0:.3f} s; sample: output "
              f"{tuple(out.shape)} {out.dtype}, {t2 - t1:.3f} s for {n_steps} DDIM steps = "
              f"{(t2 - t1) / n_steps:.4f} s/step (B={B}, T={T}); max |out| "
              f"{out.abs().max().item():.4g}", flush=True)
        print(f"   launches in the {label} path: {json.dumps(counts[label], sort_keys=True)}",
              flush=True)
        if tuple(out.shape) != (B, T, 2 * system.nfeats):
            raise SmokeFailure(f"{label} sample shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            raise SmokeFailure(f"{label} sample output is not finite")
    return counts


# --------------------------------------------------------------------------
# Phase 5b: the inference surface at full width
# --------------------------------------------------------------------------

# The DPM-Solver++ run of the CLI: 25 steps, the first 5 skipped.
DPM_STEPS, DPM_SKIP = 25, 5
# serve at bench.py's workload: B 10, T 299, DDIM-50, W8A8.
SERVE_B = 10


def _save_released(system, root):
    """The three released files of ``system`` (the mixer file without its
    CLIP tower, as the released MixerMDM.ckpt drops it); their paths."""
    import torch

    from mixermdm_tpu_torch.weights import released_in2in_state_dict, \
        released_mixermdm_state_dict

    files = (f"{root}/MixerMDM.ckpt", f"{root}/individual.ckpt", f"{root}/interaction.ckpt")
    torch.save({"state_dict": released_mixermdm_state_dict(system, with_clip=False)}, files[0])
    torch.save({"state_dict": released_in2in_state_dict(system.model1, "individual")}, files[1])
    torch.save({"state_dict": released_in2in_state_dict(system.model2, "interaction")}, files[2])
    return files


def _int8_buffers(system):
    from mixermdm_tpu_torch.models import layers

    return {f"{name}.{src}_{kind}": getattr(m, f"{src}_{kind}")
            for name, m in system.named_modules() if isinstance(m, layers.Int8Block)
            for src in m._int8_sources() for kind in ("q8", "scale")
            if hasattr(m, f"{src}_{kind}")}


def _request(url, body=None, timeout=600):
    """(status, json) of GET ``url`` or POST ``body`` to it."""
    import urllib.error
    import urllib.request

    data = None if body is None else (body if isinstance(body, bytes)
                                      else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def surface_phase(system, seed, card):
    """The inference surface on the card, on files written from ``system``
    (the shipped config's W8A8 system of phases 4-5):

    (a) the three released files load into a system built from another
        seed: every parameter bitwise, the unfilled list exactly the mixer's
        CLIP tower, every Int8Block's int8 weights and scales equal, and one
        W8A8 CFG mixer step the same bits on both systems;
    (b) ``infer-mixermdm`` in-process on those files: B 2, T 299,
        DPM-Solver++ 25 with 5 skipped, trajectory control and a warm start
        from a motion it writes, the individual prompts decomposed; finite,
        non-zero motions, influence histories of 20 steps, and launches of
        20 W8A8 steps plus one text encoding;
    (c) one DPM-Solver++ step (trajectory control on, a multistep step) at
        phase 4's input on the kernels against the plain versions: its x0
        and its update of the latents on STEP_TOL and on phase 4's witness
        against an f32 twin;
    (d) ``serve`` in-process at B 10, T 299, DDIM-50, W8A8 on the files: warm
        after start-up, a seeded request twice the same bytes and equal to
        ``sample`` on the padded batch, three concurrent unseeded requests
        of 3 rows in one dispatch, 400 for a malformed request.

    Returns the readings for the summary."""
    import base64
    import io
    import os
    import tempfile
    import threading

    import numpy as np
    import torch

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.cli import infer_mixermdm, serve
    from mixermdm_tpu_torch.cli.infer_mixermdm import build_system
    from mixermdm_tpu_torch.diffusion.mixer_diffusion import dpmpp_step
    from mixermdm_tpu_torch.diffusion.gaussian import _apply_traj_control, dpmpp_coefficients
    from mixermdm_tpu_torch.diffusion.schedule import named_schedule
    from mixermdm_tpu_torch.train.checkpoint import load_released_mixermdm

    B, T, F = len(PROMPTS), 299, system.nfeats
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    x = torch.randn(B, T, 2 * F, generator=gen, device="cuda")
    t = torch.full((B,), 979, dtype=torch.long, device="cuda")
    batch = {"text_interaction": [p[0] for p in PROMPTS],
             "text_individual1": [p[1] for p in PROMPTS],
             "text_individual2": [p[2] for p in PROMPTS]}
    cond = system.generate_cond(batch)
    readings = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_surface_") as tmp:
        # (a) checkpoint round trip
        t0 = time.time()
        files = _save_released(system, tmp)
        t1 = time.time()
        other = build_system(None, device="cuda", seed=seed + 7, zero_init_std=0.02)
        with torch.inference_mode():
            unfilled = load_released_mixermdm(other, *files)
        torch.cuda.synchronize()
        t2 = time.time()
        mb = sum(os.path.getsize(f) for f in files) / 2**20
        print(f"   (a) wrote the 3 released files ({mb:.0f} MiB) in {t1 - t0:.1f} s, built a "
              f"system from seed {seed + 7} and loaded them in {t2 - t1:.1f} s", flush=True)
        tower = sorted(k for k, _ in other.named_parameters() if k.startswith("text.clip."))
        if unfilled != tower:
            raise SmokeFailure(f"unfilled after the load: {unfilled[:5]}... (want the mixer's "
                               f"CLIP tower, {len(tower)} tensors)")
        src = dict(system.named_parameters())
        differ = [k for k, p in other.named_parameters()
                  if k not in unfilled and not torch.equal(p, src[k])]
        # The W8A8 step quantises the loaded weights again (each block keys
        # its int8 cache on its weights' versions); then the buffers match.
        with _quant(system, True), _quant(other, True):
            step_a, step_b = (s.cfg_mixer_step(x, x, t, cond) for s in (system, other))
        same_step = torch.equal(step_a, step_b)
        q8_src, q8_dst = _int8_buffers(system), _int8_buffers(other)
        q8_differ = [k for k in q8_src if k not in q8_dst or not torch.equal(q8_src[k], q8_dst[k])]
        print(f"   (a) {len(src) - len(unfilled)} parameters bitwise equal: "
              f"{'ok' if not differ else 'FAIL ' + str(differ[:3])}; unfilled = the mixer's "
              f"CLIP tower ({len(tower)} tensors): ok; {len(q8_src)} int8 buffers equal: "
              f"{'ok' if not q8_differ and q8_src else 'FAIL ' + str(q8_differ[:3])}; one W8A8 "
              f"CFG mixer step bitwise equal: {'ok' if same_step else 'FAIL'}", flush=True)
        if differ or q8_differ or not q8_src or not same_step:
            raise SmokeFailure("the released files did not load back bit for bit")
        del other, step_b
        torch.cuda.empty_cache()

        # (b) the CLI: DPM-Solver++ 25, skip 5, trajectory control, warm start
        with _quant(system, True):
            ops.reset_launch_counts()
            system.cfg_mixer_step(x, x, t, cond)
            torch.cuda.synchronize()
            step_counts = collections.Counter(ops.launches)
            ops.reset_launch_counts()
            system.generate_cond({k: [v[0]] * B for k, v in batch.items()})
            torch.cuda.synchronize()
            text_counts = collections.Counter(ops.launches)
        motion = np.random.default_rng(seed).standard_normal((T - 40, 2 * F)).astype(np.float32)
        np.save(f"{tmp}/control.npy", 0.5 * motion)
        argv = ["--name", "surface", "--out-dir", f"{tmp}/out", "--num-samples", str(B),
                "--window", str(T), "--seed", str(seed + 11),
                "--text-interaction", "one person pushes the other, who stumbles back",
                "--sampler", "dpmpp", "--sample-steps", str(DPM_STEPS),
                "--skip-timesteps", str(DPM_SKIP), "--traj-control", f"{tmp}/control.npy",
                "--warm-start", f"{tmp}/control.npy", "--checkpoint", files[0],
                "--ckpt-individual", files[1], "--ckpt-interaction", files[2]]
        out = io.StringIO()
        ops.reset_launch_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(out):
            infer_mixermdm.main(argv)
        torch.cuda.synchronize()
        t_cli = time.time() - t0
        cli_counts = collections.Counter(ops.launches)
        for line in out.getvalue().splitlines():
            print(f"   (b) | {line}", flush=True)
        sampled_s = [float(line.split(" in ")[1].split(" s")[0])
                     for line in out.getvalue().splitlines() if line.startswith("sampled ")]
        n_steps = DPM_STEPS - DPM_SKIP
        motions = np.load(f"{tmp}/out/surface_motion.npy")
        infl = np.load(f"{tmp}/out/surface_influence_i1.npy")
        want = {k: n_steps * step_counts[k] + text_counts[k]
                for k in set(step_counts) | set(text_counts)}
        said = out.getvalue()
        ok = (motions.shape == (B, T, 2 * F) and bool(np.isfinite(motions).all())
              and float(np.abs(motions).max()) > 0 and infl.shape == (n_steps, B, T, F)
              and dict(cli_counts) == want and len(sampled_s) == 1
              and "decomposed individual prompts" in said
              and ("(skipped video render" in said or "influence plot:" in said))
        readings["dpmpp"] = {"s_per_request": sampled_s[0] if sampled_s else None,
                             "cli_wall_s": t_cli, "launches": sum(cli_counts.values()),
                             "B": B, "T": T, "steps": n_steps}
        print(f"   (b) infer-mixermdm, DPM-Solver++ {DPM_STEPS} skip {DPM_SKIP} (B={B}, T={T}): "
              f"output {motions.shape}, max |out| {float(np.abs(motions).max()):.4g}, influence "
              f"{infl.shape}; {t_cli:.1f} s for the CLI, {sampled_s[0] if sampled_s else '?'} s "
              f"for the request (text + {n_steps} steps) on {card}; launches "
              f"{sum(cli_counts.values())} = {n_steps} x {sum(step_counts.values())} (one W8A8 "
              f"step) + {sum(text_counts.values())} (text): "
              f"{'ok' if dict(cli_counts) == want else 'FAIL'}", flush=True)
        if not ok:
            raise SmokeFailure(f"the CLI's DPM-Solver++ run: counts {dict(cli_counts)} vs "
                               f"{want}, or its output is wrong")

        # (c) one DPM-Solver++ step, kernels vs plain, at phase 4's input:
        # its latents (seed + 1) and conds at t = 979, which is step j = 1 (a
        # multistep step, c2 > 0) of the 1000-step chain entered at chain
        # index 980 (19 steps skipped), with the root trajectory pinned.
        # Held as phase 4 holds its step, on STEP_TOL and on the witness
        # against an f32 twin: the step's x0 (the CFG mixer step's raw
        # output, and its split into the two model spaces) and each stream's
        # update, sig_ratio * pinned latent - next latent = alp_next * phi *
        # D, which is where the x0 enters the next latents.
        s = named_schedule(system.cfg.BETA_SCHEDULER, int(system.cfg.DIFFUSION_STEPS),
                           device="cuda")
        n_eff, j = 981, 1
        coefs = dpmpp_coefficients(s, n_eff)
        if int(s.timestep_map[n_eff - 1 - j]) != int(t[0]):
            raise SmokeFailure("phase 5b (c) does not sit at phase 4's timestep")
        x4 = torch.randn(B, T, 2 * F, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(seed + 1))
        prev = torch.randn(B, T, 2 * F, generator=gen, device="cuda")
        ctl = torch.randn(B, T, 2 * F, generator=gen, device="cuda")
        pinned = _apply_traj_control(x4, ctl)

        def one_step(sys_):
            raw = []

            def mixer(a, b, tt, m, c):
                raw.append(sys_.cfg_mixer_step(a, b, tt, c, m))
                return raw[-1]

            with torch.inference_mode():
                nxt, nxt2, x0, x02 = dpmpp_step(
                    mixer, s, coefs, j, x4, x4, prev, prev, cond, normalizer1=sys_.normalizer1,
                    normalizer2=sys_.normalizer2, align=sys_.align, nfeats=F, traj_control=ctl)
                return {"x0, raw (the CFG mixer step)": raw[0], "x0, model-1 space": x0,
                        "x0, model-2 space": x02,
                        "update, model-1 space": coefs[0][j] * pinned - nxt,
                        "update, model-2 space": coefs[0][j] * pinned - nxt2}

        twin = copy.deepcopy(system).cast_(None)
        with _quant(system, True):
            got = one_step(system)
            with ops.plain_versions():
                plain = one_step(system)
                f32 = one_step(twin)
        del twin
        torch.cuda.empty_cache()
        name = "one DPM-Solver++ step with trajectory control, W8A8"
        for what in got:
            _agree(f"{name}: {what}", got[what], plain[what], STEP_TOL, "fro")
            gap_p = _agree(f"{name}: {what}", plain[what], f32[what], None, "fro",
                           "plain W8A8 vs f32")
            _agree(f"{name}: {what}", got[what], f32[what], WITNESS_RATIO * gap_p, "fro",
                   f"kernels vs f32 (at most {WITNESS_RATIO} x plain W8A8 vs f32)")

        # (d) serve at B 10, T 299, DDIM-50, W8A8
        t0 = time.time()
        server, batcher, state = serve.make_server(
            ["--batch-size", str(SERVE_B), "--window", str(T), "--port", "0",
             "--seed", str(seed + 13), "--checkpoint", files[0], "--ckpt-individual", files[1],
             "--ckpt-interaction", files[2]])
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            print(f"   (d) serve up and warm in {time.time() - t0:.1f} s (B={SERVE_B}, T={T}, "
                  f"{state['system'].sample_schedule.num_timesteps} {state['system'].sampler_type}"
                  f" steps, QUANT_FROZEN {state['system'].quant_frozen})", flush=True)
            code, health = _request(url + "/healthz")
            if code != 200 or not health.get("warm"):
                raise SmokeFailure(f"/healthz after start-up: {code} {health}")
            body = {"text_interaction": PROMPTS[0][0], "text_individual1": PROMPTS[0][1],
                    "text_individual2": PROMPTS[0][2], "num_samples": 3, "seed": 11}
            latencies = []
            answers = []
            for _ in range(2):
                ops.reset_launch_counts()
                t1 = time.time()
                code, resp = _request(url + "/generate", body)
                latencies.append(time.time() - t1)
                if code != 200:
                    raise SmokeFailure(f"seeded request: {code} {resp}")
                answers.append(resp["motion_npy_b64"])
                print(f"   (d) seeded request (3 rows, seed 11): {code}, {latencies[-1]:.3f} s "
                      f"at the client, {resp['latency_s']} s in the server", flush=True)
            serve_launches = sum(ops.launches.values())
            srv = state["system"]
            padded = {k: [body[k]] * SERVE_B for k in serve.TEXT_KEYS}
            direct = srv.sample(srv.generate_cond(padded), T,
                                generator=torch.Generator(device="cuda").manual_seed(11))
            got = np.load(io.BytesIO(base64.b64decode(answers[0])))
            same = answers[0] == answers[1]
            equal = bool(np.array_equal(got, direct[:3].float().cpu().numpy()))
            print(f"   (d) the two answers identical bytes: {'ok' if same else 'FAIL'}; equal to "
                  f"sample() on the padded batch: {'ok' if equal else 'FAIL'}", flush=True)
            if not (same and equal):
                raise SmokeFailure("a seeded request is not reproducible")
            # Three unseeded requests of 3 rows queue behind a seeded one and
            # go out as one dispatch.
            before = batcher.batches
            results = {}

            def post(i, b):
                t1 = time.time()
                results[i] = (_request(url + "/generate", b), time.time() - t1)

            blocker = threading.Thread(target=post, args=("seeded", body))
            blocker.start()
            time.sleep(0.3)
            unseeded = {k: v for k, v in body.items() if k != "seed"}
            threads = [threading.Thread(target=post, args=(i, unseeded)) for i in range(3)]
            for th in threads:
                th.start()
            for th in [blocker] + threads:
                th.join(timeout=300)
            codes = {i: r[0][0] for i, r in results.items()}
            seeds = {r[0][1].get("seed") for i, r in results.items() if i != "seeded"}
            dispatches = batcher.batches - before
            for i, ((code, resp), dt) in sorted(results.items(), key=str):
                print(f"   (d) {'seeded' if i == 'seeded' else 'unseeded'} request {i}: {code}, "
                      f"{dt:.3f} s at the client, dispatch seed {resp.get('seed')}", flush=True)
            print(f"   (d) dispatches for the seeded + 3 unseeded requests: {dispatches} "
                  f"(want 2), one dispatch seed among the unseeded: {len(seeds) == 1}",
                  flush=True)
            if set(codes.values()) != {200} or dispatches != 2 or len(seeds) != 1:
                raise SmokeFailure(f"the unseeded requests did not coalesce: {codes}, "
                                   f"{dispatches} dispatches, seeds {seeds}")
            code, resp = _request(url + "/generate", {"text_interaction": "no other texts"})
            print(f"   (d) malformed request: {code} ({resp.get('error', '')[:60]})", flush=True)
            if code != 400:
                raise SmokeFailure(f"a malformed request got {code}")
            code, health = _request(url + "/healthz")
            print(f"   (d) /healthz: {json.dumps(health)}; on {card}", flush=True)
            readings["serve"] = {"s_per_request": latencies, "launches": serve_launches,
                                 "B": SERVE_B, "T": T, "dispatches": health["batches"]}
        finally:
            server.shutdown()
            server.server_close()
            batcher.stop()
            del state
            torch.cuda.empty_cache()
    return readings


# --------------------------------------------------------------------------
# Phase 5c: the base-model systems at full width
# --------------------------------------------------------------------------

# The base models' requests: B 2; in2IN at the infer-in2in window (T 210),
# MDM at infer-mdm's (T 196), InterGen at in2IN's; DDIM-50.  The dual run
# also pins a trajectory and starts warm, BASE_SKIP steps down the chain.
BASE_B, IN2IN_T, MDM_T, BASE_SKIP = 2, 210, 196, 10
# The chain index of the first CFG step held in (a) and of the one in (c):
# the first step of DDIM-50 (original timestep 980).
BASE_STEP = 49


@contextlib.contextmanager
def _plain_calls():
    """Count the entry points' choices of their plain versions inside the
    block (``ops._lib.use_plain`` answering yes); yields a one-item list."""
    from mixermdm_tpu_torch.ops import _lib

    n, orig = [0], _lib.use_plain

    def counted(x):
        r = orig(x)
        n[0] += bool(r)
        return r

    _lib.use_plain = counted
    try:
        yield n
    finally:
        _lib.use_plain = orig


def _hold_step(name, run, system, twin):
    """``run(sys_)`` -> {what: tensor} on the kernels, on the plain versions
    and on the f32 twin (plain versions): each on STEP_TOL (rel fro) and the
    witness, as phase 4 holds its step."""
    from mixermdm_tpu_torch import ops

    got = run(system)
    with ops.plain_versions():
        plain, f32 = run(system), run(twin)
    for what in got:
        _agree(f"{name}: {what}", got[what], plain[what], STEP_TOL, "fro")
        gap_p = _agree(f"{name}: {what}", plain[what], f32[what], None, "fro", "plain vs f32")
        _agree(f"{name}: {what}", got[what], f32[what], WITNESS_RATIO * gap_p, "fro",
               f"kernels vs f32 (at most {WITNESS_RATIO} x plain vs f32)")


def _base_step(system, x, cond):
    """Two CFG steps of a base-model system from chain index BASE_STEP: the
    first step's x0, and the update of the two (the latent two steps on,
    minus ``x``), the second step taken from the first step's own latent.
    The update holds what the first x0 does not fix: the network again, at
    the latent that the first step made."""
    import torch

    from mixermdm_tpu_torch.diffusion.gaussian import ddim_step
    from mixermdm_tpu_torch.models.layers import w8a8_scope

    s = system.sample_schedule
    t = torch.full((x.shape[0],), BASE_STEP, dtype=torch.long, device=x.device)
    model = system.cfg_model()
    with torch.inference_mode(), w8a8_scope(system.quant):
        x0 = model(x, s.timestep_map[t], None, cond)
        x1 = ddim_step(s, x, t, x0)
        x2 = ddim_step(s, x1, t - 1, model(x1, s.timestep_map[t - 1], None, cond))
    return {"x0": x0, "update": x2 - x}


def _hold_network(name, fn):
    import torch

    from mixermdm_tpu_torch import ops

    with torch.inference_mode():
        k = fn()
        with ops.plain_versions():
            p = fn()
    _agree(name, k, p, NET_TOL, "max")


def _run_cli(label, main, argv, out_dir, name, want_shape, card):
    """One CLI run in-process, counted: its launches per kernel, the plain
    versions it chose (none allowed), its seconds per request; the output
    finite, non-zero and of ``want_shape``."""
    import io

    import numpy as np
    import torch

    from mixermdm_tpu_torch import ops

    out = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.time()
    with _plain_calls() as plain, contextlib.redirect_stdout(out):
        main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(ops.launches)
    gemms = sorted(ops._lib.launch_shapes.items(), key=lambda kv: -kv[1])
    for line in out.getvalue().splitlines():
        print(f"   (b) | {line}", flush=True)
    print(f"   (b) {label}: GEMM launches per request by (route, M, K, N, epilogue): "
          f"{json.dumps([[*k, n] for k, n in gemms])}", flush=True)
    said = [float(line.split(" in ")[1].split(" s")[0])
            for line in out.getvalue().splitlines() if line.startswith("sampled ")]
    motions = np.load(f"{out_dir}/{name}_motion.npy")
    ok = (motions.shape == want_shape and bool(np.isfinite(motions).all())
          and float(np.abs(motions).max()) > 0 and plain[0] == 0 and len(said) == 1)
    print(f"   (b) {label}: output {motions.shape}, max |out| {float(np.abs(motions).max()):.4g}; "
          f"{said[0] if said else '?'} s per request, {wall:.1f} s for the CLI, on {card}; plain "
          f"versions chosen: {plain[0]}; launches per request: {json.dumps(counts, sort_keys=True)}"
          f": {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SmokeFailure(f"{label}: wrong output or a plain version chosen")
    return {"s_per_request": said[0], "cli_wall_s": wall, "launches": counts}


def _same_params(label, got, sources):
    """Every parameter of ``got`` bitwise the one of the same name in the
    first of ``sources`` (name -> module) whose key prefix matches."""
    import torch

    differ = []
    for k, p in got.named_parameters():
        src = next(m for pre, m in sources if k.startswith(pre))
        if not torch.equal(p, dict(src.named_parameters())[k]):
            differ.append(k)
    n = sum(1 for _ in got.parameters())
    print(f"   (b) {label}: {n - len(differ)}/{n} parameters bitwise equal to the written system: "
          f"{'ok' if not differ else 'FAIL ' + str(differ[:3])}", flush=True)
    if differ:
        raise SmokeFailure(f"{label}: the released files did not load back bit for bit")


def base_models_phase(seed, card):
    """The base-model systems on the card at full published width, random
    weights from ``seed``:

    (a) per family (in2IN interaction with its 4-way CFG, in2IN individual,
        DualMDM's two denoisers and blend, MDM, InterGen) one network
        forward at the CFG batch on NET_TOL and two CFG steps (the first
        x0, the two steps' update) on STEP_TOL and the witness, kernels vs
        plain, at B 2; two W8A8 steps of in2IN interaction (QUANT: true)
        likewise, their launches read off the modules;
    (b) the released files of in2IN (interaction, individual) and MDM,
        written from those systems, load back bitwise (the dual pair
        merged); then ``infer-in2in`` in its three modes (B 2, T 210,
        DDIM-50; dual with trajectory control and a warm start) and
        ``infer-mdm`` (B 2, T 196) in-process on them, counted per kernel,
        no plain version chosen;
    (c) ``build_mixer_system`` with MDM as MODEL1 and InterGen as MODEL2:
        one CFG mixer step, bf16 and W8A8, kernels vs plain on STEP_TOL and
        the witness.

    Returns (readings, launches per request by path)."""
    import tempfile

    import numpy as np
    import torch

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.cli import infer_in2in, infer_mdm
    from mixermdm_tpu_torch.config import INTERGEN_DEFAULT, MDM_DEFAULT, MIXERMDM_DEFAULT
    from mixermdm_tpu_torch.models.clip_text import ClipTextConfig
    from mixermdm_tpu_torch.systems.intergen import InterGenSystem
    from mixermdm_tpu_torch.systems.mixermdm import build_mixer_system
    from mixermdm_tpu_torch.train.checkpoint import load_released_in2in, load_released_mdm, \
        save_released
    from mixermdm_tpu_torch.weights import init_params_, released_in2in_state_dict, \
        released_mdm_state_dict

    B = BASE_B
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    texts = {"text": [p[0] for p in PROMPTS], "text_individual1": [p[1] for p in PROMPTS],
             "text_individual2": [p[2] for p in PROMPTS]}
    bf = torch.bfloat16
    readings, counts = {}, {}

    def twin_of(system):
        return copy.deepcopy(system).cast_(None)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_base_") as tmp:
        files = {}
        # (a) in2IN interaction: 4-way CFG, bf16, then W8A8
        t0 = time.time()
        inter = infer_in2in.build_system(None, "interaction", device="cuda", seed=seed,
                                         zero_init_std=0.02)
        cond = inter.build_cond(texts)
        x = torch.randn(B, IN2IN_T, 2 * inter.nfeats, generator=gen, device="cuda")
        t = torch.full((4 * B,), int(inter.sample_schedule.timestep_map[BASE_STEP]),
                       device="cuda")
        td = inter.text_dim
        c4 = torch.cat([cond, torch.cat([cond[:, :td], torch.zeros_like(cond[:, td:])], 1),
                        torch.cat([torch.zeros_like(cond[:, :td]), cond[:, td:]], 1),
                        torch.zeros_like(cond)])
        den = inter.denoisers["interaction"]
        print(f"   (a) built in2IN interaction (1024-d, 8 x 8 heads, FF 2048, ViT-L/14) in "
              f"{time.time() - t0:.1f} s", flush=True)
        _hold_network("(a) in2IN interaction denoiser at the 4-way CFG batch",
                      lambda: den(torch.cat([x] * 4).to(bf), t, None, c4.to(bf)))
        twin = twin_of(inter)
        _hold_step("(a) in2IN interaction, two 4-way CFG steps, bf16",
                   lambda sys_: _base_step(sys_, x, cond), inter, twin)
        inter.quant = True
        inter.cast_(bf)  # quantises the blocks' int8 weights
        ops.reset_launch_counts()
        _base_step(inter, x, cond)
        torch.cuda.synchronize()
        want = {k: 2 * n for k, n in _expected_launches([den], "W8A8").items()}
        got = {k: int(ops.launches.get(k, 0)) for k in want}
        print(f"   (a) launches in two W8A8 4-way CFG steps of in2IN interaction: "
              f"{json.dumps(got)}; from the modules: {json.dumps(want)}", flush=True)
        if got != want:
            raise SmokeFailure("the W8A8 in2IN steps' launches differ from the modules' count")
        _hold_step("(a) in2IN interaction, two 4-way CFG steps, W8A8 (QUANT: true)",
                   lambda sys_: _base_step(sys_, x, cond), inter, twin)
        inter.quant = False
        del twin
        files["interaction"] = f"{tmp}/interaction.ckpt"
        save_released(files["interaction"], released_in2in_state_dict(inter, "interaction"))

        # (a) in2IN individual
        ind = infer_in2in.build_system(None, "individual", device="cuda", seed=seed + 1,
                                       zero_init_std=0.02)
        cond_i = ind.build_cond(texts)
        xi = torch.randn(B, IN2IN_T, ind.nfeats, generator=gen, device="cuda")
        t2 = t[:2 * B]
        d_i = ind.denoisers["individual"]
        _hold_network("(a) in2IN individual denoiser at the CFG batch",
                      lambda: d_i(torch.cat([xi] * 2).to(bf), t2, None,
                                  torch.cat([cond_i, torch.zeros_like(cond_i)]).to(bf)))
        _hold_step("(a) in2IN individual, two CFG steps", lambda sys_: _base_step(sys_, xi, cond_i),
                   ind, twin_of(ind))
        files["individual"] = f"{tmp}/individual.ckpt"
        save_released(files["individual"], released_in2in_state_dict(ind, "individual"))

        # (a) DualMDM: its two denoisers on the 5-slice cond, and the blend
        dual = infer_in2in.build_system(None, "dual", device="cuda", seed=seed + 2,
                                        zero_init_std=0.02)
        cond_d = dual.build_cond(texts)
        c2 = torch.cat([cond_d, torch.zeros_like(cond_d)]).to(bf)
        for name in ("interaction", "individual"):
            dn = dual.denoisers[name]
            _hold_network(f"(a) DualMDM {name} denoiser at the CFG batch",
                          lambda: dn(torch.cat([x] * 2).to(bf), t2, None, c2))
        _hold_step("(a) DualMDM, two CFG steps (both denoisers, the blend)",
                   lambda sys_: _base_step(sys_, x, cond_d), dual, twin_of(dual))
        del dual

        # (a) MDM
        mdm = infer_mdm.build_system(None, device="cuda", seed=seed + 3, zero_init_std=0.02)
        cond_m = mdm.text_process(texts["text_individual1"])
        xm = torch.randn(B, MDM_T, mdm.nfeats, generator=gen, device="cuda")
        print(f"   (a) built MDM (512-d, 8 x 4 heads, FF 1024, ViT-B/32); cond "
              f"{tuple(cond_m.shape)}", flush=True)
        _hold_network("(a) MDM denoiser at the CFG batch",
                      lambda: mdm.denoiser(torch.cat([xm] * 2).to(bf), t2, None,
                                           torch.cat([cond_m, torch.zeros_like(cond_m)]).to(bf)))
        _hold_step("(a) MDM, two CFG steps", lambda sys_: _base_step(sys_, xm, cond_m), mdm,
                   twin_of(mdm))
        files["mdm"] = f"{tmp}/mdm.ckpt"
        save_released(files["mdm"], released_mdm_state_dict(mdm))

        # (a) InterGen
        ig = init_params_(InterGenSystem(INTERGEN_DEFAULT, clip_cfg=ClipTextConfig.vit_l_14()),
                          seed + 4, 0.02)
        cond_g = ig.text_process(texts["text"])
        _hold_network("(a) InterGen denoiser at the CFG batch",
                      lambda: ig.denoiser(torch.cat([x] * 2).to(bf), t2, None,
                                          torch.cat([cond_g, torch.zeros_like(cond_g)]).to(bf)))
        _hold_step("(a) InterGen, two CFG steps", lambda sys_: _base_step(sys_, x, cond_g), ig,
                   twin_of(ig))
        del ig
        torch.cuda.empty_cache()

        # (b) the files load back bitwise, then the CLIs on them
        other = infer_in2in.build_system(None, "interaction", device="cuda", seed=seed + 7)
        if load_released_in2in(other, files["interaction"], strict=True):
            raise SmokeFailure("the interaction file left parameters unfilled")
        _same_params("interaction file", other, [("", inter)])
        other = infer_in2in.build_system(None, "individual", device="cuda", seed=seed + 7)
        load_released_in2in(other, files["individual"], strict=True)
        _same_params("individual file", other, [("", ind)])
        other = infer_in2in.build_system(None, "dual", device="cuda", seed=seed + 7)
        load_released_in2in(other, files["interaction"], files["individual"], strict=True)
        _same_params("the dual pair, merged", other,
                     [("denoisers.individual.", ind), ("text.post.individual.", ind),
                      ("", inter)])
        other = infer_mdm.build_system(None, device="cuda", seed=seed + 7)
        load_released_mdm(other, files["mdm"], strict=True)
        _same_params("MDM file", other, [("", mdm)])
        del other, inter, ind, mdm
        torch.cuda.empty_cache()

        motion = np.random.default_rng(seed).standard_normal((IN2IN_T - 40, 524))
        np.save(f"{tmp}/control.npy", (0.5 * motion).astype(np.float32))
        common = ["--num-samples", str(B), "--out-dir", f"{tmp}/out", "--seed", str(seed + 11)]
        runs = {
            "interaction": ["--mode", "interaction", "--checkpoint", files["interaction"]],
            "individual": ["--mode", "individual", "--checkpoint", files["individual"]],
            "dual": ["--mode", "dual", "--checkpoint", files["interaction"],
                     "--ckpt-individual", files["individual"], "--traj-control",
                     f"{tmp}/control.npy", "--warm-start", f"{tmp}/control.npy",
                     "--skip-timesteps", str(BASE_SKIP)],
        }
        for mode, extra in runs.items():
            argv = ["--name", mode, "--text", PROMPTS[0][0], "--text-individual1", PROMPTS[0][1],
                    "--text-individual2", PROMPTS[0][2], "--window", str(IN2IN_T), "--strict",
                    *extra, *common]
            width = 262 if mode == "individual" else 524
            r = _run_cli(f"infer-in2in --mode {mode}", infer_in2in.main, argv, f"{tmp}/out",
                         mode, (B, IN2IN_T, width), card)
            readings[f"infer-in2in {mode}"] = r
            counts[f"in2in {mode}"] = r["launches"]
        r = _run_cli("infer-mdm", infer_mdm.main,
                     ["--name", "mdm", "--text", PROMPTS[0][1], "--window", str(MDM_T),
                      "--checkpoint", files["mdm"], "--strict", *common],
                     f"{tmp}/out", "mdm", (B, MDM_T, 262), card)
        readings["infer-mdm"] = r
        counts["mdm"] = r["launches"]

    # (c) the mixer with MDM as MODEL1 and InterGen as MODEL2
    t0 = time.time()
    mixer = init_params_(build_mixer_system(MIXERMDM_DEFAULT, MDM_DEFAULT, INTERGEN_DEFAULT,
                                            clip_cfg=ClipTextConfig.vit_l_14(), device="cuda"),
                         seed + 6, 0.02)
    batch = {"text_interaction": texts["text"], "text_individual1": texts["text_individual1"],
             "text_individual2": texts["text_individual2"]}
    cond = mixer.generate_cond(batch)
    print(f"   (c) built the mixer with MDM (MODEL1) and InterGen (MODEL2) in "
          f"{time.time() - t0:.1f} s; cond {tuple(cond.shape)}, slices "
          f"{json.dumps(mixer.mixer_cfg.cond_slices())}", flush=True)
    xx = torch.randn(B, IN2IN_T, 2 * mixer.nfeats, generator=gen, device="cuda")
    tt = torch.full((B,), 979, dtype=torch.long, device="cuda")
    twin = twin_of(mixer)
    for label, on in (("bf16", False), ("W8A8", True)):
        with _quant(mixer, on):
            _hold_step(f"(c) one CFG mixer step, MDM + InterGen, {label}",
                       lambda sys_: {"x0": sys_.cfg_mixer_step(xx, xx, tt, cond)}, mixer, twin)
    with _quant(mixer, True):
        ops.reset_launch_counts()
        mixer.cfg_mixer_step(xx, xx, tt, cond)
        torch.cuda.synchronize()
    q8 = {k: int(v) for k, v in ops.launches.items() if "q8" in k}
    print(f"   (c) launches of the int8 kernels in one W8A8 step: {json.dumps(q8)}", flush=True)
    if not q8.get("linear_q8") or not q8.get("attention_q8"):
        raise SmokeFailure("the W8A8 mixer step with InterGen launched no int8 kernel")
    del mixer, twin
    torch.cuda.empty_cache()
    return readings, counts


# --------------------------------------------------------------------------
# Phase 6: adversarial training at full width
# --------------------------------------------------------------------------

MODEL_CFG, TRAIN_CFG = "configs/models/MixerMDM.yaml", "configs/train/MixerMDM.yaml"
TRAIN_B, TRAIN_T = 8, 300
# Gradients of one G and one D step, kernels against plain versions, per
# trained subtree, rel(fro).  Both run bf16 networks and round at the same
# points; the step's chain (denoisers -> alignment -> mixer ->
# discriminators) carries the bf16 noise of the sums into the gradients.
# Readings on an H100, with data statistics in the normalizers (see
# _fixture_normalizer): 0.017 (core), 0.0086 (text head), 0.010 / 0.011
# (discriminators); the limit is 3x the largest.  The witness (kernels vs f32
# at most 1.5 x plain vs f32) read 0.93-1.09x.
GRAD_TOL = 5e-2


def _fixture(root, seed):
    """A synthetic InterHuman dataset: 8 clips (16 items with the mirrored
    copies), two longer than 300 frames (cropped), the rest shorter, so that
    the discriminators' attention sees key padding in every batch."""
    from mixermdm_tpu_torch.data.synthetic import make_interhuman_fixture

    make_interhuman_fixture(root, n_clips=8, n_frames=[340, 301, 280, 240, 200, 150, 100, 60],
                            seed=seed)


def _fixture_normalizer(dataset):
    """Per-feature mean and std of the fixture's valid frames (both persons),
    as the InterHuman statistics are made from the training set; std floored
    at 1e-2.  With the identity normalizer a random model's raw 6d rotations
    are near zero, and the Gram-Schmidt of ``center_person`` (1 / |a|) then
    amplifies bf16 noise without bound; with data statistics they sit near
    the unit vectors of real motion."""
    import numpy as np
    import torch

    from mixermdm_tpu_torch.utils.normalizer import Normalizer

    frames = np.concatenate([np.concatenate([it["motion1"][:it["motion_lens"]],
                                             it["motion2"][:it["motion_lens"]]])
                             for it in (dataset[i] for i in range(len(dataset)))])
    mean = torch.from_numpy(frames.mean(0).astype(np.float32)).cuda()
    std = torch.from_numpy(np.maximum(frames.std(0), 1e-2).astype(np.float32)).cuda()
    return Normalizer(mean, std)


def _device_batch(system, batch):
    import torch

    return {"motions": torch.from_numpy(batch["motions"]).float().to(system.device),
            "motion_lens": torch.from_numpy(batch["motion_lens"]).long().to(system.device),
            **system.tokenize_batch(batch)}


def _grad_step(seed, normalizer, batch_np):
    """The full-width training system at ``seed`` with ``normalizer`` (the
    fixture's statistics, :func:`_fixture_normalizer`), its f32 twin, and
    ``side(sys_, mode, plain) -> (losses, {subtree: flat gradient})``: one
    G or D step's gradients of the trained subtrees, on the kernels or
    (``plain``) the plain versions."""
    import torch

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.cli.infer_mixermdm import build_system
    from mixermdm_tpu_torch.systems.mixermdm import DISC_MODULES, GEN_MODULES
    from mixermdm_tpu_torch.train.trainer import trainable_params

    t0 = time.time()
    system = build_system(MODEL_CFG, device="cuda", seed=seed, zero_init_std=0.02, train=True)
    system.normalizer1 = system.normalizer2 = normalizer
    system.cast_(system.compute_dtype, train=True)  # the forward takes the new statistics
    twin = copy.deepcopy(system).cast_(None, train=True)
    print(f"   built the training system and its f32 twin in {time.time() - t0:.1f} s (seed "
          f"{seed})", flush=True)
    batch = _device_batch(system, batch_np)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    t = torch.randint(0, int(system.cfg.DIFFUSION_STEPS), (TRAIN_B,), generator=gen,
                      device="cuda")
    noise = torch.randn(TRAIN_B, TRAIN_T, 2 * system.nfeats, generator=gen, device="cuda")
    drop = torch.zeros(TRAIN_B, 1, dtype=torch.bool, device="cuda")
    drop[-1] = True

    def side(sys_, mode, plain):
        keys = GEN_MODULES if mode == "generator" else DISC_MODULES
        params = trainable_params(sys_, keys)
        for p in params:
            p.requires_grad_(True)
        try:
            with ops.plain_versions() if plain else contextlib.nullcontext():
                cond = sys_.encode_cond(batch["tokens_inter"], batch["tokens_i1"],
                                        batch["tokens_i2"])
                losses = sys_.compute_loss(batch["motions"], batch["motion_lens"], cond,
                                           mode=mode, t=t, noise=noise, drop=drop,
                                           dropout=False)
                grads = torch.autograd.grad(losses["total"], params)
        finally:
            for p in params:
                p.requires_grad_(False)
        out, i = {}, 0
        for k in keys:
            n = len(list(sys_.get_submodule(k).parameters()))
            out[k] = torch.cat([g.float().flatten() for g in grads[i:i + n]])
            i += n
        return {k: float(v) for k, v in losses.items()}, out

    return system, twin, side


def grad_check(seed, normalizer, batch_np):
    """The gradients of one G and one D step on the full-width training
    system at ``seed``, on the kernels, on the plain versions and in f32
    (plain versions): all three gaps of every trained subtree's gradient are
    printed first, then each is held, in the order and with the limits
    below (kernels vs plain on GRAD_TOL; the witness, kernels vs f32 at most
    WITNESS_RATIO x plain vs f32).  Returns the gaps, ``{"generator.core":
    (k-p, p-f, k-f), ...}`` in rel(fro)."""
    import torch

    system, twin, side = _grad_step(seed, normalizer, batch_np)
    gaps, grads = {}, {}
    for mode in ("generator", "discriminator"):
        lk, gk = side(system, mode, False)
        lp, gp = side(system, mode, True)
        lf, gf = side(twin, mode, True)
        print(f"   {mode} step losses, kernels / plain / f32: "
              + ", ".join(f"{k} {lk[k]:.6g} / {lp[k]:.6g} / {lf[k]:.6g}" for k in lk),
              flush=True)
        if not all(math.isfinite(v) for v in list(lk.values()) + list(lp.values())):
            raise SmokeFailure(f"{mode} step losses are not finite")
        for k in gk:
            gaps[f"{mode}.{k}"] = (_gaps(gk[k], gp[k])[2], _gaps(gp[k], gf[k])[2],
                                   _gaps(gk[k], gf[k])[2])
            grads[f"{mode}.{k}"] = (gk[k], gp[k], gf[k])
    del system, twin
    torch.cuda.empty_cache()
    for name, (kp, pf, kf) in gaps.items():
        print(f"   seed {seed}, {name} gradient, rel(fro): kernels vs plain {kp:.5g}, plain vs "
              f"f32 {pf:.5g}, kernels vs f32 {kf:.5g} (witness ratio {kf / max(pf, 1e-12):.4g})",
              flush=True)
    for name, (gk_, gp_, gf_) in grads.items():
        what = f"{name.split('.')[0]} step, gradient of {name.split('.', 1)[1]}"
        _agree(what, gk_, gp_, GRAD_TOL, "fro")
        gap_p = _agree(what, gp_, gf_, None, "fro", "plain vs f32")
        _agree(what, gk_, gf_, WITNESS_RATIO * gap_p, "fro",
               f"kernels vs f32 (at most {WITNESS_RATIO} x plain vs f32)")
    return gaps


def train_phase(seed):
    """Gradient check of one G and one D step (kernels vs plain versions vs
    f32), the training CLI on a synthetic fixture with its launch counts,
    and seconds per fit step with the differentiated attention on the
    kernels and on the plain versions."""
    import os
    import shutil
    import tempfile

    import torch

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.cli import train_mixermdm
    from mixermdm_tpu_torch.cli.infer_mixermdm import build_system
    from mixermdm_tpu_torch.data.interhuman import InterHumanDataset
    from mixermdm_tpu_torch.data.loader import collate
    from mixermdm_tpu_torch.models import layers

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        data = os.path.join(tmp, "data")
        _fixture(data, seed)
        dataset = InterHumanDataset(data, mode="train")
        batch_np = collate([dataset[i] for i in range(TRAIN_B)])
        print(f"   fixture: {len(dataset)} items, batch lengths "
              f"{batch_np['motion_lens'].tolist()} of T = {batch_np['motions'].shape[1]}",
              flush=True)

        grad_check(seed, _fixture_normalizer(dataset), batch_np)

        # --- the training CLI, counted -----------------------------------------
        out_dir = os.path.join(tmp, "out")
        argv = ["--model", MODEL_CFG, "--train", TRAIN_CFG, "--data-root", data, "--out-dir",
                out_dir, "--batch-size", str(TRAIN_B), "--max-steps", "4", "--seed", str(seed),
                "--init-std", "0.02", "--log-jsonl", os.path.join(tmp, "steps.jsonl")]
        layers.set_train_attention("kernel")
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        out = train_mixermdm.run(argv)
        torch.cuda.synchronize()
        counts = dict(ops.launches)
        print(f"   train-mixermdm {' '.join(argv)}: {time.time() - t0:.1f} s for "
              f"{len(out['records'])} fit steps (system build included)", flush=True)
        for r in out["records"]:
            print("   " + json.dumps(r), flush=True)
        print(f"   launches in the training run: {json.dumps(counts, sort_keys=True)}", flush=True)
        if len(out["records"]) != 4 or not all(
                math.isfinite(r["g_total"]) and math.isfinite(r["d_total"])
                for r in out["records"]):
            raise SmokeFailure("training losses missing or not finite")
        trained = out["system"]
        ref = build_system(MODEL_CFG, device="cuda", seed=seed, zero_init_std=0.02, train=True)
        frozen = ("model1", "model2", "text.clip")
        changed = ("core", "text.post.mixer", "disc_i", "disc_I")
        for name in frozen + changed:
            a = trained.get_submodule(name).state_dict()
            b = ref.get_submodule(name).state_dict()
            same = all(torch.equal(a[k], b[k]) for k in a)
            print(f"   after training, {name}: {'bitwise unchanged' if same else 'changed'}",
                  flush=True)
            if same != (name in frozen):
                raise SmokeFailure(f"{name} should {'not ' if name in frozen else ''}change")
        del ref
        torch.cuda.empty_cache()

        # --- seconds per fit step, differentiated attention kernel vs plain ----
        trainer = out["trainer"]
        readings = {}
        for bsz in (TRAIN_B, 64):
            items = [dataset[i % len(dataset)] for i in range(bsz)]
            big = _device_batch(trained, collate(items))
            step_gen = torch.Generator(device="cuda").manual_seed(seed + 3)
            for impl in ("kernel", "plain", "kernel", "plain"):
                layers.set_train_attention(impl)
                trainer.fit_step(big, step_gen, 0)  # warm-up
                torch.cuda.synchronize()
                t0 = time.time()
                for _ in range(2):
                    trainer.fit_step(big, step_gen, 0)
                torch.cuda.synchronize()
                readings.setdefault(f"B={bsz} {impl}", []).append((time.time() - t0) / 2)
        layers.set_train_attention("kernel")
        print("   s per fit step (G + D step, eager, two turns each): "
              + json.dumps({k: [round(v, 4) for v in vs] for k, vs in readings.items()}),
              flush=True)
        return counts
    finally:
        layers.set_train_attention("kernel")
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "adaln_modulate": ("mixermdm_tpu_torch/csrc/adaln.cu",
                       "mixermdm_tpu/ops/fused_block.py:80 (LN + modulation prologue of "
                       "_sa_block_kernel, _ca_block_kernel :259, _ffn_kernel :438)"),
    "adaln_modulate_q8": ("mixermdm_tpu_torch/csrc/adaln.cu",
                          "mixermdm_tpu/ops/fused_block.py:94-105 (_ln, modulation and "
                          "_quant_act :58 of _sa_block_kernel_q8 :160; of x and xf in "
                          "_ca_block_kernel_q8 :333, :276-284; of _ffn_kernel_q8 :467, "
                          ":444 via _qdot :76)"),
    "linear_epilogue": ("mixermdm_tpu_torch/csrc/linear.cu",
                        "mixermdm_tpu/ops/fused_block.py:80 (projections of "
                        "_sa_block_kernel, _ca_block_kernel :259, _ffn_kernel :438)"),
    "linear_epilogue_skinny": ("mixermdm_tpu_torch/csrc/linear.cu",
                               "mixermdm_tpu/ops/fused_block.py:80 (the dense layers beside "
                               "the blocks at M <= 64: AdaLN modulations, embeddings)"),
    "linear_epilogue_ragged": ("mixermdm_tpu_torch/csrc/linear.cu",
                               "mixermdm_tpu/ops/fused_block.py:80 (the dense layers beside "
                               "the blocks that TMA cannot describe: motion_embed, K = 262)"),
    "attention": ("mixermdm_tpu_torch/csrc/attention.cu",
                  "mixermdm_tpu/ops/attention.py:47 (_attn_body; attention loop of "
                  "fused_block.py:80 and :259)"),
    "attention_f32": ("mixermdm_tpu_torch/csrc/attention.cu",
                      "mixermdm_tpu/ops/attention.py:47 (_attn_body, f32 softmax branch :60; "
                      "pallas_call :273)"),
    "attention_bwd": ("mixermdm_tpu_torch/csrc/attention_bwd.cu",
                      "mixermdm_tpu/ops/attention.py:370 (_fused_attention_bwd_impl -> "
                      "pallas_call :412, body _attn_bwd_kernel :323)"),
    "fused_attention": ("mixermdm_tpu_torch/ops/attention.py",
                        "mixermdm_tpu/ops/attention.py:103 (fused_attention -> pallas_call :273)"),
    "fused_sa_block": ("mixermdm_tpu_torch/ops/fused_block.py",
                       "mixermdm_tpu/ops/fused_block.py:172 (fused_sa_block -> pallas_call :240)"),
    "fused_ca_block": ("mixermdm_tpu_torch/ops/fused_block.py",
                       "mixermdm_tpu/ops/fused_block.py:346 (fused_ca_block -> pallas_call :406)"),
    "fused_ffn_block": ("mixermdm_tpu_torch/ops/fused_block.py",
                        "mixermdm_tpu/ops/fused_block.py:473 (fused_ffn_block -> pallas_call :522)"),
    "quant_rows": ("mixermdm_tpu_torch/csrc/quant.cu",
                   "mixermdm_tpu/ops/fused_block.py:58 (_quant_act of _sa_block_kernel_q8 :160, "
                   "_ca_block_kernel_q8 :333, _ffn_kernel_q8 :467; on the W8A8 path only for "
                   "an FFN input that is not modulated)"),
    "attention_q8": ("mixermdm_tpu_torch/csrc/attention.cu",
                     "mixermdm_tpu/ops/fused_block.py:58 (_quant_act of the attention output "
                     "in _sa_block_kernel_q8 :160 via _qdot :74, and _ca_block_kernel_q8 :333; "
                     "attention loop of :80 and :259)"),
    "linear_q8_gelu_q8": ("mixermdm_tpu_torch/csrc/linear_q8.cu",
                          "mixermdm_tpu/ops/fused_block.py:58 (_quant_act of the GELU hidden "
                          "in _ffn_kernel_q8 :467 via _qdot :74; the product _qdot :74)"),
    "linear_q8": ("mixermdm_tpu_torch/csrc/linear_q8.cu",
                  "mixermdm_tpu/ops/fused_block.py:66 (_qdot8, _qdot :74: the int8 products of "
                  "_sa_block_kernel_q8 :160, _ca_block_kernel_q8 :333, _ffn_kernel_q8 :467)"),
    "fused_sa_block_q8": ("mixermdm_tpu_torch/ops/fused_block.py",
                          "mixermdm_tpu/ops/fused_block.py:172 (fused_sa_block quant=True -> "
                          "pallas_call :240, body _sa_block_kernel_q8 :160)"),
    "fused_ca_block_q8": ("mixermdm_tpu_torch/ops/fused_block.py",
                          "mixermdm_tpu/ops/fused_block.py:346 (fused_ca_block quant=True -> "
                          "pallas_call :406, body _ca_block_kernel_q8 :333)"),
    "fused_ffn_block_q8": ("mixermdm_tpu_torch/ops/fused_block.py",
                           "mixermdm_tpu/ops/fused_block.py:473 (fused_ffn_block quant=True -> "
                           "pallas_call :522, body _ffn_kernel_q8 :467)"),
    "sa_block": ("mixermdm_tpu_torch/csrc/sa_block.cu",
                 "scripts/exp_kernels.py:204 (sa_variant -> _sa_v_kernel :69, _sa_v_kernel_q8 "
                 ":145); :595 (sa_headbatch -> _sa_hb_kernel :483, _hb_q8 :548); :433 "
                 "(sa_ablate -> _sa_abl_kernel :315, _abl_q8 :386)"),
    "sa_block_i8x": ("mixermdm_tpu_torch/csrc/sa_block_i8x.cu",
                     "scripts/exp_kernels.py:792 (sa_int8x -> _sa_i8x_kernel :655)"),
}
# The kernels each main path must launch.  The shipped config samples on the
# W8A8 path; the bf16 path (QUANT_FROZEN off) runs the bf16 block forms.
GEMM_ROUTES = ("linear_epilogue", "linear_epilogue_skinny", "linear_epilogue_ragged")
PATH_KERNELS = {
    "W8A8": ("adaln_modulate_q8", *GEMM_ROUTES, "attention", "attention_f32",
             "attention_q8", "fused_attention", "linear_q8", "linear_q8_gelu_q8",
             "fused_sa_block_q8", "fused_ca_block_q8", "fused_ffn_block_q8"),
    "bf16": ("adaln_modulate", *GEMM_ROUTES, "attention", "attention_f32",
             "fused_attention", "fused_sa_block", "fused_ca_block", "fused_ffn_block"),
    # Adversarial training: the frozen denoisers on the bf16 blocks, the
    # discriminators' attention forward and backward in bf16, the mixer
    # head's in f32.
    "train": ("adaln_modulate", *GEMM_ROUTES, "attention", "attention_f32",
              "attention_bwd", "fused_attention", "fused_sa_block", "fused_ca_block",
              "fused_ffn_block"),
    # The kernel experiments (mixermdm_tpu_torch.scripts.exp_kernels): the
    # one-launch SA blocks, beside the shipped composition.
    "exp_kernels": ("sa_block", "sa_block_i8x", "fused_sa_block", "fused_sa_block_q8"),
    # The base models' CLIs (phase 5c), one request each: in2IN in bf16 (its
    # configs leave QUANT off), its post-encoder heads on the f32 attention;
    # MDM's encoder on the attention kernel without zero-attn and the GEMM
    # routes, its embed_text in f32.
    "in2in interaction": ("adaln_modulate", *GEMM_ROUTES, "attention", "attention_f32",
                          "fused_attention", "fused_sa_block", "fused_ca_block",
                          "fused_ffn_block"),
    "in2in individual": ("adaln_modulate", *GEMM_ROUTES, "attention", "attention_f32",
                         "fused_attention", "fused_sa_block", "fused_ffn_block"),
    "in2in dual": ("adaln_modulate", *GEMM_ROUTES, "attention", "attention_f32",
                   "fused_attention", "fused_sa_block", "fused_ca_block", "fused_ffn_block"),
    "mdm": (*GEMM_ROUTES, "attention", "fused_attention"),
}
# The path whose counts stand in a kernel's row: the shipped sampling path,
# the bf16 one for the bf16 block forms, the training path for the kernels
# it brought; quant_rows stands on the W8A8 path it left to its producers
# (0 launches there unless an FFN input is not modulated).
ROW_PATH = {"attention_f32": "train", "attention_bwd": "train", "quant_rows": "W8A8",
            "sa_block": "exp_kernels", "sa_block_i8x": "exp_kernels"}
# The check whose numbers stand for each name in the kernels line: the
# largest main-path shape.
REPRESENTATIVE = {
    "adaln_modulate": "adaln_modulate E=1024 T=299",
    "adaln_modulate_q8": "adaln_modulate_q8 E=1024 T=299",
    "linear_epilogue": "linear QKV E=1024",
    "linear_epilogue_skinny": "linear skinny M=8 K=1024 N=2048",
    "linear_epilogue_ragged": "linear motion_embed K=262",
    "attention": "attention denoiser D=128",
    "attention_f32": "attention f32 post-encoder D=96",
    "attention_bwd": "attention_bwd bf16 discriminator",
    "fused_attention": "attention clip tower",
    "fused_sa_block": "fused_sa_block E=1024 T=299 residual=True",
    "fused_ca_block": "fused_ca_block E=1024 T=299 residual=True",
    "fused_ffn_block": "fused_ffn_block E=1024 F=2048 residual=True adaln=True",
    "quant_rows": "quant_rows float32 M=2392 K=2048",
    "attention_q8": "attention_q8 SA f32 D=128",
    "linear_q8_gelu_q8": "linear_q8_gelu_q8 FFN1 E=1024",
    "linear_q8": "linear_q8 QKV E=1024",
    "fused_sa_block_q8": "fused_sa_block_q8 E=1024 T=299 residual=True",
    "fused_ca_block_q8": "fused_ca_block_q8 E=1024 T=299 residual=True",
    "fused_ffn_block_q8": "fused_ffn_block_q8 E=1024 F=2048 residual=True",
    "sa_block": "sa_block rows=1 recip=0 bf16 B=8",
    "sa_block_i8x": "sa_block_i8x static + int8 attn w8a8 B=8",
}


def kernels_line(results, counts):
    """One row per kernel and entry point; ``launches`` from the main path
    of :data:`ROW_PATH` (else the W8A8 sampling path, or the bf16 one for the
    bf16 block forms that only it runs)."""
    by_name = {r["check"]: r for r in results}
    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = by_name[REPRESENTATIVE[name]]
        path = ROW_PATH.get(name, "W8A8" if name in PATH_KERNELS["W8A8"] else "bf16")
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": int(counts[path].get(name, 0)), "path": path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
        })
    return {"kernels": rows}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    faulthandler.dump_traceback_later(BUDGET_S, exit=True)
    t_start = time.time()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script needs one GPU", file=sys.stderr)
        return 2
    try:
        from mixermdm_tpu_torch.ops import _lib
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the repository root",
              file=sys.stderr)
        return 2

    t0 = phase("1. device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi failed (rc {smi.returncode})"
    print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), {torch.cuda.get_device_name(0)}", flush=True)
    done(t0)

    t0 = phase("2. build")
    lib_path, log = _lib.build()
    print(log if log else f"   reused {lib_path}", flush=True)
    _lib.library()
    done(t0)

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references are full f32
    torch.backends.cudnn.allow_tf32 = False
    t0 = phase("3. kernels against their plain versions (bf16, W8A8, f32, backward)")
    torch.manual_seed(args.seed)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = kernel_checks(gen)
    bad = [r["check"] for r in results if not r["ok"]]
    done(t0)
    if bad:
        raise SmokeFailure("kernels disagree with their plain versions: " + ", ".join(bad))

    t0 = phase("3b. the SA-block variants (sa_block, sa_block_i8x) and the W8A8 blocks' "
               "unfused route, against their plain versions; the kernel experiments, counted")
    sa_results, sa_counts = sa_variant_phase(args.seed)
    results += sa_results
    bad = [r["check"] for r in sa_results if not r["ok"]]
    done(t0)
    if bad:
        raise SmokeFailure("kernels disagree with their plain versions: " + ", ".join(bad))

    t0 = phase("4. sampling path at full width: networks and one step, kernels vs plain")
    system, batch = sample_phase(args.seed)
    done(t0)

    t0 = phase("5. sampling main paths (text + DDIM-50, W8A8 and bf16), counted")
    counts = sample_main_paths(system, batch, args.seed)
    done(t0)

    t0 = phase("5b. the inference surface at full width: released files, infer-mixermdm "
               "(DPM-Solver++, trajectory control, warm start), serve")
    surface = surface_phase(system, args.seed, card)
    del system
    torch.cuda.empty_cache()
    done(t0)

    t0 = phase("5c. the base-model systems at full width: in2IN (interaction, individual, "
               "DualMDM), MDM, InterGen; infer-in2in, infer-mdm; the mixer with MDM + InterGen")
    base, base_counts = base_models_phase(args.seed, card)
    counts.update(base_counts)
    done(t0)

    t0 = phase("6. adversarial training at full width")
    counts["train"] = train_phase(args.seed)
    done(t0)

    t0 = phase("7. summary")
    counts["exp_kernels"] = sa_counts
    line = kernels_line(results, counts)
    missing = [f"{name} ({path} path)" for path, names in PATH_KERNELS.items() for name in names
               if not counts[path].get(name)]
    if missing:
        raise SmokeFailure("not launched in the main path: " + ", ".join(missing))
    done(t0)
    print(f"   inference surface (phase 5b): {json.dumps(surface)}", flush=True)
    print("   base-model requests (phase 5c): " + json.dumps(
        {k: {"s_per_request": v["s_per_request"], "launches": sum(v["launches"].values())}
         for k, v in base.items()}), flush=True)
    print(f"   total seconds: {time.time() - t_start:.1f} (BUDGET_S {BUDGET_S})", flush=True)
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
