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
   the evaluator's f32 attention (the InterCLIP motion tower (96, 8, 301,
   128) under a key mask, the text tower (96, 8, 77, 96)) and its backward
   at train-evaluator's batch of 32; every kernel of the W8A8 sampling
   chain, and its blocks, at the rows the protocol's generation batches
   give them (96 prompts x 4 sequences x 299 frames, 32 x 4 x 300), and
   eval-base's bf16 blocks at its largest batch (96 x 8 sequences);
3b. the one-launch SA blocks of the kernel experiments (``sa_block``:
   ``sa_variant`` rows 1 / 2 with and without the reciprocal softmax,
   ``sa_headbatch``, ``sa_ablate``'s five skip sets, bf16 and W8A8;
   ``sa_block_i8x``: ``sa_int8x``'s four lever sets) against their plain
   versions at (8, 299, 1024), (8, 299, 512) and (40, 299, 1024), H 8, and
   at B 8 with keys masked; at B 8 timed beside the shipped composition and
   the bound, and at (8, 299, 1024) each phase's device time read from the
   kernels' %globaltimer stamps;
   int8 p.v also held on the kernel's own operands (the operand pass
   bitwise, the witness of its limit); the W8A8 blocks at shapes their
   fused plan refuses (16 heads; FFN 4096) through the unfused pair; then
   ``python -m mixermdm_tpu_torch.scripts.exp_kernels`` in each of its
   modes, which times B 40 and reads its phases there, with the launch
   counts of that run;
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
5d. evaluation at full width (InterCLIP: 1024-d, 8 layers, 8 heads, FF
   2048; text 768 x 8 layers) on synthetic InterHuman (96 clips) and
   HumanML3D (32 clips) sets of differing lengths: both evaluators written
   in the reference's file layout and read back ``--strict``; both towers'
   embeddings of one protocol batch, and the metrics computed from them, on
   the kernels against the plain versions; a mixer with its zero-init
   layers drawn from N(0, 0.02): one CFG step at the batch of 96 prompts on
   the kernels against the plain versions and f32, its released files;
   ``eval-mixermdm --datasets both`` through its entry point on those files
   (one replication, batches of 96 and 32, MultiModality 2 x 15, DDIM-50
   W8A8), each side's generation and scoring seconds and its launches,
   every shape its generation batches launched a kernel at held in phase
   3; ``eval-base`` in each mode, counted;
5e. the diffusion engine at full width on in2IN interaction (B 2, T 210,
   DDIM-50's schedule): each step function (``p_mean_variance`` ->
   ``ddpm_step``, ``ddim_step`` at eta 0.5, ``condition_mean``,
   ``condition_score``, ``ddim_reverse_step``, ``vb_terms_bpd``) on the
   kernels against the plain versions; DDPM-50 with prefix inpainting,
   translation pinning and a ``cond_fn``, DDIM-50 at eta 0.5 with a
   ``cond_fn``, the reverse ODE of that sample and the decode of its
   latent, ``calc_bpd_loop``: s a request, launches, each chain's states
   against its float64 replay on the CPU from its recorded model outputs
   and noises;
5f. the data path: the native motion-feature library built with g++,
   phase 6's items on it against its numpy version, items/s of the
   dataset on both and of the loader at B 64 with 1, 4 and 8 workers,
   with the host's CPU model and cores;
6. adversarial training at full width (``configs/models/MixerMDM.yaml``,
   ``configs/train/MixerMDM.yaml``, B = 8, T = 300): the gradients of one G
   and one D step on the kernels against the plain versions (and against
   f32), all three gaps printed before any is held, the training CLI
   (``cli/train_mixermdm``) for 4 fit steps on a
   synthetic InterHuman fixture with the launch counts of that run, the
   frozen networks bitwise unchanged, and seconds per fit step with the
   differentiated attention on the kernels and on the plain versions;
6b. the rest of training at full width: (a) per base model (in2IN
   interaction and individual, 1024-d on ViT-L/14; MDM, 512-d on
   ViT-B/32; B 4, T 300, synthetic InterHuman / HumanML3D fixtures) one
   step's gradients at dropout 0 on the kernels against the plain versions
   and f32, then ``train-in2in`` for 2 steps per mode at the shipped
   dropout, counted; (b) ``QUANT_TRAIN`` (the frozen denoisers as int8):
   phase 6's gradient check of a G and a D step with the frozen outputs
   shared, and those outputs against f32, the int8 launches of each
   step against the frozen denoisers' modules (none of the mixer core's),
   the frozen denoisers' int8 outputs against the int8 plain versions,
   seconds per fit step against bf16; (c) ``train-mixermdm`` for 2 steps,
   then ``--resume auto`` for 2 more from its ``final_state``, the restored
   state bitwise the saved one and steps 3-4 against phase 6's 4 unbroken
   steps, then ``--resume auto --quant-train`` for 2 more, its int8
   launches counted; ``train-finetuned`` for one step from a released
   individual file,
   every ``sa_block`` bitwise unchanged and every ``ca_block`` trained;
6c. ``train-evaluator`` at full width: one step's loss and gradients (B
   32) on the kernels against the plain versions, the CLI for 3 steps,
   counted, and its file read by ``eval-mixermdm --evaluator-checkpoint
   --strict``;
7. parallel sampling (``mixermdm_tpu_torch.scripts.parallel_layouts``):
   (a) an NCCL world of one rank on ``cuda:0``, ``infer-mixermdm``'s
   data-parallel sample path bitwise against the plain call; (b) two ranks
   on ``cuda:0`` through ``gloo``, the shipped system at full width from
   the seed, B 2, T 299, DDIM cut to 10 steps: data parallelism (W8A8) row
   for row, ``--pp 2`` (W8A8, 4 layers a stage), ``--tp 2`` (bf16: the
   kernels at H 4, N 1536, K 512) and ``--tp 2 --sp`` at T 298, each step
   held to one rank's within 1.5x its kernels-vs-plain gap; ``serve`` with
   data parallelism answering 2 requests; ``infer-mixermdm`` on both
   ranks; launch shapes, transports and seconds a step of each layout
   (two ranks sharing one card: no multi-card speed);
8. one JSON line per kernel and entry point, then the result line.

Any failure exits nonzero and prints no result line.  The script imports
nothing of JAX or of the JAX package.

``python -m mixermdm_tpu_torch.scripts.grad_seeds [--quant-train]`` runs
phase 6's (or 6b (b)'s) gradient check at several seeds, with a diagnosis
of its gaps.
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
import os
import subprocess
import sys
import time

BUDGET_S = 1100          # hard stop, under the 1200 s limit of a run
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM at 700 W
H100_INT8_OPS = 1979e12   # dense int8 tensor-core peak
H100_F32_FLOPS = 67e12    # f32 outside the tensor cores
H100_TF32_FLOPS = 495e12  # dense TF32 tensor-core peak
# f32-accurate products on the tensor cores: three TF32 passes (hi.hi +
# hi.lo + lo.hi, f32 sums), the form of the f32 attention kernels' tiled
# routes; the bound of every f32 attention row.
H100_F32_MMA_FLOPS = H100_TF32_FLOPS / 3
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


def light_timed(fn):
    """:func:`graph_timed` with few calls, for the large shapes of the
    protocol's batches (phase 3's eval-rows checks): a reading, not a
    tuned mean."""
    return graph_timed(fn, reps=2, replays=3)


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
                peak=H100_BF16_FLOPS, light=False, **shape):
        out_k = kernel()
        torch.cuda.synchronize()
        out_p = plain()
        diff = (out_k.float() - out_p.float()).abs()
        ref_scale = max(out_p.float().abs().max().item(), 1e-6)
        max_abs = diff.max().item()
        finite = bool(torch.isfinite(out_k.float()).all().item())
        ok = finite and max_abs <= tol * ref_scale
        b_ms, b_by = bound_ms(n_bytes, flops, peak)
        dev_ms = light_timed if light else graph_timed
        res = {
            "check": name, "kind": kind, "shape": shape, "max_abs_err": max_abs,
            "max_rel_err": max_abs / ref_scale, "tol_rel": tol, "ok": ok,
            "ms": dev_ms(kernel), "plain_ms": dev_ms(plain),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if library is None else dev_ms(library),
            "eager_ms": None if light else timed(kernel),
            "host_us": None if light else host_us(kernel),
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
                  kpm_tail=False, light=False):
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
            kind="attention", light=light, B=B, H=H, Tq=Tq, Tk=Tk, D=D, zero_attn=zero_attn,
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
    def adaln_case(B, T, E, label="", light=False):
        x = rnd(B, T, E)
        sc, sh = rnd(B, 2 * E, std=0.2).chunk(2, dim=-1)
        return compare(
            f"adaln_modulate E={E} T={T}{label}", lambda: ops.adaln_modulate(x, sc, sh),
            lambda: ops.adaln_modulate_plain(x, sc, sh), 2e-2,
            2 * (2 * B * T * E + 2 * B * E), 8 * B * T * E, kind="adaln_modulate",
            peak=H100_F32_FLOPS, light=light, B=B, T=T, E=E)

    for B, T, E in ((8, 299, 1024), (8, 299, 512), (3, 131, 1024)):
        results.append(adaln_case(B, T, E))

    # --- linear_epilogue, each route at its main-path shapes ---------------
    # The yardstick is one F.linear call (the product and the bias, not the
    # GELU or the residual of the epilogue), timed here and never called by
    # the port.
    from mixermdm_tpu_torch.ops.linear import gemm_plan, tma_describable

    def lin_case(name, M, K, N, act=None, res=False, tol=2e-2, ldx=None, light=False,
                 bias=True):
        # ldx: x is the view x[:, :K] of an (M, ldx) tensor.  bias=False: a
        # row-parallel partial (its bias is added after the sum).
        x = rnd(M, ldx or K)[:, :K]
        w, b = rnd(N, K, std=K ** -0.5), rnd(N, std=0.1)
        b = b if bias else None
        r = rnd(M, N) if res else None
        n_bytes = 2 * (M * K + N * K + (N if bias else 0) + M * N * (2 if res else 1))
        plan = gemm_plan(M, N, K, tma_ok=tma_describable(2, (x.data_ptr(), x.stride(0)),
                                                          (w.data_ptr(), w.stride(0))))
        route = {"tma": "linear_epilogue", "skinny": "linear_epilogue_skinny",
                 "ragged": "linear_epilogue_ragged"}[plan.route]
        return compare(
            name, lambda: ops.linear(x, w, b, activation=act, residual=r),
            lambda: ops.linear_plain(x, w, b, activation=act, residual=r), tol,
            n_bytes, 2 * M * N * K, library=lambda: F.linear(x, w, b), kind=route, light=light,
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

    def sa_case(B, T, E, H, residual, kpm_tail=False, label="", light=False):
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
                       kind="fused_sa_block", light=light, B=B, T=T, E=E, H=H,
                       residual=residual, key_padding=kpm_tail)

    def ca_case(B, T, E, H, residual, label="", light=False):
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
                       kind="fused_ca_block", light=light, B=B, T=T, E=E, H=H,
                       residual=residual)

    def ffn_case(B, T, E, F_, residual, modulate=True, label="", light=False):
        x = rnd(B, T, E)
        sc, sh = (rnd(B, E, std=0.2), rnd(B, E, std=0.2)) if modulate else (None, None)
        p = block_params(E, F_)
        args = (x, sc, sh, p["w1"], p["b1"], p["w2"], p["b2"])
        n_bytes = 2 * (2 * B * T * E + (2 * B * E if modulate else 0) + 2 * E * F_ + F_ + E)
        return compare(f"fused_ffn_block E={E} F={F_} residual={residual} adaln={modulate}{label}",
                       lambda: ops.fused_ffn_block(*args, residual=residual),
                       lambda: ops.fused_ffn_block_plain(*args, residual=residual), 3e-2,
                       n_bytes, 4 * B * T * E * F_, kind="fused_ffn_block", light=light,
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
    # The rest of training (phase 6b), drawn after every earlier check: the
    # attention backward at the base models' training shapes, and the W8A8
    # kernels at the rows QUANT_TRAIN gives the frozen denoisers.
    results += base_bwd_checks(gen)
    results += quant_train_q8_checks(gen, compare, block_params, rnd)
    # The evaluator's shapes (phases 5d and 6c), drawn after every earlier
    # check.
    results += eval_kernel_checks(gen, compare)
    # The protocol's batches (phase 5d), drawn after every earlier check:
    # each kernel of eval-mixermdm's W8A8 chain at the shapes its two
    # generation batches give it (phase 5d (c) holds the shapes it counts
    # to this set) and the W8A8 blocks there; then eval-base's bf16 blocks
    # at its largest batch, the CLIP tower at 96 prompts and MDM's encoder
    # at eval-base mdm's 32 (2-way CFG, the cond token + 300 frames).
    for S, T in EVAL_GEN_ROWS:
        P, M_, lab = S // 4, S * T, f" B={S} T={T}"
        for E in (1024, 512):
            results.append(_adaln_q8_case(rnd, S, T, E, label=lab, light=True))
        for K, N, res in EVAL_Q8_GEMMS:
            results.append(_q8_linear_case(
                gen, rnd, M_, f"linear_q8 K={K} N={N}{' +residual' if res else ''}{lab}", K, N,
                res=res, light=True))
        for K, N in EVAL_GEMMS_FRAMES:
            results.append(lin_case(f"linear K={K} N={N}{lab}", M_, K, N, light=True))
        for rows, shapes in ((2 * P, EVAL_GEMMS_2P), (4 * P, EVAL_GEMMS_4P)):
            for K, N in shapes:
                results.append(lin_case(f"linear M={rows} K={K} N={N} ({P} prompts)", rows, K,
                                        N, light=True))
        for E, F_ in ((1024, 2048), (512, 1024)):
            results.append(_sa_q8(compare, block_params, rnd, S, T, E, 8, True, label=lab,
                                  light=True))
            results.append(_ca_q8(compare, block_params, rnd, S, T, E, 8, True, label=lab,
                                  light=True))
            results.append(_ffn_q8(compare, block_params, rnd, S, T, E, F_, True, label=lab,
                                   light=True))
    results += fused_q8_checks(gen, rnd, rows=EVAL_GEN_ROWS)
    S, lab = EVAL_BASE_ROWS, f" B={EVAL_BASE_ROWS} eval-base"
    results.append(adaln_case(S, 299, 1024, label=lab, light=True))
    results.append(attn_case("attention denoiser D=128" + lab, S, 8, 299, 299, 128, True,
                             light=True))
    results.append(sa_case(S, 299, 1024, 8, True, label=lab, light=True))
    results.append(ca_case(S, 299, 1024, 8, True, label=lab, light=True))
    results.append(ffn_case(S, 299, 1024, 2048, True, label=lab, light=True))
    results.append(attn_case(f"attention clip tower B={EVAL_IH_CLIPS}", EVAL_IH_CLIPS, 12, 77,
                             77, 64, False, causal=True, light=True))
    results.append(attn_case(f"attention MDM encoder D=128 kpm B={2 * EVAL_HML_CLIPS} T=301",
                             2 * EVAL_HML_CLIPS, 4, 301, 301, 128, False, kpm_tail=True,
                             light=True))
    # The f32 attention's two routes side by side (its own generator, after
    # every earlier check).
    results += f32_route_checks(gen.initial_seed() + 16)
    # Tensor parallelism's shard shapes (phase 7, --tp 2), after every
    # earlier check: H 4 of the denoisers' and the mixer's 8 heads, the
    # column-parallel products (QKV N 3E/2, FFN1 N F/2) and the row-parallel
    # partials (out-projection K E/2, FFN2 K F/2, no bias: it is added after
    # the sum), the CLIP tower's 6 of 12 heads and c_fc N 1536; --sp's
    # prologue on half of T 298.
    for E, F_, D in ((1024, 2048, 128), (512, 1024, 64)):
        results.append(attn_case(f"attention tp2 H=4 D={D}", 8, 4, 299, 299, D, True))
        results.append(lin_case(f"linear tp2 QKV E={E} N={3 * E // 2}", M, E, 3 * E // 2))
        results.append(lin_case(f"linear tp2 out-proj partial E={E} K={E // 2}", M, E // 2, E,
                                bias=False))
        results.append(lin_case(f"linear tp2 FFN1 gelu E={E} N={F_ // 2}", M, E, F_ // 2,
                                act="gelu"))
        results.append(lin_case(f"linear tp2 FFN2 partial E={E} K={F_ // 2}", M, F_ // 2, E,
                                bias=False))
    results.append(attn_case("attention tp2 clip tower H=6", 2, 6, 77, 77, 64, False,
                             causal=True))
    results.append(lin_case("linear tp2 clip c_fc N=1536", 2 * 77, 768, 1536))
    results.append(adaln_case(8, 149, 1024, label=" tp2+sp"))
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


def _adaln_q8_case(rnd, B, T, E, label="", light=False):
    """``adaln_modulate_q8`` held twice on the same inputs: bitwise against
    quant_rows_plain of adaln_modulate's rows (the quantisation is exact),
    and against the plain composition adaln_modulate_q8_plain, which rounds
    rows the kernel's statistics may put one f32 ulp apart to the other bf16
    neighbour: at most Q8_INT8_ERR off per int8 value, at most
    Q8_DIFFER_SHARE of them off, scales within Q8_SCALE_REL.  The row's
    max_abs_err is the distance to the plain composition.  Timed beside the
    unfused pair of kernels it replaces, adaln_modulate then quant_rows."""
    import torch

    from mixermdm_tpu_torch import ops

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
    dev_ms = light_timed if light else graph_timed
    res = {
        "check": f"adaln_modulate_q8 E={E} T={T}{label}", "kind": "adaln_modulate_q8",
        "shape": {"B": B, "T": T, "E": E}, "max_abs_err": float(err8),
        "int8_differ": differ, "max_scale_rel_err": scale_rel,
        "tol": {"max_int8_err": Q8_INT8_ERR, "int8_differ": Q8_DIFFER_SHARE,
                "max_scale_rel_err": Q8_SCALE_REL},
        "vs_kernel_rows": {"max_int8_err": rows_err8, "max_scale_err": rows_errs,
                           "tol": "bitwise"},
        "ok": ok,
        "ms": dev_ms(kern),
        "plain_ms": dev_ms(lambda: ops.adaln_modulate_q8_plain(x, sc, sh)),
        "pair_ms": dev_ms(lambda: ops.quant_rows(ops.adaln_modulate(x, sc, sh))),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "eager_ms": None if light else timed(kern), "host_us": None if light else host_us(kern),
    }
    print("   " + json.dumps(res), flush=True)
    return res


# --- linear_q8: f32 out to 1e-5 of max |plain|, bf16 out within one bf16
# rounding per element ------------------------------------------------------
def _q8_linear_case(gen, rnd, M, name, K, N, act=None, res=False, light=False):
    """A ``linear_q8`` product at M rows against its plain version, timed
    beside ``torch._int_mm`` (``light``: :func:`light_timed`, no eager or
    host time)."""
    import torch

    from mixermdm_tpu_torch import ops

    x8, xs = ops.quant_rows(torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16))
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
    library_ms = None
    try:  # the library's int8 product (no dequantisation), a yardstick only
        library_ms = (light_timed if light else graph_timed)(lambda: torch._int_mm(x8, w8t))
    except RuntimeError as e:
        print(f"   torch._int_mm at M={M} K={K} N={N} not timed: {e}", flush=True)
    dev_ms = light_timed if light else graph_timed
    result = {
        "check": name, "kind": "linear_q8",
        "shape": {"M": M, "K": K, "N": N, "activation": act, "residual": res},
        "max_abs_err": max_abs, "max_rel_err": rel, "tol": tol, "ok": bool(ok),
        "ms": dev_ms(run), "plain_ms": dev_ms(plain),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        "eager_ms": None if light else timed(run), "host_us": None if light else host_us(run),
    }
    print("   " + json.dumps(result), flush=True)
    return result


# --- the three q8 entry points ---------------------------------------------
def _q8w(p, *names):
    from mixermdm_tpu_torch import ops

    return [t for n in names for t in (*ops.quantize_weight(p["w" + n]), p["b" + n])]


def _q8_eq_ops(B, T, E, F_=None):
    """int8 GEMM ops counted at half a bf16 op (the int8 peak is twice the
    bf16 one), plus the bf16 attention ops."""
    if F_:
        return 2 * B * T * E * F_
    return B * T * E * 4 * E + 4 * B * T * T * E


def _sa_q8(compare, block_params, rnd, B, T, E, H, residual, kpm_tail=False, label="",
           light=False):
    import torch

    from mixermdm_tpu_torch import ops

    x, sc, sh = rnd(B, T, E), rnd(B, E, std=0.2), rnd(B, E, std=0.2)
    p = block_params(E)
    kpm = None
    if kpm_tail:
        kpm = torch.zeros(B, T, dtype=torch.bool, device="cuda")
        kpm[:, T - T // 4:] = True
    args = (x, sc, sh, *_q8w(p, "_qkv", "_o"), kpm)
    kw = dict(n_heads=H, residual=residual)
    n_bytes = 2 * 2 * B * T * E + 2 * 2 * B * E + 4 * E * E + 4 * 4 * E + 2 * 4 * E
    return compare(f"fused_sa_block_q8 E={E} T={T} residual={residual}{label}",
                   lambda: ops.fused_sa_block_q8(*args, **kw),
                   lambda: ops.fused_sa_block_q8_plain(*args, **kw), 3e-2, n_bytes,
                   _q8_eq_ops(B, T, E), kind="fused_sa_block_q8", light=light, B=B, T=T, E=E,
                   H=H, residual=residual, key_padding=kpm_tail)


def _ca_q8(compare, block_params, rnd, B, T, E, H, residual, label="", light=False):
    from mixermdm_tpu_torch import ops

    x, xf = rnd(B, T, E), rnd(B, T, E)
    mods = [rnd(B, E, std=0.2) for _ in range(4)]
    p = block_params(E)
    args = (x, xf, *mods, *_q8w(p, "_qkv", "_o"), None)
    kw = dict(n_heads=H, residual=residual)
    n_bytes = 2 * 3 * B * T * E + 2 * 4 * B * E + 4 * E * E + 4 * 4 * E + 2 * 4 * E
    return compare(f"fused_ca_block_q8 E={E} T={T} residual={residual}{label}",
                   lambda: ops.fused_ca_block_q8(*args, **kw),
                   lambda: ops.fused_ca_block_q8_plain(*args, **kw), 3e-2, n_bytes,
                   _q8_eq_ops(B, T, E), kind="fused_ca_block_q8", light=light, B=B, T=T, E=E,
                   H=H, residual=residual)


def _ffn_q8(compare, block_params, rnd, B, T, E, F_, residual, label="", light=False):
    from mixermdm_tpu_torch import ops

    x, sc, sh = rnd(B, T, E), rnd(B, E, std=0.2), rnd(B, E, std=0.2)
    p = block_params(E, F_)
    args = (x, sc, sh, *_q8w(p, "1", "2"))
    n_bytes = 2 * 2 * B * T * E + 2 * 2 * B * E + 2 * E * F_ + 6 * (F_ + E)
    return compare(f"fused_ffn_block_q8 E={E} F={F_} residual={residual}{label}",
                   lambda: ops.fused_ffn_block_q8(*args, residual=residual),
                   lambda: ops.fused_ffn_block_q8_plain(*args, residual=residual), 3e-2,
                   n_bytes, _q8_eq_ops(B, T, E, F_), kind="fused_ffn_block_q8", light=light,
                   B=B, T=T, E=E, F=F_, residual=residual)


def quant_train_q8_checks(gen, compare, block_params, rnd):
    """The W8A8 kernels at the rows ``QUANT_TRAIN`` gives the frozen
    denoisers in a fit step of phase 6b (2 x 8 person-stacked sequences of
    300 frames): the QKV product and the three blocks of the 1024-d
    denoisers, against their plain versions."""
    B, T = 2 * TRAIN_B, TRAIN_T
    label = f" B={B} training rows"
    return [_q8_linear_case(gen, rnd, B * T, "linear_q8 QKV E=1024" + label, 1024, 3072),
            _sa_q8(compare, block_params, rnd, B, T, 1024, 8, True, kpm_tail=True, label=label),
            _ca_q8(compare, block_params, rnd, B, T, 1024, 8, True, label=label),
            _ffn_q8(compare, block_params, rnd, B, T, 1024, 2048, True, label=label)]


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

    # --- adaln_modulate_q8 (:func:`_adaln_q8_case`)
    for B, T, E in ((8, 299, 1024), (8, 299, 512), (3, 131, 1024)):
        results.append(_adaln_q8_case(rnd, B, T, E))

    for name, K, N, kw in (("QKV E=1024", 1024, 3072, {}),
                           ("FFN1 gelu f32 E=1024", 1024, 2048, {"act": "gelu"}),
                           ("FFN2 +residual E=1024", 2048, 1024, {"res": True}),
                           ("out-proj +residual E=1024", 1024, 1024, {"res": True}),
                           ("QKV E=512", 512, 1536, {}),
                           ("out-proj +residual E=512", 512, 512, {"res": True}),
                           ("FFN1 gelu f32 E=512", 512, 1024, {"act": "gelu"}),
                           ("FFN2 +residual E=512", 1024, 512, {"res": True})):
        results.append(_q8_linear_case(gen, rnd, M, "linear_q8 " + name, K, N, **kw))
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

    results.append(_sa_q8(compare, block_params, rnd, 8, 299, 1024, 8, True))
    results.append(_sa_q8(compare, block_params, rnd, 8, 299, 1024, 8, False, kpm_tail=True))
    results.append(_sa_q8(compare, block_params, rnd, 8, 299, 512, 8, True))
    results.append(_ca_q8(compare, block_params, rnd, 8, 299, 1024, 8, True))
    results.append(_ca_q8(compare, block_params, rnd, 8, 299, 512, 8, True))
    results.append(_ffn_q8(compare, block_params, rnd, 8, 299, 1024, 2048, True))
    results.append(_ffn_q8(compare, block_params, rnd, 8, 299, 512, 1024, True))
    return results


# The fused quantising epilogues against their plain compositions, on the
# dequantised values x8 * s, max |diff| / max |plain|: the unfused kernel's
# own limit against its plain version (attention 2e-2, the int8 GELU
# product 1e-5) plus one int8 step (1 / 127 of a row's amax), by which a
# value on a rounding boundary may move.
FUSED_Q8_TOL = {"attention_q8": 2e-2 + 1 / 127, "linear_q8_gelu_q8": 1e-5 + 1 / 127}


def fused_q8_checks(gen, rnd, rows=None):
    """``attention_q8`` and the quantising GELU product (``linear_q8_gelu_q8``)
    at the six shapes where the W8A8 step quantised with ``quant_rows``
    before: int8 values and scales bitwise ``quant_rows`` of the unfused
    kernel's output on the same inputs, and the dequantised values against
    the plain composition (:data:`FUSED_Q8_TOL`); timed beside the unfused
    pair they replace (the producer kernel, then ``quant_rows``), with every
    warpgroup count of the plan forced beside the one it picks (rows per
    block: the plan's choice rests on these readings), and a ragged case of
    each (not timed).  With ``rows`` ((sequences, T), ...), instead: each
    kernel at the shapes of those batches (:data:`EVAL_GEN_ROWS`), on the
    plans they pick, timed lightly."""
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

    def held(name, kind, got, pair, plain, n_bytes, ops_, peak, timing, light=False, **shape):
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
            dev_ms = light_timed if light else graph_timed
            res.update({"ms": dev_ms(kern), "pair_ms": dev_ms(pair_fn),
                        "plain_ms": dev_ms(plain_fn),
                        "eager_ms": None if light else timed(kern),
                        "host_us": None if light else host_us(kern)})
        print("   " + json.dumps(res), flush=True)
        return res

    # --- attention_q8: Q, K, V as the blocks pass them (slices of a packed
    # projection); the SA form quantises the f32 output, the CA form its bf16
    # rounding.
    def attn_q8(name, B, T, H, D, out_dtype, kpm_rows=(), time_it=True, light=False):
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
                   H100_BF16_FLOPS, (kern, pair, plain) if time_it else None, light=light, B=B,
                   H=H, Tq=T, Tk=T, D=D, out=str(out_dtype)[6:], masked_rows=list(kpm_rows),
                   plan={"nwg": plan.nwg, "stages": plan.stages, "ctas": plan.grid[0] * H * B,
                         "clusters_at_once": clusters})
        if time_it and not light:
            res["by_nwg"] = forced(attn_mod, "attention_q8_plan", "nwg",
                                   range(1, attn_mod.MAX_WARPGROUPS + 1), (B, H, T, T, D),
                                   kern, pair)
            res["ok"] = res["ok"] and all(r["bitwise_vs_unfused_kernel"]
                                          for r in res["by_nwg"].values())
            print("   " + json.dumps({"check": name, "by_nwg": res["by_nwg"]}), flush=True)
        return res

    # --- the quantising GELU product (FFN1 of the W8A8 FFN blocks) ----------
    def gelu_q8(name, M_, K, N, time_it=True, light=False):
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
                   H100_INT8_OPS, (kern, pair, plain) if time_it else None, light=light, M=M_,
                   K=K, N=N, plan=dataclasses.asdict(plan))
        if time_it and not light:
            res["by_nc"] = forced(lq, "gelu_q8_plan", "nc", lq.GELU_Q8_WARPGROUPS,
                                  (M_, N, K), kern, pair)
            res["ok"] = res["ok"] and all(r["bitwise_vs_unfused_kernel"]
                                          for r in res["by_nc"].values())
            print("   " + json.dumps({"check": name, "by_nc": res["by_nc"]}), flush=True)
        return res

    if rows:
        for S, T in rows:
            lab = f" B={S} T={T}"
            for D, form, dt in ((128, "SA f32", torch.float32), (64, "SA f32", torch.float32),
                                (128, "CA bf16", torch.bfloat16), (64, "CA bf16", torch.bfloat16)):
                results.append(attn_q8(f"attention_q8 {form} D={D}{lab}", S, T, 8, D, dt,
                                       light=True))
            results.append(gelu_q8(f"linear_q8_gelu_q8 FFN1 E=1024{lab}", S * T, 1024, 2048,
                                   light=True))
            results.append(gelu_q8(f"linear_q8_gelu_q8 FFN1 E=512{lab}", S * T, 512, 1024,
                                   light=True))
        return results

    M = 8 * 299
    results.append(attn_q8("attention_q8 SA f32 D=128", 8, 299, 8, 128, torch.float32))
    results.append(attn_q8("attention_q8 SA f32 D=64", 8, 299, 8, 64, torch.float32))
    results.append(attn_q8("attention_q8 CA bf16 D=128", 8, 299, 8, 128, torch.bfloat16))
    results.append(attn_q8("attention_q8 CA bf16 D=64", 8, 299, 8, 64, torch.bfloat16))
    results.append(attn_q8("attention_q8 T=131 key padding + masked row", 3, 131, 8, 128,
                           torch.bfloat16, kpm_rows=(1,), time_it=False))
    results.append(gelu_q8("linear_q8_gelu_q8 FFN1 E=1024", M, 1024, 2048))
    results.append(gelu_q8("linear_q8_gelu_q8 FFN1 E=512", M, 512, 1024))
    results.append(gelu_q8("linear_q8_gelu_q8 M=393 N=1040 (ragged)", 393, 1024, 1040,
                           time_it=False))
    return results


# f32 attention is held at ~1e-5 of max |plain|: the plain versions are f32
# products (TF32 off: set in main()); the kernels' products are f32 FMA (the
# forward's warp-per-row route) or three TF32 passes on the tensor cores
# (the tiled routes and the backward's other kernel, ~2^-22 a product), so
# beyond the order of the sums they differ by a few f32 roundings.
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


def _pair_bound(B, H, T, D, e, kpm, zero_attn):
    """The bound of attention's forward with statistics + backward, and of
    the backward alone: q, k, v read and o written by the forward (and the
    statistics); q, k, v, g, o read and dq, dk, dv written by the
    backward; 2 + 5 products of 2 * H*T*D operations for every (query row,
    key) pair that the key mask leaves (the zero key counted).  f32 on the
    tensor cores in three TF32 passes, bf16 at its peak."""
    keys = B * T if kpm is None else int((~kpm).sum())
    keys += B if zero_attn else 0
    peak = H100_F32_MMA_FLOPS if e == 4 else H100_BF16_FLOPS
    pair_bytes = 12 * B * H * T * D * e + 8 * B * H * T + (2 * B * T if kpm is not None else 0)
    b_ms, b_by = bound_ms(pair_bytes, 7 * 2 * H * T * keys * D, peak)
    bwd_b_ms, _ = bound_ms(8 * B * H * T * D * e + 8 * B * H * T, 5 * 2 * H * T * keys * D, peak)
    return b_ms, b_by, bwd_b_ms


# --- attention_bwd -------------------------------------------------------
# What autograd runs (ops.FusedAttention): the forward that also writes
# the row statistics, then the backward from them and the forward's
# output.  The row's ms times that pair, against SDPA forward + backward;
# the backward alone stands beside it.
def _bwd_case(gen, name, dt, B, H, T, D, zero_attn, kpm_tail, masked_rows=(), time_it=True,
              route=None):
    import torch
    import torch.nn.functional as F

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.ops import attention as attn_mod

    dev = torch.device("cuda")
    q, k, v, g = (torch.randn(B, H, T, D, generator=gen, device=dev).to(dt) for _ in range(4))
    kpm = None
    if kpm_tail or masked_rows:
        kpm = torch.zeros(B, T, dtype=torch.bool, device=dev)
        if kpm_tail:
            kpm[:, T - T // 5:] = True
        for r in masked_rows:
            kpm[r] = True                      # every key of one sequence masked
    out, stats = ops.fused_attention(q, k, v, kpm, None, zero_attn, return_stats=True,
                                     route=route)
    kern = lambda: ops.attention_bwd(q, k, v, kpm, g, zero_attn, stats, out,  # noqa: E731
                                     route=route)
    plain = lambda: ops.attention_bwd_plain(q, k, v, kpm, g, zero_attn, stats,  # noqa: E731
                                            out)

    def pair():
        o, st = ops.fused_attention(q, k, v, kpm, None, zero_attn, return_stats=True,
                                    route=route)
        return ops.attention_bwd(q, k, v, kpm, g, zero_attn, st, o, route=route)

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
    b_ms, b_by, bwd_b_ms = _pair_bound(B, H, T, D, q.element_size(), kpm, zero_attn)
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


def train_kernel_checks(gen, compare):
    """The kernels of the training path: the f32-input ``attention`` (the
    text heads) and ``attention_bwd`` (G step: discriminators in bf16, the
    mixer's head in f32), each against its plain version."""
    import torch
    import torch.nn.functional as F

    from mixermdm_tpu_torch import ops

    dev = torch.device("cuda")
    results = []

    def rnd(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    # --- attention, f32 inputs ---------------------------------------------
    f32_cases = (("attention f32 post-encoder D=96", (2, 8, 77, 96, False)),
                 ("attention f32 clip tower D=64", (2, 12, 77, 64, True)))
    for name, (B, H, T, D, causal) in f32_cases:
        q, k, v = rnd(B, H, T, D), rnd(B, H, T, D), rnd(B, H, T, D)
        am = torch.triu(torch.full((T, T), float("-inf"), device=dev), 1) if causal else None
        n_bytes = 4 * 4 * B * H * T * D + (4 * T * T if causal else 0)
        results.append(compare(
            name, lambda: ops.fused_attention(q, k, v, None, am, False),
            lambda: ops.fused_attention_plain(q, k, v, None, am, False), F32_TOL, n_bytes,
            4 * B * H * T * T * D,
            library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am),
            kind="attention_f32", peak=H100_F32_MMA_FLOPS, B=B, H=H, Tq=T, Tk=T, D=D,
            zero_attn=False, causal=causal))

    # G step: the discriminators' attention (bf16, 4 heads of 64, T = 300,
    # zero-attn, key padding) and the mixer head's (f32, 8 heads of 96).
    results.append(_bwd_case(gen, "attention_bwd bf16 discriminator", torch.bfloat16, 8, 4,
                             300, 64, True, True))
    # The heads pin the warp-per-row route (models/layers.py), as here.
    results.append(_bwd_case(gen, "attention_bwd f32 post-encoder", torch.float32, 8, 8, 77,
                             96, False, False, route="rows"))
    # A sequence whose keys are all masked, with and without the zero key,
    # in both dtypes (small: checks, not timed).
    for dt, D in ((torch.bfloat16, 64), (torch.float32, 96)):
        for zero_attn in (True, False):
            results.append(_bwd_case(
                gen, f"attention_bwd {str(dt)[6:]} fully masked row zero_attn={zero_attn}", dt,
                3, 2, 45, D, zero_attn, True, masked_rows=(1,), time_it=False))
    return results


def base_bwd_checks(gen):
    """``attention_bwd`` at the base models' training shapes (phase 6b's
    denoisers at dropout 0: in2IN's 8 heads of 128 over 300 frames and the
    zero key, MDM's 4 heads of 128 over the cond token + 300 frames without
    it; both under a key mask, B 4), against its plain version."""
    import torch

    # in2IN stacks the two persons: 2 x B rows.
    return [_bwd_case(gen, "attention_bwd bf16 in2IN denoiser D=128", torch.bfloat16,
                      2 * BASE_TRAIN_B, 8, TRAIN_T, 128, True, True),
            _bwd_case(gen, "attention_bwd bf16 MDM encoder D=128", torch.bfloat16, BASE_TRAIN_B,
                      4, TRAIN_T + 1, 128, False, True)]


# The InterCLIP towers (phases 5d and 6c), f32: the motion tower's query
# token + 300 frames under a key mask, 8 heads of 128; the text tower's 77
# tokens, 8 heads of 96, no mask.  The forward at the protocol's InterHuman
# batch of 96, the backward at train-evaluator's batch of 32.
EVAL_B, EVAL_TRAIN_B, EVAL_T = 96, 32, 301
# The protocol's generation batches on the sampling kernels (phase 5d (c)):
# eval-mixermdm samples InterHuman's 96 prompts and HumanML3D's 32 on the
# W8A8 path, 4 sequences a prompt (CFG x the two persons) at the batch's
# longest item (299 frames in phase 5d's InterHuman set, 300 in its
# HumanML3D set).
EVAL_IH_CLIPS, EVAL_HML_CLIPS = 96, 32
EVAL_GEN_ROWS = ((4 * EVAL_IH_CLIPS, 299), (4 * EVAL_HML_CLIPS, 300))
# One W8A8 step's int8 products, (K, N, residual), as phase 5 counts them:
# QKV, the cross-attention's Q and KV, the out-projections and FFN2 with
# the residual, of the 1024-d denoisers and the 512-d mixer core.
EVAL_Q8_GEMMS = ((512, 512, False), (512, 512, True), (512, 1024, False), (512, 1536, False),
                 (1024, 512, True), (1024, 1024, False), (1024, 1024, True),
                 (1024, 2048, False), (1024, 3072, False), (2048, 1024, True))
# Its bf16 products, (K, N): at every frame (the final layers, the influence
# head, motion_embed) and at 2 or 4 rows a prompt (the AdaLN modulations,
# the time and text embeddings).
EVAL_GEMMS_FRAMES = ((1024, 262), (512, 23), (262, 1024), (262, 512))
EVAL_GEMMS_2P = ((512, 512), (768, 512), (768, 1024), (1024, 1024))
EVAL_GEMMS_4P = ((512, 1024), (768, 1024), (1024, 1024), (1024, 2048))
# eval-base's largest batch: in2IN interaction's 4-way CFG over InterHuman's
# 96 prompts, 8 sequences a prompt, bf16.
EVAL_BASE_ROWS = 8 * EVAL_IH_CLIPS


def eval_kernel_checks(gen, compare):
    """``attention_f32`` at the evaluator's two shapes and ``attention_bwd``
    f32 (with the forward that writes its statistics) at train-evaluator's,
    each against its plain version.  The motion tower's keys past a
    sequence's length are masked; the bound counts the products over the
    keys that are not (what the masked logits need is their bias)."""
    import torch
    import torch.nn.functional as F

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.ops import attention as attn_mod

    dev = torch.device("cuda")
    results = []
    for name, (B, H, T, D, masked) in (
            ("attention f32 InterCLIP motion D=128 kpm", (EVAL_B, 8, EVAL_T, 128, True)),
            ("attention f32 InterCLIP text D=96", (EVAL_B, 8, 77, 96, False))):
        q, k, v = (torch.randn(B, H, T, D, generator=gen, device=dev) for _ in range(3))
        kpm = bias = None
        keys = B * T
        if masked:  # the query token and 15-300 frames valid
            lens = torch.randint(15, T, (B,), generator=gen, device=dev)
            kpm = torch.arange(T, device=dev)[None, :] > lens[:, None]
            bias = attn_mod.key_bias(kpm)[:, None, None, :]
            keys = int((~kpm).sum())
        results.append(compare(
            name, lambda: ops.fused_attention(q, k, v, kpm, None, False),
            lambda: ops.fused_attention_plain(q, k, v, kpm, None, False), F32_TOL,
            4 * 4 * B * H * T * D + (B * T if masked else 0), 4 * H * T * keys * D,
            library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias),
            kind="attention_f32", peak=H100_F32_MMA_FLOPS, B=B, H=H, Tq=T, Tk=T, D=D,
            zero_attn=False, key_padding=masked, valid_keys=keys))
    results.append(_bwd_case(gen, "attention_bwd f32 InterCLIP motion D=128", torch.float32,
                             EVAL_TRAIN_B, 8, EVAL_T, 128, False, True))
    results.append(_bwd_case(gen, "attention_bwd f32 InterCLIP text D=96", torch.float32,
                             EVAL_TRAIN_B, 8, 77, 96, False, False))
    return results


# The f32 attention's routes (ops.attention.F32_ROUTES) at the InterCLIP
# towers' shapes, the post-encoder heads' and the f32 CLIP tower's, and at
# B 8 / 16 of the head shape (the dispatch changes between B 2 and 8): each route's
# forward (and, for the backward's shapes, forward with statistics +
# backward) against the plain version and timed beside SDPA.
F32_FWD_SHAPES = (  # (name, B, H, T, D, key mask, causal)
    ("motion", EVAL_B, 8, EVAL_T, 128, True, False), ("text", EVAL_B, 8, 77, 96, False, False),
    ("head", 2, 8, 77, 96, False, False), ("clip tower", 2, 12, 77, 64, False, True),
    ("head B=8", 8, 8, 77, 96, False, False), ("head B=16", 16, 8, 77, 96, False, False))
F32_BWD_SHAPES = (  # (name, B, H, T, D, key mask)
    ("motion", EVAL_TRAIN_B, 8, EVAL_T, 128, True), ("text", EVAL_TRAIN_B, 8, 77, 96, False),
    ("head training", 8, 8, 77, 96, False))


def _motion_mask(gen, B, T, dev):
    """The motion tower's key mask: the query token and 15-300 frames valid."""
    import torch

    lens = torch.randint(15, T, (B,), generator=gen, device=dev)
    return torch.arange(T, device=dev)[None, :] > lens[:, None]


def _mask_cases(B, T, dev):
    """The key masks that exercise the tiled routes' passing over fully
    masked keys: (name, mask, zero_attn)."""
    import torch

    lens = torch.arange(B, device=dev) * 7 % (T - 30) + 20
    tail = torch.arange(T, device=dev)[None, :] > lens[:, None]
    all_one = tail.clone()
    all_one[1] = True                 # every key of sequence 1 masked, no zero key
    middle = torch.zeros(B, T, dtype=torch.bool, device=dev)
    middle[:, 40:170] = True          # whole tiles masked in the middle of the row
    middle[2, 200:] = True
    zero_tail = tail.clone()
    zero_tail[3] = True               # with the zero key: every tile of sequence 3 passed over
    return (("one sequence all masked, no zero key", all_one, False),
            ("masked tiles in the middle", middle, False),
            ("zero key + masked tail", zero_tail, True))


def f32_route_checks(seed):
    """Phase 3's f32 routes: every shape of :data:`F32_FWD_SHAPES` /
    :data:`F32_BWD_SHAPES` on both routes against the plain version on
    ``F32_TOL`` (the forward's statistics on ``STATS_TOL``), each timed
    beside SDPA, the route the dispatch takes printed; then the three mask
    cases of :func:`_mask_cases` on the forward at the motion tower's shape
    and on the backward at train-evaluator's."""
    import torch
    import torch.nn.functional as F

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.ops import attention as attn_mod

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    results = []

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp_min(1e-30)).item()

    def fwd(q, k, v, kpm, am, za, route):
        B, H, Tq, _ = q.shape
        st = torch.empty((2, B, H, Tq), dtype=torch.float32, device=dev)
        o = attn_mod.attention_into(q, k, v, torch.empty_like(q), kpm, am, za, st, route=route)
        return o, st

    def fwd_check(name, q, k, v, kpm, am, za, time_it):
        want = ops.fused_attention_plain(q, k, v, kpm, am, za)
        want_st = attn_mod.attention_stats_plain(q, k, kpm, am, za)
        B, H, T, D = q.shape
        # The bound as phase 3's other f32 rows count it: the products over
        # the keys that the mask leaves, three TF32 passes.
        keys = (B * T if kpm is None else int((~kpm).sum())) + (B if za else 0)
        b_ms, b_by = bound_ms(16 * B * H * T * D + (B * T if kpm is not None else 0)
                              + (4 * T * T if am is not None else 0), 4 * H * T * keys * D,
                              H100_F32_MMA_FLOPS)
        res = {"check": f"attention_f32 routes {name}", "kind": "attention_f32 routes",
               "shape": {"B": B, "H": H, "Tq": T, "Tk": T, "D": D, "zero_attn": za,
                         "key_padding": kpm is not None, "causal": am is not None},
               "dispatch": attn_mod.attention_f32_plan(B, H, T, T, D).route, "err": {},
               "stats_err": {}, "ms": {}, "tol_rel": F32_TOL, "stats_tol": STATS_TOL,
               "bound_ms": b_ms, "bound_by": b_by}
        for route in attn_mod.F32_ROUTES:
            o, st = fwd(q, k, v, kpm, am, za, route)
            torch.cuda.synchronize()
            res["err"][route] = rel(o, want)
            res["stats_err"][route] = max(rel(st[i], want_st[i]) for i in range(2))
            if time_it:
                res["ms"][route] = graph_timed(lambda r=route: fwd(q, k, v, kpm, am, za, r))
        res["ok"] = all(e <= F32_TOL for e in res["err"].values()) and all(
            e <= STATS_TOL for e in res["stats_err"].values())
        return res

    def bwd_check(name, q, k, v, g, kpm, za, time_it):
        B, H, T, D = q.shape
        b_ms, b_by, bwd_b_ms = _pair_bound(B, H, T, D, 4, kpm, za)
        res = {"check": f"attention_bwd f32 routes {name}", "kind": "attention_bwd routes",
               "shape": {"B": B, "H": H, "Tq": T, "Tk": T, "D": D, "zero_attn": za,
                         "key_padding": kpm is not None},
               "dispatch": attn_mod.attention_bwd_f32_plan(B, H, T, T, D).route, "err": {},
               "ms": {}, "bwd_ms": {}, "tol_rel": F32_TOL, "bound_ms": b_ms, "bound_by": b_by,
               "bwd_bound_ms": bwd_b_ms}

        def pair(route):
            o, st = fwd(q, k, v, kpm, None, za, route)
            return ops.attention_bwd(q, k, v, kpm, g, za, st, o, route=route)

        for route in attn_mod.F32_ROUTES:
            o, st = fwd(q, k, v, kpm, None, za, route)
            got = ops.attention_bwd(q, k, v, kpm, g, za, st, o, route=route)
            torch.cuda.synchronize()
            want = ops.attention_bwd_plain(q, k, v, kpm, g, za, st, o)
            res["err"][route] = max(rel(a, b) for a, b in zip(got, want))
            if time_it:
                res["ms"][route] = graph_timed(lambda r=route: pair(r))
                res["bwd_ms"][route] = graph_timed(
                    lambda r=route: ops.attention_bwd(q, k, v, kpm, g, za, st, o, route=r))
        res["ok"] = all(e <= F32_TOL for e in res["err"].values())
        return res

    def inputs(B, H, T, D, n):
        return [torch.randn(B, H, T, D, generator=gen, device=dev) for _ in range(n)]

    for name, B, H, T, D, masked, causal in F32_FWD_SHAPES:
        q, k, v = inputs(B, H, T, D, 3)
        kpm = _motion_mask(gen, B, T, dev) if masked else None
        am = torch.triu(torch.full((T, T), float("-inf"), device=dev), 1) if causal else None
        bias = attn_mod.key_bias(kpm)[:, None, None, :] if masked else am
        res = fwd_check(f"{name} {(B, H, T, D)}", q, k, v, kpm, am, False, True)
        res["library_ms"] = graph_timed(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias))
        results.append(res)
        print("   " + json.dumps(res), flush=True)
    for name, B, H, T, D, masked in F32_BWD_SHAPES:
        q, k, v, g = inputs(B, H, T, D, 4)
        kpm = _motion_mask(gen, B, T, dev) if masked else None
        bias = attn_mod.key_bias(kpm)[:, None, None, :] if masked else None
        res = bwd_check(f"{name} {(B, H, T, D)}", q, k, v, g, kpm, False, True)
        lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))

        def library():  # SDPA forward + backward
            o = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=bias)
            return torch.autograd.grad(o, (lq, lk, lv), g)

        res["library_ms"] = graph_timed(library)
        results.append(res)
        print("   " + json.dumps(res), flush=True)
    for B, n in ((EVAL_B, 3), (EVAL_TRAIN_B, 4)):
        for name, kpm, za in _mask_cases(B, EVAL_T, dev):
            ins = inputs(B, 8, EVAL_T, 128, n)
            label = f"motion B={B}: {name}"
            res = (fwd_check(label, *ins, kpm, None, za, False) if n == 3
                   else bwd_check(label, *ins, kpm, za, False))
            results.append(res)
            print("   " + json.dumps(res), flush=True)
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
# The SA blocks' shape, the mixer's width (head dim 64, the kernels' other
# instantiation) and the experiment script's B 40.
SA_SHAPES = ((8, 299, 1024, 8), (8, 299, 512, 8), (40, 299, 1024, 8))
SA_TIMED_B = 8  # B 40 is timed by the experiment script's own run
# The cases whose phases (ops.sa_variants.phase_stamps) are printed at B 8,
# E 1024: median ns of each phase over SA_PHASE_READS launches.
SA_PHASE_CASES = ("rows=1 recip=0", "static act scale")
SA_PHASE_READS = 5


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
    """The int8 p.v of sa_block_i8x on its own q, k, v (``mid``: the
    operands its launch wrote, ``sa_int8x(intermediates=)``) against the
    plain product: the integer sums p8.v8 of both, how many differ, and how
    many differ by more than the keys whose 127 p lies within SA_FLIP_REL
    (relative) of a rounding boundary can move them (each such key moves a
    sum by at most |v8|)."""
    import torch

    q, k, v = (mid[n].float() for n in "qkv")
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
    at the SA blocks' shape (8, 299, 1024), H 8, at the mixer's width (8,
    299, 512), H 8 (head dim 64), and at the kernel experiments' B 40; at
    B 8 also with keys masked (sa_variant, sa_int8x), and there graph-replay
    ms beside the shipped composition (fused_sa_block / fused_sa_block_q8 on
    the same inputs) and the H100's bound, and host us per eager call; at
    (8, 299, 1024) each phase's device time of sa_variant rows 1 (bf16,
    W8A8) and sa_int8x static (ops.sa_variants.phase_stamps).  The int8 p.v
    configurations also launch once more with the scratch kept (the same
    output, bit for bit) and hold the int8 operands bitwise against the
    plain operand pass on the kernel's q, k, v, the kernel's attention alone
    against the plain one on those q, k, v (:func:`_qpv_witness`) and the
    block's tail (quantised attention, out-projection, residual) against the
    plain tail on the kernel's attention.  Then the W8A8 blocks at shapes
    whose fused plan refuses them (16 heads; F 4096) through the unfused
    pair, against their plain versions.  Then the slice's path: the
    experiment script (``python -m mixermdm_tpu_torch.scripts.exp_kernels``)
    in each of its modes at B 40, which times B 40 (and reads its phases
    there), with the launch counts of that run.
    Returns (results, counts)."""
    import torch

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.ops import _lib
    from mixermdm_tpu_torch.ops import sa_variants as sv
    from mixermdm_tpu_torch.scripts import exp_kernels as ek

    results = []
    for B, T, E, H in SA_SHAPES:
        timed = B == SA_TIMED_B
        at = f"B={B}" + (f" E={E}" if E != 1024 else "")
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
            got = outs[name, quant] = run()
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
                "check": f"{kernel} {name} {'w8a8' if quant else 'bf16'} {at}", "kind": kernel,
                "shape": {"B": B, "T": T, "E": E, "H": H, "quant": quant, "masked_keys":
                          B * T - keys, **kw},
                "max_abs_err": max_abs, "max_rel_err": rel, "tol_rel": tol,
                "update_rel_l2": l2, "tol_l2": SA_L2_TOL,
                "bound_ms": bound, "bound_by": by, "library_ms": None,
                "ms": None, "shipped_ms": shipped[quant][0], "shipped_host_us": shipped[quant][1],
                "host_us": None, "plain_ms": None,
            }
            if qpv:
                # Each stage alone, read from a second launch of the same
                # route that keeps its scratch (its output bit for bit the
                # checked one's): the projections, the int8 operands against
                # the plain operand pass on the kernel's q, k, v, the
                # attention on them, and the tail on the kernel's attention
                # (the plain tail: quant_rows, linear_q8 with bias and cast,
                # + x).
                qqk = kw.get("qqk", False)
                mid = {}
                res["same_as_checked"] = torch.equal(run(intermediates=mid), got)
                torch.cuda.synchronize()
                _, kp = sv._pad(inp.x, mask)
                ours = torch.cat([mid[n].float() for n in "qkv"], dim=-1)
                qkv = sv.sa_int8x_qkv_plain(*args, static_as=kw.get("static_as"))
                res["qkv_rel_err"] = _finite_rel(ours, qkv)[1]
                q8, k8, v8 = sv.i8x_operands_plain(ours, H, qqk=qqk, qpv=True)
                res["operands_bitwise"] = torch.equal(mid["v8"], v8) and (
                    not qqk or torch.equal(mid["q8"], q8) and torch.equal(mid["k8"], k8))
                res["witness"] = wit = _qpv_witness(sv, mid, kp, H, T, qqk)
                a8, as_ = sv.quant_rows_plain(mid["attn"])
                tail = sv.linear_q8_plain(a8, as_, w.w8_o, w.s_o, w.b_o, dtype=inp.x.dtype,
                                          residual=sv._pad(inp.x, None)[0])[:, :T]
                res["tail_rel_err"] = _finite_rel(got, tail)[1]
                ok = (ok and res["same_as_checked"] and res["qkv_rel_err"] <= SA_TOL
                      and res["operands_bitwise"] and wit["unexplained"] == 0
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
        res = {"check": f"sa_block schedule {at}", "kind": "sa_block", "bitwise": same,
               "ok": all(same.values())}
        print("   " + json.dumps(res), flush=True)
        results.append(res)
        if timed and E == 1024:
            # Each phase's device time (block 0's %globaltimer at the start
            # and after each grid barrier, the latest block's end).
            split = {}
            for name, kernel, quant, kw, mask, run in cases:
                if name not in SA_PHASE_CASES:
                    continue
                with sv.phase_stamps() as log:
                    for _ in range(SA_PHASE_READS):
                        run()
                torch.cuda.synchronize()
                reads = [sv.phase_ns(e) for e in log]
                split[f"{kernel} {name} {'w8a8' if quant else 'bf16'}"] = {
                    k: sorted(r[k] for r in reads)[len(reads) // 2] for k in reads[0]}
            print("   " + json.dumps({"check": f"sa phases {at}", "phase_ns": split}), flush=True)

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
                 ["--ablate", "--quant"], ["--int8attn"], ["--phases"]):
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


def _gemm_shapes():
    """The GEMM launches counted by shape so far: {(route, M, K, N,
    epilogue): n}."""
    from mixermdm_tpu_torch.ops import _lib

    return collections.Counter({k: n for k, n in _lib.launch_shapes.items()
                                if k[0] in GEMM_NAMES})


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
            text_shapes = _gemm_shapes()
            out = system.sample(cond, T,
                                generator=torch.Generator(device="cuda").manual_seed(seed))
            torch.cuda.synchronize()
            t2 = time.time()
            counts[label] = dict(ops.launches)
            chain_shapes = _gemm_shapes() - text_shapes
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


def _save_released(system, root, with_clip=False):
    """The three released files of ``system`` (the mixer file without its
    CLIP tower, as the released MixerMDM.ckpt drops it, unless
    ``with_clip``); their paths."""
    import torch

    from mixermdm_tpu_torch.weights import released_in2in_state_dict, \
        released_mixermdm_state_dict

    files = (f"{root}/MixerMDM.ckpt", f"{root}/individual.ckpt", f"{root}/interaction.ckpt")
    torch.save({"state_dict": released_mixermdm_state_dict(system, with_clip=with_clip)},
               files[0])
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
    gemms = sorted(_gemm_shapes().items(), key=lambda kv: -kv[1])
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
# Phase 5e: the diffusion engine at full width
# --------------------------------------------------------------------------

# in2IN interaction (4-way CFG, bf16: its configs leave QUANT off) at the
# infer-in2in request (BASE_B, IN2IN_T) on its 50-step respaced schedule.
# (a) holds each step function from one latent at chain index ENGINE_STEP,
# with one injected noise; (b) runs the chains: DDPM with the first
# ENGINE_PRE frames inpainted, the root XZ pinned at ENGINE_PINS and the
# mean shifted by a cond_fn; DDIM at ENGINE_ETA with the score conditioned;
# the reverse ODE of that DDIM sample and the decode of its latent; the
# whole bound of the sample.
ENGINE_STEP, ENGINE_ETA, ENGINE_PRE = 25, 0.5, 30
ENGINE_PINS = ((60, 0.4, 0.8), (120, 0.8, 1.6), (180, 1.2, 2.4))
# Each chain's own arithmetic: replayed on the CPU in float64 from the
# chain's recorded model outputs and its noises (the network is the card's,
# so bf16 does not enter the replay), the states the model saw and the
# chain's result held on ||card - replay|| / ||replay||, the largest over
# the steps.  The card runs the engine in float32: over 50 steps a few
# float32 roundings a step, about 1e-6.  Where float32 itself cannot
# resolve a result (the bound's decoder term at t == 0 takes the log of a
# bin's mass, a difference of two cdf values near 1; DDIM's eps near t == 0
# divides by sqrt(1 / a - 1)), the limit is WITNESS_RATIO x the distance of
# the same chain replayed in float32 on the CPU.  A first reading on an
# H100: the bound's vb 1.08e-4 from float64.
REPLAY_TOL = 1e-4


def _root_cond_fn(x, t_orig):
    """``grad log p(y | x)`` of a root-XZ target (person 1's root pulled to
    (0.5, 1.0) in the model's space), taken by autograd on a detached ``x``
    alone: the denoiser's call records no gradient and keeps its fused
    kernels."""
    import torch

    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        loss = -0.5 * ((x[..., 0] - 0.5) ** 2 + (x[..., 2] - 1.0) ** 2).sum()
        return 0.1 * torch.autograd.grad(loss, x)[0]


class _Recorder:
    """A model function that keeps each call's input and output (device
    copies) for the replay."""

    def __init__(self, fn):
        self.fn, self.inputs, self.outputs = fn, [], []

    def __call__(self, x, t):
        out = self.fn(x, t)
        self.inputs.append(x.clone())
        self.outputs.append(out.clone())
        return out

    def replay(self, dtype):
        """A model function that hands back the recorded outputs in order,
        in ``dtype`` on the CPU, and the list of the inputs it is given."""
        outs, seen = iter([o.cpu().to(dtype) for o in self.outputs]), []

        def fn(x, t):
            seen.append(x)
            return next(outs)
        return fn, seen


def _rel_fro(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _engine_steps(model_fn, s, x, z, x_start, t):
    """One step of each engine function from latent ``x`` at ``t`` with the
    noise ``z``; the VLB term of ``x_start`` q-sampled there with ``z``."""
    from mixermdm_tpu_torch.diffusion.gaussian import ddim_step, ddpm_step, p_mean_variance, \
        q_sample
    from mixermdm_tpu_torch.diffusion.guidance import condition_mean, condition_score, \
        ddim_reverse_step
    from mixermdm_tpu_torch.diffusion.vlb import vb_terms_bpd

    out = p_mean_variance(model_fn, s, x, t)
    x0 = out["pred_xstart"]
    return {
        "p_mean_variance x0": x0,
        "ddpm_step": ddpm_step(s, out, t, z),
        f"ddim_step eta {ENGINE_ETA}": ddim_step(s, x, t, x0, ENGINE_ETA, z),
        "condition_mean": condition_mean(_root_cond_fn, s, out, x, t),
        "condition_score x0": condition_score(_root_cond_fn, s, out, x, t)["pred_xstart"],
        "ddim_reverse_step": ddim_reverse_step(s, x, t, x0),
        "vb_terms_bpd": vb_terms_bpd(model_fn, s, x_start, q_sample(s, x_start, t, z),
                                     t)["output"],
    }


def engine_phase(seed, card, device="cuda", tiny=False):
    """The diffusion engine (``diffusion/{gaussian,guidance,vlb}.py``) on
    the in2IN interaction denoiser at full width, random weights from
    ``seed`` (zero-init layers N(0, 0.02)), B 2, T 210, DDIM-50's schedule:

    (a) each step function (``p_mean_variance`` -> ``ddpm_step``,
        ``ddim_step`` at eta 0.5, ``condition_mean``, ``condition_score``,
        ``ddim_reverse_step``, ``vb_terms_bpd``) on the kernels against the
        plain versions, one latent and one noise, on STEP_TOL as phase 5c
        holds this network's CFG steps;
    (b) the chains on the kernels, each counted and timed: DDPM-50 with
        ``pre_seq``, ``transl_req`` and ``cond_fn``; DDIM-50 at eta 0.5
        with ``cond_fn``; ``ddim_encode_loop`` of that sample and the
        DDIM-50 decode of its latent (the reconstruction gap printed);
        ``calc_bpd_loop`` of the sample; each replayed in float64 on the
        CPU from its recorded model outputs and noises on REPLAY_TOL.

    ``tiny`` (with ``device="cpu"``) runs the same at the tiny config, a
    rehearsal of the control flow.  Returns (launches of the chains,
    readings)."""
    import torch

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.cli import infer_in2in
    from mixermdm_tpu_torch.diffusion.gaussian import ddim_sample_loop, p_sample_loop
    from mixermdm_tpu_torch.diffusion.guidance import ddim_encode_loop
    from mixermdm_tpu_torch.diffusion.schedule import named_schedule, resolve_sampler_strategy
    from mixermdm_tpu_torch.diffusion.vlb import calc_bpd_loop
    from mixermdm_tpu_torch.models.layers import w8a8_scope

    B, T = BASE_B, (16 if tiny else IN2IN_T)
    t0 = time.time()
    system = infer_in2in.build_system(None, "interaction", tiny=tiny, device=device,
                                      seed=seed, zero_init_std=0.02)
    texts = {"text": [p[0] for p in PROMPTS], "text_individual1": [p[1] for p in PROMPTS],
             "text_individual2": [p[2] for p in PROMPTS]}
    cond = system.build_cond(texts)
    model = system.cfg_model()
    s = system.sample_schedule
    n = s.num_timesteps
    shape = (B, T, 2 * system.nfeats)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    print(f"   built in2IN interaction in {time.time() - t0:.1f} s; schedule "
          f"{system.cfg.BETA_SCHEDULER} {n} steps, shape {shape}", flush=True)

    def model_fn(x, t):
        return model(x, t, None, cond)

    gen = torch.Generator(device=device).manual_seed(seed + 17)

    def randn(*size):
        return torch.randn(size, generator=gen, device=device)

    readings = {"card": card}
    with torch.no_grad(), w8a8_scope(system.quant):
        # (a) each step function, kernels against plain versions
        x, z = randn(*shape), randn(*shape)
        x_start = torch.tanh(randn(*shape))
        t = torch.full((B,), min(ENGINE_STEP, n - 1), dtype=torch.long, device=device)
        got = _engine_steps(model_fn, s, x, z, x_start, t)
        with ops.plain_versions():
            plain = _engine_steps(model_fn, s, x, z, x_start, t)
        for name in got:
            _agree(f"(a) {name} at chain index {int(t[0])}", got[name], plain[name], STEP_TOL,
                   "fro")

        # (b) the chains, recorded, timed and counted
        pre = torch.tanh(randn(B, min(ENGINE_PRE, T // 2), shape[-1]))
        pins = tuple((f * T // IN2IN_T, a, b) for f, a, b in ENGINE_PINS)
        inputs = {"noise": randn(*shape), "pre": pre,
                  "ddpm": [{"x": randn(*shape), "prefix": randn(*pre.shape),
                            "pin": randn(len(pins), 2)} for _ in range(n)],
                  "ddim": [{"x": randn(*shape)} for _ in range(n)],
                  "bpd": randn(n, *shape)}
        chains = {
            ("ddpm", f"DDPM-{n} (pre_seq, transl_req, cond_fn)"): lambda m, sc, a: p_sample_loop(
                m, sc, shape, noise=a["noise"], step_noise=a["ddpm"], pre_seq=a["pre"],
                transl_req=pins, cond_fn=_root_cond_fn),
            ("ddim", f"DDIM-{n} eta {ENGINE_ETA} (cond_fn)"): lambda m, sc, a: ddim_sample_loop(
                m, sc, shape, noise=a["noise"], step_noise=a["ddim"], eta=ENGINE_ETA,
                cond_fn=_root_cond_fn),
            ("encode", "ddim_encode_loop of the DDIM sample"): lambda m, sc, a: ddim_encode_loop(
                m, sc, a["sample"]),
            ("decode", f"DDIM-{n} decode of its latent"): lambda m, sc, a: ddim_sample_loop(
                m, sc, shape, noise=a["latent"]),
            ("bpd", "calc_bpd_loop of the DDIM sample"): lambda m, sc, a: calc_bpd_loop(
                m, sc, a["sample"], noise=a["bpd"]),
        }
        _, strategy = resolve_sampler_strategy(system.cfg)
        on_cpu = {dt: named_schedule(system.cfg.BETA_SCHEDULER, int(system.cfg.DIFFUSION_STEPS),
                                     strategy, dtype=dt) for dt in (torch.float64, torch.float32)}
        counts = collections.Counter()
        results = {}
        for (key, label), run in chains.items():
            rec = _Recorder(model_fn)
            ops.reset_launch_counts()
            sync()
            t0 = time.time()
            out = run(rec, s, inputs)
            sync()
            wall = time.time() - t0
            launches = dict(ops.launches)
            counts.update(launches)
            # the replays: the same chain on the CPU on the card's model
            # outputs and noises, in float64 and (the witness) in float32
            replays = {}
            for dt, sc in on_cpu.items():
                fn, seen = rec.replay(dt)
                res = run(fn, sc, _on_cpu(inputs, dt))
                replays[dt] = (res if isinstance(res, dict) else {"result": res}, seen)
            (want, seen), (f32, seen32) = replays[torch.float64], replays[torch.float32]
            outs = out if isinstance(out, dict) else {"result": out}
            gaps = {"states": (max(_rel_fro(a, b) for a, b in zip(rec.inputs, seen)),
                               max(_rel_fro(a, b) for a, b in zip(seen32, seen)))}
            gaps.update({k: (_rel_fro(outs[k], want[k]), _rel_fro(f32[k], want[k]))
                         for k in outs})
            ok = (all(bool(torch.isfinite(v).all()) for v in outs.values())
                  and len(seen) == len(rec.inputs) == n
                  and all(g <= max(REPLAY_TOL, WITNESS_RATIO * w) for g, w in gaps.values()))
            results[label] = {"s_per_request": wall, "model_calls": n, "launches": launches,
                              "replay_gaps": gaps}
            shown = {k: [float(f"{g:.3g}"), float(f"{w:.3g}")] for k, (g, w) in gaps.items()}
            print(f"   (b) {label}: {wall:.3f} s a request ({n} model calls) on {card}; "
                  f"launches {json.dumps(launches, sort_keys=True)}; rel(fro) from the float64 "
                  f"replay [card, CPU float32] {json.dumps(shown)}, held <= max({REPLAY_TOL:g}, "
                  f"{WITNESS_RATIO} x CPU float32): {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise SmokeFailure(f"{label}: the chain disagrees with its float64 replay")
            if key == "ddim":
                inputs["sample"] = out
            elif key == "encode":
                inputs["latent"] = out
            elif key == "decode":
                readings["reconstruction rel(fro)"] = _rel_fro(out, inputs["sample"])
                print(f"   (b) the decoded latent against the DDIM sample: rel(fro) "
                      f"{readings['reconstruction rel(fro)']:.4g} (a reading: random weights)",
                      flush=True)
    readings["chains"] = results
    del system, model
    if device == "cuda":
        torch.cuda.empty_cache()
    return counts, readings


def _on_cpu(a, dtype):
    """Tensors (in lists and dicts too) in ``dtype`` on the CPU."""
    if isinstance(a, dict):
        return {k: _on_cpu(v, dtype) for k, v in a.items()}
    if isinstance(a, list):
        return [_on_cpu(v, dtype) for v in a]
    return a.cpu().to(dtype)


# --------------------------------------------------------------------------
# Phase 5f: the data path
# --------------------------------------------------------------------------

# Dataset items on the native route against the numpy route (its plain
# version), person 1 and person 2: the tolerances of tests/test_native.py
# (the C++ computes in float64 as numpy does, with sums in another order;
# person 2 also goes through the relative transform).
DATA_TOL = (2e-5, 2e-4)
# The rates: items of 301 frames (cropped to 300, training's length), 256
# clips (512 items with the mirrored copies: 8 batches an epoch, so that 8
# workers have a batch each), the dataset over its first RATE_ITEMS items on
# each route, the loader at training's batch of 64 for LOADER_EPOCHS epochs
# at each number of workers.
LOADER_B, LOADER_CLIPS, LOADER_EPOCHS, LOADER_WORKERS = 64, 256, 2, (1, 4, 8)
RATE_ITEMS = 128


def _host():
    """The host's CPU model (``/proc/cpuinfo``, else ``lscpu``), its
    architecture and the cores this process may use."""
    import os
    import platform

    lines = []
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().splitlines()
    except OSError:
        pass
    try:
        lines += subprocess.run(["lscpu"], capture_output=True, text=True,
                                timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        pass
    model = next((line.split(":", 1)[1].strip() for line in lines
                  if line.lower().startswith(("model name", "cpu model"))), "unknown")
    return {"cpu": model, "arch": platform.machine(), "nproc": len(os.sched_getaffinity(0))}


def data_phase(seed, card, tmp, clips=LOADER_CLIPS):
    """The data path of training on the card's host: the native
    motion-feature library built with g++ (seconds printed); the items of
    phase 6's synthetic InterHuman set on the native route against the
    numpy route; items/s of the dataset on both routes and of the loader at
    B 64 with 1, 4 and 8 workers over ``clips`` clips.  Returns the
    readings."""
    import os
    import random

    import numpy as np

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.data import native
    from mixermdm_tpu_torch.data.interhuman import InterHumanDataset
    from mixermdm_tpu_torch.data.loader import DataLoader
    from mixermdm_tpu_torch.data.synthetic import make_interhuman_fixture

    host = _host()
    t0 = time.time()
    path, log = native.build(os.path.join(tmp, "host_build"))  # a cold build, timed
    build_s = time.time() - t0
    print(f"   host library built with g++ in {build_s:.2f} s into {path} (the package's "
          f"own, loaded: {native.library()._name})", flush=True)
    for line in log.splitlines():
        print(f"   | {line}", flush=True)

    # native against numpy on phase 6's items
    root = os.path.join(tmp, "data_5f")
    _fixture(root, seed)
    nat = InterHumanDataset(root, mode="train", rng=random.Random(seed))
    ref = InterHumanDataset(root, mode="train", rng=random.Random(seed))
    worst = [0.0, 0.0]
    for i in range(len(nat)):
        a = nat[i]
        with ops.plain_versions():
            b = ref[i]
        if a["motion_lens"] != b["motion_lens"] or a["text"] != b["text"]:
            raise SmokeFailure(f"item {i}: native and numpy routes took other draws")
        for k, key in enumerate(("motion1", "motion2")):
            worst[k] = max(worst[k], float(np.abs(a[key] - b[key]).max()))
    ok = worst[0] <= DATA_TOL[0] and worst[1] <= DATA_TOL[1]
    print(f"   {len(nat)} items of phase 6's set, native against numpy: max |diff| motion1 "
          f"{worst[0]:.3g} (<= {DATA_TOL[0]:g}), motion2 {worst[1]:.3g} (<= {DATA_TOL[1]:g}): "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SmokeFailure("the native motion library disagrees with its numpy version")

    # the rates
    root = os.path.join(tmp, "data_5f_rates")
    make_interhuman_fixture(root, n_clips=clips, n_frames=301, seed=seed)
    ds = InterHumanDataset(root, mode="train")
    rates = {}
    n = min(RATE_ITEMS, len(ds))
    for route in ("numpy", "native"):
        with ops.plain_versions() if route == "numpy" else contextlib.nullcontext():
            t0 = time.time()
            for i in range(n):
                ds[i]
            rates[f"dataset {route}"] = n / (time.time() - t0)
    for _ in DataLoader(ds, LOADER_B, seed=seed):  # warm-up, untimed
        pass
    for workers in LOADER_WORKERS * 2:  # two turns
        loader = DataLoader(ds, LOADER_B, seed=seed, num_workers=workers, reseed_dataset=True)
        t0 = time.time()
        items = sum(len(b["name"]) for _ in range(LOADER_EPOCHS) for b in loader)
        rates.setdefault(f"loader B {LOADER_B}, {workers} workers", []).append(
            items / (time.time() - t0))
    print(f"   items/s ({len(ds)} items of 300 frames, {len(ds) // LOADER_B} batches an epoch; "
          f"on {host['cpu']} ({host['arch']}), nproc {host['nproc']}; card {card}): " + json.dumps(
              {k: [round(x, 1) for x in v] if isinstance(v, list) else round(v, 1)
               for k, v in rates.items()}), flush=True)
    return {"build_s": build_s, "native_vs_numpy": worst, "items_per_s": rates, "host": host}


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


def _grad_step(seed, normalizer, batch_np, quant_train=False):
    """The full-width training system at ``seed`` with ``normalizer`` (the
    fixture's statistics, :func:`_fixture_normalizer`), its f32 twin, and
    ``side(sys_, mode, plain) -> (losses, {subtree: flat gradient})``: one
    G or D step's gradients of the trained subtrees, on the kernels or
    (``plain``) the plain versions.  ``quant_train``: the system's frozen
    denoisers run as int8 inside the loss (``QUANT_TRAIN``); the f32 twin
    runs them in f32, where nothing quantises."""
    import torch

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.cli.infer_mixermdm import build_system
    from mixermdm_tpu_torch.systems.mixermdm import DISC_MODULES, GEN_MODULES
    from mixermdm_tpu_torch.train.trainer import trainable_params

    t0 = time.time()
    system = build_system(MODEL_CFG, device="cuda", seed=seed, zero_init_std=0.02, train=True,
                          quant_train=quant_train or None)
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


# The frozen denoisers of the mixer, (submodel, denoiser name).
FROZEN = (("model1", "individual"), ("model2", "interaction"))


@contextlib.contextmanager
def _frozen_outputs(system, edit):
    """Inside the block, each call of a frozen denoiser returns
    ``edit((name, i), out)`` (``i`` its call index in the block) where that
    is not None."""
    calls = collections.Counter()

    def hook(name):
        def fn(module, args, out):
            key = (name, calls[name])
            calls[name] += 1
            return edit(key, out)
        return fn

    handles = [getattr(system, sub).denoisers[name].register_forward_hook(hook(name))
               for sub, name in FROZEN]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def quant_grad_check(seed, normalizer, batch_np):
    """Phase 6's gradient check under ``QUANT_TRAIN``: one G and one D step
    with the frozen denoisers as int8 on the kernels and on the plain
    versions (the f32 twin runs them in f32, without int8).  int8 rounds a
    value on a boundary one step either way, so the two int8 frozen outputs
    differ by about as much as either differs from f32, and at random
    weights ``center_person`` amplifies any such difference into the G
    gradient (ROADMAP Queue 3 item 3; scripts/grad_seeds.py --quant-train).
    So the int8 part is held at its outputs, and the trained part with
    those outputs shared:

    - each frozen output: kernels vs plain on NET_TOL (rel max, as phase 4
      holds its networks), kernels vs f32 at most WITNESS_RATIO x plain vs
      f32 (the int8 kernels no farther from f32 than their plain versions);
    - each trained subtree's gradient of the plain and the f32 step fed the
      kernels' frozen outputs: kernels vs that plain step on GRAD_TOL, and
      the witness against that f32 step, as phase 6 holds them.

    The gaps of the steps each on its own frozen outputs are printed, a
    reading.  Every gap is printed before any is held.  Returns {name:
    (k-p, p-f, k-f) with own outputs, then the same with shared ones}."""
    import torch

    system, twin, side = _grad_step(seed, normalizer, batch_np, quant_train=True)

    def run(sys_, mode, plain, edit):
        with _frozen_outputs(sys_, edit):
            return side(sys_, mode, plain)

    def capture(store):
        def edit(key, o):
            store[key] = o.detach()
        return edit

    outputs, grads = [], []  # (what, kernels, plain, f32)
    for mode in ("generator", "discriminator"):
        ok, op, of = {}, {}, {}
        lk, gk = run(system, mode, False, capture(ok))
        lp, gp = run(system, mode, True, capture(op))
        lf, gf = run(twin, mode, True, capture(of))
        fed = lambda key, o: ok[key].to(o.dtype)  # noqa: E731
        (ls, gs), (lsf, gsf) = run(system, mode, True, fed), run(twin, mode, True, fed)
        print(f"   (b) QUANT_TRAIN {mode} step losses, kernels / plain / f32 / plain and f32 fed "
              f"the kernels' frozen outputs: " + ", ".join(
                  f"{k} {lk[k]:.6g} / {lp[k]:.6g} / {lf[k]:.6g} / {ls[k]:.6g} / {lsf[k]:.6g}"
                  for k in lk), flush=True)
        if not all(math.isfinite(v) for d in (lk, lp, lf, ls, lsf) for v in d.values()):
            raise SmokeFailure(f"QUANT_TRAIN {mode} step losses are not finite")
        outputs += [(f"(b) QUANT_TRAIN {mode} step, frozen {key[0]} denoiser output", ok[key],
                     op[key], of[key]) for key in ok]
        grads += [(f"{mode}.{k}", (gk[k], gp[k], gf[k]), (gk[k], gs[k], gsf[k])) for k in gk]
    del system, twin
    torch.cuda.empty_cache()

    def three(k_, p_, f_):
        return _gaps(k_, p_)[2], _gaps(p_, f_)[2], _gaps(k_, f_)[2]

    for what, *kpf in outputs:
        kp, pf, kf = three(*kpf)
        print(f"   {what}, rel(fro): kernels vs plain {kp:.5g}, plain vs f32 {pf:.5g}, kernels "
              f"vs f32 {kf:.5g} (witness ratio {kf / max(pf, 1e-12):.4g})", flush=True)
    gaps = {}
    for name, own, fed in grads:
        gaps[name] = three(*own) + three(*fed)
        g = gaps[name]
        print(f"   (b) QUANT_TRAIN seed {seed}, {name} gradient, rel(fro), each step on its own "
              f"frozen outputs: kernels vs plain {g[0]:.5g}, plain vs f32 {g[1]:.5g}, kernels vs "
              f"f32 {g[2]:.5g} (witness ratio {g[2] / max(g[1], 1e-12):.4g}), a reading; plain "
              f"and f32 fed the kernels' frozen outputs: {g[3]:.5g}, {g[4]:.5g}, {g[5]:.5g} "
              f"(witness ratio {g[5] / max(g[4], 1e-12):.4g})", flush=True)
    held = outputs + [(f"(b) QUANT_TRAIN {name.split('.')[0]} step, gradient of "
                       f"{name.split('.', 1)[1]}, frozen outputs shared", *fed)
                      for name, _, fed in grads]
    for what, k_, p_, f_ in held:
        if "shared" in what:
            _agree(what, k_, p_, GRAD_TOL, "fro")
        else:  # held as phase 4 holds its networks' outputs
            _agree(what, k_, p_, NET_TOL, "max")
        gap_p = _agree(what, p_, f_, None, "fro", "plain vs f32")
        _agree(what, k_, f_, WITNESS_RATIO * gap_p, "fro",
               f"kernels vs f32 (at most {WITNESS_RATIO} x plain vs f32)")
    return gaps


def train_phase(seed, tmp):
    """Gradient check of one G and one D step (kernels vs plain versions vs
    f32), the training CLI on a synthetic fixture with its launch counts,
    and seconds per fit step with the differentiated attention on the
    kernels and on the plain versions.  The fixture and the training run's
    files stay under ``tmp`` for phase 6b.  Returns (launches of the
    training run, {"argv", "records", "state", "data", and the gradient
    check's "batch_np" and "normalizer"})."""
    import os

    import torch

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.cli import train_mixermdm
    from mixermdm_tpu_torch.cli.infer_mixermdm import build_system
    from mixermdm_tpu_torch.data import native
    from mixermdm_tpu_torch.data.interhuman import InterHumanDataset
    from mixermdm_tpu_torch.data.loader import collate
    from mixermdm_tpu_torch.models import layers

    try:
        data = os.path.join(tmp, "data")
        _fixture(data, seed)
        dataset = InterHumanDataset(data, mode="train")
        # The gradient checks (here and phase 6b) hold kernels, plain versions
        # and f32 on one batch: its items and statistics come from the
        # dataset's numpy route, the inputs these checks were set on.  At
        # random weights the gradients move with the inputs' last bits (the
        # standing hazard of ROADMAP Queue 3), and the native route's items
        # lie up to 3e-8 from these.  The training CLI below reads the
        # native route.
        with ops.plain_versions():
            batch_np = collate([dataset[i] for i in range(TRAIN_B)])
            normalizer = _fixture_normalizer(dataset)
        print(f"   fixture: {len(dataset)} items, batch lengths "
              f"{batch_np['motion_lens'].tolist()} of T = {batch_np['motions'].shape[1]}",
              flush=True)

        grad_check(seed, normalizer, batch_np)

        # --- the training CLI, counted -----------------------------------------
        out_dir = os.path.join(tmp, "out")
        argv = ["--model", MODEL_CFG, "--train", TRAIN_CFG, "--data-root", data, "--out-dir",
                out_dir, "--batch-size", str(TRAIN_B), "--max-steps", "4", "--seed", str(seed),
                "--init-std", "0.02", "--log-jsonl", os.path.join(tmp, "steps.jsonl")]
        layers.set_train_attention("kernel")
        ops.reset_launch_counts()
        items_before = native.calls["process_pair_interhuman"]
        torch.cuda.synchronize()
        t0 = time.time()
        out = train_mixermdm.run(argv)
        torch.cuda.synchronize()
        counts = dict(ops.launches)
        native_items = native.calls["process_pair_interhuman"] - items_before
        print(f"   train-mixermdm {' '.join(argv)}: {time.time() - t0:.1f} s for "
              f"{len(out['records'])} fit steps (system build included); items on the "
              f"native route: {native_items}", flush=True)
        if native_items < 4 * TRAIN_B:
            raise SmokeFailure("train-mixermdm's items did not take the native motion library")
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
        return counts, {"argv": argv, "records": out["records"], "state": out["state"],
                        "data": data, "batch_np": batch_np, "normalizer": normalizer}
    finally:
        layers.set_train_attention("kernel")


# --------------------------------------------------------------------------
# Phase 6b: the rest of training at full width
# --------------------------------------------------------------------------

# The base models' training batch: B sequences of TRAIN_T frames (in2IN
# interaction stacks the two persons, 2 x B rows).
BASE_TRAIN_B = 4
BASE_MODES = ("interaction", "individual", "mdm")
# The int8 kernels QUANT_TRAIN launches, all from the frozen denoisers.
QUANT_TRAIN_Q8 = ("adaln_modulate_q8", "linear_q8", "attention_q8", "linear_q8_gelu_q8")
# A resumed run against the unbroken one (steps 3-4): the losses and the
# trained parameters, rel(fro), where they are not bitwise.
RESUME_TOL = 1e-3


def _hml3d_fixture(root, seed):
    """A synthetic HumanML3D dataset: 8 clips, two longer than 300 frames
    (cropped), the rest shorter, so the encoder sees key padding."""
    from mixermdm_tpu_torch.data.synthetic import make_hml3d_fixture

    make_hml3d_fixture(root, n_clips=8, n_frames=[340, 301, 280, 240, 200, 150, 100, 60],
                       seed=seed)


def _frames_normalizer(dataset, keys):
    """Per-feature mean and std (floored at 1e-2) of the valid frames of
    ``dataset``'s ``keys`` (the persons), as :func:`_fixture_normalizer`."""
    import numpy as np
    import torch

    from mixermdm_tpu_torch.utils.normalizer import Normalizer

    frames = np.concatenate([it[k][:it["motion_lens"]] for it in
                             (dataset[i] for i in range(len(dataset))) for k in keys])
    return Normalizer(torch.from_numpy(frames.mean(0).astype(np.float32)).cuda(),
                      torch.from_numpy(np.maximum(frames.std(0), 1e-2).astype(np.float32)).cuda())


def base_grad_check(mode, seed, normalizer, batch_np):
    """One base-model training step of ``mode`` at full width, dropout 0,
    the timesteps, noise and (no) cond drop injected: the loss and the
    gradient of every trained subtree on the kernels, on the plain versions
    and on the f32 twin (plain versions); every gap printed first, then
    each gradient held on GRAD_TOL (kernels vs plain) and the witness.
    Returns {subtree: (k-p, p-f, k-f)}, the losses' gaps beside."""
    import torch

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.cli import train_in2in
    from mixermdm_tpu_torch.train.trainer import subtree_state

    t0 = time.time()
    system = train_in2in.build_system(mode, device="cuda", seed=seed, zero_init_std=0.02,
                                      normalizer=normalizer)
    twin = copy.deepcopy(system).cast_(None, train=True)
    print(f"   (a) {mode}: built the training system and its f32 twin in "
          f"{time.time() - t0:.1f} s", flush=True)
    dev = system.device
    motions = torch.from_numpy(batch_np["motions"]).float().to(dev)
    lens = torch.from_numpy(batch_np["motion_lens"]).long().to(dev)
    tokens = train_in2in.batch_tokens(system, mode, batch_np)
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    t = torch.randint(0, system.train_schedule.num_timesteps, (motions.shape[0],),
                      generator=gen, device="cuda")
    noise = torch.randn(motions.shape, generator=gen, device="cuda")
    drop = torch.zeros(motions.shape[0], 1, dtype=torch.bool, device="cuda")
    keys = system.TRAIN_MODULES

    def side(sys_, plain):
        named = subtree_state(sys_, keys)
        for p in named.values():
            p.requires_grad_(True)
        try:
            with ops.plain_versions() if plain else contextlib.nullcontext():
                cond = sys_.encode_cond_tokens(tokens)
                losses = sys_.compute_loss(motions, lens, cond, t=t, noise=noise, drop=drop,
                                           dropout=False)
                grads = torch.autograd.grad(losses["total"], list(named.values()))
        finally:
            for p in named.values():
                p.requires_grad_(False)
        flat = {k: torch.cat([g.float().flatten() for n, g in zip(named, grads)
                              if n.startswith(k + ".")]) for k in keys}
        return float(losses["total"]), flat

    ops.reset_launch_counts()
    lk, gk = side(system, False)
    torch.cuda.synchronize()
    print(f"   (a) {mode}: launches of one step at dropout 0 on the kernels: "
          f"{json.dumps(dict(sorted(ops.launches.items())))}", flush=True)
    (lp, gp), (lf, gf) = side(system, True), side(twin, True)
    print(f"   (a) {mode} loss, kernels / plain / f32: {lk:.6g} / {lp:.6g} / {lf:.6g} (t "
          f"{t.tolist()}); kernels vs plain {abs(lk - lp) / abs(lp):.4g}, plain vs f32 "
          f"{abs(lp - lf) / abs(lf):.4g} relative", flush=True)
    if not all(math.isfinite(v) for v in (lk, lp, lf)):
        raise SmokeFailure(f"{mode}: training losses are not finite")
    gaps = {k: (_gaps(gk[k], gp[k])[2], _gaps(gp[k], gf[k])[2], _gaps(gk[k], gf[k])[2])
            for k in keys}
    for k, (kp, pf, kf) in gaps.items():
        print(f"   (a) seed {seed}, {mode}, gradient of {k}, rel(fro): kernels vs plain "
              f"{kp:.5g}, plain vs f32 {pf:.5g}, kernels vs f32 {kf:.5g} (witness ratio "
              f"{kf / max(pf, 1e-12):.4g})", flush=True)
    for k in keys:
        what = f"(a) {mode} step, gradient of {k}"
        _agree(what, gk[k], gp[k], GRAD_TOL, "fro")
        gap_p = _agree(what, gp[k], gf[k], None, "fro", "plain vs f32")
        _agree(what, gk[k], gf[k], WITNESS_RATIO * gap_p, "fro",
               f"kernels vs f32 (at most {WITNESS_RATIO} x plain vs f32)")
    del system, twin
    torch.cuda.empty_cache()
    return gaps


def _cli_run(label, run, argv, printed=None):
    """A CLI's ``run(argv)`` in-process, counted: its launches per kernel,
    the plain versions it chose (none allowed); its output printed (only
    the lines that start with one of ``printed``, when given).  Returns (its
    result, the launches, its output lines)."""
    import io

    import torch

    from mixermdm_tpu_torch import ops

    text = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.time()
    with _plain_calls() as plain, contextlib.redirect_stdout(text):
        out = run(argv)
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    lines = text.getvalue().splitlines()
    for line in lines:
        if printed is None or line.startswith(printed):
            print(f"   | {line}", flush=True)
    print(f"   {label}: {time.time() - t0:.1f} s (system build included), plain versions "
          f"chosen: {plain[0]}; launches: {json.dumps(counts, sort_keys=True)}", flush=True)
    if plain[0]:
        raise SmokeFailure(f"{label}: a plain version was chosen on the card")
    return out, counts, lines


def _sample_trained(mode, out_dir):
    """``infer-in2in`` (``infer-mdm`` for MDM) in-process from the
    ``final.ckpt`` that ``train-in2in --mode mode`` wrote to ``out_dir``,
    ``--strict``, two DDIM steps: every parameter loaded, the sample finite,
    no plain version chosen."""
    import io
    import os

    import numpy as np

    from mixermdm_tpu_torch.cli import infer_in2in, infer_mdm

    argv = ["--name", mode, "--text", PROMPTS[0][1], "--num-samples", "1", "--sample-steps", "2",
            "--checkpoint", os.path.join(out_dir, "final.ckpt"), "--strict", "--out-dir",
            os.path.join(out_dir, "sampled")]
    text = io.StringIO()
    with _plain_calls() as plain, contextlib.redirect_stdout(text):
        (infer_mdm.main if mode == "mdm" else infer_in2in.main)(
            argv + ([] if mode == "mdm" else ["--mode", mode]))
    loaded = [ln.split()[1] for ln in text.getvalue().splitlines() if ln.startswith("loaded ")]
    motion = np.load(os.path.join(out_dir, "sampled", f"{mode}_motion.npy"))
    ok = (plain[0] == 0 and len(loaded) == 1 and loaded[0].split("/")[0] == loaded[0].split("/")[1]
          and bool(np.isfinite(motion).all()))
    command = "infer-mdm" if mode == "mdm" else f"infer-in2in --mode {mode}"
    print(f"   (a) {command} --strict from train-in2in's final.ckpt: parameters loaded "
          f"{loaded}, sample {motion.shape} finite: {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SmokeFailure(f"{command}: train-in2in's final.ckpt did not load or sample")


def _state_gaps(a, b):
    """(bitwise, largest rel(fro)) of two trainer state dicts' tensors."""
    import torch

    if isinstance(a, torch.Tensor):
        same = a.dtype == b.dtype and torch.equal(a, b)
        return same, 0.0 if same else _gaps(a, b)[2]
    if isinstance(a, dict):
        parts = [_state_gaps(a[k], b[k]) for k in a] + [(sorted(a) == sorted(b), 0.0)]
    elif isinstance(a, (list, tuple)):
        parts = [_state_gaps(x, y) for x, y in zip(a, b)] + [(len(a) == len(b), 0.0)]
    else:
        return a == b, 0.0 if a == b else math.inf
    return all(p[0] for p in parts), max((p[1] for p in parts), default=0.0)


def rest_of_training_phase(seed, tmp, phase6):
    """(a) Base-model training at full width: per mode (in2IN interaction
    and individual, 1024-d on ViT-L/14; MDM, 512-d on ViT-B/32) one step's
    gradients on the kernels against the plain versions and f32, then
    ``train-in2in`` for 2 steps at the shipped dropout, counted.  (b)
    ``QUANT_TRAIN``, the frozen denoisers as int8: one G and one D step's
    frozen outputs and gradients (:func:`quant_grad_check`), the int8 launches of each side step
    against the denoisers' modules, the frozen outputs against the int8
    plain versions, seconds per fit step against bf16.  (c) Resume:
    ``train-mixermdm`` for 2 steps, then a fresh system restored from its
    ``final_state`` for 2 more, against phase 6's 4 unbroken steps; then
    ``train-mixermdm --resume auto --quant-train`` for 2 more, its int8
    launches counted; ``train-finetuned`` for one step from a released
    individual file, every ``sa_block`` bitwise unchanged.  Returns
    (launches per path, readings)."""
    import os

    import torch

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.cli import train_finetuned, train_in2in, train_mixermdm
    from mixermdm_tpu_torch.cli.infer_mixermdm import build_system
    from mixermdm_tpu_torch.data.humanml3d import HumanML3DDataset
    from mixermdm_tpu_torch.data.interhuman import InterHumanDataset
    from mixermdm_tpu_torch.data.loader import collate
    from mixermdm_tpu_torch.train import checkpoint as ck
    from mixermdm_tpu_torch.train.trainer import MixerTrainer
    from mixermdm_tpu_torch.weights import released_in2in_state_dict

    counts, readings = {}, {}
    seconds = {}
    inter_data, hml_data = phase6["data"], os.path.join(tmp, "hml3d")
    _hml3d_fixture(hml_data, seed)
    datasets = {"interaction": InterHumanDataset(inter_data, mode="train"),
                "individual": HumanML3DDataset(hml_data, mode="train")}
    norms = {"interaction": _fixture_normalizer(datasets["interaction"]),
             "individual": _frames_normalizer(datasets["individual"], ("motion1",))}

    # --- (a) base-model training ------------------------------------------------
    t_part = time.time()
    for mode in BASE_MODES:
        data_mode = "interaction" if mode == "interaction" else "individual"
        batch_np = collate([datasets[data_mode][i] for i in range(BASE_TRAIN_B)])
        readings[f"grad {mode}"] = base_grad_check(mode, seed, norms[data_mode], batch_np)
    for mode in BASE_MODES:
        data = inter_data if mode == "interaction" else hml_data
        argv = ["--mode", mode, "--data-root", data, "--out-dir", os.path.join(tmp, mode),
                "--batch-size", str(BASE_TRAIN_B), "--max-steps", "2", "--seed", str(seed),
                "--init-std", "0.02"]
        out, c, _ = _cli_run(f"(a) train-in2in {' '.join(argv)}", train_in2in.run, argv)
        recs = out["records"]
        if len(recs) != 2 or not all(math.isfinite(r["total"]) for r in recs):
            raise SmokeFailure(f"train-in2in {mode}: losses missing or not finite")
        counts[f"train-in2in {mode}"] = c
        readings[f"s/step {mode}"] = recs[-1]["dt_s"]
        print(f"   (a) train-in2in {mode}: losses {[r['total'] for r in recs]}, s per step "
              f"{[round(r['dt_s'], 4) for r in recs]} (the first with warm-up); launches per "
              f"step: {json.dumps({k: v / 2 for k, v in sorted(c.items())})}", flush=True)
        if mode == "individual":
            individual = out["system"]
        else:
            del out
        torch.cuda.empty_cache()
        _sample_trained(mode, os.path.join(tmp, mode))
    seconds["(a)"] = time.time() - t_part

    # --- (b) QUANT_TRAIN ---------------------------------------------------------
    t_part = time.time()
    # one G and one D step's frozen outputs and gradients at phase 6's
    # inputs, int8 on the kernels and on the plain versions, the f32 twin
    # without int8
    batch_np, normalizer = phase6["batch_np"], phase6["normalizer"]
    readings["grad quant_train"] = quant_grad_check(seed, normalizer, batch_np)
    system = build_system(MODEL_CFG, device="cuda", seed=seed, zero_init_std=0.02, train=True,
                          quant_train=True)
    system.normalizer1 = system.normalizer2 = normalizer
    system.cast_(system.compute_dtype, train=True)
    trainer = MixerTrainer(system, grad_acc_steps=1)
    batch = _device_batch(system, batch_np)
    dens = [system.model1.denoiser_apply("individual"),
            system.model2.denoiser_apply("interaction")]
    want = _expected_launches(dens, "W8A8")
    q8_side = {k: want[k] for k in QUANT_TRAIN_Q8}
    for mode in ("generator", "discriminator"):
        ops.reset_launch_counts()
        losses = trainer.side_step(mode, batch, torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        got = {k: int(ops.launches.get(k, 0)) for k in QUANT_TRAIN_Q8}
        core_bf16 = int(ops.launches.get("fused_sa_block", 0))
        ok = got == q8_side and math.isfinite(float(losses["total"]))
        print(f"   (b) QUANT_TRAIN {mode} step: loss {float(losses['total']):.6g}; int8 launches "
              f"{json.dumps(got)}, the two frozen denoisers' modules give "
              f"{json.dumps(q8_side)}; the core's bf16 fused SA blocks {core_bf16}: "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SmokeFailure(f"QUANT_TRAIN {mode} step: int8 launches not the denoisers' alone")
        counts[f"quant_train {mode}"] = dict(ops.launches)
    # seconds per fit step, QUANT_TRAIN against bf16
    step_s = {}
    for quant in (True, False, True, False):
        system.quant_train = quant
        system.cast_(system.compute_dtype, train=True)
        step_gen = torch.Generator(device="cuda").manual_seed(seed + 3)
        trainer.fit_step(batch, step_gen, 0)
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(2):
            trainer.fit_step(batch, step_gen, 0)
        torch.cuda.synchronize()
        step_s.setdefault("QUANT_TRAIN" if quant else "bf16", []).append((time.time() - t0) / 2)
    print(f"   (b) s per fit step at B {TRAIN_B} (G + D, eager, two turns each): "
          f"{json.dumps({k: [round(v, 4) for v in vs] for k, vs in step_s.items()})}", flush=True)
    readings["quant_train s/step"] = step_s
    del system, trainer
    torch.cuda.empty_cache()
    seconds["(b)"] = time.time() - t_part

    # --- (c) resume, then the fine-tune -------------------------------------------
    t_part = time.time()
    out_dir = os.path.join(tmp, "resume")
    argv = [a for a in phase6["argv"]]
    argv[argv.index("--out-dir") + 1] = out_dir
    argv[argv.index("--max-steps") + 1] = "2"
    argv = [a for i, a in enumerate(argv) if a != "--log-jsonl" and
            (i == 0 or argv[i - 1] != "--log-jsonl")]
    first, _, _ = _cli_run("(c) train-mixermdm, steps 1-2", train_mixermdm.run, argv)
    saved = torch.load(first["state"], map_location="cuda", weights_only=True)
    del first
    torch.cuda.empty_cache()
    restored = {}
    real_restore = train_mixermdm.restore_train_state

    def restore(path, trainer):
        real_restore(path, trainer)
        restored["state"] = trainer.state_dict()

    argv[argv.index("--max-steps") + 1] = "4"
    train_mixermdm.restore_train_state = restore
    try:
        rest, _, _ = _cli_run("(c) train-mixermdm --resume auto, steps 3-4", train_mixermdm.run,
                           argv + ["--resume", "auto"])
    finally:
        train_mixermdm.restore_train_state = real_restore
    same, gap = _state_gaps(restored["state"], saved)
    print(f"   (c) the restored state against the saved one (parameters, both AdamW states, the "
          f"step): {'bitwise' if same else f'NOT bitwise (rel(fro) {gap:.4g})'}", flush=True)
    if not same:
        raise SmokeFailure("the restored train state differs from the saved one")
    want_state = torch.load(phase6["state"], map_location="cuda", weights_only=True)
    got_state = rest["trainer"].state_dict()
    losses_got = [(r["g_total"], r["d_total"]) for r in rest["records"]]
    losses_want = [(r["g_total"], r["d_total"]) for r in phase6["records"][2:]]
    same_params, gap_params = _state_gaps(got_state["params"], want_state["params"])
    same_all, gap_all = _state_gaps(got_state, want_state)
    loss_gap = max(abs(a - b) / max(abs(b), 1e-12) for g, w in zip(losses_got, losses_want)
                   for a, b in zip(g, w))
    print(f"   (c) steps 3-4 resumed against phase 6's unbroken run: losses {losses_got} vs "
          f"{losses_want} ({'bitwise' if losses_got == losses_want else f'rel {loss_gap:.4g}'}); "
          f"trained parameters {'bitwise' if same_params else f'rel(fro) {gap_params:.4g}'}; "
          f"whole state {'bitwise' if same_all else f'rel(fro) up to {gap_all:.4g}'}", flush=True)
    readings["resume"] = {"losses_bitwise": losses_got == losses_want, "loss_rel": loss_gap,
                          "params_bitwise": same_params, "params_rel_fro": gap_params}
    if len(losses_got) != 2 or loss_gap > RESUME_TOL or gap_params > RESUME_TOL:
        raise SmokeFailure("the resumed run departs from the unbroken one")
    del rest, saved, want_state, got_state
    torch.cuda.empty_cache()
    # --quant-train through the CLI: steps 5-6 resumed from steps 3-4's
    # final_state, the frozen denoisers as int8 in both side steps of each
    argv[argv.index("--max-steps") + 1] = "6"
    quant, c, _ = _cli_run("(c) train-mixermdm --resume auto --quant-train, steps 5-6",
                        train_mixermdm.run, argv + ["--resume", "auto", "--quant-train"])
    recs = quant["records"]
    sides = sum(1 + (r["d_total"] is not None) for r in recs)
    got = {k: int(c.get(k, 0)) for k in QUANT_TRAIN_Q8}
    ok = ([r["step"] for r in recs] == [4, 5] and got == {k: sides * v for k, v in q8_side.items()}
          and all(math.isfinite(r["g_total"]) and math.isfinite(r["d_total"]) for r in recs))
    print(f"   (c) --quant-train: losses {[(r['g_total'], r['d_total']) for r in recs]}, s per "
          f"step {[round(r['dt_s'], 4) for r in recs]}; int8 launches {json.dumps(got)} in {sides} "
          f"side steps, the frozen denoisers' {json.dumps(q8_side)} each: "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SmokeFailure("train-mixermdm --quant-train: steps, losses or int8 launches wrong")
    counts["train-mixermdm quant"] = c
    readings["s/step train-mixermdm --quant-train"] = recs[-1]["dt_s"]
    del quant
    torch.cuda.empty_cache()

    # the fine-tune from the individual file train-in2in's system writes
    ind_file = os.path.join(tmp, "individual_released.ckpt")
    ck.save_released(ind_file, released_in2in_state_dict(individual, "individual"))
    fresh = {}
    real_transfer = train_finetuned.individual_to_interaction

    def transfer(src, dst):
        kept = real_transfer(src, dst)
        fresh.update({k: v.detach().clone() for k, v in dst.named_parameters()})
        return kept

    argv = ["--individual-checkpoint", ind_file, "--data-root", inter_data, "--out-dir",
            os.path.join(tmp, "finetuned"), "--batch-size", str(BASE_TRAIN_B), "--max-steps", "1",
            "--seed", str(seed)]
    train_finetuned.individual_to_interaction = transfer
    try:
        ft, _, _ = _cli_run(f"(c) train-finetuned {' '.join(argv)}", train_finetuned.run, argv)
    finally:
        train_finetuned.individual_to_interaction = real_transfer
    after = dict(ft["system"].denoisers["interaction"].named_parameters())
    src = dict(individual.denoisers["individual"].named_parameters())
    sa = [k for k in after if ".sa_block." in k]
    ca = [k for k in after if ".ca_block." in k]
    sa_same = all(torch.equal(after[k], src[k]) and torch.equal(after[k], fresh[k]) for k in sa)
    ca_moved = sum(not torch.equal(after[k], fresh[k]) for k in ca)
    ok = (sa_same and ca_moved == len(ca) and len(ft["records"]) == 1
          and math.isfinite(ft["records"][0]["total"]))
    print(f"   (c) train-finetuned: loss {ft['records'][0]['total']:.6g}; {len(sa)} sa_block "
          f"tensors bitwise the individual file's: {sa_same}; {ca_moved}/{len(ca)} ca_block "
          f"tensors trained: {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SmokeFailure("train-finetuned: sa_block moved or a ca_block did not train")
    counts["train-finetuned"] = dict(ops.launches)
    del ft, individual
    torch.cuda.empty_cache()
    seconds["(c)"] = time.time() - t_part
    print("   phase 6b seconds by part: "
          + json.dumps({k: round(v, 1) for k, v in seconds.items()}), flush=True)
    readings["seconds"] = seconds
    return counts, readings


# --------------------------------------------------------------------------
# Phases 5d and 6c: evaluation
# --------------------------------------------------------------------------

# Both towers are f32 on the kernels and on the plain versions; the kernels
# hold 1e-5 one call at a time (F32_TOL), and 8 post-norm layers carry that
# into the L2-normalised embeddings: max |diff| / max |plain| (readings on
# an H100: 5.1e-7 to 8.7e-7).
EVAL_EMB_TOL = 1e-5
# The metrics computed from the kernels' embeddings against those from the
# plain versions', relative (FID over 96 samples moved 1e-6 relative under
# 1e-5 of noise in the embeddings, on the CPU).
EVAL_METRIC_TOL = 1e-4
# One train-evaluator step's gradients, kernels vs plain (both f32), rel(fro)
# per trained subtree (readings on an H100: 1.8e-6 to 1.8e-5); the loss on
# F32_TOL.
EVAL_GRAD_TOL = 2e-4
EVAL_SUBTREES = ("motion_encoder", "textTransEncoder", "text_ln", "out", "latent_scale")
EVAL_PRINTED = ("==", "generation:", "scoring:", "mm generation:", "loaded ", "note:",
                "evaluator training done", "NON-PROTOCOL", "wrote ")


def _eval_fixtures(root, seed):
    """The synthetic InterHuman set (96 clips, every clip in train and test)
    and HumanML3D set (32 clips), their lengths drawn so that they differ
    inside a batch, up to the 300-frame window (an InterHuman item is at most
    299 frames long: its features take one frame for the velocities)."""
    import os

    import numpy as np

    from mixermdm_tpu_torch.data.synthetic import make_hml3d_fixture, make_interhuman_fixture

    rng = np.random.default_rng(seed + 5)
    ih = [301] + [int(n) for n in rng.integers(40, 302, EVAL_IH_CLIPS - 1)]
    hml = [300] + [int(n) for n in rng.integers(40, 301, EVAL_HML_CLIPS - 1)]
    ih_root, hml_root = os.path.join(root, "interhuman"), os.path.join(root, "hml3d")
    make_interhuman_fixture(ih_root, n_clips=EVAL_IH_CLIPS, n_frames=ih, seed=seed,
                            n_test=EVAL_IH_CLIPS)
    make_hml3d_fixture(hml_root, n_clips=EVAL_HML_CLIPS, n_frames=hml, seed=seed + 1)
    return ih_root, hml_root


def _side_seconds(lines):
    """{side: {part: seconds}} from an evaluation CLI's progress lines."""
    sides, side = {}, None
    for line in lines:
        if line.startswith("===== "):
            side = line.split()[1]
            sides[side] = {}
        elif side and line.startswith(("generation:", "scoring:", "mm generation:")):
            for part in line.split("; "):
                key, value = part.split(":", 1)
                sides[side][key.replace(" ", "_") + "_s"] = float(value.split()[0])
    return sides


def _loaded_all(lines, n):
    """Whether the output says ``n`` times that a file filled every
    parameter (``loaded k/k parameters``)."""
    loaded = [ln.split()[1].split("/") for ln in lines if ln.startswith("loaded ")]
    return len(loaded) == n and all(a == b for a, b in loaded)


def _finite_summary(summary):
    vals = [v for side in summary.values() for d in side.values() for pair in d.values()
            for v in pair]
    return bool(vals) and all(math.isfinite(v) for v in vals)


def _protocol_metrics(t_emb, m_emb, m_emb2, seed):
    """MM-Distance, R-precision top-1/2/3, FID (of ``m_emb2`` against
    ``m_emb``) and Diversity of one batch's embeddings, as the protocol
    computes them."""
    import numpy as np

    from mixermdm_tpu_torch.eval import metrics as M

    t, m, m2 = (x.double().cpu().numpy() for x in (t_emb, m_emb, m_emb2))
    dist = M.euclidean_distance_matrix(t, m)
    top = M.calculate_top_k(np.argsort(dist, axis=1), 3).sum(axis=0) / len(t)
    return {"MM Distance": float(dist.trace() / len(t)),
            **{f"R_precision_top{k + 1}": float(top[k]) for k in range(3)},
            "FID": M.calculate_fid(m2, m),
            "Diversity": M.calculate_diversity(m, len(m) - 1, seed=seed)}


def evaluation_phase(seed, card, tmp, held):
    """Evaluation at full width (InterCLIP: 1024-d, 8 layers, 8 heads, FF
    2048; text 768 x 8 layers) on synthetic InterHuman (96 clips) and
    HumanML3D (32 clips) sets with lengths that differ inside a batch:

    (setup) the interaction and individual evaluators written in the
    reference's file layout and read back ``strict`` into evaluators of
    other weights, bit for bit;
    (a) on one protocol batch (InterHuman 96; HumanML3D 32, 64 persons) both
    towers' embeddings on the kernels against the plain versions;
    (b) MM-Distance, R-precision, FID and Diversity from the kernels'
    embeddings against those from the plain versions';
    (c) the mixer, its zero-init layers drawn from N(0, 0.02) so that the
    generated motions depend on the noise and on the kernels: one CFG mixer
    step at the InterHuman batch on the W8A8 kernels against the plain
    versions and f32, held as phase 4 holds its step; its three released
    files (CLIP tower included); then ``eval-mixermdm --datasets both``
    through its entry point on those files and the evaluators' ``--strict``:
    one replication, one InterHuman batch of 96, one HumanML3D batch of 32,
    MultiModality at 2 prompts x 15 replicas, DDIM-50 on the shipped W8A8
    path; each side's generation and scoring seconds, the launches by
    kernel, MultiModality above 0 on both sides, and every shape the two
    generation batches launched a kernel at among ``held`` (the launch-shape
    keys of phase 3's checks);
    (d) ``eval-base`` in each mode (8 items, DDIM respaced to 10 steps, no
    MultiModality), counted.
    Returns (launches by path, readings, the fixture roots)."""
    import os
    import shutil

    import numpy as np
    import torch

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.cli import eval_base, eval_mixermdm
    from mixermdm_tpu_torch.cli.infer_mixermdm import build_system
    from mixermdm_tpu_torch.data.humanml3d import HumanML3DDataset
    from mixermdm_tpu_torch.data.interhuman import InterHumanDataset
    from mixermdm_tpu_torch.data.loader import collate
    from mixermdm_tpu_torch.eval import driver, metrics as M
    from mixermdm_tpu_torch.eval.driver import interleave
    from mixermdm_tpu_torch.eval.interclip import build_interclip
    from mixermdm_tpu_torch.ops import _lib
    from mixermdm_tpu_torch.eval.protocol import EvaluatorWrapperIndividual
    from mixermdm_tpu_torch.train.checkpoint import load_released_interclip, save_released
    from mixermdm_tpu_torch.weights import released_interclip_state_dict

    t0 = time.time()
    seconds, readings, counts = {}, {}, {}
    ih_root, hml_root = _eval_fixtures(tmp, seed)
    files, evaluators = {}, {}
    for i, mode in enumerate(("interaction", "individual")):
        written = build_interclip(mode, device="cuda", seed=seed + 30 + i)
        path = f"{tmp}/interclip_{mode}.ckpt"
        save_released(path, released_interclip_state_dict(written))
        ev = build_interclip(mode, device="cuda", seed=seed + 40 + i)
        unfilled = load_released_interclip(ev, path, strict=True)
        same = all(torch.equal(a, b) for a, b in zip(ev.state_dict().values(),
                                                      written.state_dict().values()))
        n = sum(1 for _ in ev.parameters())
        print(f"   (setup) {mode} InterCLIP: {n} parameters written to the reference layout and "
              f"read back --strict ({len(unfilled)} unfilled), bitwise: "
              f"{'ok' if same and not unfilled else 'FAIL'}", flush=True)
        if unfilled or not same:
            raise SmokeFailure(f"{mode} evaluator file did not load back bit for bit")
        files[mode], evaluators[mode] = path, ev
        del written
    seconds["setup"] = time.time() - t0

    # (a) one protocol batch through both towers of both evaluators
    t_part = time.time()
    ih = InterHumanDataset(ih_root, mode="test", max_gt_length=300)
    batch = collate([ih[i] for i in range(EVAL_IH_CLIPS)])
    hml = HumanML3DDataset(hml_root, mode="test", max_gt_length=300, extended=True)
    hbatch = collate([hml[i] for i in range(EVAL_HML_CLIPS)])
    inter, ind = evaluators["interaction"], evaluators["individual"]
    persons, plens = EvaluatorWrapperIndividual(ind)._split_persons(hbatch["motions"],
                                                                  hbatch["motion_lens"])
    # the second set FID needs: the same motions with N(0, 0.3) noise
    noised = batch["motions"] + 0.3 * np.random.default_rng(seed).standard_normal(
        batch["motions"].shape).astype(np.float32)
    print(f"   (a) InterHuman batch {batch['motions'].shape}, lengths "
          f"{int(batch['motion_lens'].min())}-{int(batch['motion_lens'].max())}; HumanML3D "
          f"persons {tuple(persons.shape)}", flush=True)
    towers = {  # name: (the tower's call, its layers: one attention_f32 launch each)
        "motion tower, InterHuman B=96": (lambda: inter.encode_motion(
            batch["motions"], batch["motion_lens"]), inter.motion_encoder.transformer),
        "motion tower, InterHuman B=96 noised": (lambda: inter.encode_motion(
            noised, batch["motion_lens"]), inter.motion_encoder.transformer),
        "text tower, InterHuman B=96": (lambda: inter.encode_text(batch["text"]),
                                        inter.textTransEncoder),
        "motion tower, HumanML3D persons B=64": (lambda: ind.encode_motion(persons, plens),
                                                 ind.motion_encoder.transformer),
        "text tower, HumanML3D persons B=64": (lambda: ind.encode_text(interleave(
            hbatch["text_individual1"], hbatch["text_individual2"])), ind.textTransEncoder),
    }
    emb = {}
    for name, (fn, stack) in towers.items():
        ops.reset_launch_counts()
        with torch.inference_mode():
            k = fn()
            torch.cuda.synchronize()
            launched = dict(ops.launches)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            with ops.plain_versions():
                p = fn()
        print(f"   (a) {name}: {start.elapsed_time(end):.3f} ms a call (eager), launches "
              f"{json.dumps(launched, sort_keys=True)}", flush=True)
        _agree(f"(a) {name} embeddings", k, p, EVAL_EMB_TOL, "max")
        if launched.get("attention_f32", 0) != len(stack.layers):
            raise SmokeFailure(f"(a) {name}: not one attention_f32 launch a layer")
        emb[name] = (k, p)
    seconds["(a)"] = time.time() - t_part

    # (b) the protocol's metrics from both sets of embeddings
    names = list(towers)
    got, want = (_protocol_metrics(emb[names[2]][j], emb[names[0]][j], emb[names[1]][j], seed)
                 for j in (0, 1))
    # FID is a difference of terms of the size of the two covariances'
    # traces; near 0 it is held relative to them.
    scale = {m: max(abs(want[m]), 1e-6) for m in want}
    scale["FID"] = max(scale["FID"], sum(float(np.trace(M.calculate_activation_statistics(
        emb[n][1].double().cpu().numpy())[1])) for n in names[:2]))
    bad = [m for m in want if not abs(got[m] - want[m]) <= EVAL_METRIC_TOL * scale[m]]
    print("   (b) metrics of the InterHuman batch, kernels / plain: " + json.dumps(
        {m: [got[m], want[m]] for m in want}) + f"; held on {EVAL_METRIC_TOL} relative (FID "
        f"relative to {scale['FID']:.4g}): " + ("ok" if not bad else f"FAIL {bad}"), flush=True)
    if bad:
        raise SmokeFailure(f"(b) metrics from the kernels' embeddings differ: {bad}")
    readings["(b)"] = {"kernels": got, "plain": want}
    del emb, evaluators, inter, ind
    torch.cuda.empty_cache()

    # (c) the mixer: one CFG mixer step at the InterHuman batch, then its
    # released files
    t_part = time.time()
    system = build_system(None, device="cuda", seed=seed + 60, zero_init_std=0.02)
    twin = copy.deepcopy(system).cast_(None)  # f32 networks never run int8
    P, T = EVAL_IH_CLIPS, int(batch["motion_lens"].max())
    g = torch.Generator(device="cuda").manual_seed(seed + 61)
    cond = system.generate_cond(batch)
    x = torch.randn(P, T, 2 * system.nfeats, generator=g, device="cuda")
    t = torch.full((P,), 979, dtype=torch.long, device="cuda")
    ops.reset_launch_counts()
    step_k = system.cfg_mixer_step(x, x, t, cond)
    torch.cuda.synchronize()
    launched = dict(ops.launches)
    with ops.plain_versions():
        step_p = system.cfg_mixer_step(x, x, t, cond)
        step_f = twin.cfg_mixer_step(x, x, t, cond)
    del twin
    name = f"(c) one CFG mixer step, W8A8, {P} prompts x {T} frames"
    print(f"   {name}: launches {json.dumps(launched, sort_keys=True)}", flush=True)
    _agree(name, step_k, step_p, STEP_TOL, "fro")
    gap_p = _agree(name, step_p, step_f, None, "fro", "plain W8A8 vs f32")
    _agree(name, step_k, step_f, WITNESS_RATIO * gap_p, "fro",
           f"kernels vs f32 (at most {WITNESS_RATIO} x plain W8A8 vs f32)")
    if not launched.get("attention_q8"):
        raise SmokeFailure(f"{name}: the W8A8 kernels did not run")
    mixer_dir = os.path.join(tmp, "mixer")
    os.makedirs(mixer_dir)
    mixer_files = _save_released(system, mixer_dir, with_clip=True)
    del system, cond, x, step_k, step_p, step_f
    torch.cuda.empty_cache()
    seconds["(c) step + files"] = time.time() - t_part

    # (c) eval-mixermdm --datasets both through its entry point, with the
    # shapes that each generation batch launched kernels at counted
    t_part = time.time()
    argv = ["--data-root", ih_root, "--hml3d-root", hml_root, "--datasets", "both",
            "--replications", "1", "--num-samples", str(EVAL_IH_CLIPS), "--mm-num-samples", "2",
            "--mm-num-repeats", "15", "--checkpoint", mixer_files[0],
            "--ckpt-individual", mixer_files[1], "--ckpt-interaction", mixer_files[2],
            "--evaluator-checkpoint", files["interaction"],
            "--evaluator-individual-checkpoint", files["individual"], "--strict",
            "--seed", str(seed), "--out", f"{tmp}/eval_mixermdm.json"]
    chain, real_sample = collections.Counter(), driver.sample

    def counted_sample(*args, **kwargs):
        before = collections.Counter(_lib.launch_shapes)
        out = real_sample(*args, **kwargs)
        chain.update(collections.Counter(_lib.launch_shapes) - before)
        return out

    driver.sample = counted_sample  # the generation batches (not MultiModality's)
    try:
        summary, counts["eval-mixermdm"], lines = _cli_run(
            "(c) eval-mixermdm --datasets both", eval_mixermdm.run, argv, EVAL_PRINTED)
    finally:
        driver.sample = real_sample
    shutil.rmtree(mixer_dir)
    sides = _side_seconds(lines)
    mm = {side: summary[side]["MultiModality"]["mixermdm"][0] for side in ("interhuman", "hml3d")}
    ok = (_loaded_all(lines, 3) and _finite_summary(summary)
          and set(summary) == {"interhuman", "hml3d", "f_score"} and len(sides) == 2
          and all(v > 0 for v in mm.values()))
    print(f"   (c) seconds by side and part on {card}: {json.dumps(sides)}; the mixer's and the "
          f"evaluators' files loaded whole, metrics finite, MultiModality {json.dumps(mm)} above "
          f"0: {'ok' if ok else 'FAIL'}", flush=True)
    print("   (c) InterHuman / HumanML3D / F-score (random weights; says nothing of quality): "
          + json.dumps({side: {m: round(v[next(iter(v))][0], 5) for m, v in d.items()}
                        for side, d in summary.items()}), flush=True)
    if not ok:
        raise SmokeFailure("(c) eval-mixermdm: files not loaded whole, metrics not finite or "
                           "the generated motions do not vary")
    shapes = collections.defaultdict(dict)
    for key, n in sorted(chain.items(), key=lambda kv: str(kv[0])):
        shapes[key[0]][" ".join(map(str, key[1:]))] = n
    missing = sorted(" ".join(map(str, k)) for k in chain if k not in held)
    print(f"   (c) the generation batches' launches by kernel and shape ({len(chain)} shapes): "
          + json.dumps(shapes), flush=True)
    print("   (c) every one of those shapes held against its plain version in phase 3: "
          + ("ok" if chain and not missing else f"FAIL, not held: {json.dumps(missing)}"),
          flush=True)
    if not chain or missing:
        raise SmokeFailure(f"(c) kernels launched at shapes phase 3 did not hold: {missing}")
    readings["(c)"] = {"seconds_by_side": sides, "multimodality": mm}
    seconds["(c)"] = time.time() - t_part

    # (d) eval-base, each mode
    t_part = time.time()
    for mode in ("interaction", "individual", "dual", "mdm"):
        argv = ["--mode", mode, "--data-root", ih_root, "--hml3d-root", hml_root,
                "--replications", "1", "--num-samples", "8", "--mm-num-samples", "0",
                "--sample-steps", "10", "--evaluator-checkpoint", files["interaction"],
                "--evaluator-individual-checkpoint", files["individual"], "--strict",
                "--seed", str(seed), "--out", f"{tmp}/eval_base_{mode}.json"]
        summary, counts[f"eval-base {mode}"], lines = _cli_run(
            f"(d) eval-base --mode {mode}", eval_base.run, argv, EVAL_PRINTED)
        want_sides = {"interhuman", "hml3d"} if mode in ("interaction", "dual") else {"hml3d"}
        ok = (_loaded_all(lines, len(want_sides)) and _finite_summary(summary)
              and set(summary) == want_sides)
        print(f"   (d) eval-base --mode {mode}: seconds {json.dumps(_side_seconds(lines))}; "
              f"sides {sorted(summary)}, metrics finite: {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SmokeFailure(f"(d) eval-base --mode {mode} failed its checks")
    seconds["(d)"] = time.time() - t_part
    print("   phase 5d seconds by part: "
          + json.dumps({k: round(v, 1) for k, v in seconds.items()}), flush=True)
    readings["seconds"] = seconds
    return counts, readings, (ih_root, hml_root)


PARALLEL_STEPS = 10       # phase 7's DDIM chain, cut from 50
PARALLEL_TIMEOUT_S = 400  # phase 7's two ranks are joined within this, else killed


def parallel_phase(seed, card, tmp):
    """Phase 7, multi-rank sampling (``mixermdm_tpu_torch.scripts.
    parallel_layouts``): (a) an NCCL world of one rank, the data-parallel
    sample path bitwise against the plain call; (b) two ranks sharing
    ``cuda:0`` through ``gloo`` (the kernels built once, in phase 2), the
    shipped system at full width: data parallelism and ``--pp 2`` (W8A8),
    ``--tp 2`` and ``--tp 2 --sp`` (bf16, the kernels at the shard shapes),
    ``serve`` with data parallelism and ``infer-mixermdm`` on both ranks,
    each held to one rank.  Prints each layout's launch shapes, seconds a
    step and the collectives' transports.  Returns (each layout's launches
    by kernel, the phase's summary)."""
    from mixermdm_tpu_torch.parallel import launch
    from mixermdm_tpu_torch.scripts import parallel_layouts as pl

    t0 = time.time()
    one = pl.world_of_one(seed, PARALLEL_STEPS, store_dir=tmp)
    out_dir = os.path.join(tmp, "parallel")
    os.makedirs(out_dir, exist_ok=True)
    rep = launch(pl.layouts_rank, 2, backend="gloo", devices=["cuda:0", "cuda:0"],
                 args=(seed, PARALLEL_STEPS, out_dir), timeout_s=PARALLEL_TIMEOUT_S,
                 store_dir=tmp)[0]
    layouts = ("data parallelism 2", "pp 2", "tp 2", "tp 2 + sp")
    keys = {"data parallelism 2": "data parallelism", "pp 2": "pp 2", "tp 2": "tp 2",
            "tp 2 + sp": "tp 2 + sp"}
    for name in layouts:
        r = rep[keys[name]]
        print(f"   {name}: {r['s_per_step']:.4f} s a step (2 ranks on one card through gloo; "
              f"one rank {rep['one rank']['s_per_step']:.4f}); launch shapes "
              f"{json.dumps(r['launch_shapes'])}", flush=True)
    print(f"   serve: {json.dumps(rep['serve'])}", flush=True)
    print(f"   collectives' transports: {json.dumps(rep['transports'])}", flush=True)
    seconds = time.time() - t0
    print(f"   {card}; phase 7 seconds {seconds:.1f}", flush=True)
    counts = {name: collections.Counter(rep["launches"][name]) for name in layouts}
    summary = {"(a)": one, "seconds": seconds,
               "s_per_step": {k: rep[keys[k]]["s_per_step"] for k in layouts},
               "one_rank_s_per_step": rep["one rank"]["s_per_step"],
               "gaps": {k: {g: rep[keys[k]][g] for g in ("rel_fro", "limit")} for k in layouts},
               "transports": rep["transports"]}
    return counts, summary


def evaluator_training_phase(seed, card, tmp, roots):
    """train-evaluator at full width: (a) one step's loss and gradients
    (batch 32 of the InterHuman set, lengths up to 300) on the kernels
    against the plain versions, both f32 with TF32 off (the model's own
    precision: the plain versions are its f32 reference), every gap printed
    first; (b) the CLI for 3 steps, counted, its file read back by
    ``eval-mixermdm --evaluator-checkpoint --strict`` (InterHuman side, 8
    items, DDIM respaced to 10 steps).  Returns (launches by path,
    readings)."""
    import os

    import numpy as np
    import torch

    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.cli import eval_mixermdm, train_evaluator
    from mixermdm_tpu_torch.data.interhuman import InterHumanDataset
    from mixermdm_tpu_torch.data.loader import collate
    from mixermdm_tpu_torch.eval.interclip import build_interclip, full_f32

    ih_root, _ = roots
    counts, readings = {}, {}
    t0 = time.time()
    model = build_interclip("interaction", device="cuda", seed=seed + 50)
    ds = InterHumanDataset(ih_root, mode="train", max_gt_length=300)
    batch = collate([ds[i] for i in range(EVAL_TRAIN_B)])
    motions = torch.from_numpy(batch["motions"]).float().cuda()
    lens = torch.from_numpy(batch["motion_lens"]).cuda()
    tokens = model.tokenize(batch["text"])
    named = {k: p for k, p in model.named_parameters() if p.requires_grad}
    n_layers = len(model.motion_encoder.transformer.layers) + len(model.textTransEncoder.layers)

    def side(plain):
        with full_f32(), ops.plain_versions() if plain else contextlib.nullcontext():
            loss, _ = model.compute_loss(motions, lens, tokens)
            grads = torch.autograd.grad(loss, list(named.values()))
        flat = {t: torch.cat([g.flatten() for k, g in zip(named, grads)
                              if k == t or k.startswith(t + ".")]) for t in EVAL_SUBTREES}
        return float(loss.detach()), flat

    ops.reset_launch_counts()
    lk, gk = side(False)
    torch.cuda.synchronize()
    launched = dict(ops.launches)
    lp, gp = side(True)
    print(f"   (a) one step at B {EVAL_TRAIN_B} (lengths {int(lens.min())}-{int(lens.max())}): "
          f"launches {json.dumps(launched, sort_keys=True)}; loss kernels / plain {lk:.7g} / "
          f"{lp:.7g}, relative {abs(lk - lp) / abs(lp):.3g} (held on {F32_TOL})", flush=True)
    gaps = {t: _gaps(gk[t], gp[t])[2] for t in EVAL_SUBTREES}
    print("   (a) gradient rel(fro) kernels vs plain by subtree: " + json.dumps(gaps), flush=True)
    if not abs(lk - lp) <= F32_TOL * abs(lp) or not math.isfinite(lk):
        raise SmokeFailure("(a) train-evaluator loss: kernels vs plain disagree")
    for t in EVAL_SUBTREES:
        _agree(f"(a) gradient of {t}", gk[t], gp[t], EVAL_GRAD_TOL, "fro")
    if not launched.get("attention_f32") == launched.get("attention_bwd") == n_layers:
        raise SmokeFailure("(a) not one attention_f32 and one attention_bwd launch a layer")
    readings["grad_rel_fro"] = gaps
    readings["loss_rel"] = abs(lk - lp) / abs(lp)
    del model, named, gk, gp
    torch.cuda.empty_cache()

    out_dir = os.path.join(tmp, "evaluator")
    argv = ["--data-root", ih_root, "--out-dir", out_dir, "--max-steps", "3",
            "--batch-size", str(EVAL_TRAIN_B), "--seed", str(seed)]
    trained, counts["train-evaluator"], _ = _cli_run(
        "(b) train-evaluator " + " ".join(argv), train_evaluator.run, argv, EVAL_PRINTED)
    steps = trained["records"]
    per_step = [r["dt_s"] for r in steps]
    ok = len(steps) == 3 and all(math.isfinite(r["total"]) for r in steps)
    print(f"   (b) train-evaluator: losses {[round(r['total'], 6) for r in steps]}, seconds a "
          f"step {[round(t, 4) for t in per_step]} on {card}: {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SmokeFailure("(b) train-evaluator: not 3 finite steps")
    readings["step_s"] = per_step
    del trained
    argv = ["--data-root", ih_root, "--datasets", "interhuman", "--replications", "1",
            "--num-samples", "8", "--mm-num-samples", "0", "--sample-steps", "10",
            "--evaluator-checkpoint", os.path.join(out_dir, "final.ckpt"), "--strict",
            "--seed", str(seed), "--out", os.path.join(tmp, "eval_trained.json")]
    summary, _, lines = _cli_run("(b) eval-mixermdm on the trained evaluator",
                                 eval_mixermdm.run, argv, EVAL_PRINTED)
    ok = _loaded_all(lines, 1) and _finite_summary(summary)
    print(f"   (b) train-evaluator's final.ckpt read by eval-mixermdm --strict, every parameter "
          f"filled, metrics finite: {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SmokeFailure("(b) the trained evaluator file did not load whole")
    readings["seconds"] = time.time() - t0
    return counts, readings


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
GEMM_NAMES = (*GEMM_ROUTES, "linear_q8", "linear_q8_gelu_q8")
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
    # Phase 7's layouts on two ranks: data parallelism and the pipeline on
    # the shipped W8A8 blocks, tensor parallelism (and with sequence
    # parallelism) on the bf16 blocks at the shard shapes.
    "data parallelism 2": ("adaln_modulate_q8", "linear_q8", "linear_q8_gelu_q8",
                           "attention_q8", "fused_sa_block_q8", "fused_ca_block_q8",
                           "fused_ffn_block_q8"),
    "pp 2": ("adaln_modulate_q8", "linear_q8", "linear_q8_gelu_q8", "attention_q8",
             "fused_sa_block_q8", "fused_ca_block_q8", "fused_ffn_block_q8"),
    "tp 2": ("adaln_modulate", "linear_epilogue", "attention", "fused_sa_block",
             "fused_ca_block", "fused_ffn_block"),
    "tp 2 + sp": ("adaln_modulate", "linear_epilogue", "attention", "fused_sa_block",
                  "fused_ca_block", "fused_ffn_block"),
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
    # The diffusion engine's chains (phase 5e (b)) on in2IN interaction in
    # bf16: its denoiser's fused blocks and the GEMM routes around them.
    "engine": ("adaln_modulate", *GEMM_ROUTES, "attention", "fused_sa_block",
               "fused_ca_block", "fused_ffn_block"),
    # The rest of training (phase 6b).  train-in2in at the shipped dropout:
    # the frozen tower on the attention kernel and the GEMM routes; the
    # trained post-encoder head (in2IN) on the f32 attention and its
    # backward; the denoiser's attention with dropout on the plain math
    # with dropout, as the JAX package takes XLA there.
    "train-in2in interaction": ("linear_epilogue", "attention", "attention_f32",
                                "attention_bwd", "fused_attention"),
    "train-in2in individual": ("linear_epilogue", "attention", "attention_f32",
                               "attention_bwd", "fused_attention"),
    "train-in2in mdm": ("linear_epilogue", "attention", "fused_attention"),
    # QUANT_TRAIN: the frozen denoisers on the W8A8 kernels in both steps,
    # each step alone and train-mixermdm --quant-train.
    "quant_train generator": ("adaln_modulate_q8", "linear_q8", "attention_q8",
                              "linear_q8_gelu_q8", "fused_sa_block_q8", "fused_ca_block_q8",
                              "fused_ffn_block_q8", "attention_bwd"),
    "quant_train discriminator": ("adaln_modulate_q8", "linear_q8", "attention_q8",
                                  "linear_q8_gelu_q8", "fused_sa_block_q8",
                                  "fused_ca_block_q8", "fused_ffn_block_q8"),
    "train-mixermdm quant": ("adaln_modulate_q8", "linear_q8", "attention_q8",
                             "linear_q8_gelu_q8", "fused_sa_block_q8", "fused_ca_block_q8",
                             "fused_ffn_block_q8", "attention_bwd"),
    "train-finetuned": ("linear_epilogue", "attention", "attention_f32", "attention_bwd",
                        "fused_attention"),
    # Evaluation (phase 5d): the mixer's W8A8 sampling, the InterCLIP towers
    # on the f32 attention; eval-base's generators in bf16 (MDM's encoder
    # without the zero key), the towers again.
    "eval-mixermdm": ("adaln_modulate_q8", *GEMM_ROUTES, "attention", "attention_f32",
                      "attention_q8", "fused_attention", "linear_q8", "linear_q8_gelu_q8",
                      "fused_sa_block_q8", "fused_ca_block_q8", "fused_ffn_block_q8"),
    "eval-base interaction": ("adaln_modulate", *GEMM_ROUTES, "attention", "attention_f32",
                              "fused_attention", "fused_sa_block", "fused_ca_block",
                              "fused_ffn_block"),
    "eval-base individual": ("adaln_modulate", *GEMM_ROUTES, "attention", "attention_f32",
                             "fused_attention", "fused_sa_block", "fused_ffn_block"),
    "eval-base dual": ("adaln_modulate", *GEMM_ROUTES, "attention", "attention_f32",
                       "fused_attention", "fused_sa_block", "fused_ca_block", "fused_ffn_block"),
    "eval-base mdm": (*GEMM_ROUTES, "attention", "attention_f32", "fused_attention"),
    # train-evaluator (phase 6c): the towers' attention forward and backward
    # in f32; their dense layers are f32 products, outside the kernels.
    "train-evaluator": ("attention_f32", "attention_bwd", "fused_attention"),
}
# The path whose counts stand in a kernel's row: the shipped sampling path,
# the bf16 one for the bf16 block forms, the training path for the backward
# and the f32 attention it brought (the InterCLIP towers' shapes stand in
# rows of their own, :data:`SHAPE_ROWS`); quant_rows stands on the W8A8 path it left to its producers (0 launches
# there unless an FFN input is not modulated).  Every row also carries its
# launches on each path that launched it (``launches_by_path``).
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


# Rows of a kernel at a second shape, each under a name of its own: (the
# kernel, the path whose launches it carries, its check).
SHAPE_ROWS = {
    "attention_f32 InterCLIP motion tower": ("attention_f32", "eval-mixermdm",
                                             "attention f32 InterCLIP motion D=128 kpm"),
    "attention_bwd f32 InterCLIP motion tower": ("attention_bwd", "train-evaluator",
                                                 "attention_bwd f32 InterCLIP motion D=128"),
    # The shard shapes of --tp 2 (phase 7): the launches are the tp 2 step's.
    "attention tp2 denoiser H=4": ("attention", "tp 2", "attention tp2 H=4 D=128"),
    "attention tp2 mixer H=4": ("attention", "tp 2", "attention tp2 H=4 D=64"),
    "linear_epilogue tp2 QKV N=1536": ("linear_epilogue", "tp 2", "linear tp2 QKV E=1024 N=1536"),
    "linear_epilogue tp2 out-proj K=512": ("linear_epilogue", "tp 2",
                                           "linear tp2 out-proj partial E=1024 K=512"),
    "linear_epilogue tp2 FFN1 N=1024": ("linear_epilogue", "tp 2",
                                        "linear tp2 FFN1 gelu E=1024 N=1024"),
    "linear_epilogue tp2 FFN2 K=1024": ("linear_epilogue", "tp 2",
                                        "linear tp2 FFN2 partial E=1024 K=1024"),
    "adaln_modulate tp2+sp T=149": ("adaln_modulate", "tp 2 + sp",
                                    "adaln_modulate E=1024 T=149 tp2+sp"),
}


def _shape_key(r):
    """The ``_lib.launch_shapes`` key of a phase-3 check that held one
    kernel against its plain version (None for an entry point, or a check
    that failed)."""
    kind, s = r.get("kind"), r.get("shape") or {}
    if not r.get("ok"):
        return None
    if kind in GEMM_ROUTES or kind == "linear_q8":
        epi = ("gelu" if s.get("activation") == "gelu" else
               "residual" if s.get("residual") else "none")
        return (kind, s["M"], s["K"], s["N"], epi)
    if kind == "linear_q8_gelu_q8":
        return (kind, s["M"], s["K"], s["N"], "gelu_q8")
    if kind in ("attention", "attention_f32", "attention_q8"):
        return (kind, s["B"], s["H"], s["Tq"], s["Tk"], s["D"])
    if kind in ("adaln_modulate", "adaln_modulate_q8"):
        return (kind, s["B"], s["T"], s["E"])
    return None


def kernels_line(results, counts):
    """One row per kernel and entry point (and per :data:`SHAPE_ROWS`);
    ``launches`` from the main path of :data:`ROW_PATH` (else the W8A8
    sampling path, or the bf16 one for the bf16 block forms that only it
    runs)."""
    by_name = {r["check"]: r for r in results}
    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = by_name[REPRESENTATIVE[name]]
        path = ROW_PATH.get(name, "W8A8" if name in PATH_KERNELS["W8A8"] else "bf16")
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": int(counts[path].get(name, 0)), "path": path,
            "launches_by_path": {p: int(c[name]) for p, c in counts.items() if c.get(name)},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
        })
    for name, (kernel, path, check) in SHAPE_ROWS.items():
        r = by_name[check]
        rows.append({
            "name": name, "route": "cuda", "source": KERNELS[kernel][0],
            "replaces": KERNELS[kernel][1], "launches": int(counts[path].get(kernel, 0)),
            "path": path, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
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

    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        t0 = phase("5d. evaluation at full width: InterCLIP towers and metrics, kernels vs plain; "
                   "eval-mixermdm --datasets both, eval-base (four modes)")
        held = {key for key in map(_shape_key, results) if key is not None}
        eval_counts, evaluation, eval_roots = evaluation_phase(args.seed, card, tmp, held)
        counts.update(eval_counts)
        done(t0)

        t0 = phase("5e. the diffusion engine at full width (in2IN interaction): DDPM, DDIM at "
                   "eta 0.5, guidance, the reverse ODE, the VLB; kernels vs plain, chains vs "
                   "their float64 replay, counted")
        counts["engine"], engine = engine_phase(args.seed, card)
        done(t0)

        t0 = phase("5f. the data path: the native motion library against its numpy version, "
                   "items/s of the dataset and of the loader's workers")
        data = data_phase(args.seed, card, tmp)
        done(t0)

        t0 = phase("6. adversarial training at full width")
        counts["train"], phase6 = train_phase(args.seed, tmp)
        done(t0)

        t0 = phase("6b. the rest of training at full width: base models (train-in2in), "
                   "QUANT_TRAIN, --resume, train-finetuned")
        rest_counts, rest = rest_of_training_phase(args.seed, tmp, phase6)
        counts.update(rest_counts)
        done(t0)

        t0 = phase("6c. train-evaluator at full width: one step's gradients, kernels vs plain; "
                   "the CLI, its file read by eval-mixermdm --strict")
        ev_counts, ev_train = evaluator_training_phase(args.seed, card, tmp, eval_roots)
        counts.update(ev_counts)
        done(t0)

        t0 = phase("7. parallel sampling: an NCCL world of one; two ranks on cuda:0 through "
                   "gloo: data parallelism, --pp 2, --tp 2, --tp 2 --sp, serve, infer-mixermdm")
        par_counts, parallel = parallel_phase(args.seed, card, tmp)
        counts.update(par_counts)
        done(t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    t0 = phase("8. summary")
    counts["exp_kernels"] = sa_counts
    line = kernels_line(results, counts)
    missing = [f"{name} ({path} path)" for path, names in PATH_KERNELS.items() for name in names
               if not counts[path].get(name)]
    if missing:
        raise SmokeFailure("not launched in the main path: " + ", ".join(missing))
    done(t0)
    print(f"   inference surface (phase 5b): {json.dumps(surface)}", flush=True)
    print("   the rest of training (phase 6b): " + json.dumps(
        {k: v for k, v in rest.items() if not k.startswith("grad ")}), flush=True)
    print("   evaluation (phase 5d): " + json.dumps(
        {"seconds": evaluation["seconds"], "by side": evaluation["(c)"]["seconds_by_side"]}),
        flush=True)
    print("   train-evaluator (phase 6c): " + json.dumps(ev_train), flush=True)
    print("   parallel sampling (phase 7): " + json.dumps(parallel), flush=True)
    print("   the diffusion engine (phase 5e): " + json.dumps(
        {k: {"s_per_request": v["s_per_request"], "launches": sum(v["launches"].values()),
             "replay_gaps": v["replay_gaps"]}
         for k, v in engine["chains"].items()}), flush=True)
    print("   the data path (phase 5f): " + json.dumps(data), flush=True)
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
