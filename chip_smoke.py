#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mixermdm_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printing its wall-clock seconds:

1. the card's name and power limit (``nvidia-smi``);
2. build of the CUDA kernels from ``mixermdm_tpu_torch/csrc`` (plain nvcc);
3. each kernel and each entry point against its plain PyTorch version on
   the card, at the shapes of the sampling and training paths (bf16, W8A8,
   f32 attention, the attention backward): max abs/rel error and tolerance,
   kernel / plain / library times and the card's bound for the same work;
4. the sampling path at full published width (two 1024-d in2IN denoisers,
   the 512-d mixer, the ViT-L/14 text tower with its f32 post-encoder heads;
   T = 299, CFG 3.5, mixing mode 4, random weights from a seed), on the
   shipped config's W8A8 path (``QUANT_FROZEN: true``) and on the bf16 path
   of the same weights: the text conds, both denoisers and one CFG mixer step
   on the kernels against the plain versions (and against f32), the int8
   launch count of one step;
5. for each sampling path the whole chain (DDIM-50) through
   ``MixerMDMSystem.generate_cond`` and ``sample``, with the launch counts of
   that run;
6. adversarial training at full width (``configs/models/MixerMDM.yaml``,
   ``configs/train/MixerMDM.yaml``, B = 8, T = 300): the gradients of one G
   and one D step on the kernels against the plain versions (and against
   f32), the training CLI (``cli/train_mixermdm``) for 4 fit steps on a
   synthetic InterHuman fixture with the launch counts of that run, the
   frozen networks bitwise unchanged, and seconds per fit step with the
   differentiated attention on the kernels and on the plain versions;
7. one JSON line per kernel and entry point, then the result line.

Any failure exits nonzero and prints no result line.  The script imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
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
            "eager_ms": timed(kernel),
        }
        print("   " + json.dumps(res), flush=True)
        return res

    # --- attention kernel, through the fused_attention entry point ---------
    def attn_case(name, B, H, Tq, Tk, D, zero_attn, causal=False, kpm_rows=(), tol=2e-2):
        q, k, v = rnd(B, H, Tq, D), rnd(B, H, Tk, D), rnd(B, H, Tk, D)
        kpm = None
        if kpm_rows:
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
    for B, T, E in ((8, 299, 1024), (8, 299, 512), (3, 131, 1024)):
        x, sc, sh = rnd(B, T, E), rnd(B, E, std=0.2), rnd(B, E, std=0.2)
        results.append(compare(
            f"adaln_modulate E={E} T={T}", lambda: ops.adaln_modulate(x, sc, sh),
            lambda: ops.adaln_modulate_plain(x, sc, sh), 2e-2,
            2 * (2 * B * T * E + 2 * B * E), 8 * B * T * E, kind="adaln_modulate",
            peak=H100_F32_FLOPS, B=B, T=T, E=E))

    # --- linear_epilogue ----------------------------------------------------
    def lin_case(name, M, K, N, act=None, res=False, tol=2e-2):
        x, w, b = rnd(M, K), rnd(N, K, std=K ** -0.5), rnd(N, std=0.1)
        r = rnd(M, N) if res else None
        n_bytes = 2 * (M * K + N * K + N + M * N * (2 if res else 1))
        lib = (lambda: F.linear(x, w, b)) if (act is None and not res) else None
        return compare(
            name, lambda: ops.linear(x, w, b, activation=act, residual=r),
            lambda: ops.linear_plain(x, w, b, activation=act, residual=r), tol,
            n_bytes, 2 * M * N * K, library=lib, kind="linear_epilogue",
            M=M, K=K, N=N, activation=act, residual=res)

    M = 8 * 299
    results.append(lin_case("linear QKV E=1024", M, 1024, 3072))
    results.append(lin_case("linear FFN1 gelu E=1024", M, 1024, 2048, act="gelu"))
    results.append(lin_case("linear FFN2 +residual E=1024", M, 2048, 1024, res=True))
    results.append(lin_case("linear QKV E=512", M, 512, 1536))
    results.append(lin_case("linear motion_embed K=262", M, 262, 1024))
    results.append(lin_case("linear final N=262", M, 1024, 262))
    results.append(lin_case("linear influence head N=23", M, 512, 23))
    results.append(lin_case("linear clip c_fc", 2 * 77, 768, 3072))

    # --- the four entry points: fused blocks ---------------------------------
    def block_params(E, F_=None):
        p = {"w_qkv": rnd(3 * E, E, std=E ** -0.5), "b_qkv": rnd(3 * E, std=0.1),
             "w_o": rnd(E, E, std=E ** -0.5), "b_o": rnd(E, std=0.1)}
        if F_:
            p.update(w1=rnd(F_, E, std=E ** -0.5), b1=rnd(F_, std=0.1),
                     w2=rnd(E, F_, std=F_ ** -0.5), b2=rnd(E, std=0.1))
        return p

    def sa_case(B, T, E, H, residual, kpm_tail=False):
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
        return compare(f"fused_sa_block E={E} T={T} residual={residual}",
                       lambda: ops.fused_sa_block(*args, **kw),
                       lambda: ops.fused_sa_block_plain(*args, **kw), 3e-2, n_bytes, flops,
                       kind="fused_sa_block", B=B, T=T, E=E, H=H, residual=residual,
                       key_padding=kpm_tail)

    def ca_case(B, T, E, H, residual):
        x, xf = rnd(B, T, E), rnd(B, T, E)
        mods = [rnd(B, E, std=0.2) for _ in range(4)]
        p = block_params(E)
        args = (x, xf, *mods, p["w_qkv"], p["b_qkv"], p["w_o"], p["b_o"], None)
        kw = dict(n_heads=H, residual=residual)
        n_bytes = 2 * (3 * B * T * E + 4 * B * E + 4 * E * E + 4 * E)
        flops = 2 * B * T * E * 4 * E + 4 * B * T * T * E
        return compare(f"fused_ca_block E={E} T={T} residual={residual}",
                       lambda: ops.fused_ca_block(*args, **kw),
                       lambda: ops.fused_ca_block_plain(*args, **kw), 3e-2, n_bytes, flops,
                       kind="fused_ca_block", B=B, T=T, E=E, H=H, residual=residual)

    def ffn_case(B, T, E, F_, residual, modulate=True):
        x = rnd(B, T, E)
        sc, sh = (rnd(B, E, std=0.2), rnd(B, E, std=0.2)) if modulate else (None, None)
        p = block_params(E, F_)
        args = (x, sc, sh, p["w1"], p["b1"], p["w2"], p["b2"])
        n_bytes = 2 * (2 * B * T * E + (2 * B * E if modulate else 0) + 2 * E * F_ + F_ + E)
        return compare(f"fused_ffn_block E={E} F={F_} residual={residual} adaln={modulate}",
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
            "library_ms": library_ms, "eager_ms": timed(run),
        }
        print("   " + json.dumps(result), flush=True)
        return result

    results.append(q8_case("linear_q8 QKV E=1024", 1024, 3072))
    results.append(q8_case("linear_q8 FFN1 gelu f32 E=1024", 1024, 2048, act="gelu"))
    results.append(q8_case("linear_q8 FFN2 +residual E=1024", 2048, 1024, res=True))
    results.append(q8_case("linear_q8 QKV E=512", 512, 1536))

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
    def bwd_case(name, dt, B, H, T, D, zero_attn, kpm_tail):
        q, k, v, g = (rnd(B, H, T, D, dt=dt) for _ in range(4))
        kpm = None
        if kpm_tail:
            kpm = torch.zeros(B, T, dtype=torch.bool, device=dev)
            kpm[:, T - T // 5:] = True
        kern = lambda: ops.attention_bwd(q, k, v, kpm, g, zero_attn)  # noqa: E731
        plain = lambda: ops.attention_bwd_plain(q, k, v, kpm, g, zero_attn)  # noqa: E731
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        # The f32 truth: torch.autograd.grad through the plain forward on the
        # inputs widened to f32 (no custom backward involved).
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        out = ops.fused_attention_plain(*leaves, kpm, None, zero_attn)
        want_f = torch.autograd.grad(out, leaves, g.float())

        def rel(a, b):
            return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

        f32 = dt == torch.float32
        errs = {n: {"vs_plain": rel(a, b), "vs_f32_autograd": rel(a, c),
                    "plain_vs_f32_autograd": rel(b, c)}
                for n, a, b, c in zip(("dq", "dk", "dv"), got, want, want_f)}
        tol = F32_TOL if f32 else BWD_BF16_TOL
        ok = all(e["vs_plain"] <= tol for e in errs.values())
        if f32:
            ok = ok and all(e["vs_f32_autograd"] <= tol for e in errs.values())
        else:  # witness: no farther from the f32 gradients than the plain version
            ok = ok and all(
                e["vs_f32_autograd"] <= WITNESS_RATIO * max(e["plain_vs_f32_autograd"], 1e-6)
                for e in errs.values())
        ok = ok and all(bool(torch.isfinite(t.float()).all()) for t in got)
        n_bytes = 7 * B * H * T * D * q.element_size() + (4 * B * T if kpm_tail else 0)
        b_ms, b_by = bound_ms(n_bytes, 5 * 2 * B * H * T * T * D,
                              H100_F32_FLOPS if f32 else H100_BF16_FLOPS)
        kz = torch.cat([k, k.new_zeros(B, H, 1, D)], 2) if zero_attn else k
        vz = torch.cat([v, v.new_zeros(B, H, 1, D)], 2) if zero_attn else v
        bias = torch.zeros(B, 1, T, kz.shape[2], device=dev, dtype=dt)
        if kpm is not None:
            bias[..., :T] += ops.attention.key_bias(kpm)[:, None, None, :].to(dt)
        lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, kz, vz))

        def library():  # SDPA forward + backward with the zero key appended
            out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=bias)
            return torch.autograd.grad(out, (lq, lk, lv), g)

        res = {
            "check": name, "kind": "attention_bwd",
            "shape": {"B": B, "H": H, "Tq": T, "Tk": T, "D": D, "dtype": str(dt)[6:],
                      "zero_attn": zero_attn, "key_padding": kpm_tail},
            "max_abs_err": max(((a.float() - b.float()).abs().max().item())
                               for a, b in zip(got, want)),
            "max_rel_err": max(e["vs_plain"] for e in errs.values()),
            "errors": errs, "tol_rel": tol,
            "witness": None if f32 else
            f"vs_f32_autograd <= {WITNESS_RATIO} x plain_vs_f32_autograd",
            "ok": bool(ok), "ms": graph_timed(kern), "plain_ms": graph_timed(plain),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": timed(library),
            "library_timing": "eager (autograd)", "eager_ms": timed(kern),
        }
        print("   " + json.dumps(res), flush=True)
        return res

    # G step: the discriminators' attention (bf16, 4 heads of 64, T = 300,
    # zero-attn, key padding) and the mixer head's (f32, 8 heads of 96).
    results.append(bwd_case("attention_bwd bf16 discriminator", torch.bfloat16, 8, 4, 300, 64,
                            True, True))
    results.append(bwd_case("attention_bwd f32 post-encoder", torch.float32, 8, 8, 77, 96,
                            False, False))
    return results


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
    # step launches linear_q8 as often as the blocks, read off the modules,
    # say: Q/K/V and O in a self-attention block, Q, K/V and O in a
    # cross-attention block, the two products of an FFN.
    _agree("one CFG mixer step", steps["W8A8"][0], steps["bf16"][0], None, "fro",
           "W8A8 vs bf16 kernels")
    q8_vs_bf16 = _gaps(steps["W8A8"][0], steps["bf16"][0])[2]
    if not q8_vs_bf16 > steps["W8A8"][1]:
        raise SmokeFailure(f"W8A8 step within {q8_vs_bf16:.4g} of the bf16 step: int8 did not run")
    n = collections.Counter(type(m).__name__ for net in (system.model1, system.model2, system.core)
                            for m in net.modules() if isinstance(m, layers.Int8Block))
    sa, ca, ffn = n["VanillaSelfAttention"], n["VanillaCrossAttention"], n["FFN"]
    expected = {"linear_q8": 2 * sa + 3 * ca + 2 * ffn, "quant_rows": 2 * sa + 3 * ca + 2 * ffn,
                "fused_sa_block_q8": sa, "fused_ca_block_q8": ca, "fused_ffn_block_q8": ffn,
                "fused_sa_block": 0, "fused_ca_block": 0, "fused_ffn_block": 0}
    ops.reset_launch_counts()
    step()
    torch.cuda.synchronize()
    got = {k: int(ops.launches.get(k, 0)) for k in expected}
    print(f"   launches in one W8A8 step: {json.dumps(got)}; from the modules "
          f"({sa} SA, {ca} CA, {ffn} FFN blocks): {json.dumps(expected)}", flush=True)
    if got != expected:
        raise SmokeFailure("W8A8 step launches differ from the count read off the modules")

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
            out = system.sample(cond, T,
                                generator=torch.Generator(device="cuda").manual_seed(seed))
            torch.cuda.synchronize()
            t2 = time.time()
            counts[label] = dict(ops.launches)
        n_steps = system.sample_schedule.num_timesteps
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
    from mixermdm_tpu_torch.systems.mixermdm import DISC_MODULES, GEN_MODULES
    from mixermdm_tpu_torch.train.trainer import trainable_params

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        data = os.path.join(tmp, "data")
        _fixture(data, seed)
        dataset = InterHumanDataset(data, mode="train")
        batch_np = collate([dataset[i] for i in range(TRAIN_B)])
        print(f"   fixture: {len(dataset)} items, batch lengths "
              f"{batch_np['motion_lens'].tolist()} of T = {batch_np['motions'].shape[1]}",
              flush=True)

        # --- gradient check ---------------------------------------------------
        t0 = time.time()
        system = build_system(MODEL_CFG, device="cuda", seed=seed, zero_init_std=0.02, train=True)
        system.normalizer1 = system.normalizer2 = _fixture_normalizer(dataset)
        system.cast_(system.compute_dtype, train=True)  # the forward takes the new statistics
        twin = copy.deepcopy(system).cast_(None, train=True)
        print(f"   built the training system and its f32 twin in {time.time() - t0:.1f} s",
              flush=True)
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
                name = f"{mode} step, gradient of {k}"
                _agree(name, gk[k], gp[k], GRAD_TOL, "fro")
                gap_p = _agree(name, gp[k], gf[k], None, "fro", "plain vs f32")
                _agree(name, gk[k], gf[k], WITNESS_RATIO * gap_p, "fro",
                       f"kernels vs f32 (at most {WITNESS_RATIO} x plain vs f32)")
        del system, twin
        torch.cuda.empty_cache()

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
    "linear_epilogue": ("mixermdm_tpu_torch/csrc/linear.cu",
                        "mixermdm_tpu/ops/fused_block.py:80 (projections of "
                        "_sa_block_kernel, _ca_block_kernel :259, _ffn_kernel :438)"),
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
                   "_ca_block_kernel_q8 :333, _ffn_kernel_q8 :467)"),
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
}
# The kernels each main path must launch.  The shipped config samples on the
# W8A8 path; the bf16 path (QUANT_FROZEN off) runs the bf16 block forms.
PATH_KERNELS = {
    "W8A8": ("adaln_modulate", "linear_epilogue", "attention", "attention_f32",
             "fused_attention", "quant_rows", "linear_q8", "fused_sa_block_q8",
             "fused_ca_block_q8", "fused_ffn_block_q8"),
    "bf16": ("adaln_modulate", "linear_epilogue", "attention", "attention_f32",
             "fused_attention", "fused_sa_block", "fused_ca_block", "fused_ffn_block"),
    # Adversarial training: the frozen denoisers on the bf16 blocks, the
    # discriminators' attention forward and backward in bf16, the mixer
    # head's in f32.
    "train": ("adaln_modulate", "linear_epilogue", "attention", "attention_f32",
              "attention_bwd", "fused_attention", "fused_sa_block", "fused_ca_block",
              "fused_ffn_block"),
}
# The path whose counts stand in a kernel's row: the shipped sampling path,
# the bf16 one for the bf16 block forms, the training path for the kernels
# it brought.
ROW_PATH = {"attention_f32": "train", "attention_bwd": "train"}
# The check whose numbers stand for each name in the kernels line: the
# largest main-path shape.
REPRESENTATIVE = {
    "adaln_modulate": "adaln_modulate E=1024 T=299",
    "linear_epilogue": "linear QKV E=1024",
    "attention": "attention denoiser D=128",
    "attention_f32": "attention f32 post-encoder D=96",
    "attention_bwd": "attention_bwd bf16 discriminator",
    "fused_attention": "attention clip tower",
    "fused_sa_block": "fused_sa_block E=1024 T=299 residual=True",
    "fused_ca_block": "fused_ca_block E=1024 T=299 residual=True",
    "fused_ffn_block": "fused_ffn_block E=1024 F=2048 residual=True adaln=True",
    "quant_rows": "quant_rows float32 M=2392 K=2048",
    "linear_q8": "linear_q8 QKV E=1024",
    "fused_sa_block_q8": "fused_sa_block_q8 E=1024 T=299 residual=True",
    "fused_ca_block_q8": "fused_ca_block_q8 E=1024 T=299 residual=True",
    "fused_ffn_block_q8": "fused_ffn_block_q8 E=1024 F=2048 residual=True",
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

    t0 = phase("4. sampling path at full width: networks and one step, kernels vs plain")
    system, batch = sample_phase(args.seed)
    done(t0)

    t0 = phase("5. sampling main paths (text + DDIM-50, W8A8 and bf16), counted")
    counts = sample_main_paths(system, batch, args.seed)
    del system
    torch.cuda.empty_cache()
    done(t0)

    t0 = phase("6. adversarial training at full width")
    counts["train"] = train_phase(args.seed)
    done(t0)

    t0 = phase("7. summary")
    line = kernels_line(results, counts)
    missing = [f"{name} ({path} path)" for path, names in PATH_KERNELS.items() for name in names
               if not counts[path].get(name)]
    if missing:
        raise SmokeFailure("not launched in the main path: " + ", ".join(missing))
    done(t0)
    print(f"   total seconds: {time.time() - t_start:.1f}", flush=True)
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
