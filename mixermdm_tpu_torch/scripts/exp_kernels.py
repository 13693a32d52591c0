"""Kernel-variant experiments for the self-attention block on the card.

The port of ``scripts/exp_kernels.py`` (the JAX package's variant study of
its fused SA block), run as::

    python -m mixermdm_tpu_torch.scripts.exp_kernels [--quant] [--check]
    python -m mixermdm_tpu_torch.scripts.exp_kernels --ablate [--quant]
    python -m mixermdm_tpu_torch.scripts.exp_kernels --headbatch [--quant] [--check]
    python -m mixermdm_tpu_torch.scripts.exp_kernels --int8attn
    python -m mixermdm_tpu_torch.scripts.exp_kernels --phases [--batch 8]

at the JAX script's shape (B 40, T 299, E 1024, H 8) and data (numpy
``default_rng(0)``, inputs scaled 0.05, weights and biases 0.02).  Each
variant is one launch of ``sa_block`` or ``sa_block_i8x``
(``mixermdm_tpu_torch/ops/sa_variants.py``); the baseline ``v0`` is the
port's shipped composition, ``fused_sa_block`` (``fused_sa_block_q8`` with
``--quant``), on the same inputs.  Variants:

- default: v1 merged QKV (one launch), v2 rows = 2 / 4 sequences per
  attention unit, v3 with the reciprocal-multiply softmax;
- ``--ablate``: the block with the softmax, the attention or the LayerNorm
  switched off (different math, timing only), with the host's microseconds
  per eager call beside each (what one launch per block saves);
- ``--headbatch``: the attention phase one unit per (sequence, query tile),
  walking all heads;
- ``--int8attn``: the W8A8 block with a static activation scale calibrated
  on the measured batch, int8 p.v and int8 q.k^T, each with its deviation
  from the bf16 block (relative L2);
- ``--phases``: each phase's device time inside the one launch (LN, the
  QKV product, the int8 operands, attention, the quantised attention
  output, the out-projection) of v1 (bf16 and W8A8) and of the four int8
  lever sets, from ``%globaltimer`` stamps at the grid barriers
  (``sa_variants.phase_stamps``), beside the unstamped graph-replay ms;
- ``--check``: each variant's largest difference from the shipped block and
  from its own plain version instead of times.

``--batch`` replaces the JAX script's B 40 (the SA blocks' B 8, say).  It
measures the ``mixermdm_tpu_torch`` that Python imports first, so one copy
of the script reads two trees: ``PYTHONPATH=<tree> python <this file>``.

Times are CUDA events over CUDA-graph replays on the card; every line gives
ms, TFLOP/s (the JAX cost estimate's 2 B Tp E (4E + 2 Tp) operations on
the padded length, ``scripts/exp_kernels.py:214``) and the share of the
H100's bound for the work the block needs on its T rows (:func:`bound`):
the larger of the bytes (inputs read once, the output written once) over
3.35 TB/s and the operations over the tensor cores' peak for their type
(989 TFLOP/s bf16, 1979 TOP/s int8).  ``--device cpu`` runs the
plain versions on the CPU (small shapes, for the tests): it prints
differences and deviations, and no times.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from mixermdm_tpu_torch import ops
from mixermdm_tpu_torch.ops import sa_variants as sv

H100_BF16_FLOPS = 989e12
H100_INT8_OPS = 1979e12
H100_BYTES_PER_S = 3.35e12
SHAPE = dict(B=40, T=299, E=1024, H=8)  # exp_kernels.py:252


@dataclasses.dataclass
class Inputs:
    """The JAX script's inputs (``exp_kernels.py:251-260``) on ``device``:
    x, scale, shift in bf16, the four (E, E) input-major weights and (E,)
    biases in f32 (numpy), a key mask with nothing masked."""
    x: torch.Tensor
    scale: torch.Tensor
    shift: torch.Tensor
    ws: list
    bs: list
    kpm: torch.Tensor
    H: int

    @property
    def wb(self) -> tuple:
        return sum(zip(self.ws, self.bs), ())


def make_inputs(B: int = 40, T: int = 299, E: int = 1024, H: int = 8, *, device="cuda",
                dtype=torch.bfloat16, seed: int = 0) -> Inputs:
    rng = np.random.default_rng(seed)
    act = lambda shape: torch.tensor(rng.standard_normal(shape) * 0.05,  # noqa: E731
                                     dtype=torch.float32).to(device=device, dtype=dtype)
    x, sc, sh = act((B, T, E)), act((B, E)), act((B, E))
    ws = [(rng.standard_normal((E, E)) * 0.02).astype(np.float32) for _ in range(4)]
    bs = [(rng.standard_normal(E) * 0.02).astype(np.float32) for _ in range(4)]
    return Inputs(x, sc, sh, ws, bs, torch.zeros(B, T, dtype=torch.bool, device=device), H)


def shipped_block(inp: Inputs, quant: bool) -> Callable[[], torch.Tensor]:
    """The port's shipped composition on the same weights (torch layout, the
    biases in the compute dtype as the shipped blocks take them)."""
    w = sv.sa_weights_from_jax(*inp.wb, quant=quant, dtype=inp.x.dtype)
    dev, cd = inp.x.device, inp.x.dtype
    b_qkv, b_o = w.b_qkv.to(dev, cd), w.b_o.to(dev, cd)
    kw = dict(n_heads=inp.H, residual=True)
    if quant:
        args = (w.w8_qkv.to(dev), w.s_qkv.to(dev), b_qkv, w.w8_o.to(dev), w.s_o.to(dev), b_o)
        return lambda: ops.fused_sa_block_q8(inp.x, inp.scale, inp.shift, *args, inp.kpm, **kw)
    args = (w.w_qkv.to(dev), b_qkv, w.w_o.to(dev), b_o)
    return lambda: ops.fused_sa_block(inp.x, inp.scale, inp.shift, *args, inp.kpm, **kw)


def weights(inp: Inputs) -> sv.SAWeights:
    return sv.sa_weights_from_jax(*inp.wb, quant=True, dtype=inp.x.dtype).to(inp.x.device)


def cost_flops(B: int, T: int, E: int) -> int:
    """The JAX kernels' cost estimate (``exp_kernels.py:214``)."""
    Tp = sv.padded_len(T)
    return 2 * B * Tp * E * (4 * E + 2 * Tp)


def bound(B: int, T: int, E: int, *, quant: bool, qqk: bool = False, qpv: bool = False,
          skip_attn: bool = False, keys: Optional[int] = None) -> tuple[float, str]:
    """The least time an H100 could take, in ms, and what bounds it
    ("operations" or "bytes"), for the work the block needs on its T rows
    (the padded rows are thrown away or masked): the projections'
    8 B T E^2 operations at the int8 (``quant``) or bf16 peak, and the
    attention's 4 T E operations per (query, unmasked key) pair, half q.k^T
    and half p.v, each at the int8 peak where it is int8 (none with
    ``skip_attn``); ``keys`` is the number of unmasked keys summed over the
    sequences (B T when nothing is masked).  LayerNorm and the softmax are
    not products, so the ablations that skip them keep the full block's
    bound.  Or, if larger, the bytes of x, scale, shift, the weights and
    biases (and scales) and the key mask read once and the output written
    once."""
    keys = B * T if keys is None else keys
    proj, attn = 8 * B * T * E * E, 0 if skip_attn else 4 * T * keys * E
    t_ops = (proj / (H100_INT8_OPS if quant else H100_BF16_FLOPS)
             + attn / 2 / (H100_INT8_OPS if qqk else H100_BF16_FLOPS)
             + attn / 2 / (H100_INT8_OPS if qpv else H100_BF16_FLOPS))
    w_bytes = 4 * E * E * (1 if quant else 2) + 4 * 4 * E + (4 * 4 * E if quant else 0)
    t_bytes = (2 * B * T * E * 2 + 2 * B * E * 2 + w_bytes + B * T) / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# ---------------------------------------------------------------------------
# Timing (the card only)
# ---------------------------------------------------------------------------

def graph_ms(fn: Callable, reps: int = 10, replays: int = 5) -> float:
    """Device milliseconds per call: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events."""
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
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def host_us(fn: Callable, reps: int = 100) -> float:
    """Host microseconds per eager call, the calls queued back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def _diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / (torch.linalg.norm(b) + 1e-12))


def _line(name: str, ms: Optional[float], flops: int, b_ms: float, extra: str = "") -> str:
    if ms is None:
        return f"{name:20s} not measured (cpu){extra}"
    return (f"{name:20s} {ms:8.4f} ms  {flops / ms / 1e9:6.1f} TF/s  "
            f"({100 * b_ms / ms:5.1f}% of H100 bound {b_ms:.4f} ms){extra}")


def _measure(fn: Callable, inp: Inputs) -> Optional[float]:
    return graph_ms(fn) if inp.x.is_cuda else None


# ---------------------------------------------------------------------------
# The modes
# ---------------------------------------------------------------------------

VARIANTS = (("v1 mergedQKV", 1, False), ("v2 rows=2", 2, False), ("v2 rows=4", 4, False),
            ("v3 rows=2+recip", 2, True), ("v3 rows=4+recip", 4, True))
CHECKS = ((1, False), (2, False), (4, False), (2, True))
ABLATIONS = (("full", {}), ("no-softmax", dict(skip_softmax=True)),
             ("no-attn", dict(skip_attn=True)), ("no-ln", dict(skip_ln=True)),
             ("no-attn,no-ln", dict(skip_attn=True, skip_ln=True)))


def variants_main(quant: bool, check: bool, inp: Inputs) -> list:
    """v0 (shipped) and the merged-QKV variants; with ``check`` their
    differences from v0 and from their plain versions."""
    B, T, E = inp.x.shape
    w, v0 = weights(inp), shipped_block(inp, quant)
    fn = lambda rows, recip: lambda: sv.sa_variant(  # noqa: E731
        inp.x, inp.scale, inp.shift, w, inp.kpm, n_heads=inp.H, rows=rows, recip=recip,
        quant=quant)
    out = []
    if check:
        ref = v0()
        for rows, recip in CHECKS:
            if B % rows:
                continue
            got = fn(rows, recip)()
            with ops.plain_versions():
                plain = fn(rows, recip)()
            r = {"rows": rows, "recip": recip, "vs_shipped": _diff(got, ref),
                 "vs_plain": _diff(got, plain)}
            print(f"rows={rows} recip={recip}: max|diff| = {r['vs_shipped']:.3e} vs shipped, "
                  f"{r['vs_plain']:.3e} vs plain", flush=True)
            out.append(r)
        return out
    flops, b_ms = cost_flops(B, T, E), bound(B, T, E, quant=quant)[0]
    print(f"--- SA variants ({'w8a8' if quant else 'bf16'}; B={B} T={T} E={E}) ---", flush=True)
    runs = [("v0 shipped", v0)] + [(name, fn(rows, recip)) for name, rows, recip in VARIANTS
                                   if B % rows == 0]
    for name, f in runs:
        ms = _measure(f, inp)
        print(_line(name, ms, flops, b_ms), flush=True)
        out.append({"name": name, "ms": ms, "bound_ms": b_ms})
    return out


def ablate_main(quant: bool, inp: Inputs) -> list:
    """The block with pieces switched off, each with host us per eager call."""
    B, T, E = inp.x.shape
    w = weights(inp)
    flops = cost_flops(B, T, E)
    print(f"--- SA ablation ({'w8a8' if quant else 'bf16'}; B={B} T={T} E={E}) ---", flush=True)
    out = []
    runs = [("v0 shipped", shipped_block(inp, quant), {})] + [
        (name, lambda sk=sk: sv.sa_ablate(inp.x, inp.scale, inp.shift, w, n_heads=inp.H,
                                          quant=quant, **sk), sk) for name, sk in ABLATIONS]
    for name, f, sk in runs:
        b_ms = bound(B, T, E, quant=quant, skip_attn=sk.get("skip_attn", False))[0]
        ms = _measure(f, inp)
        us = host_us(f) if inp.x.is_cuda else None
        extra = "" if us is None else f"  host {us:7.1f} us/eager call"
        print(_line(name, ms, flops, b_ms, extra), flush=True)
        out.append({"name": name, "ms": ms, "host_us": us, "bound_ms": b_ms})
    return out


def headbatch_main(quant: bool, check: bool, inp: Inputs) -> list:
    B, T, E = inp.x.shape
    w, v0 = weights(inp), shipped_block(inp, quant)
    hb = lambda: sv.sa_headbatch(inp.x, inp.scale, inp.shift, w,  # noqa: E731
                                 n_heads=inp.H, quant=quant)
    if check:
        got, ref = hb(), v0()
        with ops.plain_versions():
            plain = hb()
        r = {"vs_shipped": _diff(got, ref), "vs_plain": _diff(got, plain)}
        print(f"headbatch: max|diff| = {r['vs_shipped']:.3e} vs shipped, "
              f"{r['vs_plain']:.3e} vs plain", flush=True)
        return [r]
    flops, b_ms = cost_flops(B, T, E), bound(B, T, E, quant=quant)[0]
    print(f"--- head-batched attention ({'w8a8' if quant else 'bf16'}; B={B} T={T} E={E}) ---",
          flush=True)
    out = []
    for name, f in (("v0 head-loop", v0), ("head-batched", hb)):
        ms = _measure(f, inp)
        print(_line(name, ms, flops, b_ms), flush=True)
        out.append({"name": name, "ms": ms, "bound_ms": b_ms})
    return out


def static_scale(inp: Inputs, eps: float = 1e-6) -> float:
    """The activation scale calibrated on the measured batch
    (``exp_kernels.py:830-835``): max |LN(x) (1 + scale) + shift| / 127 in
    f32 over the unpadded rows."""
    xf = inp.x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps)
    xn = xn * (1.0 + inp.scale.float()[:, None]) + inp.shift.float()[:, None]
    return float(xn.abs().max()) / 127.0


LEVERS = (("static act scale", "static"), ("int8 p@v", "qpv"), ("int8 q@k + p@v", "qpv+qqk"),
          ("static + int8 attn", "static+qpv+qqk"))


def lever_kwargs(levers: str, static_as: float) -> dict:
    parts = levers.split("+")
    kw = dict(qpv="qpv" in parts, qqk="qqk" in parts)
    if "static" in parts:
        kw["static_as"] = static_as
    return kw


def int8attn_main(inp: Inputs) -> list:
    """The shipped W8A8 block and the four lever sets: ms, share of the int8
    bound, deviation from the bf16 block (rel-L2)."""
    B, T, E = inp.x.shape
    w = weights(inp)
    sa = static_scale(inp)
    ref_bf16, q8 = shipped_block(inp, False)(), shipped_block(inp, True)
    flops = cost_flops(B, T, E)
    print(f"--- int8 levers (B={B} T={T} E={E}; dev = rel-L2 vs bf16; static scale "
          f"{sa:.6g}; shipped w8a8 dev = {rel_l2(q8(), ref_bf16):.4f}) ---", flush=True)
    out = []
    runs = [("shipped w8a8", q8, {})]
    for name, levers in LEVERS:
        kw = lever_kwargs(levers, sa)
        runs.append((name, lambda kw=kw: sv.sa_int8x(inp.x, inp.scale, inp.shift, w, inp.kpm,
                                                     n_heads=inp.H, **kw), kw))
    for name, f, kw in runs:
        b_ms = bound(B, T, E, quant=True, qqk=kw.get("qqk", False), qpv=kw.get("qpv", False))[0]
        dev = rel_l2(f(), ref_bf16)
        ms = _measure(f, inp)
        print(_line(name, ms, flops, b_ms, f"  dev={dev:.4f}"), flush=True)
        out.append({"name": name, "ms": ms, "bound_ms": b_ms, "dev": dev})
    return out


def phases_main(inp: Inputs, reps: int = 10) -> list:
    """v1 rows 1 (bf16, W8A8) and the four lever sets: the median ns of
    each phase over ``reps`` stamped launches (block 0's ``%globaltimer``
    at the start and after each grid barrier, the latest block's end) and
    the graph-replay ms of the same call without stamps."""
    B, T, E = inp.x.shape
    w = weights(inp)
    args = (inp.x, inp.scale, inp.shift, w, inp.kpm)
    sa = static_scale(inp)
    runs = [(f"v1 {'w8a8' if q else 'bf16'}",
             lambda q=q: sv.sa_variant(*args, n_heads=inp.H, quant=q)) for q in (False, True)]
    runs += [(name, lambda kw=lever_kwargs(levers, sa): sv.sa_int8x(*args, n_heads=inp.H, **kw))
             for name, levers in LEVERS]
    print(f"--- phases, us (B={B} T={T} E={E}) ---", flush=True)
    out = []
    for name, f in runs:
        phases, ms = None, _measure(f, inp)
        if ms is not None:
            with sv.phase_stamps() as log:
                for _ in range(reps):
                    f()
            torch.cuda.synchronize()
            per = [sv.phase_ns(e) for e in log]
            phases = {k: statistics.median(r[k] for r in per) for k in per[0]}
        text = "not measured (cpu)" if ms is None else (
            " / ".join(f"{k} {v / 1e3:.1f}" for k, v in phases.items())
            + f" = {sum(phases.values()) / 1e3:.1f}; graph {ms:.4f} ms")
        print(f"{name:20s} {text}", flush=True)
        out.append({"name": name, "phase_ns": phases, "ms": ms})
    return out


def run(argv=None) -> Optional[list]:
    """Parse the flags, run the mode and return its records (None, with a
    message, where the card is asked for and there is none)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quant", action="store_true", help="W8A8 (int8 weights and products)")
    ap.add_argument("--check", action="store_true",
                    help="differences from the shipped block and the plain versions")
    ap.add_argument("--ablate", action="store_true", help="time the block with pieces disabled")
    ap.add_argument("--headbatch", action="store_true",
                    help="attention units walking all heads vs the shipped block")
    ap.add_argument("--int8attn", action="store_true",
                    help="static activation scale + int8 attention products")
    ap.add_argument("--phases", action="store_true",
                    help="device time of each phase inside the one launch")
    ap.add_argument("--batch", type=int, default=SHAPE["B"], help="sequences (B)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("exp_kernels: no CUDA device visible (--device cpu runs the plain versions)",
              file=sys.stderr)
        return None
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
            else torch.cuda.get_device_name(0)
        print(f"device: {card}", flush=True)
    inp = make_inputs(**{**SHAPE, "B": args.batch}, device=args.device,
                      dtype=torch.bfloat16 if args.device == "cuda" else torch.float32)
    if args.phases:
        return phases_main(inp)
    if args.ablate:
        return ablate_main(args.quant, inp)
    if args.headbatch:
        return headbatch_main(args.quant, args.check, inp)
    if args.int8attn:
        return int8attn_main(inp)
    return variants_main(args.quant, args.check, inp)


def main(argv=None) -> int:
    return 2 if run(argv) is None else 0


if __name__ == "__main__":
    sys.exit(main())
