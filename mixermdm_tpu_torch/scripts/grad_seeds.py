"""Phase 6's gradient check of ``chip_smoke.py`` at several seeds, and what
its gaps are made of.  Run from the repository root on a machine with one
GPU::

    python -m mixermdm_tpu_torch.scripts.grad_seeds --seeds 0,1,2,3,4 [--draws 16] \
        [--quant-train]

Each seed makes the fixture, the training system and the step's inputs that
``python3 chip_smoke.py --seed N`` makes (``chip_smoke._grad_step``), and
reads:

1. phase 6 itself (``chip_smoke.grad_check``): the three gaps of each
   trained subtree's gradient of one G and one D step (kernels vs plain,
   plain vs f32, kernels vs f32), then its gates; a failing seed is
   reported and the next one runs;
2. every kernel call of the two steps (the fused blocks, the dense layers
   and attention forwards outside them, the attention backward), each
   against its plain version on that call's own inputs and against f32
   (the inputs widened);
3. the frozen denoisers' outputs (what the trained parts receive from the
   networks that run the most kernels), kernels vs plain vs f32;
4. ``swap``: the plain steps with those outputs replaced by the kernels'
   ones, the gradient against the plain steps' (the share of the gap that
   the frozen outputs carry);
5. ``flip``: the plain steps with the frozen outputs moved by the measured
   kernels-vs-plain gap under random signs, ``out_p + s * (out_k - out_p)``
   with ``s = +-1`` per element, ``draws`` draws: the gradient's spread
   under a perturbation of exactly the kernels' size, and where the kernel
   and swap readings fall in it;
6. ``round``: the f32 steps with the frozen outputs moved by their own bf16
   rounding under random signs, ``out_f + s * (bf16(out_f) - out_f)``
   (``s = +1`` everywhere, the real round trip, is the first draw): the
   gradient's spread from f32 under one bf16 rounding of those outputs, and
   where plain vs f32 and kernels vs f32 fall in it.

``--quant-train`` reads the same with the frozen denoisers as int8 inside
the loss (``QUANT_TRAIN``): on the kernels and on the plain versions, the
f32 twin without int8, and runs phase 6b (b)'s check
(``chip_smoke.quant_grad_check``) in place of phase 6's.

Prints the readings, one JSON line per seed and the card's name and power
limit; exits 1 if any seed failed phase 6's gates.  The per-call check
replaces the entry points named in ``per_call`` by name while it runs.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
import time

import torch

STEPS = {"generator": ("core", "text.post.mixer"), "discriminator": ("disc_i", "disc_I")}


def rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-6))


def rank(value: float, spread: list) -> float:
    """The share of ``spread`` below ``value``."""
    return sum(v < value for v in spread) / len(spread)


@contextlib.contextmanager
def patched(module, name, make):
    """``module.name`` replaced by ``make(original)`` inside the block."""
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def per_call(system, side) -> dict:
    """Reading 2: every kernel call of a G and a D step, each against its
    plain version on its own inputs and against f32 (the inputs widened, on
    the plain versions): the fused blocks, the dense layers and the attention
    forwards outside them, and the attention backward.  Per kind: the number
    of calls, the largest kernels-vs-plain gap and, over the bf16 calls, the
    largest kernels-vs-f32 over plain-vs-f32 ratio."""
    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.models import clip_text, layers
    from mixermdm_tpu_torch.ops import attention as attn_mod

    calls = []
    first = lambda o: o[0] if isinstance(o, tuple) else o  # noqa: E731
    wide = lambda x: x.float() if torch.is_tensor(x) and x.is_floating_point() else x  # noqa: E731

    def checked(kind):
        def make(orig):
            def wrapped(*a, **k):
                out = orig(*a, **k)
                with ops.plain_versions():
                    p = orig(*a, **k)
                    f = orig(*map(wide, a), **{n: wide(v) for n, v in k.items()})
                o, p, f = first(out), first(p), first(f)
                calls.append((kind, o.dtype, rel(o, p), rel(p, f), rel(o, f)))
                return out
            return wrapped
        return make

    def bwd(orig):
        def wrapped(q, k, v, kpm, g, zero_attn, stats, out, route=None):
            r = orig(q, k, v, kpm, g, zero_attn, stats, out, route)
            with ops.plain_versions():
                p = orig(q, k, v, kpm, g, zero_attn, stats, out, route)
            leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
            with torch.enable_grad():
                f = torch.autograd.grad(
                    attn_mod.fused_attention_plain(*leaves, kpm, None, zero_attn),
                    leaves, g.float())
            for a_, b_, c_ in zip(r, p, f):
                calls.append(("attention_bwd", q.dtype, rel(a_, b_), rel(b_, c_), rel(a_, c_)))
            return r
        return wrapped

    targets = [(layers, "fused_sa_block"), (layers, "fused_ca_block"),
               (layers, "fused_ffn_block"), (layers, "linear"), (clip_text, "linear"),
               (layers, "fused_attention"), (attn_mod, "fused_attention")]
    with contextlib.ExitStack() as stack:
        for module, name in targets:
            stack.enter_context(patched(module, name, checked(name)))
        stack.enter_context(patched(attn_mod, "attention_bwd", bwd))
        for mode in STEPS:
            side(system, mode, False)
    kinds = {}
    for kind, dtype, kp, pf, kf in calls:
        r = kinds.setdefault(kind, {"calls": 0, "max_kernels_vs_plain": 0.0,
                                    "max_witness_ratio_bf16": 0.0})
        r["calls"] += 1
        r["max_kernels_vs_plain"] = max(r["max_kernels_vs_plain"], kp)
        if dtype == torch.bfloat16:
            r["max_witness_ratio_bf16"] = max(r["max_witness_ratio_bf16"], kf / max(pf, 1e-12))
    return kinds


def diagnose(seed, normalizer, batch_np, draws, quant_train=False) -> dict:
    """Readings 2-6 at ``seed``."""
    import chip_smoke

    system, twin, side = chip_smoke._grad_step(seed, normalizer, batch_np, quant_train)
    out = {"per_call": per_call(system, side)}

    def run(sys_, plain, edit):
        with chip_smoke._frozen_outputs(sys_, edit):
            return {m: side(sys_, m, plain)[1] for m in STEPS}

    def capture(store):
        def edit(key, o):
            store[key] = o.detach().float()
        return edit

    ok, op, of = {}, {}, {}
    gk = run(system, False, capture(ok))
    gp = run(system, True, capture(op))
    gf = run(twin, True, capture(of))
    out["frozen_outputs"] = {f"{n}.{i}": {"kernels_vs_plain": rel(ok[(n, i)], op[(n, i)]),
                                          "plain_vs_f32": rel(op[(n, i)], of[(n, i)]),
                                          "kernels_vs_f32": rel(ok[(n, i)], of[(n, i)])}
                             for n, i in op}
    gs = run(system, True, lambda key, o: ok[key].to(o.dtype))

    flips, rounds = collections.defaultdict(list), collections.defaultdict(list)
    for j in range(draws):
        gen = torch.Generator(device=system.device).manual_seed(1000 * seed + j)

        def flip(key, o):
            s = 2.0 * torch.randint(0, 2, o.shape, generator=gen, device=o.device) - 1.0
            return op[key] + s * (ok[key] - op[key])

        def rounding(key, o):
            d = of[key].to(torch.bfloat16).float() - of[key]
            if j == 0:
                return of[key] + d
            s = 2.0 * torch.randint(0, 2, o.shape, generator=gen, device=o.device) - 1.0
            return of[key] + s * d

        gj = run(system, True, flip)
        rj = run(twin, True, rounding)
        for m, keys in STEPS.items():
            for k in keys:
                flips[f"{m}.{k}"].append(rel(gj[m][k], gp[m][k]))
                rounds[f"{m}.{k}"].append(rel(rj[m][k], gf[m][k]))

    out["gradients"] = {}
    for m, keys in STEPS.items():
        for k in keys:
            name = f"{m}.{k}"
            r = {"kernels_vs_plain": rel(gk[m][k], gp[m][k]),
                 "plain_vs_f32": rel(gp[m][k], gf[m][k]),
                 "kernels_vs_f32": rel(gk[m][k], gf[m][k]),
                 "swap_vs_plain": rel(gs[m][k], gp[m][k]),
                 "swap_vs_kernels": rel(gs[m][k], gk[m][k]),
                 "flip": sorted(flips[name]), "round": sorted(rounds[name]),
                 "round_trip": rounds[name][0]}
            r["rank_kernels_in_flip"] = rank(r["kernels_vs_plain"], r["flip"])
            r["rank_swap_in_flip"] = rank(r["swap_vs_plain"], r["flip"])
            r["rank_plain_in_round"] = rank(r["plain_vs_f32"], r["round"])
            r["rank_kernels_in_round"] = rank(r["kernels_vs_f32"], r["round"])
            out["gradients"][name] = r
    del system, twin
    torch.cuda.empty_cache()
    return out


def report(seed, d) -> None:
    for kind, r in d["per_call"].items():
        print(f"   seed {seed} (2): {r['calls']} {kind} calls, each on its own inputs: kernels "
              f"vs plain rel(fro) at most {r['max_kernels_vs_plain']:.3g}; per bf16 call, "
              f"kernels vs f32 over plain vs f32 at most {r['max_witness_ratio_bf16']:.4g}",
              flush=True)
    for key, r in d["frozen_outputs"].items():
        print(f"   seed {seed} (3): frozen denoiser {key} output, rel(fro): kernels vs plain "
              f"{r['kernels_vs_plain']:.4g}, plain vs f32 {r['plain_vs_f32']:.4g}, kernels vs "
              f"f32 {r['kernels_vs_f32']:.4g}", flush=True)
    for name, r in d["gradients"].items():
        med = lambda v: v[len(v) // 2]  # noqa: E731
        print(f"   seed {seed} (4-6): {name} gradient, rel(fro): kernels vs plain "
              f"{r['kernels_vs_plain']:.4g}, swap vs plain {r['swap_vs_plain']:.4g} (vs kernels "
              f"{r['swap_vs_kernels']:.4g}); flip {r['flip'][0]:.4g} / {med(r['flip']):.4g} / "
              f"{r['flip'][-1]:.4g} (min / median / max), kernels at rank "
              f"{r['rank_kernels_in_flip']:.3g}, swap at {r['rank_swap_in_flip']:.3g}; round "
              f"{r['round'][0]:.4g} / {med(r['round']):.4g} / {r['round'][-1]:.4g}, round trip "
              f"{r['round_trip']:.4g}, plain vs f32 {r['plain_vs_f32']:.4g} at rank "
              f"{r['rank_plain_in_round']:.3g}, kernels vs f32 {r['kernels_vs_f32']:.4g} at "
              f"{r['rank_kernels_in_round']:.3g}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", default="0,1,2,3,4")
    parser.add_argument("--draws", type=int, default=16)
    parser.add_argument("--quant-train", action="store_true",
                        help="the frozen denoisers as int8 inside the loss (QUANT_TRAIN)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("grad_seeds: no CUDA device visible; this script needs one GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.data.interhuman import InterHumanDataset
    from mixermdm_tpu_torch.data.loader import collate
    from mixermdm_tpu_torch.ops import _lib

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    _, log = _lib.build()
    print(log, flush=True)
    _lib.library()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references are full f32
    torch.backends.cudnn.allow_tf32 = False
    failed = []
    for seed in (int(v) for v in args.seeds.split(",")):
        t0 = time.time()
        tmp = tempfile.mkdtemp(prefix="grad_seeds_")
        try:
            chip_smoke._fixture(f"{tmp}/data", seed)
            dataset = InterHumanDataset(f"{tmp}/data", mode="train")
            # As phase 6 reads them: the dataset's numpy route.  Read once:
            # each read of the fixture draws its crops anew.
            with ops.plain_versions():
                batch_np = collate([dataset[i] for i in range(chip_smoke.TRAIN_B)])
                normalizer = chip_smoke._fixture_normalizer(dataset)
            try:
                check = chip_smoke.quant_grad_check if args.quant_train else chip_smoke.grad_check
                check(seed, normalizer, batch_np)
            except chip_smoke.SmokeFailure as e:
                failed.append(seed)
                print(f"   seed {seed}: phase 6 FAILS ({e})", flush=True)
            d = diagnose(seed, normalizer, batch_np, args.draws, args.quant_train)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        report(seed, d)
        print(json.dumps({"seed": seed, "quant_train": args.quant_train,
                          "phase6_ok": seed not in failed, **d}), flush=True)
        print(f"   seed {seed}: {time.time() - t0:.1f} s", flush=True)
    print(f"   failed seeds: {failed}")
    print(smi.stdout.strip())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
