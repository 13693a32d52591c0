"""Multi-rank sampling on one card: each parallel layout of the full-width
system against one rank.

Two parts, each also a phase of ``chip_smoke.py`` (phase 7):

- :func:`world_of_one`: an NCCL world of one rank; ``infer-mixermdm``'s
  data-parallel path (the sample call with a mesh, its rows gathered over
  NCCL) against the same call without one, bitwise.
- :func:`layouts_rank`, on two ranks that share ``cuda:0`` through ``gloo``
  (:func:`..parallel.launch` with both devices named ``cuda:0``): the
  shipped architecture at full width, random weights from ``seed`` (the
  zero-init layers drawn from N(0, 0.02)), B 2, T 299, the DDIM chain cut
  to ``steps`` steps:

  * data parallelism (W8A8), the chain row for row against one rank;
  * ``--pp 2`` (W8A8): one CFG mixer step against one rank, the in2IN
    stacks at 4 layers a stage, 2 microbatches;
  * ``--tp 2`` (bf16): one CFG mixer step against one rank, the kernels at
    H 4, QKV N 3E/2, out-projection K E/2, FFN N and K F/2;
  * ``--tp 2 --sp`` at T 298 (2 divides it);
  * ``serve`` with data parallelism answering 2 seeded requests;
  * the ``infer-mixermdm`` CLI entered by both ranks.

  Each layout's step is held to one rank's within ``RATIO`` times that
  step's kernels-vs-plain gap (rel(fro)); data parallelism and the server
  row for row within the W8A8 step's.  Prints the launch shapes of each
  layout (``ops._lib.launch_shapes``), each collective's transport and each
  layout's seconds per step.  Two ranks through ``gloo`` on one card give
  no multi-card speed: their step times say what the path costs here, not
  what N cards would do.

Run alone on a card (builds the kernels first)::

    python -m mixermdm_tpu_torch.scripts.parallel_layouts [--seed 0] [--steps 10]
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import functools
import io
import json
import os
import sys
import tempfile
import threading
import time
import urllib.request

WINDOW = 299
SP_WINDOW = 298
RATIO = 1.5
PROMPTS = [
    ("two people shake hands and then hug", "a person reaches out and hugs",
     "a person raises an arm and hugs"),
    ("one person pushes the other who stumbles back",
     "a person pushes forward with both hands", "a person stumbles backwards"),
]
# The kernels whose launch shapes a layout's line prints.
SHAPE_KERNELS = ("attention", "attention_q8", "linear_epilogue", "linear_q8",
                 "linear_q8_gelu_q8", "adaln_modulate", "adaln_modulate_q8")


class LayoutFailure(RuntimeError):
    pass


def batch_of(n: int = 2) -> dict:
    rows = [PROMPTS[i % len(PROMPTS)] for i in range(n)]
    return {"text_interaction": [p[0] for p in rows], "text_individual1": [p[1] for p in rows],
            "text_individual2": [p[2] for p in rows]}


def gaps(a, b) -> dict:
    """rel(max) and rel(fro) of ``a`` to ``b``."""
    a, b = a.float(), b.float()
    return {"rel_max": (a - b).abs().max().item() / max(b.abs().max().item(), 1e-6),
            "rel_fro": ((a - b).norm() / b.norm().clamp_min(1e-6)).item()}


def hold(name: str, got: dict, limit: float, say=print) -> dict:
    ok = got["rel_fro"] <= limit
    say(f"   {name}: rel(max) {got['rel_max']:.4g}, rel(fro) {got['rel_fro']:.4g}, "
          f"held on rel(fro) <= {limit:.4g}: {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise LayoutFailure(f"{name}: disagrees with one rank")
    return dict(got, limit=limit)


def shapes_of(counter) -> list:
    """The launch shapes of :data:`SHAPE_KERNELS`, most launched first."""
    return [[*k, n] for k, n in counter.most_common() if k[0] in SHAPE_KERNELS]


def _timed(fn, steps: int):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / steps


def _build(device, seed: int, steps: int):
    from ..cli.infer_mixermdm import build_system
    from ..systems import apply_sampler_overrides

    system = build_system(None, device=device, seed=seed, zero_init_std=0.02)
    return apply_sampler_overrides(system, None, steps)


def world_of_one(seed: int = 0, steps: int = 10, store_dir=None) -> dict:
    """Part (a): an NCCL world of one rank on ``cuda:0``."""
    import torch
    import torch.distributed as dist

    from ..parallel import make_mesh
    from ..parallel.mesh import INIT_TIMEOUT, destroy

    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1, timeout=INIT_TIMEOUT)
        try:
            system = _build("cuda:0", seed, steps)
            cond = system.generate_cond(batch_of())
            gen = lambda: torch.Generator(device="cuda:0").manual_seed(seed)  # noqa: E731
            one, (i1, i2) = system.sample(cond, WINDOW, generator=gen(), collect_influence=True)
            via, (j1, j2) = system.sample(cond, WINDOW, generator=gen(), collect_influence=True,
                                          mesh=make_mesh())
            same = all(torch.equal(a, b) for a, b in ((one, via), (i1, j1), (i2, j2)))
        finally:
            destroy()
    print(f"   (a) NCCL world of 1: the data-parallel sample path against the plain call: "
          f"{'bitwise equal' if same else 'DIFFERENT'}", flush=True)
    if not same:
        raise LayoutFailure("(a) the world of one rank changed the samples")
    return {"bitwise_equal": same, "shape": list(one.shape)}


def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def layouts_rank(rank: int, seed: int = 0, steps: int = 10, out_dir: str = ".") -> dict:
    """Part (b), one rank of two on one card (see the module's text);
    returns rank 0's report."""
    import numpy as np
    import torch

    from .. import ops, parallel as par
    from ..cli import infer_mixermdm, serve
    from ..models import layers
    from ..ops import _lib
    from ..parallel import comm

    dev = par.rank_device("cuda")
    report = {}
    say = print if rank == 0 else (lambda *a, **k: None)
    system = _build(dev, seed, steps)
    torch.manual_seed(seed)
    cond = system.generate_cond(batch_of())
    gen = lambda s=seed: torch.Generator(device=dev).manual_seed(s)  # noqa: E731
    x = torch.randn((2, WINDOW, 2 * system.nfeats), generator=gen(), device=dev)
    x2 = torch.randn((2, WINDOW, 2 * system.nfeats), generator=gen(seed + 1), device=dev)
    t = torch.tensor([980, 420], device=dev)

    @contextlib.contextmanager
    def quant(on: bool):
        prev, system.quant_frozen = system.quant_frozen, on
        try:
            yield
        finally:
            system.quant_frozen = prev

    def step(T=WINDOW, plain=False):
        with ops.plain_versions() if plain else contextlib.nullcontext():
            return system.cfg_mixer_step(x[:, :T], x2[:, :T], t, cond, None)

    launches = {}

    def counted(layout, fn):
        """``fn()`` with the launch counts set to 0 just before; the layout's
        launches by kernel kept, its launch shapes returned."""
        _lib.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launches[layout] = dict(_lib.launches)
        return out, shapes_of(_lib.launch_shapes)

    def held(name, got, gap):
        return hold(name, got, RATIO * gap, say)

    # One rank's references, every layout's inputs, before any sharding.
    ref_q8, plain_q8 = step(), step(plain=True)
    with quant(False):
        ref_bf = {T: step(T) for T in (WINDOW, SP_WINDOW)}
        gap_bf = {T: gaps(ref_bf[T], step(T, plain=True))["rel_fro"] for T in ref_bf}
    gap_q8 = gaps(ref_q8, plain_q8)["rel_fro"]
    one, s_one = _timed(lambda: system.sample(cond, WINDOW, generator=gen()), steps)
    say(f"   one rank: W8A8 step kernels vs plain rel(fro) {gap_q8:.4g}; bf16 "
        f"{gap_bf[WINDOW]:.4g} (T {WINDOW}), {gap_bf[SP_WINDOW]:.4g} (T {SP_WINDOW}); "
        f"{s_one:.4f} s a step (B 2, W8A8)", flush=True)
    report["one rank"] = {"s_per_step": s_one, "gap_q8": gap_q8, "gap_bf16": gap_bf}

    # Data parallelism (W8A8), row for row.
    data = par.make_mesh(2)
    (dp, s_dp), shapes = counted("data parallelism 2", lambda: _timed(
        lambda: system.sample(cond, WINDOW, generator=gen(), mesh=data), steps))
    rows = [gaps(dp[i], one[i]) for i in range(2)]
    worst = max(rows, key=lambda g: g["rel_fro"])
    report["data parallelism"] = dict(held("data parallelism 2 (W8A8), chain rows vs one rank",
                                           worst, gap_q8),
                                      s_per_step=s_dp, launch_shapes=shapes[:8])

    # Pipeline (W8A8): the in2IN stacks, 4 layers a stage.
    pipe = par.make_mesh(2, axis="pipe")
    with par.pipeline_scope(pipe):
        pp, shapes = counted("pp 2", step)
        _, s_pp = _timed(lambda: system.sample(cond, WINDOW, generator=gen()), steps)
    report["pp 2"] = dict(held("pp 2 (W8A8), one CFG step vs one rank", gaps(pp, ref_q8),
                               gap_q8), s_per_step=s_pp, launch_shapes=shapes[:8])

    # Tensor parallelism (bf16: W8A8 goes off), then with sequence parallelism.
    tp_mesh = par.make_mesh_2d(1, 2)
    par.tp_shard_params(system, tp_mesh)
    tp, shapes = counted("tp 2", step)
    _, s_tp = _timed(lambda: system.sample(cond, WINDOW, generator=gen()), steps)
    report["tp 2"] = dict(held("tp 2 (bf16), one CFG step vs one rank", gaps(tp, ref_bf[WINDOW]),
                               gap_bf[WINDOW]), s_per_step=s_tp, launch_shapes=shapes)
    keys = {tuple(s[:-1]) for s in shapes}
    at_shards = (any(k[0] == "attention" and k[2] == 4 for k in keys)
                 and any(k[0] == "linear_epilogue" and k[3] == 1536 for k in keys)
                 and any(k[0] == "linear_epilogue" and k[2] == 512 for k in keys))
    if not at_shards:
        raise LayoutFailure("tp 2: no attention at H 4, or no linear_epilogue at N 1536 / K 512")
    layers.set_sequence_parallel(tp_mesh)
    try:
        sp, shapes = counted("tp 2 + sp", lambda: step(SP_WINDOW))
        _, s_sp = _timed(lambda: system.sample(cond, SP_WINDOW, generator=gen()), steps)
    finally:
        layers.set_sequence_parallel(None)
        layers.set_tensor_parallel(False)
    report["tp 2 + sp"] = dict(held(f"tp 2 + sp (bf16, T {SP_WINDOW}), one CFG step vs one rank",
                                    gaps(sp, ref_bf[SP_WINDOW]), gap_bf[SP_WINDOW]),
                               s_per_step=s_sp, launch_shapes=shapes)
    del system
    torch.cuda.empty_cache()

    # serve with data parallelism: rank 0 serves and asks twice; its system
    # and the CLI's draw their zero-init layers too.
    infer_mixermdm.build_system = functools.partial(infer_mixermdm.build_system,
                                                    zero_init_std=0.02)
    argv = ["--port", "0", "--batch-size", "2", "--window", str(WINDOW), "--sample-steps",
            str(steps), "--seed", str(seed), "--device", str(dev)]
    server, batcher, state = serve.make_server(argv)
    if server is None:
        serve.serve_rank(state)
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
        url = "http://127.0.0.1:%d/generate" % server.server_address[1]
        replies = []
        try:
            for s in (1, 2):
                t0 = time.perf_counter()
                r = _post(url, {"text_interaction": PROMPTS[0][0],
                                "text_individual1": PROMPTS[0][1],
                                "text_individual2": PROMPTS[0][2], "seed": s})
                replies.append((r, time.perf_counter() - t0))
        finally:
            server.shutdown()
            serve.stop(server, batcher, state)
        srv = state["system"]
        one_batch = {k: [v[0]] * 2 for k, v in batch_of(1).items()}
        worst, seconds = None, []
        for (r, sec), s in zip(replies, (1, 2)):
            got = torch.from_numpy(np.load(io.BytesIO(base64.b64decode(r["motion_npy_b64"]))))
            with torch.inference_mode():
                want = srv.sample(srv.generate_cond(one_batch), WINDOW, generator=gen(s))[:1]
            g = gaps(got.to(dev), want.float())
            worst = g if worst is None or g["rel_fro"] > worst["rel_fro"] else worst
            seconds.append(sec)
        report["serve"] = dict(held("serve, data parallelism 2: 2 requests vs one rank", worst,
                                    gap_q8), s_per_request=seconds)

    # infer-mixermdm, entered by both ranks.
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        infer_mixermdm.main(["--name", "p7", "--num-samples", "2", "--sample-steps", str(steps),
                             "--seed", str(seed), "--out-dir", out_dir,
                             "--text-interaction", PROMPTS[0][0],
                             "--text-individual1", PROMPTS[0][1],
                             "--text-individual2", PROMPTS[0][2]])
    if rank == 0:
        motion = np.load(os.path.join(out_dir, "p7_motion.npy"))
        line = [ln for ln in log.getvalue().splitlines() if ln.startswith("sampled")]
        ok = motion.shape == (2, WINDOW, 524) and np.isfinite(motion).all() and line \
            and "data 2 of 2 ranks" in line[0]
        print(f"   infer-mixermdm on 2 ranks: {line[0] if line else 'no line'}; "
              f"{motion.shape}: {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise LayoutFailure("infer-mixermdm on 2 ranks")
        report["infer-mixermdm"] = line[0]
    report["transports"] = [list(k) + [n] for k, n in sorted(comm.transports.items())]
    report["launches"] = launches
    return report if rank == 0 else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args(argv)

    import torch

    from ..ops import _lib
    from ..parallel import launch

    if not torch.cuda.is_available():
        print("parallel_layouts: needs a card", file=sys.stderr)
        return 2
    _lib.build()
    t0 = time.time()
    report = {"(a)": world_of_one(args.seed, args.steps)}
    with tempfile.TemporaryDirectory() as tmp:
        report["(b)"] = launch(layouts_rank, 2, backend="gloo", devices=["cuda:0", "cuda:0"],
                               args=(args.seed, args.steps, tmp), timeout_s=600)[0]
    report["seconds"] = time.time() - t0
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
