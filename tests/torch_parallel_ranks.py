"""What the ranks of the port's multi-rank CPU tests run (spawned by
``mixermdm_tpu_torch.parallel.launch``).  This module imports neither JAX
nor the JAX package, so a rank starts with torch alone; the tests hold what
rank 0 returns against the JAX package on one device.

Sizes are those of ``tests/test_golden.py`` (2 layers, 4 heads, width 64);
the system is the one ``tests/test_torch_port_models.py:port_tiny_system``
builds, its weights handed over as a state dict file.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

L, FF, NL, NH, TD, F = 64, 128, 2, 4, 768, 262
B, T = 2, 8
N_STEPS = 20
CHAIN_STEPS = 4


def mixer_cfg_dict():
    gen = {"NUM_LAYERS": NL, "NUM_HEADS": NH, "DROPOUT": 0.0, "INPUT_DIM": F,
           "LATENT_DIM": L, "FF_SIZE": FF}
    return {"NAME": "MixerMDM", "GENERATOR": gen, "DISCRIMINATOR": dict(gen),
            "ACTIVATION": "gelu", "DIFFUSION_STEPS": N_STEPS, "BETA_SCHEDULER": "cosine",
            "SAMPLER": "uniform", "MOTION_REP": "global", "T_BAR": 10, "STRATEGY": "ddim5",
            "CFG_WEIGHT": 3.5, "MIXING_MODE": 4, "FORCE_INFLUENCE_VAL": None,
            "QUANT_FROZEN": False}


def normalizer_stats(seed=11):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(F).astype(np.float32) * 0.1,
             (0.5 + rng.random(F)).astype(np.float32)) for _ in range(2)]


def port_system(state_path=None):
    """The tiny MixerMDM system on the CPU (f32), the chain respaced to
    :data:`CHAIN_STEPS` steps, with the weights of ``state_path``."""
    from mixermdm_tpu_torch.config import Config, tiny_config
    from mixermdm_tpu_torch.models.clip_text import ClipTextConfig
    from mixermdm_tpu_torch.systems import apply_sampler_overrides
    from mixermdm_tpu_torch.systems.in2in import In2INSystem
    from mixermdm_tpu_torch.systems.mixermdm import MixerMDMSystem
    from mixermdm_tpu_torch.utils.normalizer import Normalizer

    clip = ClipTextConfig.tiny()
    c = tiny_config(latent=L, layers=NL, heads=NH, diffusion_steps=N_STEPS)
    (m1, s1), (m2, s2) = normalizer_stats()
    system = MixerMDMSystem(
        Config.wrap(mixer_cfg_dict()),
        model1=In2INSystem(c, mode="individual", clip_cfg=clip, device="cpu"),
        model2=In2INSystem(c, mode="interaction", clip_cfg=clip, device="cpu"), clip_cfg=clip,
        normalizer1=Normalizer(torch.from_numpy(m1), torch.from_numpy(s1)),
        normalizer2=Normalizer(torch.from_numpy(m2), torch.from_numpy(s2)), device="cpu")
    if state_path is not None:
        system.load_state_dict(torch.load(state_path))
    return apply_sampler_overrides(system, None, CHAIN_STEPS)


def texts():
    return {"text_interaction": ["two people shake hands", "one pushes the other"],
            "text_individual1": ["a person reaches out", "a person pushes"],
            "text_individual2": ["a person takes the hand", "a person stumbles back"]}


def _step(system, inp):
    return system.cfg_mixer_step(inp["x"], inp["x2"], inp["t"], inp["cond"], inp["mask"])


def _chain(system, inp, **kw):
    out, (i1, i2) = system.sample(inp["cond"], T, noise=inp["noise"], collect_influence=True,
                                  **kw)
    return torch.cat([out.reshape(-1), i1.reshape(-1), i2.reshape(-1)])


def layouts(rank: int, state_path: str, inputs_path: str) -> dict:
    """Every layout on 2 ranks, each against the single-rank port on the
    same inputs, in order: PP 2 (interaction stack pair-major, 2
    microbatches), data parallelism 2, then the weights sharded for TP 2
    and TP 2 + SP (T 8 divides by 2).  Rank 0 returns the outputs; rank 1
    its own TP step (which must equal rank 0's: the outputs are
    replicated), its weight shards and whether it imported no JAX."""
    from mixermdm_tpu_torch import parallel as par
    from mixermdm_tpu_torch.models import layers
    from mixermdm_tpu_torch.parallel import comm

    system = port_system(state_path)
    inp = torch.load(inputs_path)
    out = {}
    with torch.inference_mode():
        out["single_step"] = _step(system, inp)
        out["single_chain"] = _chain(system, inp)
        out["single_cond"] = system.generate_cond(texts())
        g = torch.Generator().manual_seed(7)
        out["single_gen"] = system.sample(inp["cond"], T, generator=g)

        pipe = par.make_mesh(2, axis="pipe")
        with par.pipeline_scope(pipe, n_microbatches=2):
            out["pp_step"] = _step(system, inp)
            out["pp_chain"] = _chain(system, inp)

        data = par.make_mesh(2)
        out["dp_chain"] = _chain(system, inp, mesh=data)
        g = torch.Generator().manual_seed(7)
        out["dp_gen"] = system.sample(inp["cond"], T, generator=g, mesh=data)
        # three rows over two ranks: padded with the last row, pad dropped
        g = torch.Generator().manual_seed(7)
        cond3 = torch.cat([inp["cond"], inp["cond"][:1]])
        out["single_gen3"] = system.sample(cond3, T, generator=g)
        g = torch.Generator().manual_seed(7)
        out["dp_gen3"] = system.sample(cond3, T, generator=g, mesh=data)

        tp = par.make_mesh_2d(1, 2)
        par.tp_shard_params(system, tp)
        block = system.model2.denoisers["interaction"].blocks[0]
        out["tp_heads"] = block.sa_block.attention.local_heads
        out["shards"] = {
            "sa.in_proj_weight": block.sa_block.attention.in_proj_weight,
            "sa.out_proj.weight": block.sa_block.attention.out_proj.weight,
            "sa.out_proj.bias": block.sa_block.attention.out_proj.bias,
            "ffn.linear1.weight": block.ffn.linear1.weight,
            "ffn.linear1.bias": block.ffn.linear1.bias,
            "ffn.linear2.weight": block.ffn.linear2.weight}
        out["tp_cond"] = system.generate_cond(texts())
        out["tp_step"] = _step(system, inp)
        out["tp_chain"] = _chain(system, inp)
        layers.set_sequence_parallel(tp)
        try:
            before = dict(comm.transports)
            out["sp_step"] = _step(system, inp)
            out["sp_chain"] = _chain(system, inp)
            moved = {k[0]: v - before.get(k, 0) for k, v in comm.transports.items()}
            out["sp_gathers"] = moved.get("all_gather", 0)
            out["sp_scatters"] = moved.get("reduce_scatter", 0)
        finally:
            layers.set_sequence_parallel(None)
            layers.set_tensor_parallel(False)
    out["transports"] = sorted(comm.transports)
    out["jax_free"] = not any(k.split(".")[0] in ("jax", "flax", "mixermdm_tpu")
                              for k in sys.modules)
    if rank == 0:
        return out
    return {k: out[k] for k in ("tp_step", "shards", "jax_free")}


def _post(url: str, body: dict) -> dict:
    import json
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def nonzero_outputs() -> None:
    """The CLIs' systems with their zero-init layers drawn from N(0, 0.02)
    (``weights.init_params_(zero_init_std=...)``), so that the denoisers do
    not output zeros and the rows compared say something."""
    import functools

    from mixermdm_tpu_torch.cli import infer_in2in, infer_mixermdm

    for mod in (infer_mixermdm, infer_in2in):
        if not isinstance(mod.build_system, functools.partial):
            mod.build_system = functools.partial(mod.build_system, zero_init_std=0.02)


def cli_surface(rank: int, out_dir: str) -> dict:
    """The multi-rank CLIs in ``--tiny`` on the CPU, each entered by both
    ranks: infer-mixermdm --tp 2 --sp, --pp 2 and with data parallelism,
    infer-in2in --pp 2, eval-mixermdm and eval-base with data parallelism
    (and eval-base with ``--no-data-parallel``), then serve with data
    parallelism answering two requests (rank 0 runs the server and asks;
    rank 1 follows its dispatches).  Returns this rank's log and report;
    the files lie under ``out_dir``."""
    import contextlib
    import io
    import threading
    import time

    from mixermdm_tpu_torch.cli import eval_base, eval_mixermdm, infer_in2in, infer_mixermdm, \
        serve
    from mixermdm_tpu_torch.models import layers

    infer_mixermdm.render = lambda *a, **k: None  # the video and plot: not this test's
    nonzero_outputs()
    log = io.StringIO()
    prompts = ["--text-interaction", "two people hug", "--text-individual1", "one hugs",
               "--text-individual2", "one hugs"]
    seconds = {}
    with contextlib.redirect_stdout(log):
        for name, extra in (("tp", ["--tp", "2", "--sp"]), ("pp", ["--pp", "2"]),
                            ("dp", [])):
            t0 = time.perf_counter()
            infer_mixermdm.main(["--tiny", "--device", "cpu", "--name", name, "--num-samples",
                                 "2", "--out-dir", out_dir, "--no-smooth"] + prompts + extra)
            layers.set_sequence_parallel(None)
            layers.set_tensor_parallel(False)
            seconds[f"infer-mixermdm {name}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        infer_in2in.main(["--tiny", "--device", "cpu", "--name", "in2in_pp", "--mode",
                          "interaction", "--text", "two people hug", "--num-samples", "2",
                          "--out-dir", out_dir, "--pp", "2"])
        seconds["infer-in2in pp"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        eval_mixermdm.run(["--tiny", "--device", "cpu", "--replications", "1",
                           "--datasets", "interhuman", "--out", out_dir + "/eval.json"])
        seconds["eval-mixermdm"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        eval_base.run(["--tiny", "--device", "cpu", "--mode", "individual", "--replications",
                       "1", "--out", out_dir + "/eval_base.json"])
        seconds["eval-base"] = time.perf_counter() - t0
        print("== eval-base --no-data-parallel ==")
        eval_base.run(["--tiny", "--device", "cpu", "--mode", "individual", "--replications",
                       "1", "--out", out_dir + "/eval_base_1.json", "--no-data-parallel"])
        t0 = time.perf_counter()
        server, batcher, state = serve.make_server(["--tiny", "--device", "cpu", "--port", "0"])
        replies = []
        if server is None:
            state["served"] = serve.serve_rank(state)
        else:
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            url = "http://127.0.0.1:%d/generate" % server.server_address[1]
            try:
                for seed in (3, 4):
                    replies.append(_post(url, {"text_interaction": "two people hug",
                                               "text_individual1": "one hugs",
                                               "text_individual2": "one hugs",
                                               "seed": seed, "format": "json"}))
            finally:
                server.shutdown()
                serve.stop(server, batcher, state)
        seconds["serve"] = time.perf_counter() - t0
    return {"log": log.getvalue(), "seconds": seconds, "batch": state["batch_size"],
            "replies": replies, "served": state.get("served")}
