"""The port's sampling slice against the JAX package's, on the CPU in f32:
the dual-stream CFG DDIM chain (with injected noise), the whole
MixerMDMSystem.sample, the recorded reference chain, and the port's
environment (no JAX, flax, optax, orbax, yaml or mixermdm_tpu).

Tolerances: 1e-3 absolute and relative for whole chains against JAX — the
chain's per-step Gram-Schmidt of the 6d rotations and heading alignment
amplify float32 rounding differences between the frameworks (the networks
alone agree to 1e-5, the 5-step chain here to ~1e-4); 2e-3 against the
recorded reference, as tests/test_golden.py holds the JAX package on the
same fixture.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import golden
from tests.test_torch_port_models import (
    B, F, FF, L, NH, NL, N_STEPS, T, TD, jax_tiny_system, port_tiny_system, random_params, texts)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN_TOL = dict(atol=1e-3, rtol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny; one intra-op thread per test worker keeps the
    port's tests from oversubscribing the cores the other workers share."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **kw)


@pytest.fixture(scope="module")
def systems():
    from mixermdm_tpu_torch.weights import load_mixermdm_params

    jsys = jax_tiny_system()
    params = random_params(jsys)
    tsys = port_tiny_system()
    load_mixermdm_params(tsys, params)
    return jsys, params, tsys


def test_system_sample_matches_jax(systems):
    """generate_cond + sample(collect_influence=True), the entry points of
    the CLI: the JAX chain's own initial noise is handed to the port."""
    jsys, params, tsys = systems
    batch = texts()
    cond_j = jsys.generate_cond(params, batch)
    cond_t = tsys.generate_cond(batch)
    _close(cond_t, cond_j, atol=1e-4, rtol=1e-4)
    rng = jax.random.PRNGKey(1)
    out_j, (i1_j, i2_j) = jsys.sample(params, cond_j, T, rng, collect_influence=True)
    _, init_rng = jax.random.split(rng)
    noise = np.array(jax.random.normal(init_rng, (B, T, 2 * F), jnp.float32))
    out_t, (i1_t, i2_t) = tsys.sample(cond_t, T, noise=torch.from_numpy(noise),
                                      collect_influence=True)
    assert out_t.shape == (B, T, 2 * F) and i1_t.shape == i1_j.shape
    _close(out_t, out_j, **CHAIN_TOL)
    _close(i1_t, i1_j, **CHAIN_TOL)
    _close(i2_t, i2_j, **CHAIN_TOL)


@pytest.fixture(scope="module")
def golden_chain():
    """The recorded reference stack (golden sizes) as JAX and port mixers."""
    from mixermdm_tpu.diffusion.schedule import get_named_beta_schedule, make_schedule, \
        space_timesteps
    from mixermdm_tpu.models.in2in import In2INDenoiser as JDen
    from mixermdm_tpu.models.mixer import MixerConfig as JCfg, MixerCore as JCore, \
        make_mixer_forward as j_make
    from mixermdm_tpu.utils.normalizer import Normalizer as JNorm
    from mixermdm_tpu_torch.diffusion.schedule import named_schedule
    from mixermdm_tpu_torch.models.in2in import In2INDenoiser
    from mixermdm_tpu_torch.models.mixer import MixerConfig, MixerCore, make_mixer_forward
    from mixermdm_tpu_torch.utils.normalizer import Normalizer
    from mixermdm_tpu_torch.weights import MIXER_RENAMES, export_mixer_core, \
        load_denoiser_params, load_state_dict_np, rename

    stack = golden.load("mixer_stack")
    n = stack["norm"]
    params = stack["mixer"]
    # JAX side, as tests/test_golden.py builds it
    jd1 = JDen(input_feats=F, mode="individual", latent_dim=L, ff_size=FF, num_layers=NL,
               num_heads=NH, dropout=0.0)
    jd2 = JDen(input_feats=F, mode="interaction", latent_dim=L, ff_size=FF, num_layers=NL,
               num_heads=NH, dropout=0.0)
    jcore = JCore(nfeats=F, latent_dim=L, ff_size=FF, n_blocks=NL, n_heads=NH, text_dim=TD,
                  mixing_mode=4, dropout=0.0)
    jn1 = JNorm(jnp.asarray(n["mean1"]), jnp.asarray(n["std1"]))
    jn2 = JNorm(jnp.asarray(n["mean2"]), jnp.asarray(n["std2"]))
    jfwd = j_make(JCfg(nfeats=F, latent_dim=L, ff_size=FF, n_blocks=NL, n_heads=NH,
                       text_dim=TD, mixing_mode=4, align=True),
                  lambda p, x, t, m, c: jd1.apply({"params": p}, x, t, m, c),
                  lambda p, x, t, m, c: jd2.apply({"params": p}, x, t, m, c),
                  lambda p, *a, train=False, rngs=None: jcore.apply({"params": p}, *a),
                  jn1, jn2, compute_dtype=None)
    js = make_schedule(get_named_beta_schedule("cosine", N_STEPS),
                       space_timesteps(N_STEPS, "ddim5"))
    # port side, loaded through weights.py
    d1 = In2INDenoiser(F, "individual", L, FF, NL, NH, TD)
    d2 = In2INDenoiser(F, "interaction", L, FF, NL, NH, TD)
    load_denoiser_params(d1, params["denoiser1"])
    load_denoiser_params(d2, params["denoiser2"])
    core = MixerCore(F, L, FF, NL, NH, TD, 4)
    sd = {}
    export_mixer_core(params["core"], sd)
    load_state_dict_np(core, {k[len("core."):]: v for k, v in rename(sd, MIXER_RENAMES).items()})
    tn1 = Normalizer(torch.from_numpy(n["mean1"]), torch.from_numpy(n["std1"]))
    tn2 = Normalizer(torch.from_numpy(n["mean2"]), torch.from_numpy(n["std2"]))
    tfwd = make_mixer_forward(MixerConfig(nfeats=F, latent_dim=L, ff_size=FF, n_blocks=NL,
                                          n_heads=NH, text_dim=TD), d1, d2, core, tn1, tn2)
    ts = named_schedule("cosine", N_STEPS, "ddim5")
    return (jfwd, params, js, jn1, jn2), (tfwd, ts, tn1, tn2)


def test_ddim_chain_matches_jax_and_reference(golden_chain):
    """ddim_sample_loop_x2 with cfg_model_x2, the recorded noise, mask and
    cond: the port against the JAX chain and against the recorded output of
    the original PyTorch reference."""
    from mixermdm_tpu.diffusion.mixer_diffusion import ddim_sample_loop_x2 as j_loop
    from mixermdm_tpu.models.cfg import cfg_model_x2 as j_cfg
    from mixermdm_tpu_torch.diffusion.mixer_diffusion import ddim_sample_loop_x2
    from mixermdm_tpu_torch.models.cfg import cfg_model_x2

    (jfwd, params, js, jn1, jn2), (tfwd, ts, tn1, tn2) = golden_chain
    fx = golden.load("mixer_ddim")
    want = j_loop(j_cfg(lambda x, x2, t, m, c: jfwd(params, x, t, c, m, x2)[0], 3.5), js,
                  (B, T, 2 * F), jax.random.PRNGKey(0), jnp.asarray(fx["cond"]),
                  mask=jnp.asarray(fx["mask"]), normalizer1=jn1, normalizer2=jn2, align=True,
                  nfeats=F, noise=jnp.asarray(fx["noise"]))
    with torch.no_grad():
        got = ddim_sample_loop_x2(
            cfg_model_x2(lambda x, x2, t, m, c: tfwd(x, t, c, m, x2)[0], 3.5), ts,
            (B, T, 2 * F), torch.from_numpy(fx["cond"]), mask=torch.from_numpy(fx["mask"]),
            normalizer1=tn1, normalizer2=tn2, align=True, noise=torch.from_numpy(fx["noise"]),
            nfeats=F)
    _close(got, want, **CHAIN_TOL)
    _close(got, fx["ref"], atol=2e-3, rtol=2e-3)


def test_quant_frozen_routes_every_block_to_the_q8_entry_points(monkeypatch):
    """QUANT_FROZEN at the published widths: cast_ builds the int8 buffers
    of every SA, CA and FFN block (width 1024 and 512, above the 512 gate),
    and inside the W8A8 scope both denoisers and the mixer core call only
    the q8 entry points.  Built and run on the meta device (no memory, no
    compute), through the plain versions, as the card's path would go."""
    from mixermdm_tpu_torch import ops
    from mixermdm_tpu_torch.config import MIXERMDM_DEFAULT
    from mixermdm_tpu_torch.models import layers
    from mixermdm_tpu_torch.systems.mixermdm import MixerMDMSystem

    assert MIXERMDM_DEFAULT["QUANT_FROZEN"] is True
    system = MixerMDMSystem(MIXERMDM_DEFAULT, compute_dtype="bf16", device="meta")
    nets = (system.model1, system.model2, system.core)  # the networks sampling runs
    blocks = [m for net in nets for m in net.modules() if isinstance(m, layers.Int8Block)]
    assert len(blocks) == 20 + 12 + 20
    for m in blocks:
        for name in m._int8_sources():
            assert getattr(m, f"{name}_q8").dtype == torch.int8
            assert getattr(m, f"{name}_scale").dtype == torch.float32
    # The 256-wide discriminators (training only) stay below the int8 gate.
    for m in list(system.disc_i.modules()) + list(system.disc_I.modules()):
        if isinstance(m, layers.Int8Block):
            assert not m.runs_int8(torch.bfloat16)
            assert not any(n.endswith(("_q8", "_scale")) for n, _ in m.named_buffers())
    assert not any(k.endswith(("_q8", "_scale")) for k in system.state_dict())

    calls = {}
    for name in ("fused_sa_block", "fused_ca_block", "fused_ffn_block"):
        for fname in (name, name + "_q8"):
            def counted(*a, _fn=getattr(layers, fname), _name=fname, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **k)

            monkeypatch.setattr(layers, fname, counted)
    bf, Tn, F = torch.bfloat16, 16, system.nfeats
    meta = lambda *shape: torch.zeros(shape, dtype=bf, device="meta")  # noqa: E731
    t = torch.zeros(2, dtype=torch.long, device="meta")
    d1 = system.model1.denoisers["individual"]
    d2 = system.model2.denoisers["interaction"]
    runs = {
        "individual": lambda: d1(meta(2, Tn, F), t, None, meta(2, d1.text_dim)),
        "interaction": lambda: d2(meta(2, Tn, 2 * F), t, None, meta(2, 3 * d2.text_dim)),
        "mixer core": lambda: system.core(*[meta(2, Tn, F)] * 4, t, *[meta(2, 768)] * 3),
    }
    want = {"individual": (8, 0, 8), "interaction": (8, 8, 8), "mixer core": (4, 4, 4)}
    for net, run in runs.items():
        calls.clear()
        with ops.plain_versions(), layers.w8a8_scope():
            run()
        sa, ca, ffn = want[net]
        assert calls == {k: v for k, v in (("fused_sa_block_q8", sa), ("fused_ca_block_q8", ca),
                                           ("fused_ffn_block_q8", ffn)) if v}, net


def test_port_runs_without_jax_yaml_or_the_jax_package(tmp_path):
    """In a fresh interpreter where jax, flax, optax, orbax, yaml and
    mixermdm_tpu cannot be imported (the card machine has none of the first
    five): import every module of the port and chip_smoke.py, run the CLI's
    tiny sample on the CPU end to end, then the CLI's system with its
    QUANT_FROZEN on in bf16 (the card's dtype) with the width gate at the
    tiny width, so that its blocks take the W8A8 path, then two steps of the
    training CLI (``python -m mixermdm_tpu_torch train-mixermdm --tiny
    --device cpu --max-steps 2``)."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "optax", "orbax", "orbax.checkpoint", "yaml",
                     "mixermdm_tpu"):
            sys.modules[name] = None
        import mixermdm_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(mixermdm_tpu_torch.__path__,
                                                      "mixermdm_tpu_torch.")]
        for m in mods:
            importlib.import_module(m)
        import chip_smoke
        from mixermdm_tpu_torch.cli import infer_mixermdm
        infer_mixermdm.main(["--tiny", "--device", "cpu", "--name", "g", "--num-samples", "2",
                             "--out-dir", {str(tmp_path)!r}, "--text-interaction", "two hug",
                             "--text-individual1", "one hugs", "--text-individual2", "one hugs"])
        import torch
        from mixermdm_tpu_torch.models import layers
        calls = []
        for name in ("fused_sa_block_q8", "fused_ca_block_q8", "fused_ffn_block_q8"):
            fn = getattr(layers, name)
            setattr(layers, name, lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
        layers.set_w8a8_min_dim(128)
        system = infer_mixermdm.build_system(tiny=True, device="cpu", zero_init_std=0.02)
        assert system.quant_frozen
        system.cast_(torch.bfloat16)
        cond = system.generate_cond({{"text_interaction": ["two hug"] * 2,
                                     "text_individual1": ["one hugs"] * 2,
                                     "text_individual2": ["one hugs"] * 2}})
        out = system.sample(cond, 16, generator=torch.Generator().manual_seed(0))
        assert out.shape == (2, 16, 524) and bool(torch.isfinite(out).all())
        assert len(calls) == 4 * 8, calls  # 3 SA + 2 CA + 3 FFN per DDIM step, 4 steps
        from mixermdm_tpu_torch.__main__ import main as cli
        sys.argv = ["mixermdm_tpu_torch", "train-mixermdm", "--tiny", "--device", "cpu",
                    "--max-steps", "2", "--out-dir", {str(tmp_path / "train")!r}]
        assert cli() == 0
        bad = [k for k, v in sys.modules.items() if v is not None and
               k.split(".")[0] in ("jax", "flax", "optax", "orbax", "yaml", "mixermdm_tpu")]
        assert not bad, bad
        print("imported", len(mods), "modules")
    """)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "imported" in res.stdout
    motion = np.load(tmp_path / "g_motion.npy")
    assert motion.shape == (2, 16, 2 * F) and np.isfinite(motion).all()
    assert np.load(tmp_path / "g_influence_i1.npy").shape == (4, 2, 16, F)
    assert "training done: 2 steps" in res.stdout
    assert (tmp_path / "train" / "MixerMDM.ckpt").is_file()


@pytest.mark.parametrize("steps,respacing", [(1000, "ddim50"), (N_STEPS, "ddim5"),
                                             (100, "10,5")])
def test_schedule_matches_jax(steps, respacing):
    """Respaced cosine schedules: the arrays the DDIM update reads, and the
    map back to original timesteps that the networks see."""
    from mixermdm_tpu.diffusion.schedule import named_schedule as j_named
    from mixermdm_tpu_torch.diffusion.schedule import named_schedule

    want = j_named("cosine", steps, respacing)
    got = named_schedule("cosine", steps, respacing)
    np.testing.assert_array_equal(got.timestep_map.numpy(), np.asarray(want.timestep_map))
    for name in ("alphas_cumprod_prev", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod"):
        _close(getattr(got, name), getattr(want, name), atol=0, rtol=1e-6)
