"""The pure functions of the base-model slice against the JAX package's,
on the CPU in float32: the CFG wrappers (``cfg_model``,
``cfg_model_multiple``, ``cfg_dual_mdm``), DualMDM's weight schedules, the
timestep embedders at a respaced chain's timesteps, and the single-stream
DDIM and DPM-Solver++ chains with trajectory control and warm starts; and
both new CLIs (``infer-in2in``, ``infer-mdm``) in an interpreter that cannot
import JAX, yaml or the JAX package; and where a system lands when the
caller names no device.  The systems themselves are held in
tests/test_torch_port_base_systems.py and
tests/test_torch_port_mdm_intergen.py.

Tolerances: 1e-4 absolute and relative for each CFG wrapper and network;
``CHAIN_TOL`` (1e-3) for whole chains; bitwise for the weight schedules but
where XLA's and torch's f32 exponentials round apart (see there).
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

from tests.test_torch_port_models import B, F, L, NH, NL, N_STEPS, T

TOL = dict(atol=1e-4, rtol=1e-4)
CHAIN_TOL = dict(atol=1e-3, rtol=1e-3)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny; one intra-op thread per test worker keeps the
    port's tests from oversubscribing the cores the other workers share."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **(kw or TOL))


def _toy_model(lib, scale=1.0):
    """A closed-form stand-in for a denoiser, (x, t, mask, cond) -> x0,
    written for ``lib`` = jnp or torch."""
    def fn(x, t, mask, cond):
        s = cond.mean(-1)[:, None, None] + 1e-3 * t[:, None, None]
        return scale * lib.tanh(0.7 * x + s)
    return fn


def _cfg_pair(name):
    from mixermdm_tpu.models import cfg as jcfg
    from mixermdm_tpu_torch.models import cfg as tcfg

    if name == "cfg_model":
        return jcfg.cfg_model(_toy_model(jnp), 3.5), tcfg.cfg_model(_toy_model(torch), 3.5), 16
    if name == "cfg_model_multiple":
        return (jcfg.cfg_model_multiple(_toy_model(jnp), 3.0, 3.0, 1.0, text_dim=16),
                tcfg.cfg_model_multiple(_toy_model(torch), 3.0, 3.0, 1.0, text_dim=16), 48)
    w_func = name.split(":")[1]
    return (jcfg.cfg_dual_mdm(_toy_model(jnp), _toy_model(jnp, 0.5), 1.0, 3.0, w_func, 0.002),
            tcfg.cfg_dual_mdm(_toy_model(torch), _toy_model(torch, 0.5), 1.0, 3.0, w_func, 0.002),
            80)


@pytest.mark.parametrize("name", ["cfg_model", "cfg_model_multiple", "cfg_dual_mdm:exp",
                                  "cfg_dual_mdm:exp-inv", "cfg_dual_mdm:lin",
                                  "cfg_dual_mdm:const"])
def test_cfg_wrappers_match_jax(name):
    jfn, tfn, width = _cfg_pair(name)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, T, 2 * F)).astype(np.float32)
    cond = rng.standard_normal((B, width)).astype(np.float32)
    t = np.array([979, 979], np.int32)
    want = jfn(jnp.asarray(x), jnp.asarray(t), None, jnp.asarray(cond))
    got = tfn(torch.from_numpy(x), torch.from_numpy(t).long(), None, torch.from_numpy(cond))
    _close(got, want)


@pytest.mark.parametrize("w_func", ["exp", "exp-inv", "lin", "const"])
def test_dual_weight_schedules_match_jax_bitwise(w_func):
    """DualMDM's blend weight at every timestep_map value of the respaced
    chains the systems run (ddim5 of 20 steps, ddim50 of 1000): bitwise,
    but for the f32 exponential of "exp" / "exp-inv", which XLA and torch
    each round their own way (one unit in the last place on 3 of the 50
    values, so one unit of exp's value, 2^-23, for "exp-inv" too; torch's
    is the reference's own ``torch.exp``)."""
    from mixermdm_tpu.models.cfg import dual_mdm_weight_fn as jw
    from mixermdm_tpu_torch.diffusion.schedule import named_schedule
    from mixermdm_tpu_torch.models.cfg import dual_mdm_weight_fn as tw

    for steps, respacing in ((N_STEPS, "ddim5"), (1000, "ddim50")):
        tm = named_schedule("cosine", steps, respacing).timestep_map.float()
        got = tw(w_func, 0.002)(tm)
        want = np.asarray(jax.vmap(jw(w_func, 0.002))(jnp.asarray(tm.numpy())), np.float32)
        # one unit in the last place of exp's value (<= 1) for the exp family
        atol = 2.0 ** -23 if w_func.startswith("exp") else 0.0
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_timestep_embedders_match_jax():
    """TimestepEmbedder and IdentityEmbedder at the timestep_map values of a
    respaced chain (ddim50 of 1000)."""
    from mixermdm_tpu.models.embeddings import IdentityEmbedder as JId
    from mixermdm_tpu_torch.diffusion.schedule import named_schedule
    from mixermdm_tpu_torch.models.embeddings import IdentityEmbedder
    from mixermdm_tpu_torch.weights import export_timestep_embedder, load_state_dict_np

    tm = named_schedule("cosine", 1000, "ddim50").timestep_map
    jmod = JId(L)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((1,), jnp.int32))
    rng = np.random.default_rng(9)
    params = jax.tree_util.tree_map(
        lambda s: rng.uniform(-0.2, 0.2, s.shape).astype(np.float32), shapes)["params"]
    want = jmod.apply({"params": params}, jnp.asarray(tm.numpy().astype(np.int32)))
    sd = {}
    export_timestep_embedder(params["time_embed"], "time_embed", sd)
    mod = load_state_dict_np(IdentityEmbedder(L), sd)
    with torch.no_grad():
        got = mod(tm)
    assert got.shape == want.shape == (tm.shape[0], 1, L)
    _close(got, want)
    with torch.no_grad():
        _close(mod.time_embed(tm), want[:, 0])


CHAIN_CASES = {
    "plain": dict(),
    "traj_control": dict(traj_control="ctl"),
    "skip_init_image": dict(skip_timesteps=2, init_image="motion"),
    "traj_skip_alone": dict(traj_control="ctl", skip_timesteps=1),
}


@pytest.mark.parametrize("loop", ["ddim_sample_loop", "dpmpp_sample_loop"])
@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_single_stream_chains_match_jax(loop, case):
    """The single-stream chains on the 4-way CFG toy model, with trajectory
    control and warm starts, the initial noise injected."""
    from mixermdm_tpu.diffusion import gaussian as jg
    from mixermdm_tpu.diffusion.schedule import named_schedule as j_named
    from mixermdm_tpu.models.cfg import cfg_model_multiple as j_cfg
    from mixermdm_tpu_torch.diffusion import gaussian as tg
    from mixermdm_tpu_torch.diffusion.schedule import named_schedule
    from mixermdm_tpu_torch.models.cfg import cfg_model_multiple

    rng = np.random.default_rng(5)
    shape = (B, T, 2 * F)
    data = {"noise": rng.standard_normal(shape).astype(np.float32),
            "motion": rng.standard_normal(shape).astype(np.float32),
            "ctl": rng.standard_normal((B, T + 2, 2 * F)).astype(np.float32)}
    cond = (0.1 * rng.standard_normal((B, 48))).astype(np.float32)
    kw = dict(CHAIN_CASES[case])
    arrays = {k: data[v] for k, v in kw.items() if isinstance(v, str)}
    jm = j_cfg(_toy_model(jnp), 3.0, 3.0, 1.0, text_dim=16)
    tm = cfg_model_multiple(_toy_model(torch), 3.0, 3.0, 1.0, text_dim=16)
    want = getattr(jg, loop)(
        lambda x, t: jm(x, t, None, jnp.asarray(cond)), j_named("cosine", N_STEPS, "ddim5"),
        shape, jax.random.PRNGKey(0), noise=jnp.asarray(data["noise"]),
        **{**kw, **{k: jnp.asarray(v) for k, v in arrays.items()}})
    got = getattr(tg, loop)(
        lambda x, t: tm(x, t, None, torch.from_numpy(cond)),
        named_schedule("cosine", N_STEPS, "ddim5"), shape, noise=torch.from_numpy(data["noise"]),
        **{**kw, **{k: torch.from_numpy(v) for k, v in arrays.items()}})
    _close(got, want, **CHAIN_TOL)




def test_new_clis_run_without_jax_yaml_or_the_jax_package(tmp_path):
    """In a fresh interpreter where jax, flax, optax, orbax, yaml,
    mixermdm_tpu and matplotlib cannot be imported (the card machine has
    none of the first five): ``python -m mixermdm_tpu_torch infer-in2in`` in
    its three modes (individual and dual from released files, dual with
    trajectory control and a warm start) and ``infer-mdm`` from a released
    MDM file, on the CPU, through the command dispatcher."""
    code = textwrap.dedent(f"""
        import os, sys
        for name in ("jax", "jaxlib", "flax", "optax", "orbax", "orbax.checkpoint", "yaml",
                     "mixermdm_tpu", "scripts", "matplotlib"):
            sys.modules[name] = None
        import numpy as np
        from mixermdm_tpu_torch.__main__ import main as cli
        from mixermdm_tpu_torch.cli import infer_in2in, infer_mdm
        from mixermdm_tpu_torch.train.checkpoint import save_released
        from mixermdm_tpu_torch.weights import released_in2in_state_dict, \\
            released_mdm_state_dict
        out = {str(tmp_path)!r}
        dual = infer_in2in.build_system(mode="dual", tiny=True, device="cpu", seed=3,
                                        zero_init_std=0.02)
        save_released(out + "/inter.ckpt", released_in2in_state_dict(dual, "interaction"))
        save_released(out + "/ind.ckpt", released_in2in_state_dict(dual, "individual"))
        mdm = infer_mdm.build_system(tiny=True, device="cpu", seed=3, zero_init_std=0.02)
        save_released(out + "/mdm.ckpt", released_mdm_state_dict(mdm))
        np.save(out + "/ctl.npy", np.random.default_rng(0).standard_normal((10, 524)))
        common = ["--tiny", "--device", "cpu", "--num-samples", "2", "--out-dir", out]
        runs = [["infer-in2in", "--mode", "interaction", "--name", "i", "--text", "two hug"],
                ["infer-in2in", "--mode", "individual", "--name", "s", "--text", "one waves",
                 "--checkpoint", out + "/ind.ckpt"],
                ["infer-in2in", "--mode", "dual", "--name", "d", "--text", "two hug",
                 "--checkpoint", out + "/inter.ckpt", "--ckpt-individual", out + "/ind.ckpt",
                 "--traj-control", out + "/ctl.npy", "--warm-start", out + "/ctl.npy",
                 "--skip-timesteps", "1", "--strict"],
                ["infer-mdm", "--name", "m", "--text", "a person waves", "--checkpoint",
                 out + "/mdm.ckpt", "--strict"]]
        for argv in runs:
            sys.argv = ["mixermdm_tpu_torch"] + argv + common
            assert cli() in (None, 0), argv
        bad = [k for k, v in sys.modules.items() if v is not None and
               k.split(".")[0] in ("jax", "flax", "optax", "orbax", "yaml", "mixermdm_tpu",
                                    "scripts")]
        assert not bad, bad
        print("ran", len(runs), "commands")
    """)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "ran 4 commands" in res.stdout
    for name, width in (("i", 2 * F), ("s", F), ("d", 2 * F), ("m", F)):
        motion = np.load(tmp_path / f"{name}_motion.npy")
        assert motion.shape == (2, 16, width) and np.isfinite(motion).all(), name
    for name in ("s", "d", "m"):
        assert np.abs(np.load(tmp_path / f"{name}_motion.npy")).max() > 0, name


@pytest.mark.parametrize("family", ["in2in", "dualmdm", "mdm", "intergen"])
def test_bare_constructor_builds_on_the_card(family):
    """A system built with no device lands on the card in bf16; where there
    is no card it raises instead of quietly running on the CPU.  The mixer
    and ``build_mixer_system`` make their submodels as parts
    (``SUBMODEL``) and place them themselves."""
    from mixermdm_tpu_torch.config import Config, tiny_config
    from mixermdm_tpu_torch.models.clip_text import ClipTextConfig
    from mixermdm_tpu_torch.systems import load_dualmdm
    from mixermdm_tpu_torch.systems.in2in import In2INSystem
    from mixermdm_tpu_torch.systems.intergen import InterGenSystem
    from mixermdm_tpu_torch.systems.mdm import MDMSystem
    from mixermdm_tpu_torch.systems.mixermdm import SUBMODEL

    def _tiny(name):
        return Config.wrap(dict(tiny_config(latent=L, layers=NL, heads=NH,
                                            diffusion_steps=N_STEPS), NAME=name))

    build = {"in2in": lambda **kw: In2INSystem(_tiny("in2IN"), mode="interaction",
                                                clip_cfg=ClipTextConfig.tiny(), **kw),
             "dualmdm": lambda **kw: load_dualmdm(_tiny("in2IN"),
                                                  clip_cfg=ClipTextConfig.tiny(), **kw),
             "mdm": lambda **kw: MDMSystem(_tiny("MDM"),
                                           clip_cfg=ClipTextConfig.tiny(), **kw),
             "intergen": lambda **kw: InterGenSystem(_tiny("InterGen"),
                                                     clip_cfg=ClipTextConfig.tiny(), **kw)}[family]
    if torch.cuda.is_available():
        system = build()
        assert system.device.type == "cuda" and system.compute_dtype == torch.bfloat16
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            build()
    if family != "dualmdm":
        with torch.device("meta"):
            part = build(**SUBMODEL)
        assert part.device.type == "meta" and part.compute_dtype is None
        assert all(p.dtype == torch.float32 for p in part.parameters())
