"""The port's modules against the JAX package's, on the CPU in float32.

Weights come from the JAX package: the parameter tree of a miniature
MixerMDMSystem (the golden sizes of tests/test_golden.py: L=64, FF=128, 2
layers, 4 heads; tiny CLIP tower), its shapes traced with ``jax.eval_shape``
(no XLA compile of the whole-system init) and filled from a numpy seed so
that no zero-init layer stays zero; the tree goes through the port's
``weights.py`` into the port's modules.  Inputs come from a numpy seed.

Tolerance: 1e-4 absolute and relative on outputs of magnitude ~1, the bound
tests/test_golden.py uses for the same modules (float32, two frameworks,
sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import golden

L, FF, NL, NH, TD, F = 64, 128, 2, 4, 768, 262
B, T = 2, 8
N_STEPS = 20
TOL = dict(atol=1e-4, rtol=1e-4)


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


def jax_tiny_system():
    from mixermdm_tpu.config import Config, tiny_config
    from mixermdm_tpu.models.clip_text import ClipTextConfig
    from mixermdm_tpu.systems import In2INSystem, MixerMDMSystem
    from mixermdm_tpu.utils.normalizer import Normalizer

    clip = ClipTextConfig.tiny()
    c = tiny_config(latent=L, layers=NL, heads=NH, diffusion_steps=N_STEPS)
    (m1, s1), (m2, s2) = normalizer_stats()
    return MixerMDMSystem(
        Config.wrap(mixer_cfg_dict()),
        model1=In2INSystem(c, mode="individual", clip_cfg=clip),
        model2=In2INSystem(c, mode="interaction", clip_cfg=clip), clip_cfg=clip,
        normalizer1=Normalizer(jnp.asarray(m1), jnp.asarray(s1)),
        normalizer2=Normalizer(jnp.asarray(m2), jnp.asarray(s2)), compute_dtype="f32")


def port_tiny_system():
    from mixermdm_tpu_torch.config import Config, tiny_config
    from mixermdm_tpu_torch.models.clip_text import ClipTextConfig
    from mixermdm_tpu_torch.systems.in2in import In2INSystem
    from mixermdm_tpu_torch.systems.mixermdm import MixerMDMSystem
    from mixermdm_tpu_torch.utils.normalizer import Normalizer

    clip = ClipTextConfig.tiny()
    c = tiny_config(latent=L, layers=NL, heads=NH, diffusion_steps=N_STEPS)
    (m1, s1), (m2, s2) = normalizer_stats()
    return MixerMDMSystem(
        Config.wrap(mixer_cfg_dict()),
        model1=In2INSystem(c, mode="individual", clip_cfg=clip),
        model2=In2INSystem(c, mode="interaction", clip_cfg=clip), clip_cfg=clip,
        normalizer1=Normalizer(torch.from_numpy(m1), torch.from_numpy(s1)),
        normalizer2=Normalizer(torch.from_numpy(m2), torch.from_numpy(s2)), device="cpu")


def random_params(jsys, seed=0):
    """The JAX system's parameter tree with numpy values: torch-style
    uniform(+-1/sqrt(fan_in)) kernels, small biases, LayerNorm scales near 1,
    CLIP embeddings N(0, 0.02) / N(0, 0.01).  Shapes come from tracing
    ``init_params`` under ``jax.eval_shape``, so nothing is compiled."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = str(getattr(path[-1], "key", "")), leaf.shape
        if name == "kernel":
            bound = 1.0 / np.sqrt(shape[-2])
            a = rng.uniform(-bound, bound, shape)
        elif name == "scale":
            a = 1.0 + 0.02 * rng.standard_normal(shape)
        elif name == "positional_embedding":
            a = 0.01 * rng.standard_normal(shape)
        else:  # biases, token embedding
            a = 0.02 * rng.standard_normal(shape)
        return a.astype(np.float32)

    shapes = jax.eval_shape(jsys.init_params, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def systems():
    """(JAX system, its numpy params, port system loaded from them)."""
    from mixermdm_tpu_torch.weights import load_mixermdm_params

    jsys = jax_tiny_system()
    params = random_params(jsys)
    tsys = port_tiny_system()
    load_mixermdm_params(tsys, params)
    return jsys, params, tsys


def texts():
    return {"text_interaction": ["two people shake hands", "one pushes the other"],
            "text_individual1": ["a person reaches out", "a person pushes"],
            "text_individual2": ["a person takes the hand", "a person stumbles back"]}


# ------------------------------------------------------------------ weights

@pytest.mark.parametrize("part", ["mixermdm", "model1", "model2"])
def test_export_matches_jax_checkpoint_export(systems, part):
    """weights.py's own copy of the export mapping gives the same reference-
    layout state dict as mixermdm_tpu/train/checkpoint.py."""
    from mixermdm_tpu.train import checkpoint as ck
    from mixermdm_tpu_torch import weights

    _, params, _ = systems
    if part == "mixermdm":
        want, got = ck.export_mixermdm_system(params), weights.export_mixermdm_system(params)
    else:
        mode = "individual" if part == "model1" else "interaction"
        want = ck.export_in2in_system(params[part], mode)
        got = weights.export_in2in_system(params[part], mode)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_load_covers_every_port_parameter(systems):
    """The strict load filled every parameter of the port system with the
    JAX values (spot-check one tensor per module family)."""
    _, params, tsys = systems
    n_port = sum(p.numel() for p in tsys.parameters())
    from mixermdm_tpu_torch.weights import mixermdm_state_dict

    assert sum(v.size for v in mixermdm_state_dict(params).values()) == n_port
    blk = params["model2"]["denoiser_interaction"]["blocks"]["block"]
    np.testing.assert_array_equal(
        tsys.model2.denoisers["interaction"].blocks[1].ca_block.attention.out_proj.weight
        .detach().numpy(), blk["ca_block"]["attention"]["out_proj"]["kernel"][1].T)
    np.testing.assert_array_equal(tsys.text.clip.token_embedding.weight.detach().numpy(),
                                  params["text"]["clip"]["token_embedding"])


# ---------------------------------------------------------------- denoisers

def _denoiser_inputs(mode, seed=3):
    rng = np.random.default_rng(seed)
    width = F if mode == "individual" else 2 * F
    x = rng.standard_normal((B, T, width)).astype(np.float32)
    t = np.array([3, 17], np.int32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, -3:] = 0.0
    return x, t, mask


@pytest.mark.parametrize("mode", ["individual", "interaction"])
def test_denoiser_matches_jax(systems, mode):
    jsys, params, tsys = systems
    jm = jsys.model1 if mode == "individual" else jsys.model2
    tm = tsys.model1 if mode == "individual" else tsys.model2
    key = "model1" if mode == "individual" else "model2"
    td = jm.text_dim
    x, t, mask = _denoiser_inputs(mode)
    cond = np.random.default_rng(4).standard_normal(
        (B, td if mode == "individual" else 3 * td)).astype(np.float32)
    want = jm.denoisers[mode].apply({"params": params[key][f"denoiser_{mode}"]},
                                    jnp.asarray(x), jnp.asarray(t), jnp.asarray(mask),
                                    jnp.asarray(cond))
    with torch.no_grad():
        got = tm.denoisers[mode](torch.from_numpy(x), torch.from_numpy(t).long(),
                                 torch.from_numpy(mask), torch.from_numpy(cond))
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("which", ["individual", "interaction"])
def test_denoiser_matches_golden_reference(which):
    """The recorded outputs of the original PyTorch reference (golden
    fixtures), with the recorded params loaded through weights.py."""
    from mixermdm_tpu_torch.models.in2in import In2INDenoiser
    from mixermdm_tpu_torch.weights import load_denoiser_params

    stack = golden.load("mixer_stack")
    fx = golden.load(f"denoiser_fwd_{which}")
    den = In2INDenoiser(input_feats=F, mode=which, latent_dim=L, ff_size=FF, num_layers=NL,
                        num_heads=NH, text_dim=TD)
    load_denoiser_params(den, stack["mixer"]["denoiser1" if which == "individual" else "denoiser2"])
    with torch.no_grad():
        got = den(torch.from_numpy(fx["x"]), torch.from_numpy(fx["t"]).long(),
                  torch.from_numpy(fx["mask"]), torch.from_numpy(fx["cond"]))
    _close(got, fx["ref"])


# ------------------------------------------------------------ mixer forward

def test_mixer_forward_matches_jax(systems):
    jsys, params, tsys = systems
    rng = np.random.default_rng(5)
    x1 = rng.standard_normal((B, T, 2 * F)).astype(np.float32)
    x2 = rng.standard_normal((B, T, 2 * F)).astype(np.float32)
    cond = rng.standard_normal((B, 8 * jsys.text_dim)).astype(np.float32)
    t = np.array([980, 420], np.int32)
    mask = np.ones((B, T, 1), np.float32)
    mask[0, -2:] = 0.0
    want = jsys._mixer_forward(jsys.mixer_params(params), jnp.asarray(x1), jnp.asarray(t),
                               jnp.asarray(cond), jnp.asarray(mask), jnp.asarray(x2))
    with torch.no_grad():
        got = tsys._mixer_forward(torch.from_numpy(x1), torch.from_numpy(t).long(),
                                  torch.from_numpy(cond), torch.from_numpy(mask),
                                  torch.from_numpy(x2))
    for name, g, w in zip(("mixed", "out1", "out2"), got[:3], want[:3]):
        _close(g, w, atol=2e-4, rtol=2e-4)
    for g, w in zip(got[3], want[3]):
        _close(g, w)


def test_mixer_forward_matches_golden_reference():
    from mixermdm_tpu_torch.models.mixer import MixerConfig, MixerCore, make_mixer_forward
    from mixermdm_tpu_torch.models.in2in import In2INDenoiser
    from mixermdm_tpu_torch.utils.normalizer import Normalizer
    from mixermdm_tpu_torch.weights import export_mixer_core, load_denoiser_params, \
        load_state_dict_np, rename, MIXER_RENAMES

    stack = golden.load("mixer_stack")
    fx = golden.load("mixer_fwd")
    d1 = In2INDenoiser(F, "individual", L, FF, NL, NH, TD)
    d2 = In2INDenoiser(F, "interaction", L, FF, NL, NH, TD)
    load_denoiser_params(d1, stack["mixer"]["denoiser1"])
    load_denoiser_params(d2, stack["mixer"]["denoiser2"])
    core = MixerCore(F, L, FF, NL, NH, TD, 4)
    sd = {}
    export_mixer_core(stack["mixer"]["core"], sd)
    load_state_dict_np(core, {k[len("core."):]: v for k, v in rename(sd, MIXER_RENAMES).items()})
    n = stack["norm"]
    fwd = make_mixer_forward(
        MixerConfig(nfeats=F, latent_dim=L, ff_size=FF, n_blocks=NL, n_heads=NH, text_dim=TD),
        d1, d2, core, Normalizer(torch.from_numpy(n["mean1"]), torch.from_numpy(n["std1"])),
        Normalizer(torch.from_numpy(n["mean2"]), torch.from_numpy(n["std2"])))
    with torch.no_grad():
        mix, o1, o2, _ = fwd(torch.from_numpy(fx["x1"]), torch.from_numpy(fx["t"]).long(),
                             torch.from_numpy(fx["cond"]), torch.from_numpy(fx["mask"]),
                             torch.from_numpy(fx["x2"]))
    # tests/test_golden.py's bound for the JAX package on the same fixture
    for name, got in (("ref_out1", o1), ("ref_out2", o2), ("ref_mixed", mix)):
        _close(got, fx[name], atol=5e-4, rtol=1e-3)


# ---------------------------------------------------------------- text path

def test_text_pipeline_matches_jax(systems):
    """Tokenisation (the port's own HashTokenizer copy) and the 8 x width
    cond: three CLIP towers (causal attention) and three post-encoders."""
    jsys, params, tsys = systems
    batch = texts()
    jtok = jsys.tokenize_batch(batch)
    ttok = tsys.tokenize_batch(batch)
    for k in jtok:
        np.testing.assert_array_equal(ttok[k].numpy(), np.asarray(jtok[k]), err_msg=k)
    want = jsys.encode_cond(params, jtok["tokens_inter"], jtok["tokens_i1"], jtok["tokens_i2"])
    got = tsys.encode_cond(ttok["tokens_inter"], ttok["tokens_i1"], ttok["tokens_i2"])
    assert got.shape == (B, 8 * jsys.text_dim) and got.dtype == torch.float32
    _close(got, want)


# ------------------------------------------------------- influence, geometry

@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_expand_influence_matches_jax(mode):
    from mixermdm_tpu.models.influence import expand_influence as jexpand
    from mixermdm_tpu_torch.models.influence import expand_influence

    width = 1 if mode in (1, 2) else 23
    shape = (B, width) if mode in (1, 3) else (B, T, width)
    w = np.random.default_rng(mode).random(shape).astype(np.float32)
    want = jexpand(jnp.asarray(w), T, mode)
    got = expand_influence(torch.from_numpy(w), T, mode)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _motion(seed, n=2 * B):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, T, F)).astype(np.float32)
    m[..., :66] += np.linspace(0, 1, T, dtype=np.float32)[None, :, None]  # a moving root
    return m


@pytest.mark.parametrize("case", ["center", "align", "align_masked"])
def test_geometry_matches_jax(case):
    """The per-step f32 geometry of the chain (centring, trajectory
    alignment, 6d Gram-Schmidt) against the JAX package's fast paths."""
    from mixermdm_tpu.utils import alignment as jal
    from mixermdm_tpu_torch.utils import alignment as tal

    a, b = _motion(7), _motion(8)
    if case == "center":
        _close(tal.center_person_fast(torch.from_numpy(a)),
               jal.center_person_fast(jnp.asarray(a)))
        return
    mask = None
    if case == "align_masked":
        mask = np.ones((2 * B, T, 1), np.float32)
        mask[1, -3:] = 0.0
    want = jal.align_persons_fast(jnp.asarray(a), jnp.asarray(b),
                                  None if mask is None else jnp.asarray(mask))
    got = tal.align_persons_fast(torch.from_numpy(a), torch.from_numpy(b),
                                 None if mask is None else torch.from_numpy(mask))
    for g, w in zip(got, want):
        _close(g, w)
