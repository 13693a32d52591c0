"""The port's MDM and InterGen systems, CLIP's ``encode_text``
(``ClipTextEncoder``) and MDM's token layout, the mixer's MDM / InterGen
adapters and ``build_mixer_system``, and ``infer-mdm``, against the JAX
package's, on the CPU in float32.

Sizes are the port's test sizes (tests/test_torch_port_models.py: L 64, FF
128, 2 layers, 4 heads, B 2, T 8; ``ClipTextConfig.tiny``; chains respaced
to 5 steps).  JAX parameters come from ``jax.eval_shape`` filled from numpy
and reach the port through ``weights.py``; the chains get the JAX chain's
own initial noise.  Tolerances: 1e-4 absolute and relative for each network
and the conds; ``CHAIN_TOL`` (1e-3) for whole chains; bitwise for the token
layouts and the loaded weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_models import B, F, L, NH, NL, N_STEPS, T, mixer_cfg_dict, \
    normalizer_stats, random_params

TOL = dict(atol=1e-4, rtol=1e-4)
CHAIN_TOL = dict(atol=1e-3, rtol=1e-3)
PROMPTS = ["a person waves with the left hand", "someone walks forward and sits down"]


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


def _cfg(name):
    from mixermdm_tpu_torch.config import tiny_config

    c = dict(tiny_config(latent=L, layers=NL, heads=NH, diffusion_steps=N_STEPS), NAME=name)
    return c


def _norms(lib):
    """(HumanML3D-like, InterHuman-like) normalizers for ``lib`` = the JAX
    or the port package."""
    if lib == "jax":
        from mixermdm_tpu.utils.normalizer import Normalizer
        conv = jnp.asarray
    else:
        from mixermdm_tpu_torch.utils.normalizer import Normalizer
        conv = torch.from_numpy
    return [Normalizer(conv(m), conv(s)) for m, s in normalizer_stats()]


@pytest.fixture(scope="module")
def mdm():
    from mixermdm_tpu.config import Config as JConfig
    from mixermdm_tpu.models.clip_text import ClipTextConfig as JClip
    from mixermdm_tpu.systems import MDMSystem as JMDM
    from mixermdm_tpu_torch.config import Config
    from mixermdm_tpu_torch.models.clip_text import ClipTextConfig
    from mixermdm_tpu_torch.systems.mdm import MDMSystem
    from mixermdm_tpu_torch.weights import load_mdm_params

    jsys = JMDM(JConfig.wrap(_cfg("MDM")), clip_cfg=JClip.tiny(), normalizer=_norms("jax")[0])
    params = random_params(jsys, seed=40)
    tsys = MDMSystem(Config.wrap(_cfg("MDM")), clip_cfg=ClipTextConfig.tiny(),
                     normalizer=_norms("port")[0], device="cpu")
    return jsys, params, load_mdm_params(tsys, params)


@pytest.fixture(scope="module")
def intergen():
    from mixermdm_tpu.config import Config as JConfig
    from mixermdm_tpu.models.clip_text import ClipTextConfig as JClip
    from mixermdm_tpu.systems import InterGenSystem as JIG
    from mixermdm_tpu_torch.config import Config
    from mixermdm_tpu_torch.models.clip_text import ClipTextConfig
    from mixermdm_tpu_torch.systems.intergen import InterGenSystem
    from mixermdm_tpu_torch.weights import load_intergen_params

    jsys = JIG(JConfig.wrap(_cfg("InterGen")), clip_cfg=JClip.tiny(), normalizer=_norms("jax")[1])
    params = random_params(jsys, seed=41)
    tsys = InterGenSystem(Config.wrap(_cfg("InterGen")), clip_cfg=ClipTextConfig.tiny(),
                          normalizer=_norms("port")[1], device="cpu")
    return jsys, params, load_intergen_params(tsys, params)


# ------------------------------------------------------- tokens, CLIP text

@pytest.mark.parametrize("kw", [dict(context_length=22, pad_to=77), dict(),
                                dict(context_length=5, pad_to=9), dict(context_length=5)])
def test_tokenize_matches_jax_bitwise(kw):
    """``tokenize``'s layouts: MDM's 22-token context zero-padded to 77, the
    plain 77, and a context short enough to truncate (EOT kept last)."""
    from mixermdm_tpu.models.clip_text import tokenize as jtok
    from mixermdm_tpu_torch.models.clip_text import default_tokenizer, tokenize

    texts = PROMPTS + ["one two three four five six seven eight nine ten eleven twelve "
                       "thirteen fourteen fifteen sixteen seventeen eighteen nineteen twenty "
                       "twenty-one twenty-two twenty-three"]
    got = tokenize(texts, default_tokenizer(), **kw)
    want = np.asarray(jtok(texts, None, **kw))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tokenize(texts, default_tokenizer(), context_length=5, truncate=False)


def test_vit_b_32_config_matches_jax():
    from mixermdm_tpu.models.clip_text import ClipTextConfig as JClip
    from mixermdm_tpu_torch.models.clip_text import ClipTextConfig

    for name in ("vit_b_32", "vit_l_14", "tiny"):
        j, t = getattr(JClip, name)(), getattr(ClipTextConfig, name)()
        assert (t.width, t.layers, t.heads, t.context_length, t.projection_dim) == \
            (j.width, j.layers, j.heads, j.context_length, j.projection_dim), name


def test_clip_text_encoder_matches_jax(mdm):
    """``encode_text``: the tower, EOT pooling and the text projection, on
    MDM's token layout."""
    jsys, params, tsys = mdm
    tokens = tsys.tokenize(PROMPTS)
    want = jax.jit(jsys.clip.apply)({"params": params["clip"]}, jnp.asarray(tokens.numpy()))
    with torch.no_grad():
        got = tsys.clip(tokens)
    assert got.shape == (B, tsys.clip_cfg.projection_dim)
    _close(got, want)


# ------------------------------------------------------------------- MDM

def test_mdm_export_matches_jax_checkpoint_export(mdm):
    from mixermdm_tpu.train import checkpoint as ck
    from mixermdm_tpu_torch import weights

    _, params, tsys = mdm
    want, got = ck.export_mdm_system(params), weights.export_mdm_system(params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert sorted(weights.mdm_state_dict(params)) == sorted(tsys.state_dict())


def _denoiser_inputs(width, cond_dim, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, width)).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, -3:] = 0.0
    cond = rng.standard_normal((B, cond_dim)).astype(np.float32)
    return x, np.array([3, 17], np.int32), mask, cond


@pytest.mark.parametrize("with_mask", [True, False])
def test_mdm_denoiser_matches_jax(mdm, with_mask):
    """The cond + timestep token first (its frame always valid), post-norm
    GELU encoder without zero-attn, with and without padded frames."""
    jsys, params, tsys = mdm
    x, t, mask, cond = _denoiser_inputs(F, L, 5)
    m = mask if with_mask else None
    want = jax.jit(jsys.denoiser.apply)({"params": params["denoiser"]}, jnp.asarray(x),
                                        jnp.asarray(t), None if m is None else jnp.asarray(m),
                                        jnp.asarray(cond))
    with torch.no_grad():
        got = tsys.denoiser(torch.from_numpy(x), torch.from_numpy(t).long(),
                            None if m is None else torch.from_numpy(m), torch.from_numpy(cond))
    _close(got, want)


def test_mdm_sample_matches_jax(mdm):
    """text_process (22-token context padded to 77) + sample, the noise of
    the JAX chain handed to the port."""
    jsys, params, tsys = mdm
    cond_j = jsys.text_process(params, PROMPTS)
    cond_t = tsys.text_process(PROMPTS)
    assert cond_t.shape == (B, L) and cond_t.dtype == torch.float32
    _close(cond_t, cond_j)
    rng = jax.random.PRNGKey(2)
    want = jsys.sample(params, cond_j, T, rng)
    _, init_rng = jax.random.split(rng)
    noise = np.array(jax.random.normal(init_rng, (B, T, F), jnp.float32))
    got = tsys.sample(cond_t, T, noise=torch.from_numpy(noise))
    assert got.shape == (B, T, F)
    _close(got, want, **CHAIN_TOL)


def _lightning_save(sd, path):
    torch.save({"state_dict": {"model." + k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()}}, path)


def test_mdm_released_file_loads_as_jax_converts_it(mdm, tmp_path):
    """A released-layout MDM file written by the JAX exporter (Lightning
    layout) loads into a port system of another seed bit for bit, and the
    JAX converter's tree maps onto the same values; the port's own writer
    round-trips."""
    from mixermdm_tpu.train import checkpoint as ck
    from mixermdm_tpu_torch.train.checkpoint import load_released_mdm, save_released
    from mixermdm_tpu_torch.weights import init_params_, mdm_state_dict, released_mdm_state_dict

    _, params, tsys = mdm
    path = str(tmp_path / "mdm.ckpt")
    _lightning_save(ck.export_mdm_system(params), path)
    sd = ck.load_torch_state_dict(path)
    converted = {"denoiser": ck.convert_mdm_denoiser(sd, NL, prefix="model"),
                 "embed_text": ck.convert_linear(sd, "embed_text"),
                 "clip": {"transformer": ck.convert_clip_text(sd, 2, prefix="clip_model"),
                          "text_projection": sd["clip_model.text_projection"]}}
    want = mdm_state_dict(converted)
    other = init_params_(type(tsys)(tsys.cfg, clip_cfg=tsys.clip_cfg, device="cpu"), seed=5)
    assert load_released_mdm(other, path, strict=True) == []
    for k, v in want.items():
        np.testing.assert_array_equal(other.state_dict()[k].numpy(), v, err_msg=k)
        assert torch.equal(other.state_dict()[k], tsys.state_dict()[k]), k
    own = str(tmp_path / "own.ckpt")
    save_released(own, released_mdm_state_dict(tsys))
    third = init_params_(type(tsys)(tsys.cfg, clip_cfg=tsys.clip_cfg, device="cpu"), seed=6)
    load_released_mdm(third, own, strict=True)
    for k, v in tsys.state_dict().items():
        assert torch.equal(third.state_dict()[k], v), k


def test_infer_mdm_cli_equals_the_system(tmp_path):
    """``infer-mdm`` on a released file: the output file is the system's
    sample from the same file and seed."""
    from mixermdm_tpu_torch.cli import infer_mdm
    from mixermdm_tpu_torch.train.checkpoint import load_released_mdm, save_released
    from mixermdm_tpu_torch.weights import released_mdm_state_dict

    src = infer_mdm.build_system(tiny=True, device="cpu", seed=3, zero_init_std=0.02)
    path = str(tmp_path / "mdm.ckpt")
    save_released(path, released_mdm_state_dict(src))
    infer_mdm.main(["--tiny", "--device", "cpu", "--name", "m", "--text", PROMPTS[0],
                    "--num-samples", str(B), "--seed", "4", "--out-dir", str(tmp_path),
                    "--checkpoint", path, "--strict"])
    got = np.load(tmp_path / "m_motion.npy")
    system = infer_mdm.build_system(tiny=True, device="cpu", seed=8)
    load_released_mdm(system, path, strict=True)
    want = system.sample(system.text_process([PROMPTS[0]] * B), 16,
                         generator=torch.Generator().manual_seed(4))
    assert got.shape == (B, 16, F) and np.abs(got).max() > 0
    np.testing.assert_array_equal(got, want.numpy())


# -------------------------------------------------------------- InterGen

def test_intergen_denoiser_matches_jax(intergen):
    """SA -> CA(partner) -> FFN on one embedding, person streams stacked."""
    jsys, params, tsys = intergen
    x, t, mask, cond = _denoiser_inputs(2 * F, jsys.text_dim, 6)
    want = jax.jit(jsys.denoiser.apply)({"params": params["denoiser"]}, jnp.asarray(x),
                                        jnp.asarray(t), jnp.asarray(mask), jnp.asarray(cond))
    with torch.no_grad():
        got = tsys.denoiser(torch.from_numpy(x), torch.from_numpy(t).long(),
                            torch.from_numpy(mask), torch.from_numpy(cond))
    _close(got, want)


def test_intergen_sample_matches_jax(intergen):
    jsys, params, tsys = intergen
    cond_j = jsys.text_process(params, PROMPTS)
    cond_t = tsys.text_process(PROMPTS)
    _close(cond_t, cond_j)
    rng = jax.random.PRNGKey(3)
    want = jsys.sample(params, cond_j, T, rng)
    _, init_rng = jax.random.split(rng)
    noise = np.array(jax.random.normal(init_rng, (B, T, 2 * F), jnp.float32))
    got = tsys.sample(cond_t, T, noise=torch.from_numpy(noise))
    assert got.shape == (B, T, 2 * F)
    _close(got, want, **CHAIN_TOL)


# --------------------------------------------- the mixer with MDM / InterGen

@pytest.fixture(scope="module")
def mixer():
    """build_mixer_system with MDM as MODEL1 and InterGen as MODEL2, in both
    packages, the port loaded from the JAX tree."""
    from mixermdm_tpu.config import Config as JConfig
    from mixermdm_tpu.models.clip_text import ClipTextConfig as JClip
    from mixermdm_tpu.systems.mixermdm import build_mixer_system as j_build
    from mixermdm_tpu_torch.config import Config
    from mixermdm_tpu_torch.models.clip_text import ClipTextConfig
    from mixermdm_tpu_torch.systems.mixermdm import build_mixer_system
    from mixermdm_tpu_torch.weights import load_mixermdm_params

    jn, tn = _norms("jax"), _norms("port")
    jsys = j_build(JConfig.wrap(mixer_cfg_dict()), JConfig.wrap(_cfg("MDM")),
                   JConfig.wrap(_cfg("InterGen")), clip_cfg=JClip.tiny(), normalizer1=jn[0],
                   normalizer2=jn[1], compute_dtype="f32")
    params = random_params(jsys, seed=42)
    tsys = build_mixer_system(Config.wrap(mixer_cfg_dict()), Config.wrap(_cfg("MDM")),
                              Config.wrap(_cfg("InterGen")), clip_cfg=ClipTextConfig.tiny(),
                              device="cpu", normalizer1=tn[0], normalizer2=tn[1])
    return jsys, params, load_mixermdm_params(tsys, params)


def _mixer_texts():
    return {"text_interaction": ["two people shake hands", "one pushes the other"],
            "text_individual1": ["a person reaches out", "a person pushes"],
            "text_individual2": ["a person takes the hand", "a person stumbles back"]}


def test_build_mixer_system_wires_the_adapters(mixer):
    """MODEL1 MDM, MODEL2 InterGen: the cond offsets follow MDM's 512-wide
    (here latent-wide) cond, the adapters' modules hold every parameter of
    the JAX tree, and the f32 heads stay f32."""
    from mixermdm_tpu_torch.systems.mixermdm import InterGenAsInteraction, MDMAsIndividual
    from mixermdm_tpu_torch.weights import mixermdm_state_dict

    jsys, params, tsys = mixer
    assert isinstance(tsys.model1, MDMAsIndividual)
    assert isinstance(tsys.model2, InterGenAsInteraction)
    assert tsys.model1.text_dim == jsys.model1.text_dim == L
    assert tsys.mixer_cfg.cond_slices() == jsys.mixer_cfg.cond_slices()
    sd = mixermdm_state_dict(params, "mdm", "intergen")
    assert sorted(sd) == sorted(tsys.state_dict())
    assert all(p.dtype == torch.float32 for p in tsys.model1.mdm.embed_text.parameters())


def test_mixer_with_mdm_and_intergen_matches_jax(mixer):
    """generate_cond (InterGen's head on the three prompts, MDM's
    encode_text on the individual ones, the mixer's head) and the whole
    dual-stream chain with influences, the JAX noise handed over."""
    jsys, params, tsys = mixer
    batch = _mixer_texts()
    cond_j = jsys.generate_cond(params, batch)
    cond_t = tsys.generate_cond(batch)
    assert cond_t.shape == (B, 3 * 64 + 2 * L + 3 * 64)
    _close(cond_t, cond_j)
    rng = jax.random.PRNGKey(1)
    out_j, (i1_j, i2_j) = jsys.sample(params, cond_j, T, rng, collect_influence=True)
    _, init_rng = jax.random.split(rng)
    noise = np.array(jax.random.normal(init_rng, (B, T, 2 * F), jnp.float32))
    out_t, (i1_t, i2_t) = tsys.sample(cond_t, T, noise=torch.from_numpy(noise),
                                      collect_influence=True)
    _close(out_t, out_j, **CHAIN_TOL)
    _close(i1_t, i1_j, **CHAIN_TOL)
    _close(i2_t, i2_j, **CHAIN_TOL)

