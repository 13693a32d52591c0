"""The port's inference surface against the JAX package's, on the CPU in
float32: trajectory control and warm start in the DDIM chain, the
DPM-Solver++ chain and its coefficients, the sampler overrides, the prompt
decomposer, and the released checkpoint files (written by the JAX
package's exporters, converted by JAX, loaded by the port, and sampled by
both through ``forward`` / ``forward_test``).

The chains run on a small closed-form mixer (the same function in both
frameworks) so that each JAX chain compiles in about a second; the
released-file tests run the miniature system of
tests/test_torch_port_models.py.  Tolerances: bitwise where both sides do
the same float operations on the same values (the trajectory pin, the
coefficient tables, the loaded weights); ``CHAIN_TOL`` (1e-3 absolute and
relative) for whole chains against JAX, as tests/test_torch_port_sample.py
holds them, with the noise injected.
"""

import argparse
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_models import (
    B, F, N_STEPS, T, jax_tiny_system, mixer_cfg_dict, normalizer_stats, port_tiny_system,
    random_params, texts)

CHAIN_TOL = dict(atol=1e-3, rtol=1e-3)
C = 16  # width of the chain tests' cond


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


# ------------------------------------------------------------ chain pieces

@pytest.mark.parametrize("D", [524, 263, 262])
def test_traj_control_matches_jax_bitwise(D):
    """_apply_traj_control pins dims 0, 2, 262, 264 where they are < D, from
    a control motion longer than the latent."""
    from mixermdm_tpu.diffusion.gaussian import _apply_traj_control as j_pin
    from mixermdm_tpu_torch.diffusion.gaussian import _apply_traj_control

    rng = np.random.default_rng(D)
    img = rng.standard_normal((2, 5, D)).astype(np.float32)
    ctl = rng.standard_normal((2, 7, D)).astype(np.float32)
    got = _apply_traj_control(torch.from_numpy(img), torch.from_numpy(ctl)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_pin(jnp.asarray(img), jnp.asarray(ctl))))
    pinned = [i for i in (0, 2, 262, 264) if i < D]
    np.testing.assert_array_equal(got[..., pinned], ctl[:, :5, pinned])
    np.testing.assert_array_equal(np.delete(got, pinned, -1), np.delete(img, pinned, -1))


@pytest.mark.parametrize("steps,respacing,n_eff", [(1000, None, None), (1000, "ddim25", None),
                                                   (1000, "ddim25", 20), (N_STEPS, "ddim5", 3)])
def test_dpmpp_coefficients_match_jax_bitwise(steps, respacing, n_eff):
    """The coefficient tables of full, respaced and skipped (n_eff < steps)
    chains, float32 bit for bit."""
    from mixermdm_tpu.diffusion.gaussian import dpmpp_coefficients as j_coef
    from mixermdm_tpu.diffusion.schedule import named_schedule as j_named
    from mixermdm_tpu_torch.diffusion.gaussian import dpmpp_coefficients
    from mixermdm_tpu_torch.diffusion.schedule import named_schedule

    js, ts = j_named("cosine", steps, respacing), named_schedule("cosine", steps, respacing)
    np.testing.assert_array_equal(ts.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod))
    got, want = dpmpp_coefficients(ts, n_eff), j_coef(js, n_eff)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _toy_mixer(lib):
    """A closed-form stand-in for the CFG mixer, (x, x2, t_orig, mask, cond)
    -> (raw-space x0, (infl1, infl2)), written for ``lib`` = jnp or torch."""
    def fn(x, x2, t, mask, cond):
        s = cond.mean(-1)[:, None, None] + 1e-3 * t[:, None, None]
        mixed = 2.0 * lib.tanh(0.6 * x + 0.3 * x2 + s)
        infl = (1.0 / (1.0 + lib.exp(-x[..., :F])), 1.0 / (1.0 + lib.exp(-x2[..., F:])))
        return mixed, infl
    return fn


@pytest.fixture(scope="module")
def chain_parts():
    from mixermdm_tpu.diffusion.schedule import named_schedule as j_named
    from mixermdm_tpu.utils.normalizer import Normalizer as JNorm
    from mixermdm_tpu_torch.diffusion.schedule import named_schedule
    from mixermdm_tpu_torch.utils.normalizer import Normalizer

    (m1, s1), (m2, s2) = normalizer_stats()
    rng = np.random.default_rng(5)
    data = {"noise": rng.standard_normal((B, T, 2 * F)).astype(np.float32),
            "cond": (0.1 * rng.standard_normal((B, C))).astype(np.float32),
            "motion": rng.standard_normal((B, T, 2 * F)).astype(np.float32),
            "ctl": rng.standard_normal((B, T + 2, 2 * F)).astype(np.float32)}
    jax_side = (j_named("cosine", N_STEPS, "ddim5"), JNorm(jnp.asarray(m1), jnp.asarray(s1)),
                JNorm(jnp.asarray(m2), jnp.asarray(s2)))
    port_side = (named_schedule("cosine", N_STEPS, "ddim5"),
                 Normalizer(torch.from_numpy(m1), torch.from_numpy(s1)),
                 Normalizer(torch.from_numpy(m2), torch.from_numpy(s2)))
    return data, jax_side, port_side


CHAIN_CASES = {
    "traj_control": dict(traj_control="ctl"),
    "skip_init_image": dict(skip_timesteps=2, init_image="motion"),
    "skip_alone": dict(skip_timesteps=2),
    "traj_skip_init": dict(traj_control="ctl", skip_timesteps=1, init_image="motion"),
    "plain": dict(),
}


def _run_chains(chain_parts, loop_name, case):
    """The named loop of both packages on the toy CFG mixer, with influence
    histories, the noise injected and ``CHAIN_CASES[case]``'s controls."""
    from mixermdm_tpu.diffusion import mixer_diffusion as jmd
    from mixermdm_tpu.models.cfg import cfg_model_x2 as j_cfg
    from mixermdm_tpu_torch.diffusion import mixer_diffusion as tmd
    from mixermdm_tpu_torch.models.cfg import cfg_model_x2

    data, (js, jn1, jn2), (ts, tn1, tn2) = chain_parts
    kw = dict(CHAIN_CASES[case])
    arrays = {k: data[v] for k, v in kw.items() if isinstance(v, str)}
    shape = (B, T, 2 * F)
    want = getattr(jmd, loop_name)(
        j_cfg(_toy_mixer(jnp), 3.5, with_influence=True), js, shape, jax.random.PRNGKey(0),
        jnp.asarray(data["cond"]), normalizer1=jn1, normalizer2=jn2, align=True, nfeats=F,
        noise=jnp.asarray(data["noise"]), collect_influence=True,
        **{**kw, **{k: jnp.asarray(v) for k, v in arrays.items()}})
    with torch.inference_mode():
        got = getattr(tmd, loop_name)(
            cfg_model_x2(_toy_mixer(torch), 3.5, with_influence=True), ts, shape,
            torch.from_numpy(data["cond"]), normalizer1=tn1, normalizer2=tn2, align=True,
            nfeats=F, noise=torch.from_numpy(data["noise"]), collect_influence=True,
            **{**kw, **{k: torch.from_numpy(v) for k, v in arrays.items()}})
    return got, want


@pytest.mark.parametrize("case", ["traj_control", "skip_init_image", "skip_alone"])
def test_ddim_chain_controls_match_jax(chain_parts, case):
    """ddim_sample_loop_x2 with trajectory control, with a warm start from
    an init image, and with skipped steps from zeros."""
    (out, (i1, i2)), (out_j, (i1_j, i2_j)) = _run_chains(chain_parts, "ddim_sample_loop_x2",
                                                         case)
    n_eff = 5 - CHAIN_CASES[case].get("skip_timesteps", 0)
    assert out.shape == (B, T, 2 * F) and i1.shape == (n_eff, B, T, F) == i1_j.shape
    _close(out, out_j, **CHAIN_TOL)
    _close(i1, i1_j, **CHAIN_TOL)
    _close(i2, i2_j, **CHAIN_TOL)


@pytest.mark.parametrize("case", ["plain", "traj_skip_init"])
def test_dpmpp_chain_matches_jax(chain_parts, case):
    """dpmpp_sample_loop_x2 (2M multistep, first-order last step, raw-space
    x0 at chain index 0) with and without the controls."""
    (out, (i1, i2)), (out_j, (i1_j, i2_j)) = _run_chains(chain_parts, "dpmpp_sample_loop_x2",
                                                         case)
    assert out.shape == (B, T, 2 * F) and i1.shape == i1_j.shape
    _close(out, out_j, **CHAIN_TOL)
    _close(i1, i1_j, **CHAIN_TOL)
    _close(i2, i2_j, **CHAIN_TOL)
    if case == "plain":  # a chain different from DDIM's on the same inputs
        (ddim, _), _ = _run_chains(chain_parts, "ddim_sample_loop_x2", case)
        assert not torch.allclose(out, ddim, **CHAIN_TOL)


def test_sampler_overrides_match_jax():
    """apply_sampler_overrides(system, "dpmpp", 25): JAX's sampler type and
    respaced schedule, on the system's device.  The JAX function reads and
    sets only ``cfg``, ``sampler_type`` and ``sample_schedule``, so its
    system is a namespace with those."""
    import types

    from mixermdm_tpu.config import Config as JConfig
    from mixermdm_tpu.systems import apply_sampler_overrides as j_over
    from mixermdm_tpu_torch.config import Config
    from mixermdm_tpu_torch.systems import apply_sampler_overrides
    from mixermdm_tpu_torch.systems.mixermdm import MixerMDMSystem

    cfg = dict(mixer_cfg_dict(), DIFFUSION_STEPS=1000, STRATEGY="ddim50")
    jsys = j_over(types.SimpleNamespace(cfg=JConfig.wrap(cfg), sampler_type="ddim"), "dpmpp", 25)
    tiny = port_tiny_system()
    tsys = MixerMDMSystem(Config.wrap(cfg), model1=tiny.model1, model2=tiny.model2,
                          clip_cfg=tiny.text.clip_cfg, device="cpu")
    assert tsys.sampler_type == "ddim" and tsys.sample_schedule.num_timesteps == 50
    assert apply_sampler_overrides(tsys, "dpmpp", 25) is tsys
    assert tsys.sampler_type == jsys.sampler_type == "dpmpp"
    got, want = tsys.sample_schedule, jsys.sample_schedule
    assert got.num_timesteps == 25 and got.timestep_map.device == tsys.device
    np.testing.assert_array_equal(got.timestep_map.numpy(), np.asarray(want.timestep_map))
    for name in ("alphas_cumprod", "alphas_cumprod_prev", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    with pytest.raises(ValueError):
        apply_sampler_overrides(tsys, "ddpm")


DECOMPOSER_PROMPTS = [
    "In an intense boxing match, one person attacks the opponent with straight punch, and "
    "then the opponent falls over.",
    "one person raises the right hand and waves while the other person claps.",
    "one person pushes the other, who stumbles back.",
    "the second person kicks, and the first person blocks with both arms.",
    "one person hugs each other tightly while the other person laughs.",
    "two people bow to each other.",
    "one person waves while the other person bows.",
    "they dance together.",
]


@pytest.mark.parametrize("text", DECOMPOSER_PROMPTS)
def test_decomposer_matches_jax(text):
    """decompose_interaction_text and the batch hook, on the prompts of
    tests/test_decompose.py."""
    from mixermdm_tpu.eval import decompose as jd
    from mixermdm_tpu_torch.eval import decompose as td

    assert td.decompose_interaction_text(text) == jd.decompose_interaction_text(text)
    assert td.heuristic_text_decomposer([text, text]) == jd.heuristic_text_decomposer(
        [text, text])


# ---------------------------------------------------------- released files

def _save(path, sd, lightning: bool):
    """A state dict of numpy arrays or tensors as a torch file; ``lightning``
    wraps it as a Lightning checkpoint does (``state_dict``, ``model.``)."""
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}
    if lightning:
        sd = {"state_dict": {f"model.{k}": v for k, v in sd.items()}, "epoch": 3}
    torch.save(sd, path)
    return str(path)


CLIP_PREFIXES = ("token_embedding", "positional_embedding", "ln_final", "clip_transformer")


@pytest.fixture(scope="module")
def released(tmp_path_factory):
    """Three released-layout files exported by the JAX package from one
    random parameter tree (the mixer file without its CLIP tower, the
    individual file with the cross-attention reference files carry),
    converted by JAX onto another tree, and loaded by the port onto the same
    other tree."""
    from mixermdm_tpu.cli.convert import deep_merge, leaf_paths
    from mixermdm_tpu.train import checkpoint as ck
    from mixermdm_tpu_torch.train.checkpoint import load_released_mixermdm
    from mixermdm_tpu_torch.weights import load_mixermdm_params

    tmp = tmp_path_factory.mktemp("released")
    jsys = jax_tiny_system()
    base, src = random_params(jsys, seed=1), random_params(jsys, seed=2)
    mixer = {k: v for k, v in ck.export_mixermdm_system(src).items()
             if not k.startswith(CLIP_PREFIXES)}
    ind = ck.export_in2in_system(src["model1"], "individual")
    ca = "decoder.net_individual.blocks.0.ca_block.attention.in_proj_weight"
    ind[ca] = np.ones((3 * 64, 64), np.float32)
    files = (_save(tmp / "MixerMDM.ckpt", mixer, True), _save(tmp / "individual.pt", ind, False),
             _save(tmp / "interaction.ckpt", ck.export_in2in_system(src["model2"], "interaction"),
                   True))
    layers = dict(num_layers=2, clip_layers=jsys.text.clip_cfg.layers)
    converted = ck.convert_mixermdm_system(ck.load_torch_state_dict(files[0]), mixer_blocks=2,
                                           disc_layers=2, clip_layers=layers["clip_layers"])
    converted["model1"] = ck.convert_in2in_system(ck.load_torch_state_dict(files[1]),
                                                  "individual", **layers)
    converted["model2"] = ck.convert_in2in_system(ck.load_torch_state_dict(files[2]),
                                                  "interaction", **layers)
    filled = []
    merged = deep_merge(base, converted, filled=filled)
    jax_missing = sorted(set(leaf_paths(base)) - set(filled))
    tsys = load_mixermdm_params(port_tiny_system(), base)
    unfilled = load_released_mixermdm(tsys, *files)
    return dict(jsys=jsys, merged=merged, jax_missing=jax_missing, tsys=tsys, files=files,
                unfilled=unfilled, tmp=tmp)


def test_released_files_fill_all_but_the_dropped_tower(released):
    """What no file filled is the mixer's CLIP tower, in the port and in
    JAX, and nothing else."""
    tsys = released["tsys"]
    tower = sorted(k for k, _ in tsys.named_parameters() if k.startswith("text.clip."))
    assert tower and released["unfilled"] == tower
    assert released["jax_missing"] and all(p.startswith("/text/clip/")
                                           for p in released["jax_missing"])


def _batch(n_frames):
    return {**texts(), "motion_lens": np.asarray([n_frames] * B)}


def _jax_noise(rng):
    _, init_rng = jax.random.split(rng)
    return torch.from_numpy(np.array(jax.random.normal(init_rng, (B, T, 2 * F), jnp.float32)))


def test_released_files_forward_matches_jax(released):
    """forward (text + chain + influence histories) of the port loaded from
    the files against JAX's on its converted tree, the JAX noise injected."""
    rng = jax.random.PRNGKey(4)
    want = released["jsys"].forward(released["merged"], _batch(T), rng)
    got = released["tsys"].forward(_batch(T), noise=_jax_noise(rng))
    assert set(got) == set(want) == {"output", "influence_i1", "influence_i2"}
    for k in want:
        assert got[k].shape == want[k].shape
        _close(got[k], want[k], **CHAIN_TOL)


def test_released_files_forward_test_matches_jax(released):
    rng = jax.random.PRNGKey(5)
    want = released["jsys"].forward_test(released["merged"], _batch(T), rng)
    got = released["tsys"].forward_test(_batch(T), noise=_jax_noise(rng))
    assert got.shape == (B, T, 2 * F)
    _close(got, want, **CHAIN_TOL)


@pytest.fixture(scope="module")
def untouched():
    """A port system that the failing loads below must leave as it is."""
    return port_tiny_system()


def test_strict_raises_before_copying(released, untouched):
    from mixermdm_tpu_torch.train.checkpoint import load_released_mixermdm

    tsys = untouched
    before = {k: v.clone() for k, v in tsys.state_dict().items()}
    with pytest.raises(ValueError, match="strict"):
        load_released_mixermdm(tsys, *released["files"], strict=True)
    assert all(torch.equal(v, before[k]) for k, v in tsys.state_dict().items())


@pytest.mark.parametrize("fault", ["unknown key", "shape"])
def test_faulty_file_raises(released, untouched, fault):
    """A key with no module path is a KeyError, a shape that differs a
    ValueError (cli/convert.py's deep_merge raises the same)."""
    from mixermdm_tpu_torch.train.checkpoint import load_released_mixermdm, \
        load_torch_state_dict

    sd = load_torch_state_dict(released["files"][0])
    if fault == "unknown key":
        sd["mixing.no_such_layer.weight"] = torch.zeros(2)
    else:
        sd["mixing.motion_embed.bias"] = torch.zeros(3)
    path = _save(released["tmp"] / f"faulty_{fault[0]}.pt", sd, False)
    with pytest.raises(KeyError if fault == "unknown key" else ValueError):
        load_released_mixermdm(untouched, path)


@pytest.mark.parametrize("extra", ["numpy arrays", "other objects"])
def test_load_torch_state_dict_reads_in_full_only_with_a_notice(tmp_path, capsys, extra):
    """Tensors and numpy arrays read under weights_only, silently; a file
    that pickles other objects (a Lightning checkpoint's hyper-parameters)
    is read in full, and that is printed."""
    from mixermdm_tpu_torch.train.checkpoint import load_torch_state_dict

    sd = {"model.a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": torch.ones(2)}
    ckpt = {"state_dict": sd, "epoch": 3}
    if extra == "other objects":
        ckpt["hyper_parameters"] = argparse.Namespace(lr=1e-4)
    torch.save(ckpt, tmp_path / "f.ckpt")
    got = load_torch_state_dict(str(tmp_path / "f.ckpt"))
    assert set(got) == {"a", "b"} and all(torch.is_tensor(v) for v in got.values())
    np.testing.assert_array_equal(got["a"].numpy(), sd["model.a"])
    said = capsys.readouterr().err
    assert ("reading it in full" in said) == (extra == "other objects")


def test_port_written_triple_loads_back_bitwise(released, tmp_path):
    """The port writes the three files (weights.py) as the training CLI
    writes MixerMDM.ckpt; another system loads them back bit for bit, with
    nothing unfilled."""
    from mixermdm_tpu_torch.train.checkpoint import load_released_mixermdm
    from mixermdm_tpu_torch.weights import init_params_, released_in2in_state_dict, \
        released_mixermdm_state_dict

    src = released["tsys"]
    torch.save({"state_dict": released_mixermdm_state_dict(src)}, tmp_path / "MixerMDM.ckpt")
    torch.save(released_in2in_state_dict(src.model1, "individual"), tmp_path / "ind.pt")
    torch.save({"state_dict": released_in2in_state_dict(src.model2, "interaction")},
               tmp_path / "inter.ckpt")
    dst = init_params_(port_tiny_system(), seed=9, zero_init_std=0.02)
    unfilled = load_released_mixermdm(
        dst, str(tmp_path / "MixerMDM.ckpt"), str(tmp_path / "ind.pt"),
        str(tmp_path / "inter.ckpt"), strict=True)
    assert unfilled == []
    want = dict(src.named_parameters())
    for k, v in dst.named_parameters():
        assert torch.equal(v, want[k]), k


def test_int8_caches_follow_a_load(tmp_path):
    """W8A8 in bf16 on the CPU (the width gate lowered to the tiny width, as
    tests/test_torch_port_w8a8.py does): after a load inside
    torch.inference_mode() every Int8Block's int8 weights and scales, as its
    next call reads them, are the quantisation of the loaded bf16 weights."""
    from mixermdm_tpu_torch.cli.infer_mixermdm import build_system
    from mixermdm_tpu_torch.models import layers
    from mixermdm_tpu_torch.ops import quantize_weight
    from mixermdm_tpu_torch.train.checkpoint import load_released_mixermdm
    from mixermdm_tpu_torch.weights import init_params_, released_in2in_state_dict, \
        released_mixermdm_state_dict

    layers.set_w8a8_min_dim(128)
    try:
        dst = build_system(tiny=True, device="cpu", zero_init_std=0.02).cast_(torch.bfloat16)
        src = init_params_(copy.deepcopy(dst), seed=1, zero_init_std=0.02)
        assert dst.quant_frozen
        with layers.w8a8_scope():
            blocks = [m for m in dst.modules()
                      if isinstance(m, layers.Int8Block) and m.runs_int8(torch.bfloat16)]
        assert blocks
        stale = [getattr(m, f"{n}_q8").clone() for m in blocks for n in m._int8_sources()]
        torch.save(released_mixermdm_state_dict(src), tmp_path / "m.pt")
        torch.save(released_in2in_state_dict(src.model1, "individual"), tmp_path / "i.pt")
        torch.save(released_in2in_state_dict(src.model2, "interaction"), tmp_path / "x.pt")
        with torch.inference_mode():
            assert load_released_mixermdm(dst, str(tmp_path / "m.pt"), str(tmp_path / "i.pt"),
                                          str(tmp_path / "x.pt")) == []
        fresh = []
        for m in blocks:
            with torch.inference_mode():
                m.int8_weights()
            for name, w in m._int8_sources().items():
                w8, s = quantize_weight(w)
                assert torch.equal(getattr(m, f"{name}_q8"), w8)
                assert torch.equal(getattr(m, f"{name}_scale"), s)
                fresh.append(w8)
        assert not all(torch.equal(a, b) for a, b in zip(stale, fresh))
    finally:
        layers.set_w8a8_min_dim(layers.W8A8_MIN_DIM)
