"""``QUANT_TRAIN`` in the port's adversarial loss against the JAX package's,
on the CPU in bf16.

The JAX side runs as tests/test_torch_port_w8a8.py runs it: the Pallas
kernels in interpret mode, Pallas attention forced on and the int8 width
gate lowered to the test width (128, head dim 64), with the fused blocks
turned off for the whole loss as the JAX trainer traces it
(``_trace_train_grads``), so that only the frozen denoisers' applies reopen
them (``fused_scope(frozen)``) and run as int8 under ``w8a8_scope``.  The
port's side is its plain versions.  Weights and inputs come from numpy
seeds, with the AdaLN outliers of tests/test_torch_port_w8a8.py that make
int8 tell from bf16.

Held: the frozen denoisers' outputs (the mixer forward's ``out1`` /
``out2``) on that file's denoiser limit (``BF16_TOL["denoiser"]``, below
the gap of the port's same forward without int8, which shows int8 ran);
the G loss's
total on its step limit (``BF16_TOL["step"]``; readings 0.009-0.035 at
three seeds, 0.005-0.013 with int8 off on both sides; its three hinge
terms are printed, not held: each is a mean of a random discriminator's
signs over a few frames, and moves by up to 0.05 absolute between two
bf16 runs without int8); and the int8 calls of both
side steps: the denoisers' blocks only, none of the mixer core's (which in
the discriminator step takes the fused route in bf16), none with
``QUANT_TRAIN`` off.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixermdm_tpu.models import layers as jlayers
from tests.test_torch_port_models import F, TD, normalizer_stats, random_params
from tests.test_torch_port_w8a8 import (BF16_TOL, SB, SL, SNH, SNL, ST, _count_q8_calls, _fro,
                                        _int8_at_tiny_width, _t, _tiny_cfg, _with_outliers)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def systems():
    """(JAX bf16 system, its params cast to bf16, the port's bf16 training
    build with QUANT_TRAIN on, loaded from the same params)."""
    from mixermdm_tpu.config import Config as JConfig, tiny_config as j_tiny
    from mixermdm_tpu.models.clip_text import ClipTextConfig as JClip
    from mixermdm_tpu.systems import In2INSystem as JIn2IN, MixerMDMSystem as JSystem
    from mixermdm_tpu.utils.normalizer import Normalizer as JNorm
    from mixermdm_tpu_torch.config import Config, tiny_config
    from mixermdm_tpu_torch.models.clip_text import ClipTextConfig
    from mixermdm_tpu_torch.systems.in2in import In2INSystem
    from mixermdm_tpu_torch.systems.mixermdm import MixerMDMSystem
    from mixermdm_tpu_torch.utils.normalizer import Normalizer
    from mixermdm_tpu_torch.weights import load_mixermdm_params

    cfg = dict(_tiny_cfg(), QUANT_FROZEN=False, QUANT_TRAIN=True)
    (m1, s1), (m2, s2) = normalizer_stats()
    jc = j_tiny(latent=SL, layers=SNL, heads=SNH, diffusion_steps=20)
    jclip = JClip.tiny()
    jsys = JSystem(JConfig.wrap(cfg), model1=JIn2IN(jc, mode="individual", clip_cfg=jclip),
                   model2=JIn2IN(jc, mode="interaction", clip_cfg=jclip), clip_cfg=jclip,
                   normalizer1=JNorm(jnp.asarray(m1), jnp.asarray(s1)),
                   normalizer2=JNorm(jnp.asarray(m2), jnp.asarray(s2)), compute_dtype="bf16")
    params = _with_outliers(random_params(jsys, seed=2))
    c = tiny_config(latent=SL, layers=SNL, heads=SNH, diffusion_steps=20)
    clip = ClipTextConfig.tiny()
    tsys = MixerMDMSystem(Config.wrap(cfg),
                          model1=In2INSystem(c, mode="individual", clip_cfg=clip, device="cpu"),
                          model2=In2INSystem(c, mode="interaction", clip_cfg=clip, device="cpu"),
                          clip_cfg=clip,
                          normalizer1=Normalizer(torch.from_numpy(m1), torch.from_numpy(s1)),
                          normalizer2=Normalizer(torch.from_numpy(m2), torch.from_numpy(s2)),
                          compute_dtype="bf16", device="cpu", train=True)
    load_mixermdm_params(tsys, params)
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    lp = {"mixer": jsys.mixer_params(bf), "disc_i": bf["disc_i"], "disc_I": bf["disc_I"]}
    return jsys, lp, tsys


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((SB, ST, 2 * F))).astype(np.float32)
    x2 = rng.standard_normal((SB, ST, 2 * F)).astype(np.float32)
    cond = (0.5 * rng.standard_normal((SB, 8 * TD))).astype(np.float32)
    mask = np.ones((SB, ST, 2), np.float32)
    mask[0, -3:] = 0.0
    noise = rng.standard_normal((SB, ST, 2 * F)).astype(np.float32)
    return x, x2, cond, mask, noise, np.array([7])


class _jax_training_trace:
    """The JAX trainer's trace configuration: fused blocks off for the
    whole loss (the frozen applies reopen them), W8A8 on or off."""

    def __init__(self, quant: bool):
        self.quant = quant

    def __enter__(self):
        self.prev = jlayers._FUSED_BLOCKS
        jlayers.set_fused_blocks(False)
        self.scope = jlayers.w8a8_scope(self.quant)
        self.scope.__enter__()

    def __exit__(self, *exc):
        self.scope.__exit__(*exc)
        jlayers.set_fused_blocks(self.prev)


def test_frozen_outputs_and_generator_loss_match_jax_int8(systems, monkeypatch):
    """The mixer forward's frozen outputs and the G loss, int8 denoisers,
    port against JAX; the port's forward without int8 lies farther away."""
    from mixermdm_tpu.diffusion.mixer_diffusion import mixer_training_losses as j_losses

    jsys, lp, tsys = systems
    x, x2, cond, mask, noise, t = _inputs(5)
    t_orig = np.asarray(tsys.train_schedule.timestep_map[torch.from_numpy(t)])

    def j_forward_and_loss():
        disc = lambda m: lambda pp, *a, train=False, rngs=None: m.apply({"params": pp}, *a)  # noqa: E731,E501
        fwd = jsys._mixer_forward(lp["mixer"], jnp.asarray(x), jnp.asarray(t_orig),
                                  jnp.asarray(cond), jnp.asarray(mask[..., :1]),
                                  jnp.asarray(x2))
        loss = j_losses(
            jsys._mixer_forward, disc(jsys.disc_i), disc(jsys.disc_I), lp, jsys.train_schedule,
            jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond), jnp.asarray(mask),
            jax.random.PRNGKey(0), mode="generator", align=True,
            normalizer1=jsys.normalizer1, normalizer2=jsys.normalizer2,
            cond_slices=jsys.mixer_cfg.cond_slices(), nfeats=F, noise=jnp.asarray(noise),
            compute_dtype=jnp.bfloat16)
        return fwd, loss

    port_args = (_t(x), torch.from_numpy(t_orig), _t(cond), _t(mask[..., :1]), _t(x2))
    calls = _count_q8_calls(monkeypatch)
    with _int8_at_tiny_width(monkeypatch):
        with _jax_training_trace(True):
            want, want_loss = jax.jit(j_forward_and_loss)()
        with torch.no_grad():
            ref = tsys._mixer_forward(*port_args)             # the same weights, no int8
            assert not calls
            got = tsys._mixer_forward(*port_args, quant_denoisers=True)
        assert calls == {"fused_sa_block_q8": 2 * SNL, "fused_ca_block_q8": SNL,
                         "fused_ffn_block_q8": 2 * SNL}
        got_loss = tsys.compute_loss(_t(x), torch.from_numpy(np.array([ST - 3])), _t(cond),
                                     mode="generator", t=torch.from_numpy(t),
                                     noise=_t(noise), drop=torch.zeros(SB, 1, dtype=torch.bool),
                                     dropout=False)
    for i, name in ((1, "out1 (individual denoiser)"), (2, "out2 (interaction denoiser)")):
        err, gap = _fro(got[i], want[i]), _fro(ref[i], want[i])
        print(f"{name}: port vs JAX int8 {err:.4g}, port bf16 vs JAX int8 {gap:.4g}")
        assert err <= BF16_TOL["denoiser"] < gap, (name, err, gap)
    for k in ("generator_i1", "generator_i2", "generator_I", "total"):
        print(f"{k}: port {float(got_loss[k]):.6g}, JAX {float(want_loss[k]):.6g}")
        assert np.isfinite(float(got_loss[k])), k
    g, w = float(got_loss["total"]), float(want_loss["total"])
    assert abs(g - w) <= BF16_TOL["step"] * abs(w), (g, w)


@pytest.mark.parametrize("quant_train", [True, False])
def test_only_the_frozen_denoisers_run_int8_in_both_steps(systems, monkeypatch, quant_train):
    """The q8 entry points' calls in a generator and a discriminator step:
    with QUANT_TRAIN the two denoisers' blocks (SA and FFN of each, CA of
    the interaction one), never the mixer core's, although the core takes
    the fused route in the discriminator step; none without QUANT_TRAIN."""
    from mixermdm_tpu_torch.models import layers as tlayers
    from mixermdm_tpu_torch.train.trainer import MixerTrainer

    _, _, tsys0 = systems
    tsys = copy.deepcopy(tsys0)
    tsys.quant_train = quant_train
    tsys.cast_(torch.bfloat16, train=True)
    trainer = MixerTrainer(tsys, grad_acc_steps=1)
    x, _, cond, _, noise, t = _inputs(6)
    q8 = _count_q8_calls(monkeypatch)
    bf16 = {}
    real = tlayers.fused_sa_block

    def counted(*a, **k):
        bf16["fused_sa_block"] = bf16.get("fused_sa_block", 0) + 1
        return real(*a, **k)

    monkeypatch.setattr(tlayers, "fused_sa_block", counted)
    batch = {"motions": _t(x), "motion_lens": torch.tensor([ST - 2]),
             **tsys.tokenize_batch({"text": ["a"], "text_individual1": ["b"],
                                    "text_individual2": ["c"]})}
    per_step = {"fused_sa_block_q8": 2 * SNL, "fused_ca_block_q8": SNL,
                "fused_ffn_block_q8": 2 * SNL}
    with _int8_at_tiny_width(monkeypatch):
        for mode, core_fused in (("generator", 0), ("discriminator", SNL)):
            q8.clear()
            bf16.clear()
            losses = trainer.side_step(mode, batch, torch.Generator().manual_seed(1))
            assert torch.isfinite(losses["total"])
            assert q8 == (per_step if quant_train else {}), mode
            # the core's SA blocks: fused (bf16) only where no graph is recorded
            assert bf16.get("fused_sa_block", 0) == core_fused + (0 if quant_train else 2 * SNL)
