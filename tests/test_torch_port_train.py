"""The port's adversarial training path against the JAX package's, on the CPU.

* ``attention_bwd_plain`` (the plain version of the ``attention_bwd`` kernel)
  against the JAX Pallas backward ``_fused_attention_bwd_impl`` in interpret
  mode and against ``jax.vjp`` of ``reference_attention``; the port's
  differentiable attention against ``jax.vjp`` of ``fused_attention``.
* The G and D losses of ``mixer_training_losses`` against the JAX function
  and the recorded reference losses (golden fixtures, the sizes of
  tests/test_golden.py), and the gradients of the trainable subtrees against
  ``jax.grad`` of the same loss; f32, noise, t and the cond-drop mask
  injected, dropout 0.
* The optimizer against optax ``make_adamw``; the trainer's two sides; the
  text heads kept f32 by ``cast_`` (their conds against the JAX package's
  bf16-tower / f32-head conds); the checkpoint the training CLI writes,
  read back by the JAX package's converter.

Weights come from the JAX package (``jax.eval_shape`` shapes filled from a
numpy seed, as in tests/test_torch_port_models.py); inputs from numpy seeds.
"""

import copy
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import golden
from tests.test_torch_port_models import (
    B, F, FF, L, N_STEPS, NH, NL, T, TD, jax_tiny_system, port_tiny_system, random_params, texts,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np32(a):
    return np.asarray(a.float().detach().numpy() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    g, w = _np32(got), _np32(want)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


# --------------------------------------------------------------- attention_bwd

def _attn_inputs(D, Tq, Tk, kpm_kind, seed):
    rng = np.random.default_rng(seed)
    q, g = (rng.standard_normal((2, 2, Tq, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, 2, Tk, D)).astype(np.float32) for _ in range(2))
    kpm = None
    if kpm_kind != "none":
        kpm = np.zeros((2, Tk), bool)
        kpm[:, Tk - 4:] = True          # padded tail
        if kpm_kind == "masked_row":
            kpm[1] = True               # every key of one sequence masked
    return q, k, v, g, kpm


# bf16: the same rounding points on both sides (p and ds rounded to bf16), so
# what differs is the f32 summation order, which can flip a rounding of p or
# ds; one flip moves an output by a bf16 step of a product, ~2^-8 relative.
BWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("zero_attn", [True, False])
@pytest.mark.parametrize("D,kpm_kind,saved", [
    pytest.param(64, "none", False, id="64-none"), pytest.param(96, "tail", False, id="96-tail"),
    pytest.param(64, "none", True, id="64-none-saved"),
    pytest.param(96, "tail", True, id="96-tail-saved")])
def test_attention_bwd_plain_matches_pallas_backward(dtype, zero_attn, D, kpm_kind, saved):
    """The plain version against the JAX Pallas backward kernel (interpret
    mode), dq / dk / dv, in both input dtypes.  ``saved``: driven, as the
    kernels are, from what the forward saved (the row statistics of
    ``attention_stats_plain`` and the output, whose rowsum(g * out) stands
    for dsum) instead of recomputing the softmax."""
    from mixermdm_tpu.ops.attention import _fused_attention_bwd_impl
    from mixermdm_tpu_torch.ops import attention_bwd_plain, fused_attention

    q, k, v, g, kpm = _attn_inputs(D, 13, 17, kpm_kind, seed=D + 2 * zero_attn)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    t_kpm = None if kpm is None else torch.from_numpy(kpm)
    out, stats = (fused_attention(tq, tk, tv, t_kpm, None, zero_attn, return_stats=True)
                  if saved else (None, None))
    got = attention_bwd_plain(tq, tk, tv, t_kpm, torch.from_numpy(g).to(tdt), zero_attn,
                              stats, out)
    want = _fused_attention_bwd_impl(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                     None if kpm is None else jnp.asarray(kpm), None,
                                     jnp.asarray(g, jdt), zero_attn, True)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tdt
        assert _rel(a, b) <= BWD_TOL[dtype], name


@pytest.mark.parametrize("zero_attn,kpm_kind", [(True, "none"), (False, "none"),
                                                (True, "masked_row"), (False, "tail")])
def test_attention_bwd_plain_matches_reference_vjp(zero_attn, kpm_kind):
    """f32 against ``jax.vjp`` of ``reference_attention``; with zero-attn a
    sequence whose keys are all masked is included (there the Pallas kernel
    spreads the weight over its 128-padded keys and the reference over the
    real ones; the port follows the reference).  Left out: all keys masked
    without zero-attn, where the reference masks by ``where`` (no gradient
    reaches the masked logits) and the Pallas kernel and the port add a
    bias; no path of the port has such a row."""
    from mixermdm_tpu.ops.attention import reference_attention
    from mixermdm_tpu_torch.ops import attention_bwd_plain

    q, k, v, g, kpm = _attn_inputs(96, 11, 19, kpm_kind, seed=7)
    got = attention_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                              None if kpm is None else torch.from_numpy(kpm),
                              torch.from_numpy(g), zero_attn)
    jkpm = None if kpm is None else jnp.asarray(kpm)
    _, vjp = jax.vjp(lambda a, b, c: reference_attention(a, b, c, key_padding_mask=jkpm,
                                                         zero_attn=zero_attn),
                     *(jnp.asarray(a) for a in (q, k, v)))
    for name, a, b in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(g))):
        assert _rel(a, b) <= 1e-5, name


@pytest.mark.parametrize("kpm_kind", ["none", "tail"])
@pytest.mark.parametrize("zero_attn", [True, False])
def test_differentiable_attention_matches_jax_vjp(kpm_kind, zero_attn, monkeypatch):
    """Autograd through the port's attention on the CPU against ``jax.vjp``
    of the JAX package's ``fused_attention`` (its custom_vjp with the Pallas
    backward, interpret mode).  The route is ``FusedAttention``'s: its
    backward reads the statistics and the output its forward saved."""
    from mixermdm_tpu.ops.attention import fused_attention as j_fused
    from mixermdm_tpu_torch.ops import attention as tattn
    from mixermdm_tpu_torch.ops import differentiable_attention

    saved = []
    plain_bwd = tattn.attention_bwd_plain
    monkeypatch.setattr(tattn, "attention_bwd_plain", lambda *a: saved.append(
        a[6] is not None and a[7] is not None) or plain_bwd(*a))
    q, k, v, g, kpm = _attn_inputs(64, 9, 9, kpm_kind, seed=11)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = differentiable_attention(tq, tk, tv, None if kpm is None else torch.from_numpy(kpm),
                                   None, zero_attn)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    jkpm = None if kpm is None else jnp.asarray(kpm)
    want_out, vjp = jax.vjp(lambda a, b, c: j_fused(a, b, c, jkpm, None, zero_attn, True),
                            *(jnp.asarray(a) for a in (q, k, v)))
    assert _rel(out, want_out) <= 1e-5
    for name, a, b in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(g))):
        assert _rel(a, b) <= 1e-5, name
    assert saved == [True]


@pytest.mark.parametrize("kpm_kind", ["none", "tail", "masked_row"])
@pytest.mark.parametrize("zero_attn", [True, False])
def test_attention_stats_plain_match_float64(zero_attn, kpm_kind):
    """The forward's row statistics (what the kernels write for the
    backward) against float64 numpy: the row max with the zero key's 0 and
    the denominator with its exp(-max).  A sequence whose keys are all
    masked has max 0 and denominator 1 + Tk e^-1e30 = 1 with the zero key,
    max -1e30 and denominator Tk without it."""
    from mixermdm_tpu_torch.ops import attention as tattn

    q, k, _, _, kpm = _attn_inputs(96, 11, 19, kpm_kind, seed=5)
    got = tattn.attention_stats_plain(torch.from_numpy(q), torch.from_numpy(k),
                                      None if kpm is None else torch.from_numpy(kpm), None,
                                      zero_attn).numpy()
    logits = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64))
    logits /= np.sqrt(96.0)
    if kpm is not None:
        logits += np.where(kpm, -1e30, 0.0)[:, None, None, :]
    row_max = logits.max(-1)
    if zero_attn:
        row_max = np.maximum(row_max, 0.0)
    denom = np.exp(logits - row_max[..., None]).sum(-1) + (np.exp(-row_max) if zero_attn else 0)
    np.testing.assert_allclose(got[0], row_max, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1], denom, rtol=1e-6)
    if kpm_kind == "masked_row":
        if zero_attn:
            assert (got[0][1] == 0).all() and np.allclose(got[1][1], 1.0)
        else:
            assert np.allclose(got[0][1], -1e30) and np.allclose(got[1][1], 19)


@pytest.mark.parametrize("setting", ["kernel", "plain"])
def test_layers_take_the_differentiable_route_under_grad(setting, monkeypatch):
    """A sub-block whose parameters require grad takes the unfused route:
    its attention goes to ``differentiable_attention`` with the "kernel"
    setting and to the plain math with "plain"; both give the same
    gradients on the CPU, and the same output as the fused route."""
    from mixermdm_tpu_torch.models import layers

    torch.manual_seed(0)
    block = layers.VanillaSelfAttention(64, 2)
    for p in block.norm.parameters():
        torch.nn.init.normal_(p, std=0.05)
    calls = []
    orig = layers.differentiable_attention
    monkeypatch.setattr(layers, "differentiable_attention",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    x, emb = torch.randn(2, 9, 64), torch.randn(2, 64)
    kpm = torch.zeros(2, 9, dtype=torch.bool)
    kpm[1, -3:] = True
    layers.set_train_attention(setting)
    try:
        out = block(x, emb, kpm, residual=True)
        grads = torch.autograd.grad(out.square().sum(), list(block.parameters()))
    finally:
        layers.set_train_attention("kernel")
    assert len(calls) == (1 if setting == "kernel" else 0)
    with torch.no_grad():
        fused = block(x, emb, kpm, residual=True)
    np.testing.assert_allclose(_np32(out), _np32(fused), atol=1e-5, rtol=1e-5)
    layers.set_train_attention("plain" if setting == "kernel" else "kernel")
    try:
        other = torch.autograd.grad(block(x, emb, kpm, residual=True).square().sum(),
                                    list(block.parameters()))
    finally:
        layers.set_train_attention("kernel")
    for a, b in zip(grads, other):
        np.testing.assert_allclose(_np32(a), _np32(b), atol=1e-5, rtol=1e-4)


def test_self_attention_simple_matches_jax():
    """``VanillaSelfAttentionSimple`` (plain LN, eps 1e-6, zero-attn MHA)
    with the JAX module's parameters, key padding included."""
    from mixermdm_tpu.models.layers import VanillaSelfAttentionSimple as JSimple
    from mixermdm_tpu_torch.models.layers import VanillaSelfAttentionSimple
    from mixermdm_tpu_torch.weights import export_mha, load_state_dict_np

    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    kpm = np.zeros((2, 7), bool)
    kpm[0, -2:] = True
    jm = JSimple(64, 4)
    jp = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32),
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = jm.apply({"params": jp}, jnp.asarray(x), jnp.asarray(kpm))
    sd = {}
    export_mha(jp["attention"], "attention", sd)
    port = load_state_dict_np(VanillaSelfAttentionSimple(64, 4), sd).requires_grad_(False)
    got = port(torch.from_numpy(x), torch.from_numpy(kpm))
    np.testing.assert_allclose(_np32(got), np.asarray(want), atol=1e-5, rtol=1e-4)


def test_f32_dense_layers_take_the_plain_product_off_the_cpu():
    """``ops.linear`` keeps f32 off the kernel (the post-encoder heads' dense
    layers, XLA in the JAX package): on a non-CPU tensor it computes the
    plain f32 product instead of raising, bf16 still goes to the kernel."""
    from mixermdm_tpu_torch import ops

    f32 = [torch.empty(s, device="meta") for s in ((2, 5, 8), (4, 8), (4,))]
    assert ops.linear(*f32).shape == (2, 5, 4)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        ops.linear(*(t.to(torch.bfloat16) for t in f32))


# ------------------------------------------------------------- training losses

def _golden_port_parts():
    """The port's denoisers, mixer core and discriminators with the recorded
    golden parameters, and the mixer forward over them."""
    from mixermdm_tpu_torch.models.discriminator import DiscriminatorTransformer
    from mixermdm_tpu_torch.models.in2in import In2INDenoiser
    from mixermdm_tpu_torch.models.mixer import MixerConfig, MixerCore, make_mixer_forward
    from mixermdm_tpu_torch.utils.normalizer import Normalizer
    from mixermdm_tpu_torch.weights import (
        MIXER_RENAMES, export_discriminator, export_mixer_core, load_denoiser_params,
        load_state_dict_np, rename,
    )

    stack = golden.load("mixer_stack")
    d1 = In2INDenoiser(F, "individual", L, FF, NL, NH, TD)
    d2 = In2INDenoiser(F, "interaction", L, FF, NL, NH, TD)
    load_denoiser_params(d1, stack["mixer"]["denoiser1"])
    load_denoiser_params(d2, stack["mixer"]["denoiser2"])
    core = MixerCore(F, L, FF, NL, NH, TD, 4)
    discs = {"disc_i": DiscriminatorTransformer(F, L, FF, NL, NH, TD),
             "disc_I": DiscriminatorTransformer(2 * F, L, FF, NL, NH, TD)}
    sd = {}
    export_mixer_core(stack["mixer"]["core"], sd)
    export_discriminator(stack["disc_i"], "discriminator_i", sd)
    export_discriminator(stack["disc_I"], "discriminator_I", sd)
    sd = rename(sd, MIXER_RENAMES)
    for name, module in (("core", core), *discs.items()):
        load_state_dict_np(module, {k[len(name) + 1:]: v for k, v in sd.items()
                                    if k.startswith(name + ".")})
    n = stack["norm"]
    n1 = Normalizer(torch.from_numpy(n["mean1"]), torch.from_numpy(n["std1"]))
    n2 = Normalizer(torch.from_numpy(n["mean2"]), torch.from_numpy(n["std2"]))
    cfg = MixerConfig(nfeats=F, latent_dim=L, ff_size=FF, n_blocks=NL, n_heads=NH, text_dim=TD)
    for m in (d1, d2, core, *discs.values()):
        m.eval()
    return make_mixer_forward(cfg, d1, d2, core, n1, n2), discs, cfg, n1, n2


@pytest.fixture(scope="module")
def golden_parts():
    return _golden_port_parts()


@pytest.mark.parametrize("mode", ["generator", "discriminator"])
def test_training_losses_match_golden_reference(mode, golden_parts):
    """Both sides' losses on the recorded inputs against the recorded
    reference losses (tests/test_golden.py's bound for the JAX package)."""
    from mixermdm_tpu_torch.diffusion.mixer_diffusion import mixer_training_losses
    from mixermdm_tpu_torch.diffusion.schedule import named_schedule

    fwd, discs, cfg, n1, n2 = golden_parts
    fx = golden.load(f"mixer_losses_{mode}")
    with torch.no_grad():
        got = mixer_training_losses(
            fwd, discs["disc_i"], discs["disc_I"], named_schedule("cosine", N_STEPS),
            torch.from_numpy(fx["x_start"]), torch.from_numpy(fx["t"]).long(),
            torch.from_numpy(fx["cond"]), torch.from_numpy(fx["mask"]), mode=mode,
            normalizer1=n1, normalizer2=n2, cond_slices=cfg.cond_slices(), nfeats=F,
            noise=torch.from_numpy(fx["noise"]))
    assert set(fx["ref_losses"]) <= set(got)
    for key, ref in fx["ref_losses"].items():
        np.testing.assert_allclose(float(got[key]), float(ref), atol=2e-3, rtol=2e-3,
                                   err_msg=key)


@pytest.fixture(scope="module")
def systems():
    """(JAX system, its numpy params, port system loaded from them)."""
    from mixermdm_tpu_torch.weights import load_mixermdm_params

    jsys = jax_tiny_system()
    params = random_params(jsys, seed=3)
    tsys = port_tiny_system()
    load_mixermdm_params(tsys, params)
    return jsys, params, tsys


def _train_inputs(seed=21):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, 2 * F)) * 0.5).astype(np.float32)
    lens = np.array([T, T - 3], np.int64)
    t = np.array([17, 4], np.int64)
    noise = rng.standard_normal((B, T, 2 * F)).astype(np.float32)
    drop = np.array([[False], [True]])
    return x, lens, t, noise, drop


@pytest.fixture(autouse=True, scope="module")
def _jax_sides_program(systems):
    """Start :func:`_jax_sides` on a worker thread as the module starts, so
    that its trace and compile overlap the tests before the first one that
    reads it (none of which touches the JAX system)."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_sides, systems)


@pytest.fixture(scope="module")
def jax_sides(_jax_sides_program):
    return _jax_sides_program.result()


def _jax_sides(systems):
    """Both sides' JAX losses and gradients, one jitted program a side: the
    generator's compiles on a second thread while the discriminator's is
    traced."""
    jsys, params, _ = systems
    toks = jsys.tokenize_batch(texts())
    toks = [toks[k] for k in ("tokens_inter", "tokens_i1", "tokens_i2")]

    def program(mode):
        def run():
            # The conds and the tower features the mixer's head encodes are
            # constants of the loss (the JAX package stop-gradients the
            # frozen conds and the tower).
            text = (jsys._encode_cond_impl(params, *toks),
                    [jsys.text.clip_features(params["text"], tok) for tok in toks], toks)
            return _jax_loss_and_grads(jsys, params, text, mode, SIDES[mode][0])
        return jax.jit(run).lower()

    with ThreadPoolExecutor(len(SIDES)) as pool:
        runs = {mode: pool.submit(lambda low=program(mode): low.compile()()) for mode in SIDES}
        return {mode: run.result() for mode, run in runs.items()}


def _jax_loss_and_grads(jsys, params, text, mode, keys):
    """The JAX loss (the body of MixerTrainer's step, with t, noise and the
    cond drop injected) and its gradient with respect to ``keys``.  The
    mixer head's three conds are encoded inside the differentiated function
    from the tower's features; the frozen conds are constants."""
    from mixermdm_tpu.diffusion.mixer_diffusion import mixer_training_losses
    from mixermdm_tpu.models.clip_text import eot_pool
    from mixermdm_tpu.systems.in2in import generate_src_mask

    x, lens, t, noise, drop = _train_inputs()
    cond0, feats, toks = text
    head = jsys.text.post["mixer"]
    n_frozen = cond0.shape[1] - 3 * jsys.text_dim

    def loss_fn(train):
        p = {**params, **{k: v for k, v in train.items() if k != "post_mixer"}}
        cond = cond0
        if "post_mixer" in train:
            mix = [eot_pool(head.apply({"params": train["post_mixer"]}, f), tok)
                   for f, tok in zip(feats, toks)]
            cond = jnp.concatenate([cond0[:, :n_frozen]] + mix, axis=1)
        cond = cond * (1.0 - jnp.asarray(drop, jnp.float32))
        lp = {"mixer": jsys.mixer_params(p), "disc_i": p["disc_i"], "disc_I": p["disc_I"]}
        losses = mixer_training_losses(
            jsys._mixer_forward,
            lambda pp, *a, train=False, rngs=None: jsys.disc_i.apply({"params": pp}, *a),
            lambda pp, *a, train=False, rngs=None: jsys.disc_I.apply({"params": pp}, *a),
            lp, jsys.train_schedule, jnp.asarray(x), jnp.asarray(t), cond,
            generate_src_mask(T, jnp.asarray(lens), B), jax.random.PRNGKey(0), mode=mode,
            align=True, normalizer1=jsys.normalizer1, normalizer2=jsys.normalizer2,
            cond_slices=jsys.mixer_cfg.cond_slices(), nfeats=F, noise=jnp.asarray(noise))
        return losses["total"], losses

    train = {k: (params["text"]["post_mixer"] if k == "post_mixer" else params[k]) for k in keys}
    (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(train)
    return losses, grads


def _port_grads(tsys, mode, keys):
    """The port's losses and the gradients of ``keys`` (module paths)."""
    x, lens, t, noise, drop = _train_inputs()
    params = [p for k in keys for p in tsys.get_submodule(k).parameters()]
    for p in params:
        p.requires_grad_(True)
    try:
        toks = tsys.tokenize_batch(texts())
        cond = tsys.encode_cond(toks["tokens_inter"], toks["tokens_i1"], toks["tokens_i2"])
        losses = tsys.compute_loss(torch.from_numpy(x), torch.from_numpy(lens), cond, mode=mode,
                                   t=torch.from_numpy(t), noise=torch.from_numpy(noise),
                                   drop=torch.from_numpy(drop), dropout=False)
        grads = torch.autograd.grad(losses["total"], params)
    finally:
        for p in params:
            p.requires_grad_(False)
    names = [f"{k}.{n}" for k in keys for n, _ in tsys.get_submodule(k).named_parameters()]
    return losses, dict(zip(names, grads))


SIDES = {"generator": (("core", "post_mixer"), ("core", "text.post.mixer")),
         "discriminator": (("disc_i", "disc_I"), ("disc_i", "disc_I"))}


@pytest.mark.parametrize("mode", ["generator", "discriminator"])
def test_losses_and_gradients_match_jax(mode, systems, jax_sides):
    """Each side's losses and the gradients of its trainable subtrees (the
    mixer core and its post-encoder head; the two discriminators) against
    ``jax.value_and_grad`` of the same loss, mapped onto the port's
    parameter names through the export mapping."""
    from mixermdm_tpu_torch.weights import (
        MIXER_RENAMES, export_clip_post_encoder, export_discriminator, export_mixer_core,
        rename,
    )

    jsys, params, tsys = systems
    jkeys, tkeys = SIDES[mode]
    want_losses, jgrads = jax_sides[mode]
    got_losses, tgrads = _port_grads(tsys, mode, tkeys)
    for key in (f"{mode}_i1", f"{mode}_i2", f"{mode}_I", "total"):
        np.testing.assert_allclose(float(got_losses[key].detach()), float(want_losses[key]),
                                   atol=1e-5, rtol=1e-4, err_msg=key)
    sd = {}
    if mode == "generator":
        export_mixer_core(jgrads["core"], sd)
        export_clip_post_encoder(jgrads["post_mixer"], "clipTransEncoder", "clip_ln", sd)
    else:
        export_discriminator(jgrads["disc_i"], "discriminator_i", sd)
        export_discriminator(jgrads["disc_I"], "discriminator_I", sd)
    want = rename(sd, MIXER_RENAMES)
    assert sorted(want) == sorted(tgrads)
    scale = max(np.abs(w).max() for w in want.values())
    assert scale > 0
    for name, w in want.items():
        np.testing.assert_allclose(_np32(tgrads[name]), w, atol=1e-4 * scale, rtol=1e-3,
                                   err_msg=name)


# ------------------------------------------------------------------- optimizer

@pytest.mark.parametrize("nan_guard", [0, 2])
def test_optimizer_matches_optax_make_adamw(nan_guard):
    """Four calls of clip(0.5) -> AdamW inside 2-step accumulation on a small
    tree, one call with a gradient above the clip norm and one below; with
    ``nan_guard`` the second call's gradient is non-finite and skipped."""
    import optax

    from mixermdm_tpu.train.optim import make_adamw
    from mixermdm_tpu_torch.train.optim import AdamW

    rng = np.random.default_rng(5)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    p0 = [(rng.standard_normal(s) * 1e-3).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
             for scale in (0.5, 0.05, 0.3, 0.02)]
    if nan_guard:
        grads[1][0][0, 0] = np.nan
    tx = make_adamw(1e-5, 1e-4, 0.5, 2, nan_guard=nan_guard)
    jp = [jnp.asarray(a) for a in p0]
    state = tx.init(jp)
    tp = [torch.from_numpy(a.copy()) for a in p0]
    opt = AdamW(tp, lr=1e-5, weight_decay=1e-4, grad_acc_steps=2, nan_guard=nan_guard)
    for g in grads:
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a)
        opt.step()
    for a, b, init in zip(tp, jp, p0):
        assert not np.array_equal(a.numpy(), init)
        np.testing.assert_allclose(a.numpy() - init, np.asarray(b) - init, atol=1e-9, rtol=1e-5)


# -------------------------------------------------------------------- trainer

def test_trainer_updates_only_the_side_it_trains():
    """A generator step changes only the mixer core and its text head (the
    update comes on the second call of the 2-step accumulation); a
    discriminator step only the two discriminators.  The CLIP towers and the
    denoisers never change."""
    from mixermdm_tpu_torch.cli.infer_mixermdm import build_system
    from mixermdm_tpu_torch.train.trainer import DISC_KEYS, GEN_KEYS, MixerTrainer

    torch.manual_seed(0)
    system = build_system(tiny=True, device="cpu", seed=1, zero_init_std=0.02, train=True)
    trainer = MixerTrainer(system, lr=1e-3, grad_acc_steps=2)
    rng = np.random.default_rng(2)
    batch = {"motions": torch.from_numpy(rng.standard_normal((2, 12, 2 * F)).astype(np.float32)),
             "motion_lens": torch.tensor([12, 9]), **system.tokenize_batch(texts())}
    gen = torch.Generator().manual_seed(3)

    def snapshot():
        return {k: v.clone() for k, v in system.state_dict().items()}

    def changed(before):
        return {k for k, v in system.state_dict().items() if not torch.equal(v, before[k])}

    def under(keys):
        return {k for k in system.state_dict() if k.startswith(tuple(p + "." for p in keys))}

    for mode, keys in (("generator", GEN_KEYS), ("discriminator", DISC_KEYS)):
        before = snapshot()
        losses = trainer.side_step(mode, batch, gen)
        assert torch.isfinite(losses["total"])
        assert not changed(before)                      # first call: accumulated only
        trainer.side_step(mode, batch, gen)
        moved = changed(before)
        assert moved and moved <= under(keys), sorted(moved - under(keys))[:5]
        assert not any(p.requires_grad for p in system.parameters())


# ------------------------------------------------------------ text heads (f32)

def test_text_heads_stay_f32_and_conds_move_toward_jax(systems):
    """After ``cast_(torch.bfloat16)`` every post-encoder head of the three
    text pipelines is f32 and the towers bf16; the conds then lie closer to
    the JAX package's (bf16 tower, f32 head: ``compute_dtype`` bf16 on its
    TextPipelines) than the former port's, which ran the heads in bf16 on
    bf16 features."""
    from mixermdm_tpu_torch.models.clip_text import eot_pool

    jsys, params, tsys = systems
    sys_bf = copy.deepcopy(tsys).cast_(torch.bfloat16)
    for tp in sys_bf.text_pipelines():
        assert all(p.dtype == torch.float32 for p in tp.post.parameters())
        assert all(p.dtype == torch.bfloat16 for p in tp.clip.parameters())
    batch = texts()
    toks = sys_bf.tokenize_batch(batch)
    with torch.no_grad():
        fixed = sys_bf.encode_cond(toks["tokens_inter"], toks["tokens_i1"], toks["tokens_i2"])
        old_sys = copy.deepcopy(tsys)
        for p in old_sys.parameters():
            p.data = p.data.to(torch.bfloat16)

        def old_enc(tp, tok, head):
            return eot_pool(tp.post[head](tp.clip(tok)), tok).float()

        old = torch.cat([old_enc(old_sys.model2.text, toks[k], "interaction")
                         for k in ("tokens_inter", "tokens_i1", "tokens_i2")]
                        + [old_enc(old_sys.model1.text, toks[k], "individual")
                           for k in ("tokens_i1", "tokens_i2")]
                        + [old_enc(old_sys.text, toks[k], "mixer")
                           for k in ("tokens_inter", "tokens_i1", "tokens_i2")], dim=1)
    jt = jsys.tokenize_batch(batch)
    pipes = (jsys.model1.text, jsys.model2.text, jsys.text)
    prev = [tp.compute_dtype for tp in pipes]
    try:
        for tp in pipes:
            tp.compute_dtype = jnp.bfloat16
        want = jax.jit(jsys._encode_cond_impl)(params, jt["tokens_inter"], jt["tokens_i1"],
                                               jt["tokens_i2"])
    finally:
        for tp, d in zip(pipes, prev):
            tp.compute_dtype = d
    w = _np32(want)
    fro = {name: float(np.linalg.norm(_np32(c) - w) / np.linalg.norm(w))
           for name, c in (("fixed", fixed), ("former", old))}
    err_fixed, err_old = _rel(fixed, want), _rel(old, want)
    print(f"conds vs JAX bf16-tower/f32-head: fixed {err_fixed:.4g}, former {err_old:.4g} "
          f"(max |diff| / max |JAX|); rel(fro) fixed {fro['fixed']:.4g}, "
          f"former {fro['former']:.4g}")
    assert fixed.dtype == torch.float32
    assert err_fixed < err_old and fro["fixed"] < fro["former"]


# ----------------------------------------------------------- checkpoint layout

def test_training_cli_writes_the_released_layout(tmp_path, systems):
    """The state dict the training CLI saves is the released MixerMDM.ckpt
    layout: the JAX package's export of the same parameters has the same
    keys and values, and its converter reads the file back."""
    from mixermdm_tpu.train import checkpoint as ck
    from mixermdm_tpu_torch.cli import train_mixermdm
    from mixermdm_tpu_torch.weights import released_mixermdm_state_dict

    _, params, tsys = systems
    sd = released_mixermdm_state_dict(tsys)
    want = ck.export_mixermdm_system(params)
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)

    out = train_mixermdm.run(["--tiny", "--device", "cpu", "--max-steps", "2",
                              "--out-dir", str(tmp_path), "--log-jsonl",
                              str(tmp_path / "steps.jsonl")])
    assert len(out["records"]) == 2
    assert all(np.isfinite(r["g_total"]) and np.isfinite(r["d_total"]) for r in out["records"])
    back = ck.convert_mixermdm_system(ck.load_torch_state_dict(out["checkpoint"]),
                                      mixer_blocks=1, clip_layers=2)
    core = out["system"].core
    np.testing.assert_array_equal(
        np.asarray(back["core"]["text_embed"]["kernel"]).T, core.text_embed.weight.numpy())
    assert (tmp_path / "steps.jsonl").read_text().count("\n") == 2
