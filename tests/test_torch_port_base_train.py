"""The port's base-model training against the JAX package's, on the CPU in
float32: the interaction and geometric losses, ``motion_training_losses`` in
both person modes, the loss-second-moment schedule sampler, ``AdamW``
without clipping and with the cosine warmup schedule, in2IN interaction's
``compute_loss`` and its gradients, the losses of individual in2IN, MDM and
InterGen, and one ``BaseTrainer`` step.

Sizes are the port's test sizes (tests/test_torch_port_models.py: L 64, FF
128, 2 layers, 4 heads, B 2, T 8; ``ClipTextConfig.tiny``).  JAX parameters
come from ``jax.eval_shape`` filled from numpy and reach the port through
``weights.py``.  The JAX loss draws its own noise: the port's noise goes
into it through a ``monkeypatch`` of
``mixermdm_tpu.diffusion.gaussian.mse_training_losses`` (which
``motion_training_losses`` imports at call time); t is injected, the cond
drop is 0 and dropout is 0.

Tolerances: losses atol 1e-5 / rtol 1e-4; gradients atol 1e-4 x (largest
gradient) / rtol 1e-3; the optimizer 1e-5 relative on the parameters'
change; a trainer step's change 1e-3 of lr where the gradient is resolved;
the sampler's history bitwise, its weights 1e-6.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_base_systems import jax_in2in, port_in2in, texts
from tests.test_torch_port_models import B, F, NH, NL, L, T, normalizer_stats, random_params

LOSS_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np32(a):
    return np.asarray(a.detach().float().numpy() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _inject_noise(monkeypatch, noise):
    """The JAX MSE pipeline with the port's noise."""
    import mixermdm_tpu.diffusion.gaussian as jg

    monkeypatch.setattr(jg, "mse_training_losses",
                        functools.partial(jg.mse_training_losses, noise=jnp.asarray(noise)))


def _norms():
    from mixermdm_tpu.utils.normalizer import Normalizer as JNorm
    from mixermdm_tpu_torch.utils.normalizer import Normalizer

    (m1, s1), (m2, s2) = normalizer_stats()
    return ((JNorm(jnp.asarray(m1), jnp.asarray(s1)), Normalizer(torch.from_numpy(m1),
                                                                 torch.from_numpy(s1))),
            (JNorm(jnp.asarray(m2), jnp.asarray(s2)), Normalizer(torch.from_numpy(m2),
                                                                 torch.from_numpy(s2))))


def _skeleton_motion(rng, persons, scale=0.3, jitter=0.004):
    """Raw-space (B, T, persons, 262) motions whose joints move little from
    frame to frame (so the foot-contact mask is not empty) and whose two
    persons stand close (so the distance-map masks are not empty)."""
    base = rng.standard_normal((B, 1, persons, F)) * scale
    return (base + jitter * rng.standard_normal((B, T, persons, F))).astype(np.float32)


# --------------------------------------------------------------- the losses

@pytest.mark.parametrize("which", ["inter", "geometric", "geometric_individual"])
def test_losses_match_jax(which):
    """``inter_loss`` (simple, DM, JA, RO) and ``geometric_loss`` (VEL, BL,
    FC; in individual mode the simple MSE) on prediction / target pairs of
    normalised motions, a padding mask and a timestep gate with one sample
    on, every masked term non-empty."""
    from mixermdm_tpu.diffusion import losses as jl
    from mixermdm_tpu_torch.diffusion import losses as tl

    rng = np.random.default_rng(4)
    (_, _), (jn, tn) = _norms()
    P = 2 if which == "inter" else 1
    tgt_raw = _skeleton_motion(rng, P)
    pred_raw = tgt_raw + 0.005 * rng.standard_normal(tgt_raw.shape).astype(np.float32)
    pred = _np32(tn.forward(torch.from_numpy(pred_raw)))
    tgt = _np32(tn.forward(torch.from_numpy(tgt_raw)))
    mask = np.ones((B, T, P, 1), np.float32)
    mask[1, -2:] = 0.0
    tmask = np.array([1.0, 0.0], np.float32)
    if which == "inter":
        want = jax.jit(lambda *a: jl.inter_loss(*a, jn))(
            *(jnp.asarray(a) for a in (pred, tgt, mask, tmask)))
        got = tl.inter_loss(*(torch.from_numpy(a) for a in (pred, tgt, mask, tmask)), tn)
        for k in ("DM", "JA", "RO"):
            assert float(want[k]) != 0.0, k
    else:
        mode = "individual" if which.endswith("individual") else "interaction"
        args = (pred[:, :, 0], tgt[:, :, 0], mask[:, :, 0], tmask)
        want = jax.jit(lambda *a: jl.geometric_loss(*a, jn, "A", mode=mode))(
            *(jnp.asarray(a) for a in args))
        got = tl.geometric_loss(*(torch.from_numpy(a) for a in args), tn, "A", mode=mode)
        if mode == "interaction":
            for k in ("VEL", "BL", "FC"):
                assert float(want[k]) != 0.0, k
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **LOSS_TOL)


# -------------------------------------------------------------- the sampler

def test_loss_second_moment_sampler_matches_jax():
    """History, counts and weights after updates that fill some timesteps'
    histories, overfill others (the shift) and warm all of them; a batch
    with a timestep twice goes in batch order.  Then the draw takes the
    weights' support and the importance weights are 1 / (T p[t])."""
    from mixermdm_tpu.diffusion import samplers as js
    from mixermdm_tpu_torch.diffusion.samplers import LossSecondMomentSampler

    n = 6
    rng = np.random.default_rng(11)
    jstate = js.loss_aware_init(n)
    j_update, j_weights = jax.jit(js.loss_aware_update), jax.jit(js.loss_aware_weights)
    port = LossSecondMomentSampler(n)
    assert np.allclose(port.weights().numpy(), 1.0 / n)
    batches = [np.array([0, 0, 3, 5, 5, 5])] + [rng.integers(0, n, n) for _ in range(20)]
    batches += [np.arange(n)] * 10
    for i, tb in enumerate(batches):
        losses = rng.random(len(tb)).astype(np.float32) + 0.1 * i
        jstate = j_update(jstate, jnp.asarray(tb), jnp.asarray(losses))
        port.update(torch.from_numpy(tb), torch.from_numpy(losses))
        np.testing.assert_array_equal(port.history.numpy(), np.asarray(jstate.history))
        np.testing.assert_array_equal(port.counts.numpy(), np.asarray(jstate.counts))
        np.testing.assert_allclose(port.weights().numpy(), np.asarray(j_weights(jstate)),
                                   rtol=1e-6)
    p = port.weights()
    assert not torch.allclose(p, torch.full_like(p, 1.0 / n))       # warmed up
    t, w = port.sample(torch.Generator().manual_seed(0), 64)
    assert t.min() >= 0 and t.max() < n
    torch.testing.assert_close(w, 1.0 / (n * p[t]))
    sd = port.state_dict()
    other = LossSecondMomentSampler(n)
    other.load_state_dict(sd)
    assert torch.equal(other.history, port.history) and torch.equal(other.counts, port.counts)


# ------------------------------------------------------------ the optimizer

def test_adamw_without_clipping_and_cosine_schedule_matches_optax():
    """Five updates of the base trainer's optimizer (no clipping, lr 1e-4,
    wd 2e-5, the cosine warmup schedule with a warmup of 3 over 10) on
    gradients far above the mixer's clip norm, against optax
    ``make_adamw(clip_norm=None, schedule=cosine_warmup_schedule(...))``;
    the state_dict round trip continues bitwise."""
    import optax

    from mixermdm_tpu.train.optim import cosine_warmup_schedule as j_sched
    from mixermdm_tpu.train.optim import make_adamw
    from mixermdm_tpu_torch.train.optim import AdamW, cosine_warmup_schedule

    rng = np.random.default_rng(5)
    shapes = [(4, 3), (5,)]
    p0 = [(rng.standard_normal(s) * 1e-2).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 3.0).astype(np.float32) for s in shapes]
             for _ in range(5)]
    for c in range(12):
        assert np.isclose(cosine_warmup_schedule(1e-4, 3, 10)(c),
                          float(j_sched(1e-4, 3, 10)(jnp.asarray(c))), rtol=1e-6)
    tx = make_adamw(1e-4, 2e-5, None, 1, schedule=j_sched(1e-4, 3, 10))
    jp = [jnp.asarray(a) for a in p0]
    state = tx.init(jp)

    @jax.jit
    def j_step(g, state, p):
        upd, state = tx.update(g, state, p)
        return optax.apply_updates(p, upd), state

    tp = [torch.from_numpy(a.copy()) for a in p0]
    opt = AdamW(tp, lr=1e-4, weight_decay=2e-5, clip_norm=None,
                schedule=cosine_warmup_schedule(1e-4, 3, 10))
    saved = None
    for i, g in enumerate(grads):
        jp, state = j_step([jnp.asarray(a) for a in g], state, jp)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a)
        opt.step()
        if i == 2:
            saved = ([p.clone() for p in tp], opt.state_dict())
    for a, b, init in zip(tp, jp, p0):
        np.testing.assert_allclose(a.numpy() - init, np.asarray(b) - init, atol=1e-9, rtol=1e-5)
    params, sd = saved
    again = AdamW(params, lr=1e-4, weight_decay=2e-5, clip_norm=None,
                  schedule=cosine_warmup_schedule(1e-4, 3, 10))
    again.load_state_dict(sd)
    for g in grads[3:]:
        for p, a in zip(params, g):
            p.grad = torch.from_numpy(a)
        again.step()
    assert all(torch.equal(a, b) for a, b in zip(params, tp))


# ------------------------------------------------- compute_loss, gradients

def _batch(seed, persons):
    rng = np.random.default_rng(seed)
    x = _skeleton_motion(rng, persons).reshape(B, T, persons * F)
    return (x, np.array([T, T - 3]), np.array([4, 13]),
            rng.standard_normal(x.shape).astype(np.float32))


@pytest.fixture(scope="module")
def interaction():
    """(JAX in2IN interaction system, its numpy params, the port's training
    build loaded from them)."""
    from mixermdm_tpu_torch.weights import load_in2in_params

    jsys = jax_in2in("interaction")
    params = random_params(jsys, seed=30)
    return jsys, params, load_in2in_params(port_in2in("interaction", train=True), params)


@pytest.fixture(autouse=True, scope="module")
def _jax_program(interaction):
    """Start :func:`_jax_interaction_grads` on a worker thread as the module
    starts, so that its trace and compile overlap the tests before the
    ones that read it (which do not touch the JAX noise injection)."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_interaction_grads, interaction)


@pytest.fixture(scope="module")
def jax_interaction_grads(_jax_program):
    return _jax_program.result()


def _jax_interaction_grads(interaction):
    """The JAX loss of in2IN interaction and its gradients with respect to
    the denoiser and the post-encoder head (the trainable subtrees of the
    JAX BaseTrainer), as one jitted program; the tower's features are
    constants of it, as in the JAX package."""
    import mixermdm_tpu.diffusion.gaussian as jg
    from mixermdm_tpu.models.clip_text import eot_pool

    jsys, params, _ = interaction
    x, lens, t, noise = _batch(21, 2)
    toks = jsys.tokenize_batch(texts())
    toks = [toks[k] for k in ("tokens", "tokens_i1", "tokens_i2")]
    head = jsys.text.post["interaction"]
    orig = jg.mse_training_losses
    jg.mse_training_losses = functools.partial(orig, noise=jnp.asarray(noise))
    try:
        def run():
            feats = [jsys.text.clip_features(params["text"], tok) for tok in toks]

            def loss_fn(train):
                p = {**params, "denoiser_interaction": train["den"]}
                cond = jnp.concatenate([eot_pool(head.apply({"params": train["post"]}, f), tok)
                                        for f, tok in zip(feats, toks)], axis=1)
                losses = jsys.compute_loss(p, jnp.asarray(x), jnp.asarray(lens), cond,
                                           jax.random.PRNGKey(0), cond_mask_prob=0.0,
                                           t=jnp.asarray(t))
                return losses["total"], losses

            train = {"den": params["denoiser_interaction"],
                     "post": params["text"]["post_interaction"]}
            return jax.value_and_grad(loss_fn, has_aux=True)(train)

        (_, losses), grads = jax.jit(run)()
    finally:
        jg.mse_training_losses = orig
    tree = {"text": {"clip": params["text"]["clip"], "post_interaction": grads["post"]},
            "denoiser_interaction": grads["den"]}
    return losses, tree


def _port_loss_grads(tsys, x, lens, t, noise):
    from mixermdm_tpu_torch.train.trainer import subtree_state

    named = subtree_state(tsys, tsys.TRAIN_MODULES)
    for p in named.values():
        p.requires_grad_(True)
    try:
        cond = tsys.encode_cond_tokens(tsys.tokenize_batch(texts()))
        losses = tsys.compute_loss(torch.from_numpy(x), torch.from_numpy(lens), cond,
                                   t=torch.from_numpy(t), noise=torch.from_numpy(noise),
                                   drop=torch.zeros(B, 1, dtype=torch.bool), dropout=False)
        grads = torch.autograd.grad(losses["total"], list(named.values()))
    finally:
        for p in named.values():
            p.requires_grad_(False)
    return losses, dict(zip(named, grads))


def test_interaction_loss_and_gradients_match_jax(interaction, jax_interaction_grads):
    """in2IN interaction's ``compute_loss`` (every term) and the gradients
    of its trainable subtrees, the denoiser and the interaction head,
    against ``jax.value_and_grad`` of the JAX loss, mapped onto the port's
    names through the export mapping; the tower gets none."""
    from mixermdm_tpu_torch.weights import in2in_state_dict

    jsys, params, tsys = interaction
    assert tsys.TRAIN_MODULES == ("denoisers.interaction", "text.post")
    assert all(p.dtype == torch.float32 for p in tsys.parameters())
    want_losses, gtree = jax_interaction_grads
    got_losses, grads = _port_loss_grads(tsys, *_batch(21, 2))
    assert sorted(got_losses) == sorted(want_losses)
    for k in want_losses:
        np.testing.assert_allclose(_np32(got_losses[k]), np.asarray(want_losses[k]),
                                   err_msg=k, **LOSS_TOL)
    want = {k: v for k, v in in2in_state_dict(gtree, "interaction").items() if k in grads}
    assert sorted(want) == sorted(grads)
    scale = max(np.abs(v).max() for v in want.values())
    assert scale > 0
    for k, v in want.items():
        np.testing.assert_allclose(_np32(grads[k]), v, atol=1e-4 * scale, rtol=1e-3, err_msg=k)


def test_base_trainer_step_matches_jax(interaction, jax_interaction_grads, monkeypatch):
    """One ``BaseTrainer`` step (t from its sampler, here the test's t; the
    noise, no cond drop, no dropout) against the JAX step: optax
    ``make_adamw(1e-4, 2e-5, None)`` on the JAX gradients.  A first Adam
    step moves a parameter by about lr times the sign of its gradient, so
    the change is held at 1e-3 of lr, element by element, wherever the
    gradient is resolved (above the gradient test's atol)."""
    import copy

    import optax

    from mixermdm_tpu.train.optim import make_adamw
    from mixermdm_tpu_torch.train.trainer import BaseTrainer, subtree_state
    from mixermdm_tpu_torch.weights import in2in_state_dict

    jsys, params, tsys0 = interaction
    _, gtree = jax_interaction_grads
    tsys = copy.deepcopy(tsys0)
    x, lens, t, noise = _batch(21, 2)
    trainer = BaseTrainer(tsys)
    assert trainer.sampler_name == "uniform" and trainer.opt.clip_norm is None
    monkeypatch.setattr(trainer.sampler, "sample",
                        lambda gen, b, dev: (torch.from_numpy(t), torch.ones(b)))
    loss = functools.partial(type(tsys).compute_loss, tsys, noise=torch.from_numpy(noise),
                             drop=torch.zeros(B, 1, dtype=torch.bool), dropout=False)
    monkeypatch.setattr(tsys, "compute_loss", loss)
    before = {k: v.clone() for k, v in subtree_state(tsys, trainer.keys).items()}
    trainer.step({"motions": torch.from_numpy(x), "motion_lens": torch.from_numpy(lens),
                  **tsys.tokenize_batch(texts())}, torch.Generator().manual_seed(0))
    after = subtree_state(tsys, trainer.keys)

    tx = make_adamw(1e-4, 2e-5, None, 1)
    train = {"text": {"clip": params["text"]["clip"],
                      "post_interaction": params["text"]["post_interaction"]},
             "denoiser_interaction": params["denoiser_interaction"]}

    @jax.jit
    def jax_step(g, p):
        upd, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, upd)

    want = in2in_state_dict(jax_step(gtree, train), "interaction")
    gsd = in2in_state_dict(gtree, "interaction")
    gscale = max(np.abs(gsd[k]).max() for k in after)
    deltas = {k: (_np32(after[k]) - _np32(before[k]), np.asarray(want[k]) - _np32(before[k]))
              for k in after}
    scale = max(np.abs(w).max() for _, w in deltas.values())
    assert 5e-5 < scale < 2e-4
    held = total = 0
    for k, (got, w) in deltas.items():
        # Where the gradient is below what the gradient test resolves (a
        # key bias's gradient is 0 up to rounding, for one), Adam's first
        # step is +-lr by the sign of that rounding: not compared.
        resolved = np.abs(gsd[k]) > 1e-4 * gscale
        held, total = held + resolved.sum(), total + resolved.size
        np.testing.assert_allclose(got[resolved], w[resolved], atol=1e-3 * scale, rtol=0,
                                   err_msg=k)
    assert held > 0.5 * total, (held, total)
    assert trainer.step_count == 1


@pytest.mark.parametrize("mode", ["interaction", "individual"])
def test_motion_training_losses_match_jax(mode, monkeypatch):
    """The whole base loss over a fixed model function (the same map of
    x_t and t on both sides), the port's noise injected into JAX: every
    term and ``mse_per_sample``."""
    from mixermdm_tpu.diffusion.losses import motion_training_losses as j_mtl
    from mixermdm_tpu.diffusion.schedule import named_schedule as j_sched
    from mixermdm_tpu_torch.diffusion.losses import motion_training_losses as t_mtl
    from mixermdm_tpu_torch.diffusion.schedule import named_schedule as t_sched

    rng = np.random.default_rng(7)
    P = 2 if mode == "interaction" else 1
    (jn1, tn1), (jn2, tn2) = _norms()
    jn, tn = (jn2, tn2) if mode == "interaction" else (jn1, tn1)
    x = _skeleton_motion(rng, P).reshape(B, T, P * F)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    lens = np.array([T, T - 3])
    mask = np.stack([np.arange(T)[None] < lens[:, None]] * 2, -1).astype(np.float32)
    t = np.array([3, 15])
    w = (0.3 * rng.standard_normal(P * F)).astype(np.float32)

    _inject_noise(monkeypatch, noise)
    want = jax.jit(lambda *a: j_mtl(
        lambda xt, tt: 0.8 * xt + jnp.asarray(w) * (tt[:, None, None] / 20.0),
        j_sched("cosine", 20), *a, jax.random.PRNGKey(0), mode=mode, t_bar=10,
        normalizer=jn))(jnp.asarray(x), jnp.asarray(t), jnp.asarray(mask))
    got = t_mtl(lambda xt, tt: 0.8 * xt + torch.from_numpy(w) * (tt[:, None, None] / 20.0),
                t_sched("cosine", 20), torch.from_numpy(x), torch.from_numpy(t),
                torch.from_numpy(mask), mode=mode, t_bar=10, normalizer=tn,
                noise=torch.from_numpy(noise))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(_np32(got[k]), np.asarray(want[k]), err_msg=k, **LOSS_TOL)


# ----------------------------------------------- the other families' losses

def _family(name):
    """(JAX system, numpy params, port training build) of individual in2IN,
    MDM or InterGen at the test sizes."""
    from mixermdm_tpu.config import Config as JConfig
    from mixermdm_tpu.models.clip_text import ClipTextConfig as JClip
    from mixermdm_tpu_torch import weights as W
    from mixermdm_tpu_torch.config import Config, tiny_config
    from mixermdm_tpu_torch.models.clip_text import ClipTextConfig

    if name == "individual":
        jsys = jax_in2in("individual")
        params = random_params(jsys, seed=31)
        return jsys, params, W.load_in2in_params(port_in2in("individual", train=True), params)
    (jn1, tn1), (jn2, tn2) = _norms()
    c = dict(tiny_config(latent=L, layers=NL, heads=NH, diffusion_steps=20), NAME=name)
    if name == "MDM":
        from mixermdm_tpu.systems import MDMSystem as J
        from mixermdm_tpu_torch.systems.mdm import MDMSystem as P
        jn, tn, load = jn1, tn1, W.load_mdm_params
    else:
        from mixermdm_tpu.systems import InterGenSystem as J
        from mixermdm_tpu_torch.systems.intergen import InterGenSystem as P
        jn, tn, load = jn2, tn2, W.load_intergen_params
    jsys = J(JConfig.wrap(c), clip_cfg=JClip.tiny(), normalizer=jn)
    params = random_params(jsys, seed=32)
    tsys = P(Config.wrap(c), clip_cfg=ClipTextConfig.tiny(), normalizer=tn, device="cpu",
             train=True)
    return jsys, params, load(tsys, params)


@pytest.mark.parametrize("name", ["individual", "MDM", "InterGen"])
def test_family_losses_match_jax(name, monkeypatch):
    """The losses of individual in2IN, MDM and InterGen on the same cond,
    t and noise: every term (MDM and individual in2IN take the individual
    loss, InterGen the interaction one)."""
    jsys, params, tsys = _family(name)
    persons = 2 if name == "InterGen" else 1
    x, lens, t, noise = _batch(22, persons)
    cond = np.random.default_rng(23).standard_normal(
        (B, int(tsys.cfg.LATENT_DIM) if name == "MDM" else jsys.text_dim)).astype(np.float32)
    _inject_noise(monkeypatch, noise)
    want = jax.jit(lambda p: jsys.compute_loss(p, jnp.asarray(x), jnp.asarray(lens),
                                               jnp.asarray(cond), jax.random.PRNGKey(0),
                                               cond_mask_prob=0.0, t=jnp.asarray(t)))(params)
    with torch.no_grad():
        got = tsys.compute_loss(torch.from_numpy(x), torch.from_numpy(lens),
                                torch.from_numpy(cond), t=torch.from_numpy(t),
                                noise=torch.from_numpy(noise),
                                drop=torch.zeros(B, 1, dtype=torch.bool), dropout=False)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(_np32(got[k]), np.asarray(want[k]), err_msg=k, **LOSS_TOL)
