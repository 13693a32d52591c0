"""The port's diffusion engine against the JAX package's, on the CPU in
float32: every schedule array; ``p_mean_variance`` over the mean and
variance types and the q / p arithmetic around it; the DDIM step at eta 0.5
and the DDPM step; ``p_sample_loop`` with prefix inpainting, translation
pinning and a ``cond_fn``, and ``ddim_sample_loop`` with eta and a
``cond_fn``, each over 10 respaced steps on the draws JAX makes, reproduced
with ``jax.random`` in its key order and handed to the port; the seven
guidance functions; the VLB functions and ``calc_bpd_loop``; the
learned-variance ``mse_training_losses``, values and gradients against
``jax.grad``; and the slice as a whole, the tiny in2IN (the sizes of
tests/test_golden.py:21-23) through ``p_sample_loop`` against the JAX
system's model function.  The chains the shipped systems run (DDIM at eta
0, DPM-Solver++) are held bit for bit to their arithmetic before this
slice.

The model functions are closed forms (``_toy``); ``cond_fn`` is the
gradient of a root-XZ target loss, taken by ``jax.grad`` and by autograd on
``x`` alone.  Tolerances: ``TOL`` (1e-5 relative, 1e-6 absolute) for a
function; ``CHAIN_TOL`` (1e-4) for a 10-step chain of closed forms; the
in2IN chain at 1e-3, the bound of the port's other whole-system chains
(tests/test_torch_port_base_systems.py: two networks' f32 sums in another
order, through 10 steps); the schedule arrays at 1e-6 relative (one f32
rounding of the same float64 values); gradients at ``GRAD_TOL`` (5e-4) of
the largest element (CPU readings: at most 1.7e-5 for the loss, 2.6e-4 for
the ``vb`` term alone, whose gradient flows through the decoder's
differences of two cdf values).  The likelihood's inputs are chosen where
f32 resolves a bin's mass (a difference of two cdf values near 1 is
otherwise a few ulps, in both packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_models import B, F, T, random_params

TOL = dict(atol=1e-6, rtol=1e-5)
CHAIN_TOL = dict(atol=1e-4, rtol=1e-4)
SLICE_TOL = dict(atol=1e-3, rtol=1e-3)
GRAD_TOL = 5e-4
STEPS, RESPACING = 100, "ddim10"
MEANS = ("start_x", "epsilon", "previous_x")
VARS = ("fixed_small", "fixed_large", "learned", "learned_range")
W = 6          # feature width of the closed-form tests
PINS = ((1, 0.4, -0.3), (5, -0.2, 0.6))


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
                               **{**TOL, **kw})


def _t(a):
    return torch.from_numpy(np.array(a))


def _scheds(respacing=RESPACING):
    from mixermdm_tpu.diffusion.schedule import named_schedule as j_named
    from mixermdm_tpu_torch.diffusion.schedule import named_schedule

    return j_named("cosine", STEPS, respacing), named_schedule("cosine", STEPS, respacing)


def _toy(lib, learned=False):
    """A closed-form model ``(x, t_orig) -> output`` for ``lib`` = jnp or
    torch: 2F channels for a learned variance (the second half in [-1, 1])."""
    cat = jnp.concatenate if lib is jnp else torch.cat

    def fn(x, t):
        s = 1e-3 * t[:, None, None]
        y = 1.5 * lib.tanh(0.7 * x + s)
        return cat([y, 0.8 * lib.tanh(0.3 * x - s)], -1) if learned else y
    return fn


def _root_loss(x):
    return -0.5 * ((x[..., 0] - 0.3) ** 2 + (x[..., 2] + 0.2) ** 2).sum()


def j_cond(x, t):
    return 0.1 * jax.grad(_root_loss)(x)


def t_cond(x, t):
    """The gradient on ``x`` alone: a detached copy, autograd enabled."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        return 0.1 * torch.autograd.grad(_root_loss(x), x)[0]


def _x(seed, shape=(B, T, W)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _steps(n, seed=3):
    return np.random.default_rng(seed).integers(0, n, size=(B,)).astype(np.int32)


# ------------------------------------------------------------------ schedule

@pytest.mark.parametrize("respacing", [None, "ddim10", "10,5"])
def test_schedule_arrays_match_jax(respacing):
    """Every array of the JAX schedule, by name, in the port's (the
    respaced betas re-derived, the posterior and fixed-large arrays)."""
    js, ts = _scheds(respacing)
    assert set(js._fields) == set(ts._fields)
    for name in js._fields:
        want, got = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        if name == "timestep_map":
            np.testing.assert_array_equal(got, want)
        else:
            assert got.dtype == np.float32, name
            np.testing.assert_allclose(got, want, atol=0, rtol=1e-6, err_msg=name)


# ------------------------------------------------------------ gaussian.py

@pytest.mark.parametrize("var_type", VARS)
@pytest.mark.parametrize("mean_type", MEANS)
def test_p_mean_variance_and_steps_match_jax(mean_type, var_type):
    """``p_mean_variance`` (with the [-1, 1] clip, which the model's output
    of up to 1.5 reaches, and a ``denoised_fn``; the chains below run
    without either), then the DDPM step from it with the same noise;
    ``model_variance`` / ``split_learned_variance`` inside, and for each
    mean type the x0 it implies."""
    import mixermdm_tpu.diffusion.gaussian as JG
    import mixermdm_tpu_torch.diffusion.gaussian as G

    js, ts = _scheds()
    learned = var_type in JG.LEARNED_VAR_TYPES
    x, noise, t = _x(0), _x(1), _steps(ts.num_timesteps)
    kw = dict(mean_type=mean_type, var_type=var_type, clip_denoised=True)
    want = JG.p_mean_variance(_toy(jnp, learned), js, jnp.asarray(x), jnp.asarray(t),
                              denoised_fn=lambda a: 0.9 * a, **kw)
    got = G.p_mean_variance(_toy(torch, learned), ts, _t(x), _t(t).long(),
                            denoised_fn=lambda a: 0.9 * a, **kw)
    for k in ("mean", "variance", "log_variance", "pred_xstart"):
        _close(np.broadcast_to(got[k].numpy(), x.shape),
               np.broadcast_to(np.asarray(want[k]), x.shape), err_msg=k)
    rng = jax.random.PRNGKey(4)
    jstep = JG.ddpm_step(js, want, jnp.asarray(t), rng)
    draw = np.asarray(jax.random.normal(rng, x.shape, jnp.float32))
    _close(G.ddpm_step(ts, got, _t(t).long(), _t(draw)), jstep)


def test_q_arithmetic_matches_jax():
    """``q_sample``, ``q_posterior_mean_variance`` and the three x0
    predictions, t == 0 included."""
    import mixermdm_tpu.diffusion.gaussian as JG
    import mixermdm_tpu_torch.diffusion.gaussian as G

    js, ts = _scheds()
    x0, xt, eps = _x(5), _x(6), _x(7)
    t = np.array([0, 7], np.int32)
    jt, tt = jnp.asarray(t), _t(t).long()
    _close(G.q_sample(ts, _t(x0), tt, _t(eps)), JG.q_sample(js, x0, jt, eps))
    for got, want in zip(G.q_posterior_mean_variance(ts, _t(x0), _t(xt), tt),
                         JG.q_posterior_mean_variance(js, x0, xt, jt)):
        _close(np.broadcast_to(got.numpy(), x0.shape), np.broadcast_to(want, x0.shape))
    _close(G.predict_xstart_from_eps(ts, _t(xt), tt, _t(eps)),
           JG.predict_xstart_from_eps(js, xt, jt, eps))
    _close(G.predict_xstart_from_xprev(ts, _t(xt), tt, _t(eps)),
           JG.predict_xstart_from_xprev(js, xt, jt, eps))


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_step_matches_jax(eta):
    """The DDIM update at eta 0 (no noise read) and 0.5 (JAX's draw handed
    over), t == 0 included (no noise there)."""
    import mixermdm_tpu.diffusion.gaussian as JG
    import mixermdm_tpu_torch.diffusion.gaussian as G

    js, ts = _scheds()
    x, x0 = _x(8), _x(9)
    t = np.array([0, 6], np.int32)
    rng = jax.random.PRNGKey(2)
    want = JG.ddim_step(js, jnp.asarray(x), jnp.asarray(t), jnp.asarray(x0), rng, eta)
    draw = _t(jax.random.normal(rng, x.shape, jnp.float32)) if eta else None
    _close(G.ddim_step(ts, _t(x), _t(t).long(), _t(x0), eta, draw), want)


def _jax_chain_draws(rng, shape, n, *, ddim=False, pre_shape=None, pins=0):
    """The draws of JAX's ``p_sample_loop`` (or ``ddim_sample_loop`` at eta
    > 0) in its key order: the initial split, then per step ``step_rng``,
    ``seq_rng`` and ``pin_rng`` (one ``fold_in`` a pinned frame).  Returns
    the port's ``(noise, step_noise)``."""
    rng, init_rng = jax.random.split(rng)
    init = _t(jax.random.normal(init_rng, shape, jnp.float32))
    steps = []
    for _ in range(n):
        rng, step_rng = jax.random.split(rng)
        d = {"x": jax.random.normal(step_rng, shape, jnp.float32)}
        if not ddim and pre_shape is not None:
            rng, seq_rng = jax.random.split(rng)
            d["prefix"] = jax.random.normal(seq_rng, pre_shape, jnp.float32)
        if not ddim and pins:
            rng, pin_rng = jax.random.split(rng)
            d["pin"] = jnp.stack([jax.random.normal(jax.random.fold_in(pin_rng, i), (2,),
                                                    jnp.float32) for i in range(pins)])
        steps.append({k: _t(v) for k, v in d.items()})
    return init, steps


def test_p_sample_loop_matches_jax():
    """The DDPM chain over 10 respaced steps, fixed-large variance, epsilon
    prediction: the first 3 frames inpainted from ``pre_seq``, two frames'
    root XZ pinned and the mean shifted by ``cond_fn``."""
    import mixermdm_tpu.diffusion.gaussian as JG
    import mixermdm_tpu_torch.diffusion.gaussian as G

    js, ts = _scheds()
    shape = (B, T, W)
    pre = _x(11, (B, 3, W))
    kw = dict(mean_type="epsilon", var_type="fixed_large", transl_req=PINS)
    rng = jax.random.PRNGKey(7)
    want = JG.p_sample_loop(_toy(jnp), js, shape, rng, pre_seq=jnp.asarray(pre),
                            cond_fn=j_cond, **kw)
    noise, steps = _jax_chain_draws(rng, shape, ts.num_timesteps, pre_shape=pre.shape,
                                    pins=len(PINS))
    got = G.p_sample_loop(_toy(torch), ts, shape, noise=noise, step_noise=steps,
                          pre_seq=_t(pre), cond_fn=t_cond, **kw)
    _close(got, want, **CHAIN_TOL)


def test_ddim_sample_loop_eta_and_cond_fn_match_jax():
    """DDIM at eta 0.5 with ``cond_fn`` (score conditioning), learned-range
    variance (the split taken), 10 respaced steps."""
    import mixermdm_tpu.diffusion.gaussian as JG
    import mixermdm_tpu_torch.diffusion.gaussian as G

    js, ts = _scheds()
    shape = (B, T, W)
    kw = dict(eta=0.5, var_type="learned_range", clip_denoised=True)
    rng = jax.random.PRNGKey(9)
    want = JG.ddim_sample_loop(_toy(jnp, True), js, shape, rng, cond_fn=j_cond, **kw)
    noise, steps = _jax_chain_draws(rng, shape, ts.num_timesteps, ddim=True)
    got = G.ddim_sample_loop(_toy(torch, True), ts, shape, noise=noise, step_noise=steps,
                             cond_fn=t_cond, **kw)
    _close(got, want, **CHAIN_TOL)


def test_shipped_chains_keep_their_arithmetic():
    """DDIM at eta 0 without ``cond_fn`` (with trajectory control and a warm
    start) and DPM-Solver++: bit for bit the chains as they stood before
    this engine, written out here (the x0, then the update)."""
    import mixermdm_tpu_torch.diffusion.gaussian as G

    _, s = _scheds()
    shape = (B, T, 270)
    model = _toy(torch)
    noise, ctl = _t(_x(12, shape)), _t(_x(13, shape))
    kw = dict(noise=noise, traj_control=ctl, skip_timesteps=2, init_image=ctl)
    n = s.num_timesteps - 2
    t0 = torch.full((B,), n - 1)
    img = G.q_sample(s, ctl, t0, noise)
    for i in reversed(range(n)):
        img = G._apply_traj_control(img, ctl)
        t = torch.full((B,), i)
        pred = model(img, s.timestep_map[t])
        ab = s.alphas_cumprod_prev[t].reshape(B, 1, 1)
        eps = ((s.sqrt_recip_alphas_cumprod[t].reshape(B, 1, 1) * img - pred)
               / s.sqrt_recipm1_alphas_cumprod[t].reshape(B, 1, 1))
        img = pred * torch.sqrt(ab) + torch.sqrt(1 - ab) * eps
    assert torch.equal(G.ddim_sample_loop(model, s, shape, **kw), pred)
    sig, alp, phi, c2 = G.dpmpp_coefficients(s, n)
    img, prev = G.q_sample(s, ctl, t0, noise), torch.zeros(shape)
    for j in range(n):
        img = G._apply_traj_control(img, ctl)
        x0 = model(img, s.timestep_map[torch.full((B,), n - 1 - j)])
        img = sig[j] * img - alp[j] * phi[j] * ((1.0 + c2[j]) * x0 - c2[j] * prev)
        prev = x0
    assert torch.equal(G.dpmpp_sample_loop(model, s, shape, **kw), prev)


# ------------------------------------------------------------ guidance.py

GUIDANCE = ("condition_mean", "condition_score", "ddim_reverse_step", "ddim_encode_loop",
            "apply_prefix_inpainting", "apply_translation_pinning", "warm_start_noise")


@pytest.mark.parametrize("name", GUIDANCE)
def test_guidance_matches_jax(name):
    import mixermdm_tpu.diffusion.gaussian as JG
    import mixermdm_tpu.diffusion.guidance as JGd
    import mixermdm_tpu_torch.diffusion.gaussian as G
    import mixermdm_tpu_torch.diffusion.guidance as Gd

    js, ts = _scheds()
    x, x0 = _x(20), _x(21)
    t = _steps(ts.num_timesteps, seed=22)
    jt, tt = jnp.asarray(t), _t(t).long()
    rng = jax.random.PRNGKey(5)
    if name in ("condition_mean", "condition_score"):
        kw = dict(mean_type="epsilon", var_type="fixed_small")
        jp = JG.p_mean_variance(_toy(jnp), js, jnp.asarray(x), jt, **kw)
        tp = G.p_mean_variance(_toy(torch), ts, _t(x), tt, **kw)
        want = getattr(JGd, name)(j_cond, js, jp, jnp.asarray(x), jt)
        got = getattr(Gd, name)(t_cond, ts, tp, _t(x), tt)
        if name == "condition_score":
            _close(got["mean"], want["mean"])
            got, want = got["pred_xstart"], want["pred_xstart"]
    elif name == "ddim_reverse_step":
        want = JGd.ddim_reverse_step(js, x, jt, x0)
        got = Gd.ddim_reverse_step(ts, _t(x), tt, _t(x0))
    elif name == "ddim_encode_loop":
        want = JGd.ddim_encode_loop(_toy(jnp), js, jnp.asarray(x0), mean_type="epsilon")
        got = Gd.ddim_encode_loop(_toy(torch), ts, _t(x0), mean_type="epsilon")
        _close(got, want, **CHAIN_TOL)
        return
    elif name == "apply_prefix_inpainting":
        pre = x0[:, :3]
        want = JGd.apply_prefix_inpainting(js, jnp.asarray(x), jt, jnp.asarray(pre), rng)
        draw = _t(jax.random.normal(rng, pre.shape, jnp.float32))
        got = Gd.apply_prefix_inpainting(ts, _t(x), tt, _t(pre), draw)
    elif name == "apply_translation_pinning":
        want = JGd.apply_translation_pinning(js, jnp.asarray(x), jt, PINS, rng, dims=(0, 2))
        draw = torch.stack([_t(jax.random.normal(jax.random.fold_in(rng, i), (2,),
                                                 jnp.float32)) for i in range(len(PINS))])
        got = Gd.apply_translation_pinning(ts, _t(x), tt, PINS, draw, dims=(0, 2))
    else:
        want = JGd.warm_start_noise(js, jnp.asarray(x0), rng, x0.shape, skip_timesteps=3)
        draw = _t(jax.random.normal(rng, x0.shape, jnp.float32))
        got = Gd.warm_start_noise(ts, _t(x0), draw, skip_timesteps=3)
    _close(got, want)


# ----------------------------------------------------------------- vlb.py

def _edge_values():
    """Data in [-1, 1] with values at and beyond the +-0.999 branch points."""
    x = np.tanh(_x(30))
    x[0, 0, :6] = [-1.0, -0.9995, -0.999, 0.999, 0.9995, 1.0]
    return x


VLB = ("normal_kl", "approx_standard_normal_cdf", "discretized_gaussian_log_likelihood",
       "vb_terms_bpd", "prior_bpd", "calc_bpd_loop")


@pytest.mark.parametrize("name", VLB)
def test_vlb_matches_jax(name):
    import mixermdm_tpu.diffusion.vlb as JV
    import mixermdm_tpu_torch.diffusion.vlb as V

    js, ts = _scheds()
    x0, a, b = _edge_values(), _x(31), _x(32)
    if name == "normal_kl":
        want = JV.normal_kl(a, 0.3 * b, b, -0.2 * a)
        got = V.normal_kl(_t(a), _t(0.3 * b), _t(b), _t(-0.2 * a))
        _close(V.normal_kl(_t(a), _t(b), 0.0, 0.0), JV.normal_kl(a, b, 0.0, 0.0))
    elif name == "approx_standard_normal_cdf":
        want, got = JV.approx_standard_normal_cdf(3 * a), V.approx_standard_normal_cdf(_t(3 * a))
    elif name == "discretized_gaussian_log_likelihood":
        # means near the data and narrow bins: the bin's mass is a difference
        # of two cdf values, which f32 resolves only where it is not tiny
        means, log_scales = x0 + 0.02 * a, -3.5 + 0.2 * b
        want = np.asarray(JV.discretized_gaussian_log_likelihood(x0, means, log_scales))
        got = V.discretized_gaussian_log_likelihood(_t(x0), _t(means), _t(log_scales)).numpy()
        branch = np.where(x0 < -0.999, 0, np.where(x0 > 0.999, 2, 1))
        assert (branch[0, 0, :6] == [0, 0, 1, 1, 2, 2]).all()
        # each value is its own branch's (the other branches differ by > 1 here)
        for k in range(3):
            _close(got[branch == k], want[branch == k])
    elif name == "vb_terms_bpd":
        t = np.array([0, 6], np.int32)
        xt = _x(33)
        for var_type in VARS:
            learned = var_type in ("learned", "learned_range")
            kw = dict(mean_type="epsilon", var_type=var_type, clip_denoised=True)
            w = JV.vb_terms_bpd(_toy(jnp, learned), js, x0, xt, jnp.asarray(t), **kw)
            g = V.vb_terms_bpd(_toy(torch, learned), ts, _t(x0), _t(xt), _t(t).long(), **kw)
            _close(g["output"], w["output"], err_msg=var_type)
            _close(g["pred_xstart"], w["pred_xstart"], err_msg=var_type)
        return
    elif name == "prior_bpd":
        want, got = JV.prior_bpd(js, jnp.asarray(x0)), V.prior_bpd(ts, _t(x0))
    else:
        # a model near the identity, as a denoiser is near t == 0: the
        # decoder's bins then hold mass that f32 resolves (see above)
        rng = jax.random.PRNGKey(8)
        want = JV.calc_bpd_loop(lambda x, t: 0.98 * x, js, jnp.asarray(x0), rng,
                                clip_denoised=True)
        draws = []
        for _ in range(ts.num_timesteps):
            rng, step_rng = jax.random.split(rng)
            draws.append(_t(jax.random.normal(step_rng, x0.shape, jnp.float32)))
        got = V.calc_bpd_loop(lambda x, t: 0.98 * x, ts, _t(x0), noise=torch.stack(draws),
                              clip_denoised=True)
        assert got["vb"].shape == (B, ts.num_timesteps)
        for k in want:
            _close(got[k], want[k], err_msg=k, **CHAIN_TOL)
        return
    _close(got, want)


# ------------------------------------------------------ learned variance

@pytest.mark.parametrize("var_type", ["learned", "learned_range"])
@pytest.mark.parametrize("mean_type", MEANS)
def test_learned_variance_loss_and_gradients_match_jax(mean_type, var_type):
    """``mse_training_losses`` with a learned variance on a linear model
    (F -> 2F), t == 0 (the decoder's term) and t > 0: the terms, and the
    gradient of the mean loss against ``jax.grad``; the ``vb`` term's
    gradient reaches the variance half of the model alone (exactly zero on
    the mean half's weights, in both packages)."""
    import mixermdm_tpu.diffusion.gaussian as JG
    import mixermdm_tpu_torch.diffusion.gaussian as G

    js, ts = _scheds()
    x0, noise = _edge_values(), _x(40)
    w0 = (0.3 * np.random.default_rng(41).standard_normal((W, 2 * W))).astype(np.float32)
    t = np.array([0, 5], np.int32)
    rescale = mean_type == "start_x"
    kw = dict(mean_type=mean_type, var_type=var_type, rescale_vb=rescale)

    def j_terms(w):
        return JG.mse_training_losses(lambda x, tt: x @ w + 1e-3 * tt[:, None, None], js,
                                      jnp.asarray(x0), jnp.asarray(t), None,
                                      noise=jnp.asarray(noise), **kw)

    def j_pair(w):
        terms = j_terms(w)
        return (terms["loss"].mean(), terms["vb"].sum()), terms

    _, vjp, want = jax.vjp(j_pair, jnp.asarray(w0), has_aux=True)
    (want_grad,), (want_vb_grad,) = vjp((1.0, 0.0)), vjp((0.0, 1.0))
    w = _t(w0).requires_grad_(True)
    got = G.mse_training_losses(lambda x, tt: x @ w + 1e-3 * tt[:, None, None], ts, _t(x0),
                                _t(t).long(), noise=_t(noise), **kw)
    for k in ("mse", "vb", "loss", "target", "pred", "x_t"):
        _close(got[k].detach(), want[k], err_msg=k)
    got_grad, = torch.autograd.grad(got["loss"].mean(), w, retain_graph=True)
    vb_grad, = torch.autograd.grad(got["vb"].sum(), w)
    assert not vb_grad[:, :W].any() and not np.asarray(want_vb_grad)[:, :W].any()
    assert vb_grad[:, W:].abs().max() > 0
    for g, wg in ((got_grad, want_grad), (vb_grad, want_vb_grad)):
        wg = np.asarray(wg)
        gap = np.abs(g.numpy() - wg).max() / np.abs(wg).max()
        assert gap <= GRAD_TOL, gap


# ------------------------------------------------------- the slice whole

def test_in2in_p_sample_loop_matches_jax():
    """The tiny in2IN interaction system (4-way CFG), its weights carried
    across with the port's ``weights.py``, through ``p_sample_loop`` over
    its 5-step respaced schedule against JAX's ``p_sample_loop`` on the JAX
    system's model function; the same draws (the controls are held on the
    closed-form model above)."""
    import mixermdm_tpu.diffusion.gaussian as JG
    from mixermdm_tpu.models.cfg import cfg_model_multiple
    from mixermdm_tpu_torch.diffusion.gaussian import p_sample_loop
    from mixermdm_tpu_torch.weights import load_in2in_params
    from tests.test_torch_port_base_systems import jax_in2in, port_in2in

    jsys = jax_in2in("interaction")
    params = random_params(jsys, seed=21)
    tsys = load_in2in_params(port_in2in("interaction"), params)
    cond = (0.5 * np.random.default_rng(50).standard_normal((B, 3 * jsys.text_dim))
            ).astype(np.float32)
    apply = jsys.denoiser_apply("interaction", cast=True)
    c = jsys.cfg
    jmodel = cfg_model_multiple(lambda x, t, m, k: apply(params["denoiser_interaction"],
                                                         x, t, m, k),
                                float(c.CFG_WEIGHT), float(c.CFG_WEIGHT_INTERACTION),
                                float(c.CFG_WEIGHT_INDIVIDUAL))
    tmodel = tsys.cfg_model()
    shape = (B, T, 2 * F)
    rng = jax.random.PRNGKey(3)
    want = JG.p_sample_loop(lambda x, t: jmodel(x, t, None, jnp.asarray(cond)),
                            jsys.sample_schedule, shape, rng)
    s = tsys.sample_schedule
    noise, steps = _jax_chain_draws(rng, shape, s.num_timesteps)
    with torch.no_grad():
        got = p_sample_loop(lambda x, t: tmodel(x, t, None, _t(cond)), s, shape, noise=noise,
                            step_noise=steps)
    assert got.shape == shape and bool(torch.isfinite(got).all())
    _close(got, want, **SLICE_TOL)
