"""The port's W8A8 path (``QUANT_FROZEN``) against the JAX package's int8
Pallas kernels, on the CPU.

The JAX side runs as its own tests run it (tests/test_pallas_ops.py): the
Pallas kernels in interpret mode (``FORCE_INTERPRET``), the fused blocks
forced on (``set_pallas_attention(True)``) and the width gate lowered to the
tiny widths.  The port's side is its plain versions, which the CPU runs;
``chip_smoke.py`` holds the CUDA kernels against them on the card.  Inputs
and weights come from a numpy seed and go to both sides as numpy arrays.

Tolerances:
* weight quantisation: bitwise (int8 values and f32 scales);
* the integer product of ``linear_q8_plain``: exact against int64;
* the three q8 entry points in f32: max |port - JAX| <= 1e-4 of max |JAX|
  (readings 5.5e-8 to 3.7e-7: both sides quantise the same f32 values, so
  only the order of f32 sums differs; the int8 path lies 2.2e-3 to 1.1e-2
  from the unquantised one);
* one interaction denoiser and one CFG mixer step of a tiny system in bf16:
  ``BF16_TOL`` of max |JAX|, see there.
Every case also shows that int8 ran: the q8 output differs from the same
call without quantisation by more than the port-vs-JAX limit.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixermdm_tpu.ops.attention as jattn
import mixermdm_tpu.ops.fused_block as jblock
from mixermdm_tpu.models import layers as jlayers
from mixermdm_tpu_torch import ops
from mixermdm_tpu_torch.models import layers as tlayers
from tests.test_torch_port_models import F, TD, normalizer_stats, random_params

F32_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny; one intra-op thread per test worker keeps the
    port's tests from oversubscribing the cores the other workers share."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _np(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _fro(got, want) -> float:
    """||got - want|| / ||want||."""
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-6))


# ------------------------------------------------------ (a) weight quantisation

@pytest.mark.parametrize("shape", [(128, 384), (512, 256)])
def test_quantize_weight_is_bitwise_the_jax_one(shape):
    """JAX quantises an (in, out) weight per output column, the port the
    (out, in) torch weight per row: the same int8 values and scales."""
    rng = np.random.default_rng(shape[0])
    w = rng.uniform(-1, 1, shape).astype(np.float32) / np.sqrt(shape[0])
    w[:, 3] = 0.0  # an all-zero channel takes the 1e-8 floor
    w8_j, s_j = jblock.quantize_weight(_j(w))
    w8_t, s_t = ops.quantize_weight(_t(w.T))
    assert w8_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(w8_t.numpy(), np.asarray(w8_j).T)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j).reshape(-1))


def test_quant_rows_is_bitwise_the_jax_one():
    """Activation quantisation (``_quant_act``), from f32 and from bf16 rows,
    including a zero row and values on the rounding midpoints."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((9, 256)).astype(np.float32)
    x[2] = 0.0
    x[4, :4] = [127.0, 63.5, -0.5, 1.5]  # s = 1: ties round to even
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        x8_j, s_j = jblock._quant_act(_j(x).astype(jdt))
        x8_t, s_t = ops.quant_rows_plain(_t(x, dt))
        np.testing.assert_array_equal(x8_t.numpy(), np.asarray(x8_j))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j).reshape(-1))


# ------------------------------------------------- (d) the exact int8 product

def test_linear_q8_plain_integer_product_is_exact():
    """Sums above 2^24 (all-127 rows over K = 2048) are exact: the plain
    version's dequantisation starts from the int64 sum."""
    rng = np.random.default_rng(6)
    M, K, N = 5, 2048, 48
    x8 = rng.integers(-127, 128, (M, K)).astype(np.int8)
    w8 = rng.integers(-127, 128, (N, K)).astype(np.int8)
    x8[0] = 127
    w8[0] = 127
    w8[1] = -127
    xs = rng.random(M).astype(np.float32) + 0.5
    ws = rng.random(N).astype(np.float32) + 0.5
    b = rng.standard_normal(N).astype(np.float32)
    acc = torch.from_numpy(x8).long() @ torch.from_numpy(w8).long().t()
    assert acc.abs().max() > 2 ** 24
    want = acc.float() * torch.from_numpy(xs)[:, None] * torch.from_numpy(ws) + _t(b)
    got = ops.linear_q8_plain(torch.from_numpy(x8), torch.from_numpy(xs), torch.from_numpy(w8),
                              torch.from_numpy(ws), _t(b), dtype=torch.float32)
    assert torch.equal(got, want)
    exact = torch.from_numpy(x8).double() @ torch.from_numpy(w8).double().t()
    assert torch.equal(exact, acc.double())


# ------------------------------------------------------- (b) the entry points

def _weights(rng, n_in, n_out):
    bound = 1.0 / np.sqrt(n_in)
    return (rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32),
            (0.1 * rng.standard_normal(n_out)).astype(np.float32))


def _mha(rng, E):
    """JAX (wq, bq, wk, bk, wv, bv, wo, bo) and the torch layout's
    (w_qkv, b_qkv, w_o, b_o)."""
    (wq, bq), (wk, bk), (wv, bv), (wo, bo) = (_weights(rng, E, E) for _ in range(4))
    jax_w = [_j(a) for a in (wq, bq, wk, bk, wv, bv, wo, bo)]
    return jax_w, (_t(np.concatenate([wq.T, wk.T, wv.T])), _t(np.concatenate([bq, bk, bv])),
                   _t(wo.T), _t(bo))


def _q8(w, b):
    """(w8, scale, bias) of a torch-layout weight."""
    return (*ops.quantize_weight(w), b)


# (block, E, heads or FFN width, residual, key padding mask / AdaLN)
BLOCK_CASES = [
    ("sa", 128, 2, False, False),
    ("sa", 256, 2, True, True),
    ("ca", 128, 2, True, True),
    ("ca", 256, 2, False, False),
    ("ffn", 128, 256, True, True),
    ("ffn", 256, 512, False, False),
]


@pytest.mark.parametrize("block,E,hf,residual,flag", BLOCK_CASES)
def test_q8_entry_points_match_jax_in_f32(block, E, hf, residual, flag):
    """fused_{sa,ca,ffn}_block_q8 (plain versions) against the Pallas q8
    kernels in interpret mode, T = 13, in f32.  The unquantised reference of
    the int8 check is the port's own plain block (tests/test_torch_port_ops.py
    holds it against the unquantised Pallas kernels)."""
    rng = np.random.default_rng(E + hf + residual)
    B, T = 2, 13
    x = (0.5 * rng.standard_normal((B, T, E))).astype(np.float32)
    xf = (0.5 * rng.standard_normal((B, T, E))).astype(np.float32)
    mods = [(0.2 * rng.standard_normal((B, E))).astype(np.float32) for _ in range(4)]
    kpm = None
    if flag and block != "ffn":
        kpm = np.zeros((B, T), bool)
        kpm[1, -4:] = True
    jm = None if kpm is None else jnp.asarray(kpm)
    tm = None if kpm is None else torch.from_numpy(kpm)
    jk = {"residual": residual, "interpret": True, "quant": True}

    def jit(fn, **kw):  # one trace of the interpret-mode kernel instead of op-by-op dispatch
        return jax.jit(functools.partial(fn, **jk, **kw))

    if block == "ffn":
        (w1, b1), (w2, b2) = _weights(rng, E, hf), _weights(rng, hf, E)
        jmods = [_j(mods[0]), _j(mods[1])] if flag else [None, None]
        tmods = [_t(mods[0]), _t(mods[1])] if flag else [None, None]
        want = jit(jblock.fused_ffn_block)(_j(x), *jmods, _j(w1), _j(b1), _j(w2), _j(b2))
        tw = (_t(w1.T), _t(b1), _t(w2.T), _t(b2))
        got = ops.fused_ffn_block_q8(_t(x), *tmods, *_q8(*tw[:2]), *_q8(*tw[2:]),
                                     residual=residual)
        unquantised = ops.fused_ffn_block_plain(_t(x), *tmods, *tw, residual=residual)
    else:
        jw, tw = _mha(rng, E)
        q8w = (*_q8(*tw[:2]), *_q8(*tw[2:]))
        kw = {"n_heads": hf, "residual": residual}
        if block == "sa":
            want = jit(jblock.fused_sa_block, n_heads=hf)(_j(x), _j(mods[0]), _j(mods[1]),
                                                          *jw, jm)
            got = ops.fused_sa_block_q8(_t(x), _t(mods[0]), _t(mods[1]), *q8w, tm, **kw)
            unquantised = ops.fused_sa_block_plain(_t(x), _t(mods[0]), _t(mods[1]), *tw, tm,
                                                   **kw)
        else:
            tmods = [_t(m) for m in mods]
            want = jit(jblock.fused_ca_block, n_heads=hf)(_j(x), _j(xf),
                                                          *[_j(m) for m in mods], *jw, jm)
            got = ops.fused_ca_block_q8(_t(x), _t(xf), *tmods, *q8w, tm, **kw)
            unquantised = ops.fused_ca_block_plain(_t(x), _t(xf), *tmods, *tw, tm, **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = _rel(got, want)
    assert err <= F32_TOL, f"port vs JAX q8: {err:.3g}"
    gap = _rel(unquantised, want)
    assert gap > 1e-3, f"q8 vs unquantised only {gap:.3g}: int8 did not run"


# --------------------------------------------- (c) the tiny system in bf16

# A width the JAX package fuses (LATENT % 128 == 0, head dim 64) and the gate
# lowered to it; one layer per network keeps interpret mode cheap.
SL, SFF, SNL, SNH = 128, 256, 1, 2
SB, ST = 1, 12
# Every AdaLN of the three networks gets an outlier channel (scale bias 40 on
# channel 0, so the modulated activation carries one value ~40x the rest).
# That is the case W8A8 handles worst: the row's int8 step grows with it,
# and the int8 error stands well above the bf16 rounding differences between
# the two packages (JAX rounds the AdaLN modulation three times in bf16 and
# takes the softmax's exp in bf16, the port rounds once from f32; near a
# rounding midpoint that flips an int8 value).  Without the outlier the two
# are the same size and no tolerance could tell int8 from bf16: the readings
# were 6.5e-3 (port q8 vs JAX q8) against 6.1e-3 (JAX q8 vs JAX bf16) for the
# denoiser (in Frobenius norm, with the JAX calls run op by op).
OUTLIER = 40.0
# Limits on ||port - JAX|| / ||JAX||, both in int8.  Readings on the CPU:
# denoiser 0.0135, CFG mixer step 0.110 (CFG scales each branch's error by
# 4.3 and the step's per-joint alignment of a random model amplifies it, as
# chip_smoke.py explains for its step check).  The JAX call without int8
# lies 0.041 and 0.336 away: each limit is below its gap.
BF16_TOL = {"denoiser": 0.025, "step": 0.2}


def _tiny_cfg():
    gen = {"NUM_LAYERS": SNL, "NUM_HEADS": SNH, "DROPOUT": 0.0, "INPUT_DIM": F,
           "LATENT_DIM": SL, "FF_SIZE": SFF}
    return {"NAME": "MixerMDM", "GENERATOR": gen, "DISCRIMINATOR": dict(gen),
            "ACTIVATION": "gelu", "DIFFUSION_STEPS": 20, "BETA_SCHEDULER": "cosine",
            "SAMPLER": "uniform", "MOTION_REP": "global", "T_BAR": 10, "STRATEGY": "ddim5",
            "CFG_WEIGHT": 3.5, "MIXING_MODE": 4, "FORCE_INFLUENCE_VAL": None,
            "QUANT_FROZEN": True}


def _with_outliers(params):
    def outlier(path, leaf):
        keys = [str(getattr(k, "key", "")) for k in path]
        if "emb_proj" in keys and keys[-1] == "bias":
            leaf = leaf.copy()
            leaf[..., 0] = OUTLIER  # the first half of the AdaLN output is the scale
        return leaf

    return {k: jax.tree_util.tree_map_with_path(outlier, v) if k in ("core", "model1", "model2")
            else v for k, v in params.items()}


@pytest.fixture(scope="module")
def q8_systems():
    """(JAX bf16 system, its mixer params cast to bf16, port bf16 system
    loaded from the same params), both with QUANT_FROZEN on."""
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

    (m1, s1), (m2, s2) = normalizer_stats()
    jc = j_tiny(latent=SL, layers=SNL, heads=SNH, diffusion_steps=20)
    jclip = JClip.tiny()
    jsys = JSystem(JConfig.wrap(_tiny_cfg()),
                   model1=JIn2IN(jc, mode="individual", clip_cfg=jclip),
                   model2=JIn2IN(jc, mode="interaction", clip_cfg=jclip), clip_cfg=jclip,
                   normalizer1=JNorm(jnp.asarray(m1), jnp.asarray(s1)),
                   normalizer2=JNorm(jnp.asarray(m2), jnp.asarray(s2)), compute_dtype="bf16")
    params = _with_outliers(random_params(jsys, seed=2))
    c = tiny_config(latent=SL, layers=SNL, heads=SNH, diffusion_steps=20)
    clip = ClipTextConfig.tiny()
    tsys = MixerMDMSystem(Config.wrap(_tiny_cfg()),
                          model1=In2INSystem(c, mode="individual", clip_cfg=clip),
                          model2=In2INSystem(c, mode="interaction", clip_cfg=clip),
                          clip_cfg=clip,
                          normalizer1=Normalizer(torch.from_numpy(m1), torch.from_numpy(s1)),
                          normalizer2=Normalizer(torch.from_numpy(m2), torch.from_numpy(s2)),
                          compute_dtype="bf16", device="cpu")
    # loaded after construction: the int8 buffers made by cast_ are stale and
    # the blocks quantise the loaded weights again at their first int8 call
    load_mixermdm_params(tsys, params)
    mp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                jsys.mixer_params(params))
    return jsys, mp, tsys


@contextlib.contextmanager
def _int8_at_tiny_width(monkeypatch):
    """Both packages' gates at the tiny width; JAX's Pallas kernels forced
    on, in interpret mode (fused_scope would otherwise pick XLA attention on
    the CPU for the denoisers)."""
    monkeypatch.setattr(jblock, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jattn, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jlayers, "use_pallas_attention", lambda: True)
    monkeypatch.setattr(jlayers, "_W8A8_MIN_DIM", SL)
    tlayers.set_w8a8_min_dim(SL)
    try:
        yield
    finally:
        tlayers.set_w8a8_min_dim(tlayers.W8A8_MIN_DIM)


def _step_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((SB, ST, 2 * F)).astype(np.float32)
    x2 = rng.standard_normal((SB, ST, 2 * F)).astype(np.float32)
    cond = (0.5 * rng.standard_normal((SB, 8 * TD))).astype(np.float32)
    mask = np.ones((SB, ST, 1), np.float32)
    mask[0, -3:] = 0.0
    return x, x2, np.array([613], np.int32), cond, mask


def _count_q8_calls(monkeypatch) -> dict:
    """Count the layers' calls of the three q8 entry points."""
    calls = {}
    for name in ("fused_sa_block_q8", "fused_ca_block_q8", "fused_ffn_block_q8"):
        def counted(*a, _fn=getattr(tlayers, name), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(tlayers, name, counted)
    return calls


def test_interaction_denoiser_q8_matches_jax_in_bf16(q8_systems, monkeypatch):
    jsys, mp, tsys = q8_systems
    x, _, t, cond, mask = _step_inputs(9)
    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(t), jnp.asarray(mask),
             jnp.asarray(cond[:, :3 * TD], jnp.bfloat16))
    jden = jsys.model2.denoisers["interaction"]

    def apply(*args):  # traced anew per call: the scopes are read at trace time
        return jax.jit(lambda *a: jden.apply({"params": mp["denoiser2"]}, *a))(*args)

    calls = _count_q8_calls(monkeypatch)
    with _int8_at_tiny_width(monkeypatch):
        ref = apply(*jargs)
        with jlayers.w8a8_scope(True):
            want = apply(*jargs)
        with torch.inference_mode(), tlayers.w8a8_scope():
            got = tsys.model2.denoisers["interaction"](
                _t(x, torch.bfloat16), torch.from_numpy(t).long(), _t(mask),
                _t(cond[:, :3 * TD], torch.bfloat16))
    assert calls == {"fused_sa_block_q8": SNL, "fused_ca_block_q8": SNL,
                     "fused_ffn_block_q8": SNL}
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err, gap = _fro(got, want), _fro(ref, want)
    assert err <= BF16_TOL["denoiser"] < gap, (err, gap)


def test_cfg_mixer_step_q8_matches_jax_in_bf16(q8_systems, monkeypatch):
    from mixermdm_tpu.models.cfg import cfg_model_x2 as j_cfg

    jsys, mp, tsys = q8_systems
    x, x2, t, cond, mask = _step_inputs(10)
    jargs = [jnp.asarray(v) for v in (x, x2, t, mask, cond)]

    def step(*args):  # traced anew per call: the scopes are read at trace time
        fn = j_cfg(lambda a, a2, tt, m, c: jsys._mixer_forward(mp, a, tt, c, m, a2)[0],
                   jsys.cfg_weight)
        return jax.jit(fn)(*args)

    calls = _count_q8_calls(monkeypatch)
    with _int8_at_tiny_width(monkeypatch):
        ref = step(*jargs)
        with jlayers.w8a8_scope(True):
            want = step(*jargs)
        got = tsys.cfg_mixer_step(_t(x), _t(x2), torch.from_numpy(t).long(), _t(cond), _t(mask))
    # the CFG branches ride in one batch: one call per block of each network
    assert calls == {"fused_sa_block_q8": 3 * SNL, "fused_ca_block_q8": 2 * SNL,
                     "fused_ffn_block_q8": 3 * SNL}
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    err, gap = _fro(got, want), _fro(ref, want)
    assert err <= BF16_TOL["step"] < gap, (err, gap)
