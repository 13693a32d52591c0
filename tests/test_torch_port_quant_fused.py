"""The W8A8 blocks' fused quantising epilogues, on the CPU: ``attention_q8``
(the attention output quantised per row in the attention kernel's epilogue)
and the quantising GELU product ``linear_q8(..., activation="gelu",
quant_out=True)`` (the FFN hidden quantised in the first product's
epilogue), each in place of its producer followed by ``quant_rows``.

Their plain versions are checked here at width 128 / head dim 64, the
smallest width the JAX package fuses; ``chip_smoke.py`` holds the CUDA
kernels to them, and bitwise to ``quant_rows`` of the unfused kernel's
output, on the card.  Inputs come from a numpy seed and go to both packages
as numpy arrays.

Tolerances:
* the plain versions against ``quant_rows_plain`` of the unfused plain
  composition, and against the JAX package's ``_quant_act`` of the same
  values: bitwise (int8 values and f32 scales);
* against ``_quant_act`` of the JAX composition (the Pallas attention in
  interpret mode; the JAX int8 product ``_qdot8`` with the q8 FFN kernel's
  rational-erf GELU): scales within ``SCALE_REL`` and int8 values within one
  step on at most ``DIFFER_SHARE`` of them, since the two packages' f32
  values differ in their last bits (the order of the softmax's sums; erf
  against a rational approximation of it, |err| < 1.5e-7), and a value on
  a rounding boundary may then move by one step.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixermdm_tpu.ops.attention as jattn
import mixermdm_tpu.ops.fused_block as jblock
from mixermdm_tpu_torch import ops

lq = importlib.import_module("mixermdm_tpu_torch.ops.linear_q8")

E, H, D, B, T = 128, 2, 64, 2, 13
SCALE_REL = 1e-5
DIFFER_SHARE = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _assert_bitwise(got, want):
    (g8, gs), (w8, ws) = got, want
    assert g8.dtype == torch.int8 and gs.dtype == torch.float32
    assert torch.equal(g8, w8) and torch.equal(gs, ws)


def _assert_jax_bitwise(got, values):
    """``_quant_act`` of the same values, in the JAX package."""
    x8_j, s_j = jblock._quant_act(jnp.asarray(values.float().numpy()))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(x8_j))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(s_j)[..., 0])


def _assert_near_jax(got, want_values):
    """``_quant_act`` of the JAX composition's values."""
    x8_j, s_j = (np.asarray(a) for a in jblock._quant_act(want_values))
    g8, gs = (a.numpy() for a in got)
    np.testing.assert_allclose(gs, s_j[..., 0], rtol=SCALE_REL, atol=0)
    diff = np.abs(g8.astype(np.int32) - x8_j.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= DIFFER_SHARE, (diff.max(), diff.mean())


# ------------------------------------------------------------- attention_q8

@pytest.fixture(scope="module")
def attn_inputs():
    """q, k, v (B, H, T, D) and a key mask: the first sequence with a padded
    tail, the second with its values all zero (an all-zero output row)."""
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(3))
    v[1] = 0.0
    kpm = np.zeros((B, T), bool)
    kpm[0, -4:] = True
    return q, k, v, kpm


# (the W8A8 block, the dtype of the output it quantises, the compute dtype)
ATTN_FORMS = {"sa": (torch.float32, torch.bfloat16), "ca": (torch.bfloat16, torch.bfloat16),
              "sa_f32": (torch.float32, torch.float32)}


@pytest.mark.parametrize("form", sorted(ATTN_FORMS))
def test_attention_q8_plain_is_quant_rows_of_the_unfused_composition(attn_inputs, form):
    out_dtype, dt = ATTN_FORMS[form]
    q, k, v, kpm = attn_inputs
    tq, tk, tv = (_t(a, dt) for a in (q, k, v))
    tm = torch.from_numpy(kpm)
    got = ops.attention_q8(tq, tk, tv, tm, True, out_dtype=out_dtype)  # CPU: the plain version
    _assert_bitwise(got, ops.attention_q8_plain(tq, tk, tv, tm, True, out_dtype=out_dtype))
    unfused = ops.fused_attention_plain(tq, tk, tv, tm, None, True, out_dtype=out_dtype)
    merged = unfused.transpose(1, 2).reshape(B, T, E)
    assert merged.dtype == out_dtype
    _assert_bitwise(got, ops.quant_rows_plain(merged))
    _assert_jax_bitwise(got, merged)
    assert got[0].shape == (B, T, E) and got[1].shape == (B, T)
    # the all-zero rows: scale 1e-8 / 127, every value 0
    assert not got[0][1].any()
    assert torch.equal(got[1][1], torch.full((T,), 1e-8) / torch.full((T,), 127.0))


def test_attention_q8_plain_matches_jax_composition(attn_inputs):
    """The SA form in f32: ``_quant_act`` of the Pallas attention (interpret
    mode) with its heads merged, as ``_sa_block_kernel_q8`` quantises it."""
    q, k, v, kpm = attn_inputs
    got = ops.attention_q8_plain(_t(q), _t(k), _t(v), torch.from_numpy(kpm), True)
    a = jattn.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kpm),
                              None, zero_attn=True, interpret=True)
    _assert_near_jax(got, jnp.transpose(a, (0, 2, 1, 3)).reshape(B, T, E))


# ------------------------------------------------- the quantising GELU product

@pytest.fixture(scope="module")
def gelu_inputs():
    """(x8, x scales, w8 (N, K), w scales, bias) at K = 128 and N = 200 (no
    multiple of either tile width), the last row of x all zero."""
    rng = np.random.default_rng(12)
    M, K, N = 9, E, 200
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[-1] = 0.0
    x8, xs = ops.quant_rows_plain(_t(x))
    w8, ws = ops.quantize_weight(_t(rng.uniform(-1, 1, (N, K)) / np.sqrt(K)))
    return x8, xs, w8, ws, _t(0.1 * rng.standard_normal(N))


@pytest.mark.parametrize("with_bias", [True, False])
def test_gelu_q8_plain_is_quant_rows_of_the_unfused_composition(gelu_inputs, with_bias):
    x8, xs, w8, ws, b = gelu_inputs
    b = b if with_bias else None
    got = ops.linear_q8(x8, xs, w8, ws, b, activation="gelu", quant_out=True)  # CPU: plain
    _assert_bitwise(got, ops.linear_q8_gelu_q8_plain(x8, xs, w8, ws, b))
    hidden = ops.linear_q8_plain(x8, xs, w8, ws, b, activation="gelu")
    assert hidden.dtype == torch.float32
    _assert_bitwise(got, ops.quant_rows_plain(hidden))
    _assert_jax_bitwise(got, hidden)
    if not with_bias:  # the zero row: gelu(0) = 0 everywhere, scale 1e-8 / 127
        assert not got[0][-1].any()
        assert float(got[1][-1]) == float(torch.tensor(1e-8) / torch.tensor(127.0))


def test_gelu_q8_plain_matches_jax_composition(gelu_inputs):
    """``_quant_act`` of the JAX int8 product ``_qdot8`` + b1 and the q8 FFN
    kernel's GELU (``_ffn_kernel``, its rational erf)."""
    x8, xs, w8, ws, b = gelu_inputs
    got = ops.linear_q8_gelu_q8_plain(x8, xs, w8, ws, b)
    h = jblock._qdot8(jnp.asarray(x8.numpy()), jnp.asarray(xs.numpy())[:, None],
                      jnp.asarray(w8.numpy().T), jnp.asarray(ws.numpy())[None, :])
    h = h + jnp.asarray(b.numpy())
    h = 0.5 * h * (1.0 + jblock._erf(h * (2.0 ** -0.5)))
    _assert_near_jax(got, h)


def test_quant_out_needs_the_gelu_hidden(gelu_inputs):
    x8, xs, w8, ws, b = gelu_inputs
    with pytest.raises(ValueError, match="quant_out"):
        ops.linear_q8(x8, xs, w8, ws, b, quant_out=True)


# ------------------------------------------------------------- the W8A8 blocks

def _block_weights(rng, n_out, n_in):
    w = _t(rng.uniform(-1, 1, (n_out, n_in)) / np.sqrt(n_in))
    return (*ops.quantize_weight(w), _t(0.1 * rng.standard_normal(n_out)))


@pytest.mark.parametrize("block", ["sa", "ca", "ffn"])
def test_q8_blocks_are_the_fused_plain_compositions(block):
    """Each W8A8 block's plain version is its prologue, the products and the
    new fused plain versions in the place of producer + ``quant_rows``, bit
    for bit, in f32 (the CPU tests' dtype)."""
    rng = np.random.default_rng(13)
    x, xf = (_t(0.5 * rng.standard_normal((B, T, E))) for _ in range(2))
    mods = [_t(0.2 * rng.standard_normal((B, E))) for _ in range(4)]
    if block == "ffn":
        w1, w2 = _block_weights(rng, 2 * E, E), _block_weights(rng, E, 2 * E)
        got = ops.fused_ffn_block_q8(x, mods[0], mods[1], *w1, *w2, residual=True)
        x8, xs = ops.adaln_modulate_q8_plain(x, mods[0], mods[1])
        h8, hs = ops.linear_q8(x8, xs, *w1, activation="gelu", quant_out=True)
        want = ops.linear_q8_plain(h8, hs, *w2, dtype=x.dtype, residual=x)
        assert torch.equal(got, want)
        return
    wqkv, wo = _block_weights(rng, 3 * E, E), _block_weights(rng, E, E)
    kpm = torch.zeros(B, T, dtype=torch.bool)
    kpm[1, -3:] = True
    if block == "sa":
        got = ops.fused_sa_block_q8(x, mods[0], mods[1], *wqkv, *wo, kpm, n_heads=H)
        x8, xs = ops.adaln_modulate_q8_plain(x, mods[0], mods[1])
        q, k, v = ops.linear_q8_plain(x8, xs, *wqkv, dtype=x.dtype).split(E, dim=-1)
        out_dtype = torch.float32
    else:
        got = ops.fused_ca_block_q8(x, xf, *mods, *wqkv, *wo, kpm, n_heads=H)
        x8, xs = ops.adaln_modulate_q8_plain(x, mods[0], mods[1])
        f8, fs = ops.adaln_modulate_q8_plain(xf, mods[2], mods[3])
        w8, s8, b8 = wqkv
        q = ops.linear_q8_plain(x8, xs, w8[:E], s8[:E], b8[:E], dtype=x.dtype)
        k, v = ops.linear_q8_plain(f8, fs, w8[E:], s8[E:], b8[E:], dtype=x.dtype).split(E, -1)
        out_dtype = x.dtype
    heads = [t.view(B, T, H, D).transpose(1, 2) for t in (q, k, v)]
    a8, as_ = ops.attention_q8(*heads, kpm, True, out_dtype=out_dtype)
    assert torch.equal(got, ops.linear_q8_plain(a8, as_, *wo, dtype=x.dtype))


# ------------------------------------------------- off the CPU: kernel or raise

META_CALLS = {
    "attention_q8": lambda m: ops.attention_q8(*(m(B, H, T, D) for _ in range(3))),
    "linear_q8_gelu_q8": lambda m: ops.linear_q8(
        m(B, T, E, dtype=torch.int8), m(B, T), m(2 * E, E, dtype=torch.int8), m(2 * E),
        m(2 * E, dtype=torch.bfloat16), activation="gelu", quant_out=True),
}


@pytest.mark.parametrize("name", sorted(META_CALLS))
def test_fused_entry_points_never_run_plain_versions_off_the_cpu(name):
    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match="expected CUDA tensors"):
        META_CALLS[name](meta)
    with ops.plain_versions():
        x8, s = META_CALLS[name](meta)
    assert x8.device.type == "meta" and x8.dtype == torch.int8 and s.dtype == torch.float32
