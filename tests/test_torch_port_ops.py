"""The port's kernel entry points (their plain PyTorch versions, which the
CPU runs) against the JAX package's Pallas entry points in interpret mode,
plus the port's config reader and output smoothing.

Inputs come from a numpy seed and go through both sides as numpy arrays.
Everything runs in float32, where the two sides do the same arithmetic in
another order: the tolerance is 2e-5 absolute (the JAX package's own Pallas
tests use the same bound for these kernels against their references).
The CUDA kernels themselves cannot run here; ``chip_smoke.py`` holds them
against these plain versions on the card.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixermdm_tpu.ops import attention as jattn
from mixermdm_tpu.ops import fused_block as jblock
from mixermdm_tpu_torch import ops
from mixermdm_tpu_torch.ops import attention as tattn

ATOL = 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny; one intra-op thread per test worker keeps the
    port's tests from oversubscribing the cores the other workers share."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, dtype=np.float32))


def _close(got, want, atol=ATOL, rtol=ATOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), atol=atol, rtol=rtol)


# ---------------------------------------------------------------- config

@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "models", "*.yaml"))))
def test_yaml_subset_reader_matches_jax_loader(path):
    """The port's YAML reader (no PyYAML) gives what the JAX package's
    yaml.safe_load + yacs coercion gives, on the shipped configs."""
    from mixermdm_tpu.config import load_yaml as jax_load
    from mixermdm_tpu_torch.config import load_yaml

    assert load_yaml(path) == jax_load(path)


def test_yaml_reader_scalars():
    from mixermdm_tpu_torch.config import parse_yaml, _coerce_tree

    text = "A: 1\nB: 1.5\nC: true\nD: None\nE: 'x # y'  # c\nF:\n  G: ddim50\n  H: 1e-5\nI:\n"
    assert _coerce_tree(parse_yaml(text)) == {
        "A": 1, "B": 1.5, "C": True, "D": None, "E": "x # y",
        "F": {"G": "ddim50", "H": 1e-5}, "I": None}


# ---------------------------------------------------------------- attention

ATTN_CASES = {
    # name: (B, H, Tq, Tk, D, zero_attn, mask kind)
    "zero_attn": (2, 4, 8, 8, 16, True, None),
    "no_zero_attn": (2, 4, 8, 8, 16, False, None),
    "key_padding": (2, 4, 8, 8, 16, True, "kpm"),
    "causal": (2, 4, 8, 8, 16, False, "causal"),
    "fully_masked_row": (2, 4, 8, 8, 16, True, "masked_row"),
    "d96_cross_lengths": (2, 2, 8, 11, 96, True, "kpm"),
}


def _attn_inputs(B, H, Tq, Tk, D, kind, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, Tq, D), (B, H, Tk, D), (B, H, Tk, D)))
    kpm = amask = None
    if kind in ("kpm", "masked_row"):
        kpm = np.zeros((B, Tk), bool)
        kpm[:, -3:] = True
        if kind == "masked_row":
            kpm[1] = True
    if kind == "causal":
        amask = np.triu(np.full((Tq, Tk), -np.inf, np.float32), k=1)
    return q, k, v, kpm, amask


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_fused_attention_plain_matches_pallas(case):
    B, H, Tq, Tk, D, zero_attn, kind = ATTN_CASES[case]
    q, k, v, kpm, amask = _attn_inputs(B, H, Tq, Tk, D, kind)
    want = jattn.fused_attention(_j(q), _j(k), _j(v),
                                 None if kpm is None else jnp.asarray(kpm),
                                 None if amask is None else _j(amask),
                                 zero_attn=zero_attn, interpret=True)
    t_kpm = None if kpm is None else torch.from_numpy(kpm)
    t_amask = None if amask is None else _t(amask)
    got = ops.fused_attention_plain(_t(q), _t(k), _t(v), t_kpm, t_amask, zero_attn)
    _close(got, want)
    # the wrapper takes the plain version for a CPU tensor
    _close(ops.fused_attention(_t(q), _t(k), _t(v), t_kpm, t_amask, zero_attn), want)
    if kind == "masked_row":  # the zero key alone: output exactly 0
        assert float(got[1].abs().max()) == 0.0


@pytest.mark.parametrize("zero_attn", [True, False])
def test_reference_attention_matches_jax(zero_attn):
    q, k, v, kpm, _ = _attn_inputs(2, 3, 8, 8, 16, "masked_row", seed=1)
    want = jattn.reference_attention(_j(q), _j(k), _j(v), jnp.asarray(kpm), None, zero_attn)
    got = tattn.reference_attention(_t(q), _t(k), _t(v), torch.from_numpy(kpm), None, zero_attn)
    _close(got, want)
    # a fully masked row without zero-attn stays finite (uniform over keys)
    assert torch.isfinite(got).all()


# ---------------------------------------------------------------- blocks

E, H, FF, B, T = 64, 4, 128, 2, 8


def _block_inputs(seed, Tk=T, ffn=False):
    rng = np.random.default_rng(seed)
    mat = lambda i, o: (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)  # noqa: E731
    vec = lambda n: (0.1 * rng.standard_normal(n)).astype(np.float32)  # noqa: E731
    x = (0.5 * rng.standard_normal((B, T, E))).astype(np.float32)
    xf = (0.5 * rng.standard_normal((B, Tk, E))).astype(np.float32)
    mods = [vec((B, E)) for _ in range(4)]
    if ffn:
        return x, mods, (mat(E, FF), vec(FF), mat(FF, E), vec(E))
    return x, xf, mods, [mat(E, E) if i % 2 == 0 else vec(E) for i in range(8)]


def _torch_mha(w):
    """JAX (in, out) q/k/v/o kernels -> torch in_proj_weight (3E, E) etc."""
    wq, bq, wk, bk, wv, bv, wo, bo = w
    w_qkv = _t(np.concatenate([wq.T, wk.T, wv.T], 0))
    b_qkv = _t(np.concatenate([bq, bk, bv]))
    return w_qkv, b_qkv, _t(wo.T), _t(bo)


@pytest.mark.parametrize("residual", [False, True])
def test_fused_sa_block_plain_matches_pallas(residual):
    x, _, mods, w = _block_inputs(2)
    kpm = np.zeros((B, T), bool)
    kpm[1, -3:] = True
    want = jblock.fused_sa_block(_j(x), _j(mods[0]), _j(mods[1]), *map(_j, w), jnp.asarray(kpm),
                                 n_heads=H, residual=residual, interpret=True)
    args = (_t(x), _t(mods[0]), _t(mods[1]), *_torch_mha(w), torch.from_numpy(kpm))
    got = ops.fused_sa_block_plain(*args, n_heads=H, residual=residual)
    _close(got, want)
    _close(ops.fused_sa_block(*args, n_heads=H, residual=residual), want)


@pytest.mark.parametrize("residual", [False, True])
def test_fused_ca_block_plain_matches_pallas(residual):
    x, xf, mods, w = _block_inputs(3)
    want = jblock.fused_ca_block(_j(x), _j(xf), *map(_j, mods), *map(_j, w), None,
                                 n_heads=H, residual=residual, interpret=True)
    args = (_t(x), _t(xf), *map(_t, mods), *_torch_mha(w), None)
    got = ops.fused_ca_block_plain(*args, n_heads=H, residual=residual)
    _close(got, want)
    _close(ops.fused_ca_block(*args, n_heads=H, residual=residual), want)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("adaln", [True, False])
def test_fused_ffn_block_plain_matches_pallas(adaln, residual):
    x, mods, (w1, b1, w2, b2) = _block_inputs(4, ffn=True)
    scale, shift = (mods[0], mods[1]) if adaln else (None, None)
    want = jblock.fused_ffn_block(_j(x), None if scale is None else _j(scale),
                                  None if shift is None else _j(shift),
                                  _j(w1), _j(b1), _j(w2), _j(b2), residual=residual,
                                  interpret=True)
    args = (_t(x), None if scale is None else _t(scale), None if shift is None else _t(shift),
            _t(w1.T), _t(b1), _t(w2.T), _t(b2))
    # the JAX kernel's erf is a rational approximation (|err| < 1.5e-7)
    _close(ops.fused_ffn_block_plain(*args, residual=residual), want)
    _close(ops.fused_ffn_block(*args, residual=residual), want)


# ---------------------------------------------------------------- primitives

def test_adaln_modulate_plain_matches_jax_layer_norm():
    from mixermdm_tpu.models.layers import layer_norm

    x, _, mods, _ = _block_inputs(5)
    want = layer_norm(_j(x), eps=1e-6) * (1.0 + _j(mods[0])[:, None]) + _j(mods[1])[:, None]
    _close(ops.adaln_modulate_plain(_t(x), _t(mods[0]), _t(mods[1])), want)


@pytest.mark.parametrize("epilogue", [None, "gelu", "residual"])
def test_linear_plain(epilogue):
    import math

    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 262)).astype(np.float32)
    w = (rng.standard_normal((23, 262)) / 16).astype(np.float32)
    b = rng.standard_normal(23).astype(np.float32)
    r = rng.standard_normal((3, 5, 23)).astype(np.float32)
    want = x @ w.T + b
    if epilogue == "gelu":
        want = 0.5 * want * (1 + np.vectorize(math.erf)(want / np.sqrt(2)))
    if epilogue == "residual":
        want = want + r
    kw = {"activation": "gelu"} if epilogue == "gelu" else (
        {"residual": _t(r)} if epilogue == "residual" else {})
    _close(ops.linear_plain(_t(x), _t(w), _t(b), **kw), want, atol=1e-4, rtol=1e-4)
    _close(ops.linear(_t(x), _t(w), _t(b), **kw), want, atol=1e-4, rtol=1e-4)


def test_wrappers_take_plain_versions_on_cpu_bf16():
    """bf16 on the CPU is what the layers send the wrappers on the card's
    dtype: they must compute the plain version and count no launch."""
    ops.reset_launch_counts()
    x, xf, mods, w = _block_inputs(7)
    bf = torch.bfloat16
    args = [a.to(bf) for a in (_t(x), _t(mods[0]), _t(mods[1]), *_torch_mha(w))]
    got = ops.fused_sa_block(*args, None, n_heads=H, residual=True)
    want = ops.fused_sa_block_plain(*args, None, n_heads=H, residual=True)
    assert got.dtype == bf and torch.equal(got, want)
    assert sum(ops.launches.values()) == 0


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, device="meta", dtype=dtype)


def _meta_q8(*shape):
    """An int8 weight (shape) and its f32 scales (shape[:-1])."""
    return _meta(*shape, dtype=torch.int8), _meta(*shape[:-1], dtype=torch.float32)


# Each entry point on tensors that are not on the CPU.  A "meta" tensor
# stands in for the card here: the entry point must go for its kernel (and so
# raise, having no CUDA tensor), never run its plain version.
_E, _T, _B = 64, 8, 2
META_CALLS = {
    "linear": lambda: ops.linear(_meta(_B, _T, _E), _meta(_E, _E), _meta(_E)),
    "adaln_modulate": lambda: ops.adaln_modulate(_meta(_B, _T, _E), _meta(_B, _E),
                                                 _meta(_B, _E)),
    "fused_attention": lambda: ops.fused_attention(_meta(_B, 2, _T, 32), _meta(_B, 2, _T, 32),
                                                   _meta(_B, 2, _T, 32)),
    "fused_sa_block": lambda: ops.fused_sa_block(
        _meta(_B, _T, _E), _meta(_B, _E), _meta(_B, _E), _meta(3 * _E, _E), _meta(3 * _E),
        _meta(_E, _E), _meta(_E), n_heads=2),
    "fused_ca_block": lambda: ops.fused_ca_block(
        _meta(_B, _T, _E), _meta(_B, _T, _E), *[_meta(_B, _E) for _ in range(4)],
        _meta(3 * _E, _E), _meta(3 * _E), _meta(_E, _E), _meta(_E), n_heads=2),
    "fused_ffn_block": lambda: ops.fused_ffn_block(
        _meta(_B, _T, _E), _meta(_B, _E), _meta(_B, _E), _meta(2 * _E, _E), _meta(2 * _E),
        _meta(_E, 2 * _E), _meta(_E)),
    "quant_rows": lambda: ops.quant_rows(_meta(_B, _T, _E))[0],
    "linear_q8": lambda: ops.linear_q8(*_meta_q8(_B, _T, _E), *_meta_q8(_E, _E), _meta(_E)),
    "fused_sa_block_q8": lambda: ops.fused_sa_block_q8(
        _meta(_B, _T, _E), _meta(_B, _E), _meta(_B, _E), *_meta_q8(3 * _E, _E), _meta(3 * _E),
        *_meta_q8(_E, _E), _meta(_E), n_heads=2),
    "fused_ca_block_q8": lambda: ops.fused_ca_block_q8(
        _meta(_B, _T, _E), _meta(_B, _T, _E), *[_meta(_B, _E) for _ in range(4)],
        *_meta_q8(3 * _E, _E), _meta(3 * _E), *_meta_q8(_E, _E), _meta(_E), n_heads=2),
    "fused_ffn_block_q8": lambda: ops.fused_ffn_block_q8(
        _meta(_B, _T, _E), _meta(_B, _E), _meta(_B, _E), *_meta_q8(2 * _E, _E), _meta(2 * _E),
        *_meta_q8(_E, 2 * _E), _meta(_E)),
}


@pytest.mark.parametrize("name", sorted(META_CALLS))
def test_entry_points_never_run_plain_versions_off_the_cpu(name):
    """Off the CPU an entry point launches its kernel or raises; only inside
    ``ops.plain_versions()`` does it run its plain version there."""
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        META_CALLS[name]()
    with ops.plain_versions():
        out = META_CALLS[name]()
    want = torch.int8 if name == "quant_rows" else torch.bfloat16
    assert out.device.type == "meta" and out.dtype == want
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        META_CALLS[name]()  # the switch is restored on leaving the block


@pytest.mark.parametrize("module", ["self_attention", "cross_attention", "mha", "ffn"])
def test_layers_route_only_through_the_entry_points(module):
    """Frozen modules (no parameter requires grad, as in a sampling system)
    have no route of their own around the kernels: a head dim the attention
    kernel does not take (32 here) still goes to the entry points off the
    CPU, which raise instead of running plain PyTorch."""
    from mixermdm_tpu_torch.models import layers

    with torch.device("meta"):
        m = {"self_attention": lambda: layers.VanillaSelfAttention(_E, 2),
             "cross_attention": lambda: layers.VanillaCrossAttention(_E, 2),
             "mha": lambda: layers.TorchMultiheadAttention(_E, 2),
             "ffn": lambda: layers.FFN(_E, 2 * _E)}[module]().to(torch.bfloat16)
    m.requires_grad_(False)
    x, emb = _meta(_B, _T, _E), _meta(_B, _E)
    call = {"self_attention": lambda: m(x, emb), "cross_attention": lambda: m(x, x, emb),
            "mha": lambda: m(x), "ffn": lambda: m(x, emb)}[module]
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        call()
    with ops.plain_versions():
        assert call().shape == (_B, _T, _E)


def test_gaussian_smooth_matches_scipy():
    from scipy.ndimage import gaussian_filter1d

    from mixermdm_tpu_torch.cli.infer_mixermdm import gaussian_smooth

    m = np.random.default_rng(8).standard_normal((2, 17, 524)).astype(np.float32)
    _close(gaussian_smooth(m), gaussian_filter1d(m, sigma=1.0, axis=-2), atol=1e-6, rtol=1e-6)
