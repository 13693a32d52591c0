"""The port's evaluation building blocks against the JAX package's, on the
CPU in float32: the rotation converters and the reference alignment chain
(``ih_to_smpl`` / ``smpl_to_ih`` / ``center_motion`` / ``align_motions``,
a zero pose included), every metric function and the Sinkhorn, InterCLIP's
motion and text embeddings and its loss at a small width, the port's
``MotionEncoder`` against the recorded reference activations
(``golden/interclip_motion.npz``), and the evaluator-file reader against
JAX's ``convert_interclip``.

Sizes: the golden sizes (L 64, FF 128, 2 layers, 4 heads) for the motion
tower, a text tower of 64 wide, 2 heads, one layer (as the JAX package's
tiny evaluator), B 4, T 10.  JAX parameters come from ``jax.eval_shape``
filled from numpy.  Tolerances: 1e-5 absolute and relative for the
geometry, 1e-6 relative for the numpy metrics (the same code on the same
embeddings), 1e-4 relative for the Sinkhorn (its stopping rule), 1e-3
absolute for values taken through axis-angles (``AXIS_ANGLE_TOL``), 1e-4 for
the embeddings and the loss (``TOL``), 2e-4 against the golden file (as
tests/test_golden.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import golden
from tests.test_torch_port_models import FF, L, NH, NL, random_params

TOL = dict(atol=1e-4, rtol=1e-4)
GEO_TOL = dict(atol=1e-5, rtol=1e-5)
# Axis-angles taken from rotation matrices: the reference's copysign
# matrix -> quaternion takes sqrt(1 + m00 - m11 - m22) (and its
# permutations), which near a zero component turns one f32 rounding of the
# matrix (~6e-8) into ~sqrt(6e-8) = 2.4e-4 of the result.  Both packages do
# so, from matrices that differ in their last bits (measured: 4.2e-4 at
# most on these inputs).
AXIS_ANGLE_TOL = dict(atol=1e-3, rtol=1e-5)
B, T = 4, 10
TEXTS = ["two people hug", "one person pushes the other", "they dance holding hands",
         "a person waves at the other"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **(kw or TOL))


def _motion(seed, shape, scale=0.5):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal(shape).astype(np.float32) * scale
    m[..., 132:258] += np.tile(np.asarray([1, 0, 0, 1, 0, 0], np.float32), 21)
    return m


# --------------------------------------------------------------------------
# Rotations and the alignment chain
# --------------------------------------------------------------------------

def _rot_inputs(name):
    rng = np.random.default_rng(1)
    aa = (rng.standard_normal((5, 7, 3)) * 1.2).astype(np.float32)
    aa[0, 0] = 0.0  # the zero rotation (the Taylor branch)
    from mixermdm_tpu.utils.rotations import axis_angle_to_matrix

    mat = np.asarray(axis_angle_to_matrix(jnp.asarray(aa)))
    return {"rotation_6d_to_matrix": rng.standard_normal((5, 7, 6)).astype(np.float32),
            "matrix_to_rotation_6d": mat, "axis_angle_to_matrix": aa,
            "matrix_to_axis_angle": mat, "axis_angle_to_quaternion": aa,
            "quaternion_to_axis_angle": rng.standard_normal((5, 7, 4)).astype(np.float32),
            "matrix_to_quaternion": mat}[name]


@pytest.mark.parametrize("name", ["rotation_6d_to_matrix", "matrix_to_rotation_6d",
                                  "axis_angle_to_matrix", "matrix_to_axis_angle",
                                  "axis_angle_to_quaternion", "quaternion_to_axis_angle",
                                  "matrix_to_quaternion"])
def test_rotations_match_jax(name):
    from mixermdm_tpu.utils import rotations as jrot
    from mixermdm_tpu_torch.utils import rotations as trot

    x = _rot_inputs(name)
    _close(getattr(trot, name)(torch.from_numpy(x)), getattr(jrot, name)(jnp.asarray(x)),
           **GEO_TOL)


def test_quaternion_to_matrix_matches_jax():
    from mixermdm_tpu.utils.quaternions import quaternion_to_matrix as jq
    from mixermdm_tpu_torch.utils.quaternions import quaternion_to_matrix as tq

    q = np.random.default_rng(2).standard_normal((6, 4)).astype(np.float32)
    _close(tq(torch.from_numpy(q)), jq(jnp.asarray(q)), **GEO_TOL)


CHAIN_CASES = ("ih_to_smpl", "smpl_to_ih 201-d", "center chain", "align_motions",
               "align_motions masked", "zero pose")


def _chains(A, x, mask, zeros):
    """Every case of the reference chain on (2B, T, 262) persons ``x``, with
    the alignment module ``A`` of either package."""
    s = A.ih_to_smpl(x)
    center = lambda m: A.smpl_to_ih(A.center_motion(A.ih_to_smpl(m)))  # noqa: E731
    return {"ih_to_smpl": s, "smpl_to_ih 201-d": A.smpl_to_ih(s[..., :201]),
            "center chain": center(x), "align_motions": A.align_motions(s[:B], s[B:])[1],
            "align_motions masked": A.align_motions(s[:B], s[B:], mask)[1],
            "zero pose": center(zeros)}


@pytest.fixture(scope="module")
def chains():
    """(port, JAX) outputs of every case; the JAX side as one compiled
    program (op-by-op dispatch compiles each op for each new shape)."""
    from mixermdm_tpu.utils import alignment as JA
    from mixermdm_tpu_torch.utils import alignment as TA

    m = _motion(3, (2 * B, T, 262))
    mask = (np.arange(T)[None, :] < np.asarray([T, 6, 8, 3])[:, None]).astype(np.float32)
    zeros = np.zeros_like(m)
    port = {k: v.numpy() for k, v in _chains(TA, *map(torch.from_numpy, (m, mask, zeros))).items()}
    want = jax.jit(lambda *a: _chains(JA, *a))(m, mask, zeros)
    return port, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("case", CHAIN_CASES)
def test_alignment_chain_matches_jax(chains, case):
    """The reference chain; ``smpl_to_ih`` of a 201-d input reads the zero
    hand joints as contacts (zeros), and the centre chain drops the
    contacts, as upstream.  A zero pose (a fresh zero-init denoiser's
    output) stays finite through the eps-stabilised norms of
    ``center_motion``."""
    got, want = chains[0][case], chains[1][case]
    assert np.isfinite(got).all()
    _close(got[..., :132], want[..., :132], **GEO_TOL)  # positions, velocities
    _close(got[..., 132:], want[..., 132:], **AXIS_ANGLE_TOL)  # through axis-angles
    if case in ("smpl_to_ih 201-d", "center chain", "zero pose"):
        assert not got[..., -4:].any()


def test_center_person_fast_is_the_reference_chain():
    """The sampling chain's one-pass ``center_person_fast`` equals the
    reference chain it replaces, but for the rotations it orthonormalises in
    6d where the chain goes through axis-angles."""
    from mixermdm_tpu_torch.utils.alignment import center_person_fast
    from mixermdm_tpu_torch.eval.protocol import center_persons

    m = torch.from_numpy(_motion(4, (3, T, 262)))
    fast, chain = center_person_fast(m), center_persons(m)
    _close(fast[..., :132], chain[..., :132], **GEO_TOL)
    _close(fast[..., 132:], chain[..., 132:], **AXIS_ANGLE_TOL)


# --------------------------------------------------------------------------
# Metrics
# --------------------------------------------------------------------------

def _emb(seed, n=24, d=16):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float64)


METRIC_CASES = {
    "euclidean_distance_matrix": lambda M: M.euclidean_distance_matrix(_emb(0), _emb(1)),
    "calculate_top_k": lambda M: M.calculate_top_k(
        np.argsort(M.euclidean_distance_matrix(_emb(0), _emb(0) + 0.1 * _emb(1)), axis=1), 3),
    "calculate_R_precision": lambda M: M.calculate_R_precision(
        _emb(0), _emb(0) + 0.5 * _emb(1), 3, sum_all=True),
    "calculate_matching_score": lambda M: M.calculate_matching_score(_emb(0), _emb(1), True),
    "calculate_activation_statistics": lambda M: np.concatenate(
        [a.ravel() for a in M.calculate_activation_statistics(_emb(2))]),
    "calculate_diversity": lambda M: M.calculate_diversity(_emb(3), 10, seed=5),
    "calculate_frechet_distance": lambda M: M.calculate_frechet_distance(
        *M.calculate_activation_statistics(_emb(4, 64)),
        *M.calculate_activation_statistics(_emb(5, 64) + 0.3)),
    "calculate_fid": lambda M: M.calculate_fid(_emb(6, 64), _emb(7, 64) * 1.2),
    "calculate_multimodality": lambda M: M.calculate_multimodality(
        _emb(8, 6 * 15).reshape(6, 15, 16), 5, seed=3),
}


@pytest.mark.parametrize("name", sorted(METRIC_CASES))
def test_metric_matches_jax(name):
    from mixermdm_tpu.eval import metrics as JM
    from mixermdm_tpu_torch.eval import metrics as TM

    got, want = METRIC_CASES[name](TM), METRIC_CASES[name](JM)
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-6, atol=1e-9)


# The loop stops once neither potential moves by more than 1e-5, so two
# implementations agree to about that on potentials of order 1 (measured:
# 1.2e-5 relative at most).
SINKHORN_RTOL = 1e-4


@pytest.mark.parametrize("shift,p", [(0.0, 2), (1.5, 2), (0.5, 1)])
def test_sinkhorn_matches_jax(shift, p):
    """The log-domain Sinkhorn loop: the transport cost, port (torch) vs JAX
    (``lax.while_loop``), on the same points; same stopping rule."""
    from mixermdm_tpu.eval import metrics as JM
    from mixermdm_tpu_torch.eval import metrics as TM

    x = _emb(9, 20, 3).astype(np.float32)
    y = (_emb(10, 16, 3) + shift).astype(np.float32)
    got = TM.calculate_wasserstein(x, y, p=p, eps=0.05)
    want = JM.calculate_wasserstein(x, y, p=p, eps=0.05)
    np.testing.assert_allclose(got, want, rtol=SINKHORN_RTOL)
    assert TM.calculate_wasserstein(torch.from_numpy(x), torch.from_numpy(x), eps=0.05) < got


# --------------------------------------------------------------------------
# InterCLIP
# --------------------------------------------------------------------------

def jax_interclip(mode):
    from mixermdm_tpu.config import Config
    from mixermdm_tpu.eval.interclip import InterCLIP
    from mixermdm_tpu.models.torch_compat import TorchEncoder

    cfg = Config.wrap({"INPUT_DIM": 258, "LATENT_DIM": L, "FF_SIZE": FF, "NUM_LAYERS": NL,
                       "NUM_HEADS": NH, "DROPOUT": 0.0, "MODE": mode})
    model = InterCLIP(cfg, text_width=64)
    model.text_encoder = TorchEncoder(64, 2, 64, 1)
    return model


def port_interclip(mode):
    from mixermdm_tpu_torch.config import Config
    from mixermdm_tpu_torch.eval.interclip import InterCLIP

    cfg = Config.wrap({"INPUT_DIM": 258, "LATENT_DIM": L, "FF_SIZE": FF, "NUM_LAYERS": NL,
                       "NUM_HEADS": NH, "DROPOUT": 0.0, "MODE": mode})
    return InterCLIP(cfg, text_width=64, text_layers=1, text_heads=2, text_ff=64, device="cpu")


def interclip_pair(mode, seed):
    """(JAX model, its numpy params, the port's model with those weights)."""
    from mixermdm_tpu_torch.weights import load_interclip_params

    jm = jax_interclip(mode)
    params = random_params(jm, seed=seed)
    params["latent_scale"] = np.asarray(1.3, np.float32)
    return jm, params, load_interclip_params(port_interclip(mode), params)


@pytest.fixture(scope="module", params=["interaction", "individual"])
def interclip(request):
    return interclip_pair(request.param, seed=20)


def _inputs(mode, seed=5):
    D = 524 if mode == "interaction" else 262
    lens = np.asarray([T, 7, 4, T])
    return _motion(seed, (B, T, D)), lens


def test_interclip_motion_embeddings_match_jax(interclip):
    jm, params, tm = interclip
    m, lens = _inputs(jm.mode)
    want = np.asarray(jm.encode_motion(params, jnp.asarray(m), jnp.asarray(lens)))
    with torch.no_grad():
        got = tm.encode_motion(m, lens)
    assert got.shape == (B, 512)
    _close(got, want)


def test_interclip_text_embeddings_match_jax(interclip):
    jm, params, tm = interclip
    want = np.asarray(jm.encode_text(params, TEXTS))
    with torch.no_grad():
        got = tm.encode_text(TEXTS)
    _close(got, want)


def test_interclip_loss_matches_jax(interclip):
    from mixermdm_tpu.models.clip_text import tokenize

    jm, params, tm = interclip
    m, lens = _inputs(jm.mode, seed=6)
    tokens = np.asarray(tokenize(TEXTS, jm.tokenizer))
    want_loss, want = jm.compute_loss(params, jnp.asarray(m), jnp.asarray(lens),
                                      jnp.asarray(tokens))
    with torch.no_grad():
        got_loss, got = tm.compute_loss(m, lens, tokens)
    for k in ("total", "ce_from_motion", "ce_from_text"):
        _close(got[k], want[k])
    _close(got_loss, want_loss)


def test_motion_encoder_matches_golden_reference():
    """The port's MotionEncoder on the recorded reference activations
    (tests/test_golden.py:176 replays the JAX one on the same file)."""
    from mixermdm_tpu_torch.weights import load_interclip_params

    fx = golden.load("interclip_motion")
    jm = jax_interclip("interaction")
    params = random_params(jm, seed=21)  # the text tower, which the file lacks
    params.update(fx["params"])
    tm = load_interclip_params(port_interclip("interaction"), params)
    with torch.no_grad():
        emb = tm.encode_motion(fx["motions"], fx["lens"])
    np.testing.assert_allclose(emb.numpy(), fx["ref_emb"], atol=2e-4, rtol=2e-4)


# --------------------------------------------------------------------------
# The evaluator file
# --------------------------------------------------------------------------

def _reference_layout(mode, seed):
    """One random state dict in the reference evaluator file's layout (as
    the JAX package's ``export_interclip`` writes it, ``latent_scale`` of
    shape (1,) as the reference's ``torch.Tensor([1])``), with entries the
    evaluator does not read (the frozen CLIP tower, the positions
    buffer)."""
    from mixermdm_tpu.train.checkpoint import export_interclip

    sd = export_interclip(random_params(jax_interclip(mode), seed=seed))
    sd["latent_scale"] = np.asarray([0.8], np.float32)
    sd["clip_transformer.resblocks.0.attn.in_proj_weight"] = np.zeros((6, 2), np.float32)
    sd["ln_final.weight"] = np.ones(2, np.float32)
    sd["motion_encoder.sequence_pos_encoder.pe"] = np.zeros((5, 1, L), np.float32)
    return sd


def test_released_reader_matches_convert_interclip(tmp_path):
    """``load_released_interclip`` on a reference-layout file (a Lightning
    ``state_dict`` with ``model.`` prefixes) against JAX's
    ``convert_interclip`` of the same dict: both models give the same
    embeddings, every parameter filled (``strict``)."""
    from mixermdm_tpu.train.checkpoint import convert_interclip
    from mixermdm_tpu_torch.train.checkpoint import load_released_interclip, save_released

    sd = _reference_layout("interaction", seed=30)
    path = str(tmp_path / "interclip.ckpt")
    save_released(path, {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    tm = port_interclip("interaction")
    assert load_released_interclip(tm, path, strict=True) == []
    jm = jax_interclip("interaction")
    params = convert_interclip(sd, num_layers=NL, text_layers=1)
    m, lens = _inputs("interaction", seed=7)
    with torch.no_grad():
        _close(tm.encode_motion(m, lens),
               jm.encode_motion(params, jnp.asarray(m), jnp.asarray(lens)))
        _close(tm.encode_text(TEXTS), jm.encode_text(params, TEXTS))
    assert float(tm.latent_scale.detach()) == pytest.approx(0.8)


def test_released_reader_checks_shapes_and_lists_unfilled(tmp_path):
    """A missing entry is listed (``strict``: refused before any copy), a
    wrong shape and an unknown key refused; the port's own file
    (``released_interclip_state_dict``) loads back bitwise and through
    JAX's ``load_torch_state_dict`` + ``convert_interclip``."""
    from mixermdm_tpu.train import checkpoint as jck
    from mixermdm_tpu_torch.train.checkpoint import load_released_interclip, save_released
    from mixermdm_tpu_torch.weights import released_interclip_state_dict

    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in _reference_layout("individual", seed=31).items()}
    missing = dict(sd)
    del missing["text_ln.bias"]
    save_released(str(tmp_path / "missing.ckpt"), missing)
    tm = port_interclip("individual")
    before = tm.out.weight.detach().clone()
    with pytest.raises(ValueError, match="strict"):
        load_released_interclip(tm, str(tmp_path / "missing.ckpt"), strict=True)
    assert torch.equal(tm.out.weight, before)  # nothing copied
    assert load_released_interclip(tm, str(tmp_path / "missing.ckpt")) == ["text_ln.bias"]
    for name, bad in (("shape", dict(sd, **{"out.bias": torch.zeros(3)})),
                      ("unknown", dict(sd, **{"extra.weight": torch.zeros(3)}))):
        save_released(str(tmp_path / f"{name}.ckpt"), bad)
        with pytest.raises((ValueError, KeyError)):
            load_released_interclip(port_interclip("individual"), str(tmp_path / f"{name}.ckpt"))
    # the port's own file
    save_released(str(tmp_path / "own.ckpt"), released_interclip_state_dict(tm))
    again = port_interclip("individual")
    assert load_released_interclip(again, str(tmp_path / "own.ckpt"), strict=True) == []
    for (k, a), b in zip(tm.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    jsd = jck.load_torch_state_dict(str(tmp_path / "own.ckpt"))
    params = jck.convert_interclip(jsd, num_layers=NL, text_layers=1)
    np.testing.assert_array_equal(np.asarray(params["text_out"]["kernel"]).T,
                                  tm.out.weight.detach().numpy())
