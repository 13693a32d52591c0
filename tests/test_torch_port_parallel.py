"""The port's multi-rank sampling against the JAX package on one device, on
the CPU: tensor parallelism (TP 2), TP 2 with sequence parallelism, the
GPipe pipeline (PP 2) and data parallelism, each on 2 ranks (``gloo``,
rendezvous through a ``FileStore`` under the test's temporary directory,
one torch thread a rank; ``tests/torch_parallel_ranks.py`` is what the
ranks run), and the tensor-parallel rule leaf for leaf against the JAX
``tp_spec`` through the weight mapping.  The JAX package runs on one device
only: it is the oracle of every layout, as in tests/test_parallel.py.

One launch of the ranks computes every layout (~7 s) while this process
computes the JAX references; the chain starts from JAX's own initial noise.
Sizes: tests/test_golden.py's (2 layers, 4 heads, width 64), B 2, T 8, f32.

Tolerances, as max |got - want| / max |want| (:func:`_rel`; the readings
of one run in brackets):
* a model call against JAX: :data:`CALL_TOL` 1e-5 for the text conds
  (5.0e-7 single-rank and TP 2), :data:`STEP_TOL` 3e-5 for one CFG mixer
  step, whose CFG weight 3.5 scales the gap of its two branches (single
  rank 1.3e-5, TP 2 and TP 2 + SP 9.5e-6, PP 2 1.3e-5; TP 2 lies 8.5e-6
  from the single-rank port: its partial sums add in another order);
* the 4-step DDIM chain (motion and both influence histories) against JAX:
  :data:`CHAIN_TOL` 1e-4 (single rank 3.9e-5, TP 2 1.7e-5, data
  parallelism 2.8e-5, PP 2 3.9e-5);
* each layout against the single-rank port on the same ranks: the same
  limits; data parallelism row for row on :data:`ROW_TOL` 2e-4 of each
  row (9.2e-5: a rank runs one row where the single rank runs two, and the
  CPU's f32 products take another summation path at one row).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as R
from tests.test_torch_port_models import jax_tiny_system, port_tiny_system, random_params

CALL_TOL = 1e-5
STEP_TOL = 3e-5
CHAIN_TOL = 1e-4
ROW_TOL = 2e-4
LAUNCH_TIMEOUT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _step_inputs():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((R.B, R.T, 2 * R.F)).astype(np.float32)
    x2 = rng.standard_normal((R.B, R.T, 2 * R.F)).astype(np.float32)
    cond = rng.standard_normal((R.B, 8 * R.TD)).astype(np.float32)
    t = np.array([980, 420], np.int64)
    mask = np.ones((R.B, R.T, 1), np.float32)
    mask[0, -2:] = 0.0
    return x, x2, t, cond, mask


CHAIN_RNG = 1


def _jax_noise() -> np.ndarray:
    """The initial noise JAX's chain draws from ``PRNGKey(CHAIN_RNG)``."""
    _, init_rng = jax.random.split(jax.random.PRNGKey(CHAIN_RNG))
    return np.array(jax.random.normal(init_rng, (R.B, R.T, 2 * R.F), jnp.float32))


def _jax_reference(jsys, params) -> dict:
    from mixermdm_tpu.models.cfg import cfg_model_x2 as j_cfg
    from mixermdm_tpu.systems import apply_sampler_overrides

    x, x2, t, cond, mask = _step_inputs()
    mp = jsys.mixer_params(params)
    step = jax.jit(j_cfg(lambda a, a2, tt, m, c: jsys._mixer_forward(mp, a, tt, c, m, a2)[0],
                         jsys.cfg_weight))
    out = {"step": np.asarray(step(*[jnp.asarray(v) for v in (x, x2, t, mask, cond)]))}
    out["cond"] = np.asarray(jsys.generate_cond(params, R.texts()))
    apply_sampler_overrides(jsys, None, R.CHAIN_STEPS)
    chain, (i1, i2) = jsys.sample(params, jnp.asarray(cond), R.T,
                                  jax.random.PRNGKey(CHAIN_RNG), collect_influence=True)
    out["chain"] = np.concatenate([np.asarray(a).reshape(-1) for a in (chain, i1, i2)])
    return out


@pytest.fixture(scope="module")
def jax_tree():
    jsys = jax_tiny_system()
    return jsys, random_params(jsys)


@pytest.fixture(scope="module")
def world(jax_tree, tmp_path_factory):
    """(rank 0's outputs, rank 1's, the JAX references, the JAX params).
    The ranks run while this process computes the JAX references."""
    from mixermdm_tpu_torch import parallel
    from mixermdm_tpu_torch.weights import load_mixermdm_params

    jsys, params = jax_tree
    tmp = tmp_path_factory.mktemp("ranks")
    tsys = port_tiny_system()
    load_mixermdm_params(tsys, params)
    torch.save(tsys.state_dict(), tmp / "state.pt")
    x, x2, t, cond, mask = _step_inputs()
    torch.save({"x": torch.from_numpy(x), "x2": torch.from_numpy(x2),
                "t": torch.from_numpy(t), "cond": torch.from_numpy(cond),
                "mask": torch.from_numpy(mask), "noise": torch.from_numpy(_jax_noise())},
               tmp / "inputs.pt")
    ranks = {}

    def run():
        try:
            ranks["out"] = parallel.launch(
                R.layouts, 2, args=(str(tmp / "state.pt"), str(tmp / "inputs.pt")),
                threads=1, timeout_s=LAUNCH_TIMEOUT_S, store_dir=str(tmp))
        except Exception as e:  # raised below, in the test's thread
            ranks["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    ref = _jax_reference(jsys, params)
    thread.join(LAUNCH_TIMEOUT_S + 60)
    if "error" in ranks:
        raise ranks["error"]
    r0, r1 = ranks["out"]
    return r0, r1, ref, params


# ------------------------------------------------------------ the rule

def _jax_owner(path, leaf, n_model):
    """The model index holding each element of a JAX leaf under its
    ``tp_spec`` (-1: replicated), as a float array the exporters take."""
    from mixermdm_tpu.parallel.mesh import tp_spec

    spec = tuple(tp_spec(path, leaf, n_model))
    owner = np.full(leaf.shape, -1.0, np.float32)
    if "model" in spec:
        d = spec.index("model")
        size = leaf.shape[d]
        idx = (np.arange(size) // (size // n_model)).astype(np.float32)
        view = [1] * len(leaf.shape)
        view[d] = size
        owner = np.broadcast_to(idx.reshape(view), leaf.shape).copy()
    return owner


@pytest.mark.parametrize("n_model", [2, 4])
def test_tp_spec_matches_jax_leaf_for_leaf(jax_tree, n_model):
    """Every element of every parameter is held by the same model index
    under the port's ``tp_plan`` as under the JAX ``tp_spec`` of the leaf it
    comes from (through ``weights.mixermdm_state_dict``: q/k/v kernels
    transposed and stacked into ``in_proj_weight``)."""
    from mixermdm_tpu_torch.parallel import tp_plan
    from mixermdm_tpu_torch.weights import mixermdm_state_dict

    owners = jax.tree_util.tree_map_with_path(lambda p, leaf: _jax_owner(p, leaf, n_model),
                                              jax_tree[1])
    want = mixermdm_state_dict(owners)
    tsys = port_tiny_system()
    plan = tp_plan(tsys, n_model)
    assert sorted(plan) == sorted(want)
    sharded = 0
    for name, p in tsys.named_parameters():
        got = plan[name].owner(p.shape, n_model)
        np.testing.assert_array_equal(got, np.asarray(want[name]).astype(np.int64), name)
        sharded += plan[name].dim is not None
    # every SA/CA/FFN, CLIP and post-encoder projection: a real share of the tree
    assert sharded >= 60, sharded


def test_rank_shards_match_the_jax_slices(world):
    """What ``tp_shard_params`` left on each rank: the slice of the JAX
    leaf that the JAX spec assigns to that model index, in layer 0 of the
    interaction denoiser (q, k and v of the rank's heads stacked; the
    out-projection's and FFN-down's input rows; the out-projection's bias
    whole)."""
    r0, r1, _, params = world
    den = params["model2"]["denoiser_interaction"]
    blk = {k: v for k, v in den.items() if k.startswith("blocks")}
    assert r0["tp_heads"] == 2
    for rank, res in ((0, r0), (1, r1)):
        got = res["shards"]
        sa = _layer0(blk, "sa_block")["attention"]
        qkv = np.concatenate([_cols(sa[n]["kernel"], rank).T for n in ("q_proj", "k_proj",
                                                                      "v_proj")], 0)
        np.testing.assert_array_equal(got["sa.in_proj_weight"], qkv)
        np.testing.assert_array_equal(got["sa.out_proj.weight"],
                                      _rows(sa["out_proj"]["kernel"], rank).T)
        np.testing.assert_array_equal(got["sa.out_proj.bias"], sa["out_proj"]["bias"])
        ffn = _layer0(blk, "ffn")
        np.testing.assert_array_equal(got["ffn.linear1.weight"],
                                      _cols(ffn["linear1"]["kernel"], rank).T)
        np.testing.assert_array_equal(got["ffn.linear1.bias"], _cols(ffn["linear1"]["bias"],
                                                                     rank))
        np.testing.assert_array_equal(got["ffn.linear2.weight"],
                                      _rows(ffn["linear2"]["kernel"], rank).T)


def _layer0(blocks, sub):
    """Layer 0's subtree of a denoiser's blocks (scanned: leaves stacked on
    a leading layer axis; unrolled: ``blocks_0``)."""
    if "blocks_0" in blocks:
        return blocks["blocks_0"][sub]
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[0], blocks["blocks"]["block"][sub])


def _cols(a, rank, n=2):
    a = np.asarray(a)
    k = a.shape[-1] // n
    return a[..., rank * k:(rank + 1) * k]


def _rows(a, rank, n=2):
    a = np.asarray(a)
    k = a.shape[0] // n
    return a[rank * k:(rank + 1) * k]


# ------------------------------------------------------------ the layouts

def test_single_rank_port_matches_jax(world):
    """The ranks' own single-rank references (before any layout) against
    JAX: what every layout below is also held to."""
    r0, _, ref, _ = world
    assert _rel(r0["single_cond"], ref["cond"]) <= CALL_TOL
    assert _rel(r0["single_step"], ref["step"]) <= STEP_TOL
    assert _rel(r0["single_chain"], ref["chain"]) <= CHAIN_TOL


@pytest.mark.parametrize("layout", ["tp", "sp", "pp"])
def test_layout_step_matches_jax(world, layout):
    """One CFG mixer step (both denoisers, the mixer core, CFG) under TP 2,
    TP 2 + SP and PP 2 (2 microbatches)."""
    r0, r1, ref, _ = world
    got = r0[f"{layout}_step"]
    assert _rel(got, ref["step"]) <= STEP_TOL
    assert _rel(got, r0["single_step"]) <= STEP_TOL
    if layout == "tp":  # the output is replicated over the model axis
        np.testing.assert_array_equal(r1["tp_step"], got)


@pytest.mark.parametrize("layout", ["tp", "sp", "pp", "dp"])
def test_layout_chain_matches_jax(world, layout):
    """The 4-step DDIM chain with the influence histories under each
    layout, from JAX's initial noise."""
    r0, _, ref, _ = world
    got = r0[f"{layout}_chain"]
    assert _rel(got, ref["chain"]) <= CHAIN_TOL
    assert _rel(got, r0["single_chain"]) <= CHAIN_TOL


def test_tp_text_conds_match_jax(world):
    """The text conds with the CLIP towers and the post-encoders sharded
    (``c_fc`` / ``c_proj``, ``linear1`` / ``linear2``, their attention)."""
    r0, _, ref, _ = world
    assert _rel(r0["tp_cond"], ref["cond"]) <= CALL_TOL


def test_sequence_parallelism_ran(world):
    """TP 2 + SP at T 8 gathered along T and reduce-scattered its sums."""
    r0 = world[0]
    assert r0["sp_gathers"] > 0 and r0["sp_scatters"] > 0, r0


def test_data_parallel_rows_match_single_rank(world):
    """Data parallelism 2 from a generator: the whole batch's noise drawn
    as one rank draws it, each rank its rows; and 3 rows over 2 ranks,
    padded with the last row and the pad dropped."""
    r0 = world[0]
    for k in ("gen", "gen3"):
        got, want = r0[f"dp_{k}"], r0[f"single_{k}"]
        assert got.shape == want.shape
        for i in range(want.shape[0]):
            assert _rel(got[i], want[i]) <= ROW_TOL, (k, i)


def test_ranks_import_no_jax(world):
    assert world[0]["jax_free"] and world[1]["jax_free"]
