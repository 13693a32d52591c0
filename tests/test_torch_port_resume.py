"""Resuming and fine-tuning in the port, on the CPU in float32.

* The mixer and the base trainers: 4 unbroken steps bitwise equal to the
  same steps split by a ``save_train_state`` / ``restore_train_state`` into
  a freshly built system and trainer, with gradient accumulation 2 (the
  port's counterpart of the JAX package's
  tests/test_training.py::TestFullStateResume); the same through the
  ``train-in2in`` command line with ``--resume auto``.
* ``latest_train_state_path``'s ranking: modification time first, ties
  toward ``final_state``, then the higher epoch.
* ``DataLoader.set_epoch``: a loader set to an epoch replays it bitwise.
* The fine-tune: the individual denoiser carried into the interaction one
  (the JAX package's ``individual_to_interaction_params`` on the same
  trees, bitwise), and one step with every ``sa_block`` frozen.  Both
  halves of the difference from the JAX package show: the other trained
  parameters take JAX's step (``masked_optimizer(make_adamw(...))`` on the
  same gradients, 1e-5 relative on the change), the port's ``sa_block``
  parameters stay bitwise as they were, and JAX's move by exactly
  +gradient (``optax.masked`` passes the masked gradients through as
  updates).

``QUANT_TRAIN`` is held in tests/test_torch_port_quant_train.py.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_base_systems import port_in2in, texts
from tests.test_torch_port_models import B, F, NL, T


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batches(persons, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = (0.3 * rng.standard_normal((B, T, persons * F))).astype(np.float32)
        out.append({"motions": torch.from_numpy(x), "motion_lens": torch.tensor([T, T - 2])})
    return out


def _mixer_run(steps, state_in=None, state_out=None, save_at=None):
    """A tiny training mixer (grad-acc 2) built from seed 1, restored from
    ``state_in``, taking the fit steps ``steps`` (each step's generator
    from (seed, step)); saved to ``state_out`` after ``save_at`` steps."""
    from mixermdm_tpu_torch.cli.infer_mixermdm import build_system
    from mixermdm_tpu_torch.train.checkpoint import restore_train_state, save_train_state
    from mixermdm_tpu_torch.train.trainer import MixerTrainer, step_generator

    system = build_system(tiny=True, device="cpu", seed=1, zero_init_std=0.02, train=True)
    trainer = MixerTrainer(system, lr=1e-3, grad_acc_steps=2)
    if state_in:
        restore_train_state(state_in, trainer)
    toks = system.tokenize_batch(texts())
    batches = _batches(2, 4)
    for step in steps:
        trainer.fit_step({**batches[step], **toks}, step_generator(7, step, "cpu"), step)
        if step + 1 == save_at:
            save_train_state(state_out, trainer)
    return trainer


def _base_run(steps, state_in=None, state_out=None, save_at=None):
    """A tiny training in2IN interaction system (grad-acc 2, the
    loss-second-moment sampler), as :func:`_mixer_run`."""
    from mixermdm_tpu_torch.train.checkpoint import restore_train_state, save_train_state
    from mixermdm_tpu_torch.train.trainer import BaseTrainer, step_generator
    from mixermdm_tpu_torch.weights import init_params_

    system = init_params_(port_in2in("interaction", train=True,
                                     extra={"SAMPLER": "loss-second-moment"}),
                          3, zero_init_std=0.02)
    trainer = BaseTrainer(system, grad_acc_steps=2)
    assert trainer.sampler_name == "loss-second-moment"
    if state_in:
        restore_train_state(state_in, trainer)
    toks = system.tokenize_batch(texts())
    batches = _batches(2, 4, seed=1)
    for step in steps:
        trainer.step({**batches[step], **toks}, step_generator(7, step, "cpu"))
        if step + 1 == save_at:
            save_train_state(state_out, trainer)
    return trainer


def _same_state(a, b) -> bool:
    """Bitwise equality of two trainer state dicts (tensors, lists, ints)."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_same_state(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_state(x, y) for x, y in zip(a, b))
    return a == b


@pytest.fixture(scope="module")
def unbroken():
    """{kind: the trainer after 4 unbroken steps}, made once."""
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = (_mixer_run if kind == "mixer" else _base_run)(range(4))
        return cache[kind]
    return get


@pytest.mark.parametrize("split", [2, 3])
@pytest.mark.parametrize("kind", ["mixer", "base"])
def test_resumed_run_equals_the_unbroken_one_bitwise(kind, split, tmp_path, unbroken):
    """4 steps in one run against ``split`` steps, a save, a fresh system
    and trainer restored from the file, and the rest: every trained
    parameter, both moments and the accumulation of every optimizer, the
    counters, the step and the sampler history bitwise equal.  Split at 3
    the accumulation holds one call's gradients at the save.  The restored
    state equals the saved one bitwise too."""
    from mixermdm_tpu_torch.train.checkpoint import restore_train_state

    run = _mixer_run if kind == "mixer" else _base_run
    path = str(tmp_path / "epoch_1_state")
    whole = unbroken(kind)
    first = run(range(split), state_out=path, save_at=split)
    saved = first.state_dict()
    fresh = run([])
    before = fresh.state_dict()["params"]
    restore_train_state(path, fresh)
    assert _same_state(fresh.state_dict(), saved)
    resumed = run(range(split, 4), state_in=path)
    got, want = resumed.state_dict(), whole.state_dict()
    assert _same_state(got, want)
    opts = ["opt_gen", "opt_disc"] if kind == "mixer" else ["opt"]
    assert all(want[o]["count"] == 2 for o in opts)
    if split == 3:
        assert all(saved[o]["mini_step"] == 1 for o in opts)
    if kind == "base":
        assert int(want["sampler"]["counts"].sum()) == 4 * B
    assert not all(torch.equal(before[k], v) for k, v in want["params"].items())


def test_train_in2in_resume_auto_continues_the_unbroken_run(tmp_path):
    """``train-in2in --tiny`` for 4 steps against 2 steps and then
    ``--resume auto`` to step 4 (the loader set to the epoch the state's
    step falls in, the taken batches passed over): the final train states
    bitwise equal, the records of steps 3-4 too."""
    from mixermdm_tpu_torch.cli import train_in2in

    common = ["--tiny", "--device", "cpu", "--epochs", "5", "--mode", "individual"]
    whole = train_in2in.run(common + ["--max-steps", "4", "--out-dir", str(tmp_path / "a")])
    train_in2in.run(common + ["--max-steps", "2", "--out-dir", str(tmp_path / "b")])
    rest = train_in2in.run(common + ["--max-steps", "4", "--out-dir", str(tmp_path / "b"),
                                     "--resume", "auto"])
    assert [r["step"] for r in rest["records"]] == [2, 3]
    assert [r["total"] for r in rest["records"]] == [r["total"] for r in whole["records"][2:]]
    a = torch.load(whole["state"], weights_only=True)
    b = torch.load(rest["state"], weights_only=True)
    assert _same_state(a, b)


def test_latest_train_state_path_ranks_by_mtime_then_name(tmp_path):
    from mixermdm_tpu_torch.train.checkpoint import latest_train_state_path

    assert latest_train_state_path(str(tmp_path)) is None
    names = ["epoch_5_state", "epoch_10_state", "final_state", "epoch_2_state", "epoch_3"]
    for n in names:
        (tmp_path / n).write_bytes(b"x")
    stamp = {"epoch_5_state": 300, "epoch_10_state": 200, "final_state": 100,
             "epoch_2_state": 50, "epoch_3": 999}
    for n, t in stamp.items():
        os.utime(tmp_path / n, (t, t))
    # the newest file wins, however low its epoch; a file without _state never
    assert latest_train_state_path(str(tmp_path)).endswith("epoch_5_state")
    os.utime(tmp_path / "epoch_10_state", (300, 300))
    assert latest_train_state_path(str(tmp_path)).endswith("epoch_10_state")  # tie: epoch
    os.utime(tmp_path / "final_state", (300, 300))
    assert latest_train_state_path(str(tmp_path)).endswith("final_state")  # tie: final


@pytest.mark.parametrize("layout", ["interhuman", "hml3d"])
def test_set_epoch_replays_an_epoch(layout, tmp_path):
    """Epochs 0-2 of one loader against a new loader set to epoch 1 (and
    one set to 2): the same items, motions and texts (the augmentation
    draws included), and the next epoch after it too."""
    from mixermdm_tpu_torch.data.humanml3d import HumanML3DDataset
    from mixermdm_tpu_torch.data.interhuman import InterHumanDataset
    from mixermdm_tpu_torch.data.loader import DataLoader
    from mixermdm_tpu_torch.data.synthetic import make_hml3d_fixture, make_interhuman_fixture

    root = str(tmp_path)
    if layout == "interhuman":
        make_interhuman_fixture(root, n_clips=4, n_frames=[40, 50, 30, 45])
        make = lambda: InterHumanDataset(root, mode="train", max_gt_length=32)  # noqa: E731
    else:
        make_hml3d_fixture(root, n_clips=5, n_frames=[40, 50, 30, 45, 60])
        make = lambda: HumanML3DDataset(root, mode="train", max_gt_length=32)  # noqa: E731

    def epoch(loader):
        return list(loader)

    first = DataLoader(make(), batch_size=2, seed=3, reseed_dataset=True)
    whole = [epoch(first) for _ in range(3)]
    assert len(whole[0]) >= 2
    for e in (1, 2):
        again = DataLoader(make(), batch_size=2, seed=3, reseed_dataset=True)
        again.set_epoch(e)
        for got, want in zip([epoch(again) for _ in range(3 - e)], whole[e:]):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert sorted(g) == sorted(w)
                for k in w:
                    if isinstance(w[k], list):
                        assert g[k] == w[k], k
                    else:
                        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert not all(np.array_equal(a["motions"], b["motions"])
                   for a, b in zip(whole[0], whole[1]))


# -------------------------------------------------------------- fine-tuning

def test_finetune_transfer_and_freeze_against_jax(monkeypatch):
    """The transfer against JAX ``individual_to_interaction_params`` on the
    same trees (bitwise); then one fine-tune step of the port (sa_block
    frozen) against JAX ``masked_optimizer(make_adamw(1e-4, 2e-5, None))``
    fed the same gradients."""
    import optax

    from mixermdm_tpu.train import checkpoint as jck
    from mixermdm_tpu.train.finetune import individual_to_interaction_params, masked_optimizer
    from mixermdm_tpu.train.optim import make_adamw
    from mixermdm_tpu_torch import weights as W
    from mixermdm_tpu_torch.train.finetune import individual_to_interaction, sa_block_frozen
    from mixermdm_tpu_torch.train.trainer import BaseTrainer, subtree_state

    ind = W.init_params_(port_in2in("individual"), 4, zero_init_std=0.02)
    tgt = W.init_params_(port_in2in("interaction", train=True), 5, zero_init_std=0.02)
    fresh_tgt = copy.deepcopy(tgt)
    kept = individual_to_interaction(ind.denoisers["individual"], tgt.denoisers["interaction"])
    assert kept and all(".ca_block." in k for k in kept)
    assert len(kept) == len(list(tgt.denoisers["interaction"].blocks[0].ca_block.parameters())) \
        * NL

    def jtree(system, mode):
        return jck.convert_in2in_system(
            {k: v.numpy() for k, v in W.released_in2in_state_dict(system, mode).items()}, mode,
            num_layers=NL, clip_layers=system.text.clip_cfg.layers)

    want = individual_to_interaction_params(jtree(ind, "individual")["denoiser_individual"],
                                            jtree(fresh_tgt, "interaction")["denoiser_interaction"])
    got = jtree(tgt, "interaction")["denoiser_interaction"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)

    # the gradients of every trained parameter (sa_block included) at fixed
    # inputs; then the port's step with the same inputs
    rng = np.random.default_rng(8)
    x = (0.3 * rng.standard_normal((B, T, 2 * F))).astype(np.float32)
    t, noise = np.array([4, 13]), rng.standard_normal((B, T, 2 * F)).astype(np.float32)
    loss_kw = dict(t=torch.from_numpy(t), noise=torch.from_numpy(noise),
                   drop=torch.zeros(B, 1, dtype=torch.bool), dropout=False)
    batch = {"motions": torch.from_numpy(x), "motion_lens": torch.tensor([T, T - 2]),
             **tgt.tokenize_batch(texts())}
    named = subtree_state(tgt, tgt.TRAIN_MODULES)
    for p in named.values():
        p.requires_grad_(True)
    try:
        cond = tgt.encode_cond_tokens({k: v for k, v in batch.items() if k.startswith("tok")})
        loss = tgt.compute_loss(batch["motions"], batch["motion_lens"], cond, **loss_kw)
        grads = dict(zip(named, torch.autograd.grad(loss["total"], list(named.values()))))
    finally:
        for p in named.values():
            p.requires_grad_(False)
    before = {k: v.clone() for k, v in named.items()}
    trainer = BaseTrainer(tgt, frozen=sa_block_frozen)
    assert trainer.frozen_names and all(".sa_block." in k for k in trainer.frozen_names)
    monkeypatch.setattr(trainer.sampler, "sample",
                        lambda gen, b, dev: (torch.from_numpy(t), torch.ones(b)))
    real_loss = type(tgt).compute_loss
    monkeypatch.setattr(tgt, "compute_loss", lambda *a, **k: real_loss(
        tgt, *a, **{**k, **loss_kw}))
    trainer.step(batch, torch.Generator().manual_seed(0))
    after = subtree_state(tgt, trainer.keys)

    # JAX: the same parameters and gradients as trees, the masked optimizer
    grad_sys = copy.deepcopy(tgt)
    for k, p in subtree_state(grad_sys, trainer.keys).items():
        p.data.copy_(grads[k])
    p_tree, g_tree = jtree(fresh_tgt, "interaction"), jtree(grad_sys, "interaction")
    for tree, src in ((p_tree, before), (g_tree, grads)):
        probe = copy.deepcopy(tgt)
        for k, p in subtree_state(probe, trainer.keys).items():
            p.data.copy_(src[k])
        tree.update(jtree(probe, "interaction"))
    sub = lambda tree: {"denoiser_interaction": tree["denoiser_interaction"],  # noqa: E731
                        "post_interaction": tree["text"]["post_interaction"]}
    tx = masked_optimizer(make_adamw(1e-4, 2e-5, None), sub(p_tree))

    @jax.jit
    def jstep(g, p):
        upd, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, upd)

    new = jstep(jax.tree_util.tree_map(jnp.asarray, sub(g_tree)),
                jax.tree_util.tree_map(jnp.asarray, sub(p_tree)))
    j_after = W.in2in_state_dict({"text": {"clip": p_tree["text"]["clip"],
                                           "post_interaction": new["post_interaction"]},
                                  "denoiser_interaction": new["denoiser_interaction"]},
                                 "interaction")
    n_frozen = n_trained = 0
    for k, a in after.items():
        b0, g, ja = before[k].numpy(), grads[k].numpy(), np.asarray(j_after[k])
        if sa_block_frozen(k):
            n_frozen += 1
            assert torch.equal(a, before[k]), k                     # the port: frozen
            np.testing.assert_array_equal(ja, b0 + g, err_msg=k)    # JAX: moved by +gradient
            assert np.abs(g).max() > 0, k
        else:
            n_trained += 1
            # the change to 1e-5, or to two f32 roundings of the parameter
            ulp = 2 * float(np.spacing(np.abs(b0).max().astype(np.float32)))
            np.testing.assert_allclose(a.numpy() - b0, ja - b0, atol=ulp, rtol=1e-5, err_msg=k)
    assert n_frozen == len(trainer.frozen_names) and n_trained == len(trainer.params)
