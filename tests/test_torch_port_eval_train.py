"""``train-evaluator``'s step against the JAX CLI's, on the CPU in float32.

The frozen embeddings: the reference's evaluator keeps CLIP's token and
positional embeddings frozen (no gradient reaches them), and its
``torch.optim.AdamW`` skips a parameter without a gradient, so they never
move.  The JAX CLI's unmasked ``optax.adamw`` decays every leaf, so each
step moves them by ``-lr * weight_decay * value``.  The port follows the
reference (ROADMAP Queue 3 item 5); the test shows both on one step, with
every gradient equal to ``jax.grad``'s (1e-4 relative and 1e-4 of the
tensor's largest absolute value) and every trained parameter equal to the
JAX step's to 3e-2 of ``lr``: Adam's first update ``lr * g / (|g| + eps)``
turns the gradients' last-bit differences into up to 1.5e-2 of ``lr``
where |g| is small (measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_eval import TEXTS, _inputs, interclip_pair

# The CLI's lr 1e-4 and wd 2e-5 decay a value by 2e-9 of itself a step,
# below f32's resolution; these make both the decay and the step visible.
LR, WD = 1e-3, 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_train_step_against_jax_and_the_frozen_embeddings():
    """One ``train-evaluator`` step (AdamW lr, wd 2e-5, no clipping) against
        one ``optax.adamw`` step of the JAX CLI on the same weights and batch
    (``WD`` larger than the CLI's, so that one step's decay shows in f32)."""
    import optax

    from mixermdm_tpu.models.clip_text import tokenize
    from mixermdm_tpu_torch.cli.train_evaluator import step, trainable
    from mixermdm_tpu_torch.train.optim import AdamW
    from mixermdm_tpu_torch.weights import interclip_state_dict

    jm, params, tm = interclip_pair("interaction", seed=50)
    m, lens = _inputs("interaction", seed=8)
    tokens = np.asarray(tokenize(TEXTS, jm.tokenizer))
    before = {k: v.detach().clone() for k, v in tm.state_dict().items()}

    opt = AdamW(trainable(tm), lr=LR, weight_decay=WD, clip_norm=None)
    losses = step(tm, opt, m, lens, tokens)

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jopt = optax.adamw(LR, weight_decay=WD)
    grads = jax.jit(jax.grad(lambda p: jm.compute_loss(p, jnp.asarray(m), jnp.asarray(lens),
                                                       jnp.asarray(tokens))[0]))(jparams)
    updates, _ = jopt.update(grads, jopt.init(jparams), jparams)
    want = interclip_state_dict(jax.tree_util.tree_map(np.asarray,
                                                       optax.apply_updates(jparams, updates)))
    got = tm.state_dict()
    assert np.isfinite(losses["total"]) and len(trainable(tm)) == len(got) - 2
    for k in ("token_embedding.weight", "positional_embedding"):
        assert torch.equal(got[k], before[k]), k  # the port: frozen, not decayed
        np.testing.assert_allclose(want[k], before[k].numpy() * (1 - LR * WD), rtol=1e-6,
                                   atol=1e-12, err_msg=k)  # JAX: decayed
        assert not np.array_equal(want[k], before[k].numpy()), k
    jgrads = interclip_state_dict(jax.tree_util.tree_map(np.asarray, grads))
    moved = 0
    for k, p in tm.named_parameters():
        if not p.requires_grad:
            continue
        g = jgrads[k]
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max(), err_msg=f"grad {k}")
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=3e-2 * LR, rtol=0, err_msg=k)
        moved += int(not torch.equal(got[k], before[k]))
    assert moved == len(want) - 2
