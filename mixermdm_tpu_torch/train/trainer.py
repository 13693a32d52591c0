"""Adversarial mixer trainer; counterpart of
``mixermdm_tpu/train/trainer.py`` (``GEN_KEYS`` / ``DISC_KEYS`` /
``_subset``, ``set_train_attention``, ``MixerTrainer``; reference
scripts/train/mixermdm.py:29-343).

One fit step is a generator step on every batch and a discriminator step
every ``discriminator_steps`` batches, each with its own :class:`AdamW`.
The side that trains is the one whose parameters require grad: the
generator step trains the mixer core and the mixer's own post-encoder head
(the CLIP tower and both denoisers never train and get no optimizer state),
through the frozen discriminators; the discriminator step trains the two
discriminators on the generator's outputs computed without a graph.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.layers import set_train_attention  # noqa: F401 (re-exported, as in the JAX trainer)
from ..systems.mixermdm import DISC_MODULES, GEN_MODULES
from .optim import AdamW

GEN_KEYS = GEN_MODULES
DISC_KEYS = DISC_MODULES


def trainable_params(system, keys) -> list:
    """The parameters of the named subtrees of ``system``."""
    return [p for k in keys for p in system.get_submodule(k).parameters()]


class MixerTrainer:
    """Adversarial trainer for a :class:`~..systems.mixermdm.MixerMDMSystem`
    built with ``train=True`` (f32 master weights in the trained subtrees).

    ``fit_step`` takes a batch dict: ``motions`` (B, T, 524) raw,
    ``motion_lens`` (B,), ``tokens_inter`` / ``tokens_i1`` / ``tokens_i2``
    (B, 77), and a ``torch.Generator`` for the cond drop, timesteps and
    noise.
    """

    def __init__(self, system, lr: float = 1e-5, weight_decay: float = 1e-4,
                 grad_acc_steps: int = 2, discriminator_steps: int = 1,
                 i_loss_factor: float = 1.0, I_loss_factor: float = 2.0, l1: float = 0.1,
                 nan_guard: int = 0):
        self.system = system
        self.discriminator_steps = max(1, int(discriminator_steps))
        self.loss_kw = dict(i_loss_factor=i_loss_factor, I_loss_factor=I_loss_factor, l1=l1)
        self.gen_params = trainable_params(system, GEN_KEYS)
        self.disc_params = trainable_params(system, DISC_KEYS)
        if any(p.dtype != torch.float32 for p in self.gen_params + self.disc_params):
            raise ValueError("the trained subtrees need f32 master weights: build the system "
                             "with train=True")
        opt = dict(lr=lr, weight_decay=weight_decay, grad_acc_steps=grad_acc_steps,
                   nan_guard=nan_guard)
        self.opt_gen = AdamW(self.gen_params, **opt)
        self.opt_disc = AdamW(self.disc_params, **opt)
        self.step = 0

    def side_step(self, mode: str, batch: dict, generator: Optional[torch.Generator]) -> dict:
        """One generator or discriminator step: encode the conds, take the
        side's loss and gradients, let its optimizer update.  Returns the
        losses, detached."""
        gen_side = mode == "generator"
        params, opt = ((self.gen_params, self.opt_gen) if gen_side
                       else (self.disc_params, self.opt_disc))
        for p in params:
            p.requires_grad_(True)
        try:
            sys_ = self.system
            cond = sys_.encode_cond(batch["tokens_inter"], batch["tokens_i1"], batch["tokens_i2"])
            losses = sys_.compute_loss(batch["motions"], batch["motion_lens"], cond, mode=mode,
                                       generator=generator, **self.loss_kw)
            opt.zero_grad()
            losses["total"].backward()
            opt.step()
            opt.zero_grad()
        finally:
            for p in params:
                p.requires_grad_(False)
        return {k: v.detach() for k, v in losses.items()}

    def fit_step(self, batch: dict, generator: Optional[torch.Generator], batch_idx: int):
        """G on every batch, D every ``discriminator_steps`` (reference
        scripts/train/mixermdm.py:146-207).  Returns (G losses, D losses or
        None)."""
        g_losses = self.side_step("generator", batch, generator)
        d_losses = None
        if batch_idx % self.discriminator_steps == 0:
            d_losses = self.side_step("discriminator", batch, generator)
        self.step += 1
        return g_losses, d_losses
