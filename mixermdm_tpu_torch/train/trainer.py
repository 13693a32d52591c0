"""Trainers; counterpart of ``mixermdm_tpu/train/trainer.py``
(``GEN_KEYS`` / ``DISC_KEYS`` / ``_subset``, ``set_train_attention``,
``MixerTrainer``, ``BaseTrainer``; reference scripts/train/mixermdm.py:29-343,
in2IN.py, mdm.py).

Adversarial mixer training: one fit step is a generator step on every batch
and a discriminator step every ``discriminator_steps`` batches, each with
its own :class:`AdamW`.  The side that trains is the one whose parameters
require grad: the generator step trains the mixer core and the mixer's own
post-encoder head (the CLIP tower and both denoisers never train and get no
optimizer state), through the frozen discriminators; the discriminator step
trains the two discriminators on the generator's outputs computed without a
graph.

Base-model training (:class:`BaseTrainer`): the MSE + geometric loss of an
in2IN, MDM or InterGen system, one :class:`AdamW` (lr 1e-4, wd 2e-5, no
clipping, an optional lr schedule) over the system's trainable subtrees, the
timesteps drawn by the config's schedule sampler, whose loss history the
per-sample MSE updates.

Both trainers have ``state_dict`` / ``load_state_dict``: the trained
subtrees' parameters, every optimizer's state, the step and the sampler
history, which is what a resumed run needs to continue bitwise
(:func:`..train.checkpoint.save_train_state`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..diffusion.samplers import create_named_schedule_sampler
from ..models.layers import set_train_attention  # noqa: F401 (re-exported, as in the JAX trainer)
from ..systems.mixermdm import DISC_MODULES, GEN_MODULES
from .optim import AdamW

GEN_KEYS = GEN_MODULES
DISC_KEYS = DISC_MODULES


def step_seed(seed: int, step: int, stream: int = 0) -> int:
    """A seed that is a function of ``(seed, step, stream)`` only (JAX
    ``fold_in(rng, step)``): the training CLIs seed each step's generator
    (stream 0) and the dropout draws (stream 1) from it, so a resumed run
    continues the draws of an unbroken one without storing RNG state."""
    return ((int(seed) * 1_000_003 + int(step)) * 2 + int(stream)) % (1 << 62)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's generator (timesteps, cond drop, noise), and the default
    generators reseeded for its dropout draws."""
    torch.manual_seed(step_seed(seed, step, 1))
    return torch.Generator(device=device).manual_seed(step_seed(seed, step, 0))


def trainable_params(system, keys) -> list:
    """The parameters of the named subtrees of ``system``."""
    return [p for k in keys for p in system.get_submodule(k).parameters()]


def subtree_state(system, keys) -> dict:
    """``{path: parameter}`` of the named subtrees (the tensors themselves)."""
    return {f"{k}.{n}": p for k in keys for n, p in system.get_submodule(k).named_parameters()}


@torch.no_grad()
def load_subtree_state(system, keys, state: dict) -> None:
    """Copy ``state`` (from :func:`subtree_state`) into the named subtrees in
    place; every name and shape checked first."""
    mine = subtree_state(system, keys)
    if sorted(mine) != sorted(state):
        raise ValueError("train state and system disagree on the trained parameters: "
                         f"{sorted(set(mine) ^ set(state))[:5]}")
    for k, p in mine.items():
        if p.shape != state[k].shape:
            raise ValueError(f"shape mismatch at {k}: {tuple(state[k].shape)} vs {tuple(p.shape)}")
    for k, p in mine.items():
        p.copy_(state[k])


def _check_f32(params) -> None:
    if any(p.dtype != torch.float32 for p in params):
        raise ValueError("the trained subtrees need f32 master weights: build the system "
                         "with train=True")


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
        _check_f32(self.gen_params + self.disc_params)
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

    def state_dict(self) -> dict:
        """The trained subtrees' parameters (cloned), both optimizers'
        states and the step."""
        return {"params": {k: v.detach().clone()
                           for k, v in subtree_state(self.system, GEN_KEYS + DISC_KEYS).items()},
                "opt_gen": self.opt_gen.state_dict(), "opt_disc": self.opt_disc.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        load_subtree_state(self.system, GEN_KEYS + DISC_KEYS, state["params"])
        self.opt_gen.load_state_dict(state["opt_gen"])
        self.opt_disc.load_state_dict(state["opt_disc"])
        self.step = int(state["step"])


class BaseTrainer:
    """MSE + geometric trainer of an in2IN, MDM or InterGen system built with
    ``train=True`` (JAX ``BaseTrainer``; reference scripts/train/{in2IN,
    mdm}.py): lr 1e-4, weight decay 2e-5, no clipping, ``lr_schedule`` (a
    function of the updates taken, e.g.
    :func:`..train.optim.cosine_warmup_schedule`) in place of the constant
    lr.

    The config's ``SAMPLER`` names the schedule sampler: "uniform" or
    "loss-second-moment", whose history lives on the system's device.  ``frozen(name)`` takes trained parameters out of
    the optimizer's list (their ``requires_grad`` stays off: no update, no
    weight decay), as the fine-tune freezes every ``sa_block``.

    ``step`` takes a batch dict: ``motions`` (B, T, persons * 262) raw,
    ``motion_lens`` (B,), the system's token tensors (keys starting with
    ``tokens``), and a ``torch.Generator`` for the timesteps, the cond drop
    and the noise (drawn in that order)."""

    def __init__(self, system, lr: float = 1e-4, weight_decay: float = 2e-5,
                 clip_norm: Optional[float] = None, grad_acc_steps: int = 1,
                 lr_schedule: Optional[Callable] = None, nan_guard: int = 0,
                 frozen: Optional[Callable[[str], bool]] = None):
        self.system = system
        self.keys = system.TRAIN_MODULES
        named = subtree_state(system, self.keys)
        self.frozen_names = sorted(k for k in named if frozen is not None and frozen(k))
        self.params = [p for k, p in named.items() if k not in self.frozen_names]
        _check_f32(self.params)
        self.opt = AdamW(self.params, lr=lr, weight_decay=weight_decay,
                         grad_acc_steps=grad_acc_steps, nan_guard=nan_guard,
                         clip_norm=clip_norm, schedule=lr_schedule)
        self.sampler_name = system.cfg.get("SAMPLER", "uniform")
        self.sampler = create_named_schedule_sampler(
            self.sampler_name, system.train_schedule.num_timesteps, device=system.device)
        self.step_count = 0

    def step(self, batch: dict, generator: Optional[torch.Generator]) -> dict:
        """One training step; returns the losses, detached."""
        sys_ = self.system
        B = batch["motions"].shape[0]
        # The schedule sampler's draw; the importance weights are discarded,
        # as the reference does (in2in.py:265).
        t, _ = self.sampler.sample(generator, B, sys_.device)
        for p in self.params:
            p.requires_grad_(True)
        try:
            cond = sys_.encode_cond_tokens({k: v for k, v in batch.items()
                                            if k.startswith("tokens")})
            losses = sys_.compute_loss(batch["motions"], batch["motion_lens"], cond, t=t,
                                       generator=generator)
            self.opt.zero_grad()
            losses["total"].backward()
            self.opt.step()
            self.opt.zero_grad()
        finally:
            for p in self.params:
                p.requires_grad_(False)
        losses = {k: v.detach() for k, v in losses.items()}
        self.sampler.update(t, losses["mse_per_sample"])
        self.step_count += 1
        return losses

    def state_dict(self) -> dict:
        """The trained subtrees' parameters (cloned; frozen ones included),
        the optimizer's state, the step and the sampler history."""
        return {"params": {k: v.detach().clone()
                           for k, v in subtree_state(self.system, self.keys).items()},
                "opt": self.opt.state_dict(), "step": self.step_count,
                "sampler": self.sampler.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        load_subtree_state(self.system, self.keys, state["params"])
        self.opt.load_state_dict(state["opt"])
        self.step_count = int(state["step"])
        self.sampler.load_state_dict(state["sampler"])
