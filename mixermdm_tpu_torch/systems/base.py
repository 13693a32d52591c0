"""What the base-model systems (in2IN in its three modes, MDM, InterGen)
share: the respaced schedule and the sampler, the cast to the compute dtype
with the post-encoder heads kept in f32, the denoisers' dtype boundary, the
single-stream chain and the normalizer's way back; and for training the
train schedule, the f32 master weights of the trained subtrees
(``train=True``) and :meth:`BaseModelSystem.compute_loss`.  The counterpart
of the parts the JAX package's ``In2INSystem``, ``MDMSystem`` and
``InterGenSystem`` repeat (``__init__``, ``denoiser_apply``, ``sample``,
``compute_loss``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..diffusion.gaussian import ddim_sample_loop, dpmpp_sample_loop
from ..diffusion.losses import motion_training_losses
from ..diffusion.schedule import named_schedule, resolve_sampler_strategy
from ..models.layers import Int8Block, w8a8_scope
from ..utils.normalizer import Normalizer

# Probability that a training sample's cond is zeroed (classifier-free
# guidance training; the JAX systems' cond_mask_prob).
COND_MASK_PROB = 0.1


def generate_src_mask(T: int, lengths, B: int, device="cpu") -> torch.Tensor:
    """(B, T, 2) float mask, zero after each sequence's length."""
    lengths = torch.as_tensor(lengths, device=device)
    frame = torch.arange(T, device=device)[None, :] < lengths[:, None]
    return frame[..., None].float().expand(B, T, 2).contiguous()


def resolve_compute_dtype(compute_dtype, device: torch.device) -> Optional[torch.dtype]:
    """``"auto"``: bf16 on CUDA, f32 (None) elsewhere, as the JAX package
    picks bf16 on TPU and f32 elsewhere."""
    if compute_dtype == "auto":
        return torch.bfloat16 if device.type == "cuda" else None
    if compute_dtype in ("bf16", "bfloat16", torch.bfloat16):
        return torch.bfloat16
    if compute_dtype in (None, "f32", "float32", torch.float32):
        return None
    raise ValueError(f"unknown compute_dtype {compute_dtype!r}")


def quantise_blocks_(module: nn.Module, compute_dtype) -> None:
    """In bf16, the blocks of ``module`` that will run as int8 quantise
    their weights now, from the bf16 values, as the JAX package quantises
    its bf16-cast tree."""
    if compute_dtype != torch.bfloat16:
        return
    with w8a8_scope():
        for m in module.modules():
            if isinstance(m, Int8Block) and m.runs_int8(compute_dtype):
                m.int8_weights()


def cast_params_(module: nn.Module, compute_dtype, f32_modules, quantise: bool) -> None:
    """Cast the parameters of ``module`` to ``compute_dtype`` (None: f32)
    once, those of ``f32_modules`` kept f32; with ``quantise``,
    :func:`quantise_blocks_`."""
    keep = {id(p) for m in f32_modules for p in m.parameters()}
    for p in module.parameters():
        p.data = p.data.to(torch.float32 if id(p) in keep else compute_dtype or torch.float32)
    if quantise:
        quantise_blocks_(module, compute_dtype)


class BaseModelSystem(nn.Module):
    """Sampling and training state and helpers of a base-model system.
    Subclasses build their modules, then call :meth:`_finish_init`; they name
    the modules whose parameters stay f32 (:meth:`f32_heads`), the subtrees
    a base trainer updates (:attr:`TRAIN_MODULES`), the denoiser the loss
    trains (:meth:`train_denoiser`) and the loss's person mode
    (:attr:`loss_mode`).

    A system is built on the card in its compute dtype ("auto": bf16 on
    CUDA, f32 elsewhere) unless the caller names another device.  ``device``
    None builds it as a part of a larger system: where the caller's
    ``torch.device`` context puts tensors, left for that system to move and
    cast (with ``compute_dtype`` None, f32).  With ``train`` the subtrees of
    :attr:`TRAIN_MODULES` keep f32 master weights (the JAX base trainer
    trains f32 parameters)."""

    def _finish_init(self, cfg, normalizer: Normalizer, device, compute_dtype,
                     train: bool = False) -> None:
        """Move to ``device`` (None: where a tensor made now would land),
        freeze, build the sampling and training schedules, cast to
        ``compute_dtype`` (None: leave f32)."""
        device = torch.device(device) if device is not None else torch.empty(0).device
        self.to(device)
        self.requires_grad_(False)
        self.eval()
        steps = int(cfg.DIFFUSION_STEPS)
        self.sampler_type, strategy = resolve_sampler_strategy(cfg)
        self.sample_schedule = named_schedule(cfg.BETA_SCHEDULER, steps, strategy, device=device)
        self.train_schedule = named_schedule(cfg.BETA_SCHEDULER, steps, device=device)
        self.normalizer = normalizer.to(device)
        self.quant = bool(cfg.get("QUANT", False))
        self.compute_dtype = None
        if compute_dtype is not None:
            self.cast_(resolve_compute_dtype(compute_dtype, device), train=train)

    def f32_heads(self) -> list:
        raise NotImplementedError

    # The subtrees a base trainer updates (JAX ``BaseTrainer._trainable_keys``):
    # the denoiser(s), the post-encoder heads or ``embed_text``; never the
    # CLIP tower.
    TRAIN_MODULES: tuple = ()
    loss_mode = "individual"

    def train_denoiser(self) -> nn.Module:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def cast_(self, compute_dtype, train: bool = False) -> "BaseModelSystem":
        """Run the networks in ``compute_dtype`` (None: f32), the weights
        cast once; the modules of :meth:`f32_heads` stay f32, and with
        ``train`` those of :attr:`TRAIN_MODULES` too (f32 master
        weights, cast per forward).  Under ``QUANT`` in bf16 (not ``train``)
        the blocks that will run as int8 quantise their weights here."""
        self.compute_dtype = compute_dtype
        f32 = self.f32_heads()
        if train:
            f32 = f32 + [self.get_submodule(n) for n in self.TRAIN_MODULES]
        cast_params_(self, compute_dtype, f32, self.quant and not train)
        return self

    def cast_apply(self, denoiser: nn.Module):
        """``fn(x, t, mask, cond)``: the denoiser in the compute dtype, f32 at
        its boundary (JAX ``denoiser_apply(cast=True)``)."""
        cd = self.compute_dtype or torch.float32

        def apply(x, t, mask, cond):
            return denoiser(x.to(cd), t, mask, cond.to(cd)).float()
        return apply

    def run_chain(self, model, shape: tuple, *, generator=None, noise=None, traj_control=None,
                  skip_timesteps: int = 0, init_image=None) -> torch.Tensor:
        """The sampler's chain (DDIM or DPM-Solver++) over ``model(x,
        t_orig)``, under the W8A8 scope when ``QUANT`` is on; the last x0 in
        the model's normalised space."""
        dev = self.device
        as_f32 = lambda a: None if a is None else torch.as_tensor(a).to(dev, torch.float32)  # noqa: E731
        loop = dpmpp_sample_loop if self.sampler_type == "dpmpp" else ddim_sample_loop
        with w8a8_scope(self.quant):
            return loop(model, self.sample_schedule, shape, device=dev, noise=as_f32(noise),
                        generator=generator, traj_control=as_f32(traj_control),
                        skip_timesteps=int(skip_timesteps), init_image=as_f32(init_image))

    def denormalize(self, out: torch.Tensor, persons: int) -> torch.Tensor:
        """Model space -> raw motion, per person."""
        B, T = out.shape[:2]
        return self.normalizer.backward(out.reshape(B, T, persons, -1)).reshape(B, T, -1)

    # ------------------------------------------------------------------- loss
    def compute_loss(self, motions, motion_lens, cond, *, t=None,
                     generator: Optional[torch.Generator] = None, noise=None, drop=None,
                     dropout: bool = True) -> dict:
        """The base model's training loss (JAX ``compute_loss`` of
        ``In2INSystem`` / ``MDMSystem`` / ``InterGenSystem``; reference
        in2in.py:246-283 -> MotionDiffusion.training_losses).

        ``motions`` (B, T, persons * 262) raw, ``motion_lens`` (B,), ``cond``
        from ``encode_cond_tokens``.  The cond-drop mask (a row zeroed with
        probability :data:`COND_MASK_PROB`), the timesteps and the noise are
        drawn from ``generator`` in that order unless given as ``drop``
        (B, 1) bool, ``t`` (B,) (a schedule sampler's draw) and ``noise``.
        The trained denoiser runs in the compute dtype in training mode
        (dropout), unless ``dropout`` is off; everything else stays in eval
        mode.  Returns the loss dict with ``total`` and ``mse_per_sample``."""
        dev = self.device
        motions = motions.to(dev, torch.float32)
        B, T = motions.shape[:2]
        if drop is None:
            drop = torch.rand((B, 1), generator=generator, device=dev) < COND_MASK_PROB
        cond = cond * (1.0 - drop.to(dev, torch.float32))
        seq_mask = generate_src_mask(T, motion_lens, B, device=dev)
        if t is None:
            t = torch.randint(0, self.train_schedule.num_timesteps, (B,), generator=generator,
                              device=dev)
        denoiser = self.train_denoiser()
        apply = self.cast_apply(denoiser)
        denoiser.train(dropout)
        try:
            return motion_training_losses(
                lambda x_t, t_orig: apply(x_t, t_orig, seq_mask, cond), self.train_schedule,
                motions, t.to(dev), seq_mask, mode=self.loss_mode, t_bar=int(self.cfg.T_BAR),
                normalizer=self.normalizer, noise=noise, generator=generator)
        finally:
            denoiser.eval()
