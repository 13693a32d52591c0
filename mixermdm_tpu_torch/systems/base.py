"""What the base-model systems (in2IN in its three modes, MDM, InterGen)
share for sampling: the respaced schedule and the sampler, the cast to the
compute dtype with the post-encoder heads kept in f32, the denoisers' dtype
boundary, the single-stream chain and the normalizer's way back.  The
counterpart of the parts the JAX package's ``In2INSystem``, ``MDMSystem``
and ``InterGenSystem`` repeat (``__init__``, ``denoiser_apply(cast=True)``,
``sample``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..diffusion.gaussian import ddim_sample_loop, dpmpp_sample_loop
from ..diffusion.schedule import named_schedule, resolve_sampler_strategy
from ..models.layers import Int8Block, w8a8_scope
from ..utils.normalizer import Normalizer


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


def cast_params_(module: nn.Module, compute_dtype, f32_modules, quantise: bool) -> None:
    """Cast the parameters of ``module`` to ``compute_dtype`` (None: f32)
    once, those of ``f32_modules`` kept f32.  With ``quantise`` in bf16 the
    blocks that will run as int8 quantise their weights here, from the bf16
    values, as the JAX package quantises its bf16-cast tree."""
    keep = {id(p) for m in f32_modules for p in m.parameters()}
    for p in module.parameters():
        p.data = p.data.to(torch.float32 if id(p) in keep else compute_dtype or torch.float32)
    if quantise and compute_dtype == torch.bfloat16:
        with w8a8_scope():
            for m in module.modules():
                if isinstance(m, Int8Block) and m.runs_int8(compute_dtype):
                    m.int8_weights()


class BaseModelSystem(nn.Module):
    """Sampling state and helpers of a base-model system.  Subclasses build
    their modules, then call :meth:`_finish_init`; they name the modules
    whose parameters stay f32 (:meth:`f32_heads`) and the parameter that
    tells their device.

    A system is built on the card in its compute dtype ("auto": bf16 on
    CUDA, f32 elsewhere) unless the caller names another device.  ``device``
    None builds it as a part of a larger system: where the caller's
    ``torch.device`` context puts tensors, left for that system to move and
    cast (with ``compute_dtype`` None, f32)."""

    def _finish_init(self, cfg, normalizer: Normalizer, device, compute_dtype) -> None:
        """Move to ``device`` (None: where a tensor made now would land),
        freeze, build the sampling schedule, cast to ``compute_dtype`` (None:
        leave f32)."""
        device = torch.device(device) if device is not None else torch.empty(0).device
        self.to(device)
        self.requires_grad_(False)
        self.eval()
        steps = int(cfg.DIFFUSION_STEPS)
        self.sampler_type, strategy = resolve_sampler_strategy(cfg)
        self.sample_schedule = named_schedule(cfg.BETA_SCHEDULER, steps, strategy, device=device)
        self.normalizer = normalizer.to(device)
        self.quant = bool(cfg.get("QUANT", False))
        self.compute_dtype = None
        if compute_dtype is not None:
            self.cast_(resolve_compute_dtype(compute_dtype, device))

    def f32_heads(self) -> list:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def cast_(self, compute_dtype) -> "BaseModelSystem":
        """Run the networks in ``compute_dtype`` (None: f32), the weights
        cast once; the modules of :meth:`f32_heads` stay f32.  Under
        ``QUANT`` in bf16 the blocks that will run as int8 quantise their
        weights here."""
        self.compute_dtype = compute_dtype
        cast_params_(self, compute_dtype, self.f32_heads(), self.quant)
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
