"""AdamW with global-norm clipping, gradient accumulation, an lr schedule
and a non-finite guard; counterpart of
``mixermdm_tpu/train/optim.py:make_adamw`` (optax
``apply_if_finite(MultiSteps(chain(clip_by_global_norm, adamw)))``;
reference train/mixermdm.py:62-97: lr 1e-5, wd 1e-4, clip 0.5, grad_acc 2)
and of ``cosine_warmup_schedule`` (reference utils.py:6-20).

The arithmetic is optax's, step for step, so the CPU tests hold it equal to
``make_adamw`` to ~1e-6: the accumulated gradient is the running mean
``acc + (g - acc) / (n + 1)``; on the k-th call it is clipped to
``clip_norm`` (when not None) by ``g / ||g|| * clip_norm`` when its global
norm is not below ``clip_norm``, then Adam (bias-corrected moments,
``eps`` outside the square root) with decoupled weight decay ``update + wd
* param`` scaled by ``-lr``, where ``lr`` is ``schedule(count)`` of the
number of updates taken before this one when a schedule is given; on the
other calls the parameters stay as they are.  The state is f32 like the
master weights, and :meth:`AdamW.state_dict` holds all of it.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch


CLIP_NORM = 0.5              # the JAX mixer trainer's clip_norm
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults


def cosine_warmup_schedule(base_lr: float, warmup: int, max_iters: int) -> Callable:
    """lr(count) = base_lr * 0.5 * (1 + cos(pi count / max_iters)), scaled
    by min((count + 1) / warmup, 1) during the warmup (reference
    CosineWarmupScheduler, utils.py:12-20; JAX ``cosine_warmup_schedule``)."""

    def schedule(count: int) -> float:
        t = float(count)
        factor = 0.5 * (1.0 + math.cos(math.pi * t / max_iters))
        warm = min((t + 1.0) / warmup, 1.0) if warmup > 0 else 1.0
        return base_lr * factor * warm

    return schedule


class AdamW:
    """The optimizer of one side of the adversarial training, or of a base
    model's training, over ``params`` (f32 tensors with ``.grad``).
    ``clip_norm`` None: no clipping (the base trainer); ``schedule``: the
    lr as a function of the number of updates taken (else ``lr``).

    ``nan_guard`` > 0: a call whose gradients are not all finite changes
    nothing (neither the parameters nor the accumulation), until
    ``nan_guard`` consecutive such calls, after which it goes through, so a
    lasting divergence shows as non-finite parameters (optax
    ``apply_if_finite``).
    """

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-5,
                 weight_decay: float = 1e-4, grad_acc_steps: int = 1, nan_guard: int = 0,
                 clip_norm: Optional[float] = CLIP_NORM, schedule: Optional[Callable] = None):
        self.params = list(params)
        self.lr, self.weight_decay = lr, weight_decay
        self.clip_norm, self.schedule = clip_norm, schedule
        self.k, self.nan_guard = max(1, int(grad_acc_steps)), int(nan_guard)
        self.acc = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.mini_step = 0      # calls accumulated since the last update
        self.count = 0          # Adam updates taken
        self.notfinite_count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _grads(self) -> list:
        return [torch.zeros_like(p, dtype=torch.float32) if p.grad is None else p.grad.float()
                for p in self.params]

    @torch.no_grad()
    def step(self) -> bool:
        """Take one call's gradients (``p.grad``); returns whether the
        parameters changed."""
        grads = self._grads()
        if self.nan_guard > 0:
            finite = all(bool(torch.isfinite(g).all()) for g in grads)
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            if not finite and self.notfinite_count <= self.nan_guard:
                return False
        n = self.mini_step
        for a, g in zip(self.acc, grads):
            a.add_((g - a) / (n + 1))
        self.mini_step = (n + 1) % self.k
        if self.mini_step != 0:
            return False
        updates = [a.clone() for a in self.acc]
        for a in self.acc:
            a.zero_()
        if self.clip_norm is not None:
            norm = torch.sqrt(sum((u * u).sum() for u in updates))
            if not bool(norm < self.clip_norm):
                updates = [u / norm * self.clip_norm for u in updates]
        lr = self.schedule(self.count) if self.schedule is not None else self.lr
        self.count += 1
        c1 = 1.0 - torch.tensor(B1, dtype=torch.float32) ** self.count
        c2 = 1.0 - torch.tensor(B2, dtype=torch.float32) ** self.count
        for p, u, mu, nu in zip(self.params, updates, self.mu, self.nu):
            mu.mul_(B1).add_((1.0 - B1) * u)
            nu.mul_(B2).add_((1.0 - B2) * u * u)
            upd = (mu / c1.to(mu.device)) / (torch.sqrt(nu / c2.to(nu.device)) + EPS)
            upd = upd + self.weight_decay * p.float()
            p.add_((-lr * upd).to(p.dtype))
        return True

    def state_dict(self) -> dict:
        """Everything a resumed run needs: the accumulation, both moments,
        the calls since the last update, the updates taken and the guard's
        counter (tensors cloned)."""
        return {"acc": [a.clone() for a in self.acc], "mu": [m.clone() for m in self.mu],
                "nu": [n.clone() for n in self.nu], "mini_step": self.mini_step,
                "count": self.count, "notfinite_count": self.notfinite_count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` in place (shapes checked)."""
        for name in ("acc", "mu", "nu"):
            mine, theirs = getattr(self, name), state[name]
            if len(mine) != len(theirs) or any(a.shape != b.shape for a, b in zip(mine, theirs)):
                raise ValueError(f"optimizer state {name!r} does not match the parameters")
            for a, b in zip(mine, theirs):
                a.copy_(b)
        self.mini_step, self.count = int(state["mini_step"]), int(state["count"])
        self.notfinite_count = int(state["notfinite_count"])
