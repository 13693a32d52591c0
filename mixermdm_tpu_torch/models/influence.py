"""Influence network: per-joint / per-frame mixing weights; counterpart of
``mixermdm_tpu/models/influence.py`` (reference influence.py:50).

Modes: 1 one global scalar, 2 one scalar per frame, 3 23 weights (22 joints
+ foot contact), 4 23 weights per frame (the shipped default).
:func:`expand_influence` maps the 23 weights onto the 262-d feature layout.
"""

from __future__ import annotations

import torch
from torch import nn

from .blocks import InfluenceBlockCross
from .layers import Linear


class Influence(nn.Module):
    def __init__(self, input_shape: int, n_blocks: int = 4, n_heads: int = 8,
                 ff_size: int = 1024, mode: int = 4, dropout: float = 0.0):
        super().__init__()
        self.mode = mode
        self.blocks = nn.ModuleList(InfluenceBlockCross(input_shape, n_heads, ff_size, dropout)
                                    for _ in range(n_blocks))
        self.out = Linear(input_shape, 1 if mode in (1, 2) else 23)

    def forward(self, m_i, m_I, cond_i, cond_I, mask=None):
        kpm = None
        if mask is not None:
            m = mask[..., 0] if mask.dim() == 3 else mask
            kpm = ~(m > 0.5)
        h = m_i
        for block in self.blocks:
            h = block(h, m_I, cond_i, cond_I, kpm)
        if self.mode in (1, 3):
            h = h.mean(dim=1)
        return torch.sigmoid(self.out(h))


def _expand_23(w: torch.Tensor) -> torch.Tensor:
    """(B, T, 23) -> (B, T, 262): [66 pos | 66 vel | 126 rot | 4 contact]."""
    joints = w[..., :22].repeat_interleave(3, dim=-1)
    rots = w[..., :21].repeat_interleave(6, dim=-1)
    contact = w[..., 22:23].expand(w.shape[:-1] + (4,))
    return torch.cat([joints, joints, rots, contact], dim=-1)


def expand_influence(influence: torch.Tensor, T: int, mode: int) -> torch.Tensor:
    """Broadcast influence weights to the (B, T, 262) feature layout (all
    four mixing modes)."""
    if mode == 1:
        return influence[:, None, :].expand(influence.shape[0], T, 1)
    if mode == 2:
        return influence
    if mode == 3:
        return _expand_23(influence[:, None, :].expand(influence.shape[0], T, 23))
    if mode == 4:
        return _expand_23(influence)
    raise ValueError(f"unknown mixing mode {mode}")
