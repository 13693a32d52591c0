"""Mixer: the learnable per-step composition of two frozen denoisers;
counterpart of ``mixermdm_tpu/models/mixer.py`` (reference
mixermdm.py:604-811).

Per step: the individual denoiser (both persons stacked at 2B) and the
interaction denoiser run on their cond slices, both outputs are denormalised
to raw motion space (f32), the individual outputs are aligned onto the
interaction trajectories, the influence net predicts per-joint weights and
the two are blended ``out2 + w * (out1 - out2)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from ..utils.alignment import align_persons_fast
from ..utils.normalizer import Normalizer
from .embeddings import PositionalEncoding, TimestepEmbedder
from .influence import Influence, expand_influence
from .layers import Linear, w8a8_scope


class MixerCore(nn.Module):
    """Trainable part of the Mixer: embedders + influence net.  Takes the
    denormalised, aligned denoiser outputs and returns the expanded
    (B, T, 262) influence weights of both persons (stacked at 2B inside)."""

    def __init__(self, nfeats: int = 262, latent_dim: int = 512, ff_size: int = 1024,
                 n_blocks: int = 4, n_heads: int = 8, text_dim: int = 768,
                 mixing_mode: int = 4, dropout: float = 0.0):
        super().__init__()
        self.mixing_mode = mixing_mode
        self.embed_timestep = TimestepEmbedder(latent_dim)
        self.text_embed = Linear(text_dim, latent_dim)
        self.motion_embed = Linear(nfeats, latent_dim)
        self.sequence_pos_encoder = PositionalEncoding(latent_dim)
        self.influence = Influence(latent_dim, n_blocks, n_heads, ff_size, mixing_mode, dropout)

    def forward(self, out1_1, out1_2, out2_1, out2_2, timesteps, cond_I, cond_i1, cond_i2,
                mask=None):
        B, T = out1_1.shape[:2]
        t_emb = self.embed_timestep(timesteps, out1_1.dtype)
        emb_I = t_emb + self.text_embed(cond_I)
        emb_i1 = t_emb + self.text_embed(cond_i1)
        emb_i2 = t_emb + self.text_embed(cond_i2)
        pos, embed = self.sequence_pos_encoder, self.motion_embed
        m_i = pos(embed(torch.cat([out1_1, out1_2], 0)))
        m_I = pos(embed(torch.cat([out2_1, out2_2], 0)))
        mask2 = None if mask is None else torch.cat([mask, mask], 0)
        infl = self.influence(m_i, m_I, torch.cat([emb_i1, emb_i2], 0),
                              torch.cat([emb_I, emb_I], 0), mask2)
        return (expand_influence(infl[:B], T, self.mixing_mode),
                expand_influence(infl[B:], T, self.mixing_mode))


@dataclasses.dataclass(frozen=True)
class MixerConfig:
    """Static composition config (mirrors configs/models/MixerMDM.yaml)."""

    nfeats: int = 262
    latent_dim: int = 512
    ff_size: int = 1024
    n_blocks: int = 4
    n_heads: int = 8
    text_dim: int = 768
    mixing_mode: int = 4
    align: bool = True
    denoiser1_text_dim: int = 768
    denoiser2_text_dim: int = 768

    def cond_slices(self):
        """Offsets into the concatenated 8 x 768 cond vector, ordered
        [I, I_i1, I_i2, ind_i1, ind_i2, mix_I, mix_i1, mix_i2]."""
        d1, d2, td = self.denoiser1_text_dim, self.denoiser2_text_dim, self.text_dim
        base = d2 * 3
        return {
            "cond2": (0, td * 3),
            "cond1_1": (base, base + d1),
            "cond1_2": (base + d1, base + 2 * d1),
            "cond_I": (base + 2 * d1, base + 2 * d1 + d2),
            "cond_i1": (base + 2 * d1 + d2, base + 2 * d1 + 2 * d2),
            "cond_i2": (base + 2 * d1 + 2 * d2, base + 2 * d1 + 3 * d2),
        }


def make_mixer_forward(cfg: MixerConfig, denoiser1: Callable, denoiser2: Callable,
                       core: Callable, normalizer1: Normalizer, normalizer2: Normalizer,
                       compute_dtype: Optional[torch.dtype] = None):
    """The per-step Mixer pipeline as a function
    ``forward(x1, t, cond, mask=None, x2=None, force_influence_val=None,
    quant_denoisers=False)`` returning ``(out_influenced, out1, out2, (infl1, infl2))``.

    ``denoiser1(x, t, mask, cond)`` -> (B, T, 262), ``denoiser2`` -> (B, T,
    524), ``core`` a :class:`MixerCore`.  With ``compute_dtype`` the
    networks run in it; the diffusion arithmetic and the alignment stay f32.
    The denoisers are frozen: they run under ``torch.no_grad()`` (the JAX
    package's ``stop_gradient`` on their cond slices and
    ``fused_scope(frozen)``), so no gradient reaches them and they take the
    fused kernels in training too; the core's conds keep their gradient.
    ``quant_denoisers=True`` runs the two denoisers' calls, and nothing else,
    inside :func:`..models.layers.w8a8_scope` (``QUANT_TRAIN``: the JAX
    package's ``_loss_impl`` scope, which reaches only the frozen fused
    blocks).
    """
    sl = cfg.cond_slices()
    F = cfg.nfeats

    def cut(cond, name):
        a, b = sl[name]
        return cond[:, a:b]

    def forward(x1, t, cond, mask=None, x2=None, force_influence_val=None,
                quant_denoisers=False):
        B, T = x1.shape[:2]
        cd = compute_dtype or x1.dtype
        x1_both = torch.cat([x1[..., :F], x1[..., F:]], 0).to(cd)
        cond1_both = torch.cat([cut(cond, "cond1_1"), cut(cond, "cond1_2")], 0).to(cd)
        t2 = torch.cat([t, t], 0)
        mask2 = None if mask is None else torch.cat([mask, mask], 0)
        with torch.no_grad(), w8a8_scope(quant_denoisers):
            out1_both = denoiser1(x1_both, t2, mask2, cond1_both).float()
            out2 = denoiser2(x2.to(cd), t, mask, cut(cond, "cond2").to(cd)).float()

        out1_both = normalizer1.backward(out1_both)
        out2 = normalizer2.backward(out2.reshape(B, T, 2, -1)).reshape(B, T, -1)
        out1_1, out1_2 = out1_both[:B], out1_both[B:]
        out2_1, out2_2 = out2[..., :F], out2[..., F:]

        if cfg.align:
            am = None if mask is None else torch.cat([mask, mask], 0)
            o2_ih, o1_ih = align_persons_fast(torch.cat([out2_1, out2_2], 0),
                                              torch.cat([out1_1, out1_2], 0), am)
            out1_1, out1_2 = o1_ih[:B], o1_ih[B:]
            out2_1, out2_2 = o2_ih[:B], o2_ih[B:]

        out1 = torch.cat([out1_1, out1_2], dim=-1)
        out2 = torch.cat([out2_1, out2_2], dim=-1)

        infl1, infl2 = core(out1_1.to(cd), out1_2.to(cd), out2_1.to(cd), out2_2.to(cd), t,
                            cut(cond, "cond_I").to(cd), cut(cond, "cond_i1").to(cd),
                            cut(cond, "cond_i2").to(cd), mask)
        infl1, infl2 = infl1.float(), infl2.float()
        if force_influence_val is not None:
            infl1 = torch.full_like(infl1, float(force_influence_val))
            infl2 = torch.full_like(infl2, float(force_influence_val))

        mixed_1 = out2_1 + infl1 * (out1_1 - out2_1)
        mixed_2 = out2_2 + infl2 * (out1_2 - out2_2)
        return torch.cat([mixed_1, mixed_2], dim=-1), out1, out2, (infl1, infl2)

    return forward
