"""in2IN system, the parts the mixer calls; counterpart of
``mixermdm_tpu/systems/in2in.py`` (``denoiser_apply``, ``encode_tokens``,
``generate_src_mask``).  Training and the standalone in2IN sampler are not
ported yet."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import IN2IN_INTERACTION_DEFAULT, Config
from ..models.clip_text import ClipTextConfig
from ..models.in2in import In2INDenoiser
from .text import TextPipeline


class In2INSystem(nn.Module):
    """One mode-specialised in2IN model: its text pipeline (tower +
    post-encoder head named after the mode) and its denoiser."""

    def __init__(self, cfg: Optional[Config] = None, mode: str = "interaction",
                 clip_cfg: Optional[ClipTextConfig] = None):
        super().__init__()
        if mode not in ("individual", "interaction"):
            raise NotImplementedError(f"In2INSystem mode {mode!r} is not ported yet")
        self.cfg = cfg or IN2IN_INTERACTION_DEFAULT
        self.mode = mode
        self.nfeats = int(self.cfg.INPUT_DIM)
        self.latent_dim = int(self.cfg.LATENT_DIM)
        self.text = TextPipeline(clip_cfg, heads=(mode,))
        self.text_dim = self.text.clip_cfg.width
        self.denoisers = nn.ModuleDict({mode: In2INDenoiser(
            input_feats=self.nfeats, mode=mode, latent_dim=self.latent_dim,
            ff_size=int(self.cfg.FF_SIZE), num_layers=int(self.cfg.NUM_LAYERS),
            num_heads=int(self.cfg.NUM_HEADS), text_dim=self.text_dim)})

    def denoiser_apply(self, name: str):
        """``apply(x, t, mask, cond)`` of the named denoiser."""
        return self.denoisers[name]

    def encode_tokens(self, tokens: torch.Tensor, head: str) -> torch.Tensor:
        return self.text.encode(tokens, head)


def generate_src_mask(T: int, lengths, B: int, device="cpu") -> torch.Tensor:
    """(B, T, 2) float mask, zero after each sequence's length."""
    lengths = torch.as_tensor(lengths, device=device)
    frame = torch.arange(T, device=device)[None, :] < lengths[:, None]
    return frame[..., None].float().expand(B, T, 2).contiguous()
