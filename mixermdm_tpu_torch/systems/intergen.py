"""InterGen system, the two-person baseline: CLIP ViT-L/14 with a 2-layer
post-encoder head, the InterGen denoiser and CFG sampling; counterpart of
``mixermdm_tpu/systems/intergen.py`` (reference intergen.py:20-213),
training (``compute_loss``, :class:`~.base.BaseModelSystem`) included; no
CLI trains it, as in the JAX package.  Neither package has an InterGen
checkpoint converter, so no InterGen file is read."""

from __future__ import annotations

from typing import Optional

import torch

from ..config import INTERGEN_DEFAULT, Config
from ..models.cfg import cfg_model
from ..models.clip_text import ClipTextConfig
from ..models.intergen import InterDenoiser
from ..utils.normalizer import Normalizer, interhuman_normalizer
from .base import BaseModelSystem
from .text import TextPipeline


class InterGenSystem(BaseModelSystem):
    def __init__(self, cfg: Optional[Config] = None, clip_cfg: Optional[ClipTextConfig] = None,
                 normalizer: Optional[Normalizer] = None, data_root: str = "./data",
                 device="cuda", compute_dtype="auto", train: bool = False):
        super().__init__()
        self.cfg = cfg or INTERGEN_DEFAULT
        self.nfeats = int(self.cfg.INPUT_DIM)
        self.text = TextPipeline(clip_cfg, heads=("interaction",))
        self.text_dim = self.text.clip_cfg.width
        self.denoiser = InterDenoiser(
            input_feats=self.nfeats, latent_dim=int(self.cfg.LATENT_DIM),
            ff_size=int(self.cfg.FF_SIZE), num_layers=int(self.cfg.NUM_LAYERS),
            num_heads=int(self.cfg.NUM_HEADS), text_dim=self.text_dim,
            dropout=float(self.cfg.get("DROPOUT", 0.0)))
        self._finish_init(self.cfg, normalizer if normalizer is not None
                          else interhuman_normalizer(data_root), device, compute_dtype, train)

    TRAIN_MODULES = ("denoiser", "text.post")
    loss_mode = "interaction"

    def f32_heads(self) -> list:
        return [self.text.post]

    def train_denoiser(self):
        return self.denoiser

    def encode_cond_tokens(self, batch_tokens: dict) -> torch.Tensor:
        return self.text.encode(batch_tokens["tokens"], "interaction")

    @torch.inference_mode()
    def text_process(self, texts) -> torch.Tensor:
        return self.text.encode(self.text.tokenize(texts), "interaction")

    def cfg_model(self):
        return cfg_model(self.cast_apply(self.denoiser), float(self.cfg.CFG_WEIGHT))

    @torch.inference_mode()
    def sample(self, cond: torch.Tensor, n_frames: int, *,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               normalize_output: bool = True) -> torch.Tensor:
        """The CFG chain, DDIM or DPM-Solver++: (B, n_frames, 524), raw motion
        unless ``normalize_output`` is off."""
        cond = cond.to(self.device, torch.float32)
        model = self.cfg_model()
        out = self.run_chain(lambda x, t: model(x, t, None, cond),
                             (cond.shape[0], n_frames, 2 * self.nfeats), generator=generator,
                             noise=noise)
        return self.denormalize(out, 2) if normalize_output else out

    def forward_test(self, batch: dict, generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.sample(self.text_process(batch["text"]), int(batch["motion_lens"][0]),
                           generator=generator, noise=noise)
