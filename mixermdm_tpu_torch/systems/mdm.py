"""MDM system, the single-person baseline: CLIP ViT-B/32 ``encode_text``,
``embed_text`` (512 -> latent), the MDM denoiser and CFG sampling;
counterpart of ``mixermdm_tpu/systems/mdm.py`` (reference mdm.py:9-231),
training (``compute_loss``, :class:`~.base.BaseModelSystem`) included:
``train=True`` keeps f32 master weights in the denoiser and ``embed_text``.

The tower runs in the compute dtype (bf16 on the card) and ``embed_text`` in
f32 on f32 weights, as the post-encoder heads of the other systems; the
cond is f32.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import MDM_DEFAULT, Config
from ..models.cfg import cfg_model
from ..models.clip_text import ClipTextConfig, ClipTextEncoder, default_tokenizer, tokenize
from ..models.layers import Linear
from ..models.mdm import MDMDenoiser
from ..utils.normalizer import Normalizer, hml3d_normalizer
from .base import BaseModelSystem, data_parallel_sample

# MDM's text layout: 22 tokens at most, zero-padded to the tower's 77
# (reference mdm.py:104-112).
MDM_CONTEXT, MDM_PAD_TO = 22, 77


class MDMSystem(BaseModelSystem):
    def __init__(self, cfg: Optional[Config] = None, clip_cfg: Optional[ClipTextConfig] = None,
                 normalizer: Optional[Normalizer] = None, data_root: str = "./data",
                 device="cuda", compute_dtype="auto", train: bool = False):
        super().__init__()
        self.cfg = cfg or MDM_DEFAULT
        self.nfeats = int(self.cfg.INPUT_DIM)
        self.clip_cfg = clip_cfg or ClipTextConfig.vit_b_32()
        self.clip = ClipTextEncoder(self.clip_cfg)
        self.embed_text = Linear(self.clip_cfg.projection_dim or self.clip_cfg.width,
                                 int(self.cfg.LATENT_DIM))
        self.denoiser = MDMDenoiser(
            input_feats=self.nfeats, latent_dim=int(self.cfg.LATENT_DIM),
            ff_size=int(self.cfg.FF_SIZE), num_layers=int(self.cfg.NUM_LAYERS),
            num_heads=int(self.cfg.NUM_HEADS), dropout=float(self.cfg.get("DROPOUT", 0.0)))
        self.tokenizer = default_tokenizer()
        self._finish_init(self.cfg, normalizer if normalizer is not None
                          else hml3d_normalizer(data_root), device, compute_dtype, train)

    TRAIN_MODULES = ("denoiser", "embed_text")

    def f32_heads(self) -> list:
        return [self.embed_text]

    def train_denoiser(self):
        return self.denoiser

    def tokenize(self, texts) -> torch.Tensor:
        """MDM's 22-token context zero-padded to 77."""
        return torch.from_numpy(tokenize(texts, self.tokenizer, context_length=MDM_CONTEXT,
                                         pad_to=MDM_PAD_TO))

    def encode_cond_tokens(self, batch_tokens: dict) -> torch.Tensor:
        """(B, latent) f32 cond from pre-tokenised text (key ``tokens``): the
        frozen tower's pooled, projected feature in f32, then
        ``embed_text``."""
        tokens = batch_tokens["tokens"].to(self.device)
        with torch.no_grad():
            feats = self.clip(tokens).float()
        return self.embed_text(feats)

    @torch.inference_mode()
    def text_process(self, texts) -> torch.Tensor:
        return self.encode_cond_tokens({"tokens": self.tokenize(texts)})

    def cfg_model(self):
        return cfg_model(self.cast_apply(self.denoiser), float(self.cfg.CFG_WEIGHT))

    @torch.inference_mode()
    def sample(self, cond: torch.Tensor, n_frames: int, *,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               normalize_output: bool = True, mesh=None) -> torch.Tensor:
        """The CFG chain, DDIM or DPM-Solver++: (B, n_frames, 262), raw motion
        unless ``normalize_output`` is off; with ``mesh`` the batch splits
        over its data axis (:func:`.base.data_parallel_sample`)."""
        cond = cond.to(self.device, torch.float32)
        if mesh is not None:
            return data_parallel_sample(self.sample, mesh, cond, (n_frames, self.nfeats),
                                        generator=generator, noise=noise,
                                        normalize_output=normalize_output)
        model = self.cfg_model()
        out = self.run_chain(lambda x, t: model(x, t, None, cond),
                             (cond.shape[0], n_frames, self.nfeats), generator=generator,
                             noise=noise)
        return self.denormalize(out, 1) if normalize_output else out

    def forward_test(self, batch: dict, generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.sample(self.text_process(batch["text"]), int(batch["motion_lens"][0]),
                           generator=generator, noise=noise)
