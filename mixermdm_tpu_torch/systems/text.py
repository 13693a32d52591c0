"""Text conditioning: CLIP tower + named post-encoders + EOT pooling;
counterpart of ``mixermdm_tpu/systems/text.py:TextPipeline`` (reference
in2in.py:109-135, mixermdm.py:283-313).

As in the JAX package (``clip_features``, ``encode``), the frozen tower runs
in the compute dtype (bf16 on the card) under ``torch.no_grad()`` and its
token features are turned to f32; the post-encoder heads run in f32 on f32
parameters (``MixerMDMSystem.cast_`` never casts them), so on the card the
tower's attention takes the bf16 ``attention`` kernel (causal, D = 64) and
the heads' the f32 one (D = 96).  The pooled condition is f32.  The module
starts in eval mode (no dropout), as the JAX package encodes with
``train=False``.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..models.clip_text import ClipTextConfig, ClipTextTransformer, default_tokenizer, eot_pool, \
    tokenize
from ..models.torch_compat import ClipPostEncoder


class TextPipeline(nn.Module):
    def __init__(self, clip_cfg: Optional[ClipTextConfig] = None, heads: tuple = ("default",)):
        super().__init__()
        self.clip_cfg = clip_cfg or ClipTextConfig.vit_l_14()
        self.clip = ClipTextTransformer(self.clip_cfg)
        self.heads = tuple(heads)
        self.post = nn.ModuleDict({h: ClipPostEncoder(d_model=self.clip_cfg.width)
                                   for h in self.heads})
        self.tokenizer = default_tokenizer()
        self.eval()

    def tokenize(self, texts: List[str]) -> torch.Tensor:
        return torch.from_numpy(tokenize(texts, self.tokenizer))

    def encode(self, tokens: torch.Tensor, head: str = "default") -> torch.Tensor:
        """Pre-tokenised text (B, 77) -> pooled (B, width) f32 condition."""
        tokens = tokens.to(self.clip.positional_embedding.device)
        with torch.no_grad():
            feats = self.clip(tokens).float()
        return eot_pool(self.post[head](feats), tokens).float()
