"""Text conditioning: CLIP tower + named post-encoders + EOT pooling;
counterpart of ``mixermdm_tpu/systems/text.py:TextPipeline`` (reference
in2in.py:109-135, mixermdm.py:283-313).

On the card both the tower and the post-encoders run in the compute dtype
(bf16), so their attention goes through the ``attention`` kernel (causal
D = 64 in the tower, D = 96 in the post-encoder).  The pooled condition is
returned in f32.
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

    def tokenize(self, texts: List[str]) -> torch.Tensor:
        return torch.from_numpy(tokenize(texts, self.tokenizer))

    def encode(self, tokens: torch.Tensor, head: str = "default") -> torch.Tensor:
        """Pre-tokenised text (B, 77) -> pooled (B, width) f32 condition."""
        tokens = tokens.to(self.clip.positional_embedding.device)
        out = self.post[head](self.clip(tokens))
        return eot_pool(out, tokens).float()
