"""CLIP text tower and tokenizers; counterpart of
``mixermdm_tpu/models/clip_text.py`` (reference in2in.py:56-66,109-135,
mdm.py:71-121).

The tower is token embedding + causal pre-LN transformer + ``ln_final``; its
pooled condition is the feature at the EOT token.  :class:`ClipTextEncoder`
is CLIP's whole ``encode_text`` (the pooled feature times
``text_projection``), which MDM conditions on.  With no released weights
in the repository it runs with random weights.  The tokenizers are this
package's own copies: :class:`ClipBPETokenizer` when a BPE merges file is
given, else :class:`HashTokenizer`, a dependency-free stand-in with CLIP's
special-token layout (SOT 49406, EOT 49407, zero padding).
"""

from __future__ import annotations

import dataclasses
import gzip
import hashlib
import html
import os
import re
from functools import lru_cache
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..ops import linear
from .layers import Linear, TorchMultiheadAttention
from .torch_compat import LayerNormAffine

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
SOT_TOKEN = 49406
EOT_TOKEN = 49407


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    width: int = 768
    layers: int = 12
    heads: int = 12
    vocab_size: int = VOCAB_SIZE
    context_length: int = CONTEXT_LENGTH
    projection_dim: Optional[int] = None  # 768 for ViT-L/14, 512 for ViT-B/32

    @staticmethod
    def vit_l_14() -> "ClipTextConfig":
        return ClipTextConfig(width=768, layers=12, heads=12, projection_dim=768)

    @staticmethod
    def vit_b_32() -> "ClipTextConfig":
        return ClipTextConfig(width=512, layers=12, heads=8, projection_dim=512)

    @staticmethod
    def tiny(width: int = 64, layers: int = 2, heads: int = 4) -> "ClipTextConfig":
        return ClipTextConfig(width=width, layers=layers, heads=heads, projection_dim=width)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class ClipMLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = Linear(width, 4 * width)
        self.c_proj = Linear(4 * width, width)

    def forward(self, x):
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ClipResBlock(nn.Module):
    """Pre-LN residual attention block with a QuickGELU MLP."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = LayerNormAffine(width)
        self.attn = TorchMultiheadAttention(width, heads, add_zero_attn=False)
        self.ln_2 = LayerNormAffine(width)
        self.mlp = ClipMLP(width)

    def forward(self, x, attn_mask=None):
        x = x + self.attn(self.ln_1(x), None, attn_mask)
        return x + self.mlp(self.ln_2(x))


class ClipTextTransformer(nn.Module):
    """CLIP text encoder: tokens (B, T) -> per-token features after
    ``ln_final`` (B, T, width)."""

    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, cfg.width))
        nn.init.normal_(self.token_embedding.weight, std=0.02)
        nn.init.normal_(self.positional_embedding, std=0.01)
        self.resblocks = nn.ModuleList(ClipResBlock(cfg.width, cfg.heads)
                                       for _ in range(cfg.layers))
        self.ln_final = LayerNormAffine(cfg.width)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        T = tokens.shape[1]
        x = self.token_embedding(tokens) + self.positional_embedding[:T]
        causal = torch.full((T, T), float("-inf"), device=x.device).triu(1)
        for block in self.resblocks:
            x = block(x, causal)
        return self.ln_final(x)


class ClipTextEncoder(nn.Module):
    """CLIP's ``encode_text``: the tower, EOT pooling and the text projection
    (B, 77) -> (B, projection_dim), as MDM uses it (JAX ``ClipTextEncoder``).
    The projection is a bare matrix (width, projection_dim); its product
    runs on the ``linear_epilogue`` kernel on the card, as every bf16 dense
    layer does."""

    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.cfg = cfg
        self.transformer = ClipTextTransformer(cfg)
        proj_dim = cfg.projection_dim or cfg.width
        self.text_projection = nn.Parameter(torch.empty(cfg.width, proj_dim))
        nn.init.normal_(self.text_projection, std=cfg.width ** -0.5)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        pooled = eot_pool(self.transformer(tokens), tokens)
        return linear(pooled, self.text_projection.t().to(pooled.dtype))


def eot_pool(feats: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Feature at the EOT token of each sequence (EOT has the largest id)."""
    idx = tokens.argmax(dim=-1)
    return feats[torch.arange(feats.shape[0], device=feats.device), idx]


# ---------------------------------------------------------------------------
# Tokenizers
# ---------------------------------------------------------------------------


@lru_cache()
def _bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipBPETokenizer:
    """CLIP's byte-pair tokenizer over the standard merges file (the OpenAI
    ``bpe_simple_vocab_16e6.txt.gz`` or a plain merges.txt)."""

    def __init__(self, bpe_path: str):
        if not os.path.exists(bpe_path):
            raise FileNotFoundError(bpe_path)
        if bpe_path.endswith(".gz"):
            with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                merges = f.read().split("\n")
            merges = merges[1: 49152 - 256 - 2 + 1]
        else:
            with open(bpe_path, encoding="utf-8") as f:
                merges = [m for m in f.read().split("\n") if m and not m.startswith("#")]
        merges = [tuple(m.split()) for m in merges]
        self.byte_encoder = _bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]"
            r"|[^\sa-zA-Z0-9]+", re.IGNORECASE)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word[:-1], word[1:]))
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = set(zip(word[:-1], word[1:]))
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = []
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids


class HashTokenizer:
    """Deterministic stand-in tokenizer (no vocabulary file): one token per
    whitespace word, id = stable hash into the BPE id range.  Not compatible
    with released CLIP weights."""

    def encode(self, text: str) -> List[int]:
        ids = []
        for w in _whitespace_clean(_basic_clean(text)).lower().split(" "):
            if w:
                h = int.from_bytes(hashlib.sha256(w.encode()).digest()[:4], "little")
                ids.append(1 + h % (SOT_TOKEN - 1))
        return ids


BPE_PATH = "data/bpe_simple_vocab_16e6.txt.gz"


def default_tokenizer():
    """CLIP's BPE when ``data/`` under the working directory holds the
    OpenAI merges file, else :class:`HashTokenizer`."""
    return ClipBPETokenizer(BPE_PATH) if os.path.exists(BPE_PATH) else HashTokenizer()


def tokenize(texts: List[str], tokenizer=None, context_length: int = CONTEXT_LENGTH,
             truncate: bool = True, pad_to: Optional[int] = None) -> np.ndarray:
    """Batch-encode texts to int32 (B, pad_to or context_length) with
    ``clip.tokenize`` semantics (SOT, ids, EOT, zero padding; long texts
    truncated to ``context_length`` with EOT kept last, or refused with
    ``truncate=False``).  MDM's layout is ``context_length=22, pad_to=77``:
    22 tokens at most, zero-padded to the tower's 77 (reference
    mdm.py:104-112)."""
    tokenizer = tokenizer or default_tokenizer()
    result = np.zeros((len(texts), pad_to or context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [SOT_TOKEN] + tokenizer.encode(text) + [EOT_TOKEN]
        if len(ids) > context_length:
            if not truncate:
                raise ValueError(f"text too long: {text!r}")
            ids = ids[: context_length - 1] + [EOT_TOKEN]
        result[i, : len(ids)] = ids
    return result
