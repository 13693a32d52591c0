"""InterCLIP: the contrastive motion <-> text evaluator (the FID backbone);
counterpart of ``mixermdm_tpu/eval/interclip.py`` (reference
evaluation/models.py:7-252).

:class:`MotionEncoder`: the motion without its 4 contact dims per person, a
learned query token in front (its key always valid), the sinusoidal
positions, a post-norm ``nn.TransformerEncoder`` stack under the key mask
(no zero key), ``out_ln`` and ``out`` (512).  :class:`InterCLIP`: the
motion tower, and the text tower: the frozen CLIP token and positional
embeddings, an 8-layer encoder at 768 with no mask, LayerNorm (eps 1e-5),
EOT pooling and ``out`` (768 -> 512); both embeddings L2-normalised and
scaled by the learned ``latent_scale``; :meth:`InterCLIP.compute_loss` the
symmetric cross-entropy at logit scale ``latent_scale ** 2``.  As in the
JAX package, both towers are built without the config's ``DROPOUT``.

The parameter names are those of the reference's evaluator file, so a
state dict of this module is that layout (``motion_encoder.*``,
``textTransEncoder.*``, ``text_ln``, ``out``, ``token_embedding``,
``positional_embedding``, ``latent_scale``; read by
:func:`..train.checkpoint.load_released_interclip`).

Everything runs in f32, on the card too: the attention on the f32
``attention`` kernel (``attention_f32``; with a gradient,
``ops.FusedAttention`` and ``attention_bwd``), the dense layers as f32
products with TF32 off (:func:`full_f32`), as the JAX package computes them
outside any Pallas kernel.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..models.clip_text import CONTEXT_LENGTH, VOCAB_SIZE, default_tokenizer, eot_pool, tokenize
from ..models.embeddings import PositionalEncoding
from ..models.layers import Linear
from ..models.torch_compat import LayerNormAffine, TorchEncoder

DEFAULT_CFG = {"INPUT_DIM": 258, "LATENT_DIM": 1024, "FF_SIZE": 2048, "NUM_LAYERS": 8,
               "NUM_HEADS": 8, "DROPOUT": 0.1, "MODE": "interaction"}
EMBED_DIM = 512


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuBLAS and cuDNN inside the block (restored after), so
    that the evaluator's f32 dense layers keep f32's precision on the card."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


class MotionEncoder(nn.Module):
    """Query-token transformer -> (B, 512) motion feature (reference
    models.py:7-80)."""

    def __init__(self, input_feats: int = 258, latent_dim: int = 1024, ff_size: int = 2048,
                 num_layers: int = 8, num_heads: int = 8, mode: str = "interaction"):
        super().__init__()
        self.mode = mode
        self.latent_dim = latent_dim
        self.query_token = nn.Parameter(torch.randn(1, latent_dim))
        self.embed_motion = Linear(input_feats * (2 if mode == "interaction" else 1), latent_dim)
        self.sequence_pos_encoder = PositionalEncoding(latent_dim)
        self.transformer = TorchEncoder(latent_dim, num_heads, ff_size, num_layers)
        self.out_ln = LayerNormAffine(latent_dim)
        self.out = Linear(latent_dim, EMBED_DIM)

    def forward(self, motions: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """motions (B, T, persons * 262), mask (B, T) with 1 = valid frame."""
        B, T, _ = motions.shape
        if self.mode == "interaction":
            x = motions.reshape(B, T, 2, -1)[..., :-4].reshape(B, T, -1)
        else:
            x = motions[..., :-4]
        emb = torch.cat([self.query_token.expand(B, 1, self.latent_dim),
                         self.embed_motion(x)], dim=1)
        valid = torch.cat([torch.ones_like(mask[:, :1], dtype=torch.bool), mask > 0.5], dim=1)
        h = self.transformer(self.sequence_pos_encoder(emb), ~valid)
        return self.out(self.out_ln(h)[:, 0])


class InterCLIP(nn.Module):
    """The evaluator: motion tower, text tower, temperature.  ``cfg`` as the
    JAX package's (``INPUT_DIM`` 258, ``LATENT_DIM``, ``FF_SIZE``,
    ``NUM_LAYERS``, ``NUM_HEADS``, ``MODE`` interaction | individual); the
    text tower is ``text_layers`` layers of ``text_heads`` heads at
    ``text_width`` with FF ``text_ff`` (default ``FF_SIZE``).  Built on
    ``device`` in f32; the token and positional embeddings are frozen
    (``requires_grad`` off), as the reference's CLIP embeddings are."""

    def __init__(self, cfg: Optional[Config] = None, text_width: int = 768,
                 text_layers: int = 8, text_heads: int = 8, text_ff: Optional[int] = None,
                 device="cuda"):
        super().__init__()
        cfg = cfg or Config.wrap(dict(DEFAULT_CFG))
        self.cfg = cfg
        self.mode = cfg.get("MODE", "interaction")
        self.text_width = text_width
        with torch.device(device):
            self.motion_encoder = MotionEncoder(
                int(cfg.INPUT_DIM), int(cfg.LATENT_DIM), int(cfg.FF_SIZE), int(cfg.NUM_LAYERS),
                int(cfg.NUM_HEADS), self.mode)
            self.token_embedding = nn.Embedding(VOCAB_SIZE, text_width)
            self.positional_embedding = nn.Parameter(torch.zeros(CONTEXT_LENGTH, text_width))
            self.textTransEncoder = TorchEncoder(text_width, text_heads,
                                                 text_ff or int(cfg.FF_SIZE), text_layers)
            self.text_ln = LayerNormAffine(text_width)
            self.out = Linear(text_width, EMBED_DIM)
            self.latent_scale = nn.Parameter(torch.ones(()))
        self.to(device)  # the positions' table is made on the host
        self.token_embedding.weight.requires_grad_(False)
        self.positional_embedding.requires_grad_(False)
        self.tokenizer = default_tokenizer()
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.latent_scale.device

    @torch.no_grad()
    def init_weights_(self, seed: int) -> "InterCLIP":
        """Random weights from ``seed`` (:func:`..weights.init_params_` for
        the dense, attention and LayerNorm parameters; the query token
        N(0, 1), the token / positional embeddings N(0, 0.02) / N(0, 0.01),
        ``latent_scale`` 1, as the JAX ``init_params``)."""
        from ..weights import init_params_

        init_params_(self, seed)
        gen = torch.Generator(device=self.device).manual_seed(int(seed) + 1)
        self.motion_encoder.query_token.normal_(0.0, 1.0, generator=gen)
        self.token_embedding.weight.normal_(0.0, 0.02, generator=gen)
        self.positional_embedding.normal_(0.0, 0.01, generator=gen)
        self.latent_scale.fill_(1.0)
        return self

    def _as_tensor(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a).to(
            self.device, dtype)

    # ------------------------------------------------------------- encoders
    def encode_motion(self, motions, motion_lens) -> torch.Tensor:
        """(B, T, D) raw motions and their lengths -> (B, 512) L2-normalised
        embeddings times ``latent_scale`` (reference models.py:144-154)."""
        motions = self._as_tensor(motions, torch.float32)
        lens = self._as_tensor(motion_lens, torch.long)
        T = motions.shape[1]
        mask = (torch.arange(T, device=self.device)[None, :] < lens[:, None]).float()
        with full_f32():
            emb = self.motion_encoder(motions, mask)
        return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True) * self.latent_scale

    def tokenize(self, texts: List[str]) -> torch.Tensor:
        return torch.from_numpy(tokenize(list(texts), self.tokenizer)).long()

    def encode_text_tokens(self, tokens) -> torch.Tensor:
        """(B, 77) CLIP tokens -> (B, 512) L2-normalised embeddings times
        ``latent_scale`` (reference models.py:156-180)."""
        tokens = self._as_tensor(tokens, torch.long)
        x = self.token_embedding(tokens) + self.positional_embedding[None]
        with full_f32():
            out = self.text_ln(self.textTransEncoder(x))
            pooled = self.out(eot_pool(out, tokens))
        return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True) * self.latent_scale

    def encode_text(self, texts: List[str]) -> torch.Tensor:
        return self.encode_text_tokens(self.tokenize(texts))

    # ----------------------------------------------------------------- loss
    def compute_loss(self, motions, motion_lens, tokens):
        """Symmetric CE CLIP loss (reference models.py:203-242): returns
        ``(loss, {"total", "ce_from_motion", "ce_from_text"})``."""
        t_emb = self.encode_text_tokens(tokens)
        m_emb = self.encode_motion(motions, motion_lens)
        t_norm = t_emb / torch.linalg.vector_norm(t_emb, dim=-1, keepdim=True)
        m_norm = m_emb / torch.linalg.vector_norm(m_emb, dim=-1, keepdim=True)
        with full_f32():
            logits_m = self.latent_scale ** 2 * m_norm @ t_norm.T
        labels = torch.arange(logits_m.shape[0], device=self.device)
        ce_m = F.cross_entropy(logits_m, labels)
        ce_t = F.cross_entropy(logits_m.T, labels)
        loss = (ce_m + ce_t) / 2.0
        return loss, {"total": loss, "ce_from_motion": ce_m, "ce_from_text": ce_t}


def build_interclip(mode: str = "interaction", *, tiny: bool = False, device="cuda",
                    seed: int = 0) -> InterCLIP:
    """The evaluator of ``mode`` with random weights from ``seed``: the
    published one (1024-d, 8 layers, 8 heads, FF 2048; text 768 x 8 layers),
    or with ``tiny`` the JAX CLIs' miniature (32-d, one layer of 2 heads, FF
    64; text 64-d, one layer of 2 heads, FF 64)."""
    if tiny:
        cfg = Config.wrap({"INPUT_DIM": 258, "LATENT_DIM": 32, "FF_SIZE": 64, "NUM_LAYERS": 1,
                           "NUM_HEADS": 2, "DROPOUT": 0.0, "MODE": mode})
        model = InterCLIP(cfg, text_width=64, text_layers=1, text_heads=2, text_ff=64,
                          device=device)
    else:
        model = InterCLIP(Config.wrap(dict(DEFAULT_CFG, MODE=mode)), device=device)
    return model.init_weights_(seed)
