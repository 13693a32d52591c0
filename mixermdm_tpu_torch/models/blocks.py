"""Transformer blocks of the denoisers, the influence net and the
discriminators; counterpart of ``mixermdm_tpu/models/blocks.py`` (reference
blocks.py:30-89 and influence.py:6-48).  Every block is SA -> (CA) -> FFN
with the residual adds inside the sub-layers (``residual=True``), fused into
the output projection on the card where no gradient is recorded."""

from __future__ import annotations

from torch import nn

from .layers import FFN, VanillaCrossAttention, VanillaSelfAttention


class TransformerBlockDoubleCond(nn.Module):
    """in2IN block: SA and FFN on the individual cond, CA to the partner
    stream on the interaction cond; individual mode has no CA."""

    def __init__(self, mode: str, latent_dim: int = 512, num_heads: int = 8,
                 ff_size: int = 1024):
        super().__init__()
        self.sa_block = VanillaSelfAttention(latent_dim, num_heads)
        self.ca_block = (VanillaCrossAttention(latent_dim, num_heads)
                         if self.has_cross_attention(mode) else None)
        self.ffn = FFN(latent_dim, ff_size)

    @staticmethod
    def has_cross_attention(mode: str) -> bool:
        return mode not in ("individual", "dual_individual")

    def forward(self, x, y, emb, emb_interaction=None, key_padding_mask=None):
        h = self.sa_block(x, emb, key_padding_mask, residual=True)
        if self.ca_block is not None:
            h = self.ca_block(h, y, emb_interaction, key_padding_mask, residual=True)
        return self.ffn(h, emb, residual=True)


class TransformerBlockSimple(nn.Module):
    """SA -> FFN on one conditioning embedding (the discriminators' block,
    reference blocks.py:66-89)."""

    def __init__(self, latent_dim: int = 512, num_heads: int = 8, ff_size: int = 1024,
                 dropout: float = 0.0):
        super().__init__()
        self.sa_block = VanillaSelfAttention(latent_dim, num_heads, dropout)
        self.ffn = FFN(latent_dim, ff_size, dropout)

    def forward(self, x, emb, key_padding_mask=None):
        return self.ffn(self.sa_block(x, emb, key_padding_mask, residual=True), emb,
                        residual=True)


class InfluenceBlockCross(nn.Module):
    """SA(individual stream, cond_i) -> CA(to the interaction stream,
    cond_I) -> FFN(cond_I)."""

    def __init__(self, latent_dim: int = 512, num_heads: int = 8, ff_size: int = 1024,
                 dropout: float = 0.0):
        super().__init__()
        self.sa_block = VanillaSelfAttention(latent_dim, num_heads, dropout)
        self.ca_block = VanillaCrossAttention(latent_dim, num_heads, dropout)
        self.ffn = FFN(latent_dim, ff_size, dropout)

    def forward(self, m_i, m_I, emb_i, emb_I, key_padding_mask=None):
        h = self.sa_block(m_i, emb_i, key_padding_mask, residual=True)
        h = self.ca_block(h, m_I, emb_I, key_padding_mask, residual=True)
        return self.ffn(h, emb_I, residual=True)
