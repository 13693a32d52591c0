"""Transformer blocks of the denoisers, the influence net and the
discriminators; counterpart of ``mixermdm_tpu/models/blocks.py`` (reference
blocks.py:3-89 and influence.py:6-48).  Every block is SA -> (CA) -> FFN
with the residual adds inside the sub-layers (``residual=True``), fused into
the output projection on the card where no gradient is recorded.

Sequence parallelism (the JAX package's ``seq_constraint`` after each
sub-layer): where it applies to a block's stream (:func:`seq_parallel_applies`)
the block takes this rank's slice of T at its entry, runs its sub-layers on
the slices (each gathers its modulated rows along T before its first
product and reduce-scatters its row-parallel sum along T) and gathers the
stream whole at its exit, so the stacks around the blocks see what they see
without it.  The partner stream of a cross-attention stays whole."""

from __future__ import annotations

from torch import nn

from .layers import FFN, VanillaCrossAttention, VanillaSelfAttention, seq_constraint, \
    seq_gather, seq_parallel_applies


class TransformerBlock(nn.Module):
    """InterGen block (reference blocks.py:3-28): SA, CA to the partner
    stream and FFN, all three on the one embedding."""

    def __init__(self, latent_dim: int = 512, num_heads: int = 8, ff_size: int = 1024,
                 dropout: float = 0.0):
        super().__init__()
        self.sa_block = VanillaSelfAttention(latent_dim, num_heads, dropout)
        self.ca_block = VanillaCrossAttention(latent_dim, num_heads, dropout)
        self.ffn = FFN(latent_dim, ff_size, dropout)

    def forward(self, x, y, emb, key_padding_mask=None):
        sp = seq_parallel_applies(x)
        h = self.sa_block(seq_constraint(x, sp), emb, key_padding_mask, residual=True, sp=sp)
        h = self.ca_block(h, y, emb, key_padding_mask, residual=True, sp=sp)
        return seq_gather(self.ffn(h, emb, residual=True, sp=sp), sp)


class TransformerBlockDoubleCond(nn.Module):
    """in2IN block: SA and FFN on the individual cond, CA to the partner
    stream on the interaction cond; individual mode has no CA."""

    def __init__(self, mode: str, latent_dim: int = 512, num_heads: int = 8,
                 ff_size: int = 1024, dropout: float = 0.0):
        super().__init__()
        self.sa_block = VanillaSelfAttention(latent_dim, num_heads, dropout)
        self.ca_block = (VanillaCrossAttention(latent_dim, num_heads, dropout)
                         if self.has_cross_attention(mode) else None)
        self.ffn = FFN(latent_dim, ff_size, dropout)

    @staticmethod
    def has_cross_attention(mode: str) -> bool:
        return mode not in ("individual", "dual_individual")

    def forward(self, x, y, emb, emb_interaction=None, key_padding_mask=None):
        sp = seq_parallel_applies(x)
        h = self.sa_block(seq_constraint(x, sp), emb, key_padding_mask, residual=True, sp=sp)
        if self.ca_block is not None:
            h = self.ca_block(h, y, emb_interaction, key_padding_mask, residual=True, sp=sp)
        return seq_gather(self.ffn(h, emb, residual=True, sp=sp), sp)


class TransformerBlockSimple(nn.Module):
    """SA -> FFN on one conditioning embedding (the discriminators' block,
    reference blocks.py:66-89)."""

    def __init__(self, latent_dim: int = 512, num_heads: int = 8, ff_size: int = 1024,
                 dropout: float = 0.0):
        super().__init__()
        self.sa_block = VanillaSelfAttention(latent_dim, num_heads, dropout)
        self.ffn = FFN(latent_dim, ff_size, dropout)

    def forward(self, x, emb, key_padding_mask=None):
        sp = seq_parallel_applies(x)
        h = self.sa_block(seq_constraint(x, sp), emb, key_padding_mask, residual=True, sp=sp)
        return seq_gather(self.ffn(h, emb, residual=True, sp=sp), sp)


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
        sp = seq_parallel_applies(m_i)
        h = self.sa_block(seq_constraint(m_i, sp), emb_i, key_padding_mask, residual=True, sp=sp)
        h = self.ca_block(h, m_I, emb_I, key_padding_mask, residual=True, sp=sp)
        return seq_gather(self.ffn(h, emb_I, residual=True, sp=sp), sp)
