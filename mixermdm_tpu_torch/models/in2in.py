"""in2IN denoiser in its four modes; counterpart of
``mixermdm_tpu/models/in2in.py:In2INDenoiser`` (reference in2in.py:358-463).

As in the JAX package the two person streams are stacked into the batch
axis (2B) so every layer runs once at double batch; in the interaction modes
the cross-person partner is the swapped half of the stack.

Inside ``parallel.pipeline_scope`` (``--pp``) the layer stacks of the
individual and interaction modes run as a GPipe pipeline
(:func:`..parallel.pipeline.pipeline_scan`) where :meth:`_can_pipeline`
holds, as the JAX package's ``run_stack`` does; ``dual_individual`` always
runs its layers in order.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel.pipeline import pipeline_context, pipeline_scan
from .blocks import TransformerBlockDoubleCond
from .embeddings import PositionalEncoding, TimestepEmbedder
from .layers import FinalLayer, Linear

MODES = ("individual", "interaction", "dual_individual", "dual_interaction")


class In2INDenoiser(nn.Module):
    """Text-conditioned motion denoiser.

    * ``individual``:       x (B, T, F), cond (B, text_dim).
    * ``interaction``:      x (B, T, 2F), cond (B, 3 * text_dim) ordered
                            [I, i1, i2].
    * ``dual_interaction``: as ``interaction``, on the first three slices of
                            DualMDM's (B, 5 * text_dim) cond.
    * ``dual_individual``:  x (B, T, 2F), DualMDM's cond, slices [3] and [4]
                            for persons a and b; no cross-attention.  The
                            reference quirk (in2in.py:441-452) is kept: person
                            b's stream is never carried from block to block,
                            so it is only the LAST block applied to its raw
                            embedding, while person a runs the whole stack.

    ``dropout`` acts in training mode only (attention probabilities and the
    FFN hidden layer, as the JAX package's ``train=True``).
    """

    def __init__(self, input_feats: int, mode: str, latent_dim: int = 512,
                 ff_size: int = 1024, num_layers: int = 8, num_heads: int = 8,
                 text_dim: int = 768, dropout: float = 0.0):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown In2INDenoiser mode {mode!r} (have {MODES})")
        self.input_feats, self.mode, self.text_dim = input_feats, mode, text_dim
        self.embed_timestep = TimestepEmbedder(latent_dim)
        self.text_embed = Linear(text_dim, latent_dim)
        self.motion_embed = Linear(input_feats, latent_dim)
        self.sequence_pos_encoder = PositionalEncoding(latent_dim)
        self.blocks = nn.ModuleList(
            TransformerBlockDoubleCond(mode, latent_dim, num_heads, ff_size, dropout)
            for _ in range(num_layers))
        self.out = FinalLayer(latent_dim, input_feats)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                mask: Optional[torch.Tensor] = None, cond: Optional[torch.Tensor] = None):
        B, F, td = x.shape[0], self.input_feats, self.text_dim
        t_emb = self.embed_timestep(timesteps, x.dtype)
        emb_of = lambda i: t_emb + self.text_embed(cond[:, i * td:(i + 1) * td])  # noqa: E731
        # mask None: no key is masked (the JAX package's all-False mask).
        kpm = None
        if mask is not None:
            m = mask[..., 0] if mask.dim() == 3 else mask
            kpm = ~(m > 0.5)

        if self.mode == "individual":
            h = self.sequence_pos_encoder(self.motion_embed(x[..., :F]))
            return self.out(self._run_stack(h, 0, emb_of(0), None, kpm))

        h = self.sequence_pos_encoder(self.motion_embed(torch.cat([x[..., :F], x[..., F:]], 0)))
        kpm2 = None if kpm is None else torch.cat([kpm, kpm], 0)
        if self.mode == "dual_individual":
            h_a, h_b0 = h[:B], h[B:]
            emb_a, emb_b = emb_of(3), emb_of(4)
            for block in self.blocks[:-1]:
                h_a = block(h_a, None, emb_a, None, kpm)
            # The last block takes person a's stream and person b's raw
            # embedding stacked, one call at 2B rows.
            h = self.blocks[-1](torch.cat([h_a, h_b0], 0), None, torch.cat([emb_a, emb_b], 0),
                                None, kpm2)
        else:  # interaction, dual_interaction
            emb = torch.cat([emb_of(1), emb_of(2)], 0)
            emb_inter = emb_of(0)
            emb_inter2 = torch.cat([emb_inter, emb_inter], 0)
            h = self._run_stack(h, B, emb, emb_inter2, kpm2)
        out = self.out(h)
        return torch.cat([out[:B], out[B:]], dim=-1)

    def _run_stack(self, h, swap_half: int, emb, emb_inter, kpm):
        """Every layer on the stream ``h``; ``swap_half`` nonzero: the
        person-stacked rows, each block's partner the other half.  Under
        ``pipeline_scope``, pipelined where :meth:`_can_pipeline` holds."""
        pp = pipeline_context()
        if pp is not None and not self.training and self._can_pipeline(pp, h.shape[0],
                                                                        swap_half):
            return self._pipelined_stack(h, swap_half, emb, emb_inter, kpm, pp)
        for block in self.blocks:
            partner = torch.cat([h[swap_half:], h[:swap_half]], 0) if swap_half else None
            h = block(h, partner, emb, emb_inter, kpm)
        return h

    def _can_pipeline(self, pp, rows: int, swap_half: int) -> bool:
        """Whether the stack runs as a pipeline under ``pp``: its layers
        divide over the stages and its rows into the microbatches (of even
        size where the persons are stacked); else it runs in order."""
        mesh, axis, n_microbatches = pp
        n_stages = mesh.shape[axis]
        M = n_microbatches or n_stages
        if len(self.blocks) % n_stages:
            return False
        return not (rows % M or (swap_half and (rows // M) % 2))

    def _pipelined_stack(self, h, swap_half: int, emb, emb_inter, kpm, pp):
        """The stack through :func:`pipeline_scan`.  The partner swap needs
        both persons of a sample in one microbatch: the person-stacked rows
        ``[a0..aB-1, b0..bB-1]`` go in pair-major ``[a0, b0, a1, b1, ...]``,
        the swap is a flip within each pair, and the output is
        de-interleaved (the JAX package's ``_pipelined_stack``)."""
        mesh, axis, n_microbatches = pp
        B = swap_half

        def interleave(a):
            if a is None or not B:
                return a
            return torch.stack([a[:B], a[B:]], 1).reshape((2 * B,) + a.shape[1:])

        def body(block, carry):
            hh, e, ei, m = carry
            partner = hh.reshape((-1, 2) + hh.shape[1:]).flip(1).reshape(hh.shape) if B else None
            return (block(hh, partner, e, ei, m), e, ei, m)

        carry = tuple(interleave(a) for a in (h, emb, emb_inter, kpm))
        out = pipeline_scan(body, list(self.blocks), carry, mesh, axis=axis,
                            n_microbatches=n_microbatches)[0]
        if B:
            d = out.reshape((B, 2) + out.shape[1:])
            out = torch.cat([d[:, 0], d[:, 1]], 0)
        return out
