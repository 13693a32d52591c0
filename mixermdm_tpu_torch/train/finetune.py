"""Fine-tuning an interaction in2IN model from an individual one;
counterpart of ``mixermdm_tpu/train/finetune.py`` (reference
scripts/train/finetuned.py: the individual -> interaction key renames
:185-188, the non-strict load, the freeze of every ``sa_block`` :218-220).

The freeze follows the reference: the ``sa_block`` parameters leave the
optimizer's list and keep ``requires_grad`` off, so they take no update and
no weight decay and stay bitwise as loaded.  (The JAX package wraps its
optimizer in ``optax.masked``, which passes the masked-out gradients through
as updates, so its "frozen" parameters move by +gradient each step.)
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def individual_to_interaction(individual: nn.Module, interaction: nn.Module) -> list:
    """Copy every tensor the individual denoiser shares with the
    interaction one (same name and shape) into the interaction denoiser, in
    place; the cross-attention blocks (``ca_block``), which the individual
    denoiser does not have, keep their fresh init.  Returns the names of the
    interaction denoiser's parameters left as they were."""
    src = individual.state_dict()
    dst = interaction.state_dict()
    for k, v in dst.items():
        if k in src:
            if src[k].shape != v.shape:
                raise ValueError(f"{k}: individual {tuple(src[k].shape)} vs interaction "
                                 f"{tuple(v.shape)}")
            v.copy_(src[k])
    return sorted(k for k, _ in interaction.named_parameters() if k not in src)


def sa_block_frozen(name: str) -> bool:
    """Whether a trained parameter stays frozen in the fine-tune: every
    parameter under an ``sa_block`` (reference finetuned.py:218-220)."""
    return ".sa_block." in f".{name}."
