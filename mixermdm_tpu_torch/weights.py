"""Weights of the port: random initialisation from a seed, and the JAX
package's parameters converted into the port's state dicts.

The conversion is this package's own copy of the mapping in
``mixermdm_tpu/train/checkpoint.py`` (``export_in2in_system``,
``export_mixermdm_system`` and their helpers, lines 380-580): a tree of
numpy arrays in the flax layout becomes a flat state dict with the reference
PyTorch repository's key names, which :func:`load_mixermdm_params` renames
onto this package's modules and loads strictly.  The way back,
:func:`released_mixermdm_state_dict`, writes a system's trained parts in the
released ``MixerMDM.ckpt`` layout (the keys ``export_mixermdm_system``
writes), which the JAX package's ``convert_mixermdm_system`` reads.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from .models.clip_text import ClipTextTransformer
from .models.layers import Linear, TorchMultiheadAttention
from .models.torch_compat import LayerNormAffine

StateDict = Dict[str, np.ndarray]


# --------------------------------------------------------------------------
# Random weights from a seed
# --------------------------------------------------------------------------

@torch.no_grad()
def init_params_(module: nn.Module, seed: int, zero_init_std: float = 0.0) -> nn.Module:
    """Fill every parameter of ``module`` in place from ``torch.Generator``
    seeded with ``seed``, on the parameters' device: torch's default
    uniform(+-1/sqrt(fan_in)) for dense layers and attention projections,
    ones/zeros for LayerNorms, N(0, 0.02) / N(0, 0.01) for the CLIP token /
    positional embeddings.  Layers marked zero-init (the reference's
    ``zero_module``) get zeros, or N(0, zero_init_std) when that is > 0 so a
    random model has nonzero outputs."""
    device = next(module.parameters()).device
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def uniform(t, bound):
        t.uniform_(-bound, bound, generator=gen)

    for m in module.modules():
        if isinstance(m, Linear):
            if m.zero_init:
                for p in (m.weight, m.bias):
                    if zero_init_std > 0:
                        p.normal_(0.0, zero_init_std, generator=gen)
                    else:
                        p.zero_()
            else:
                bound = 1.0 / math.sqrt(m.in_features)
                uniform(m.weight, bound)
                uniform(m.bias, bound)
        elif isinstance(m, TorchMultiheadAttention):
            bound = 1.0 / math.sqrt(m.embed_dim)
            uniform(m.in_proj_weight, bound)
            uniform(m.in_proj_bias, bound)
        elif isinstance(m, LayerNormAffine):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, ClipTextTransformer):
            m.token_embedding.weight.normal_(0.0, 0.02, generator=gen)
            m.positional_embedding.normal_(0.0, 0.01, generator=gen)
    return module


# --------------------------------------------------------------------------
# flax params -> reference-layout state dicts
# --------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    return np.asarray(x)


def unstack_layer_tree(tree, n: int) -> list:
    """A stacked (scan) layer tree -> a list of ``n`` per-layer trees."""
    def take(t, i):
        if isinstance(t, Mapping):
            return {k: take(v, i) for k, v in t.items()}
        return _np(t)[i]
    return [take(tree, i) for i in range(n)]


def _first_leaf(tree) -> np.ndarray:
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return _np(tree)


def _layer_list(params: Mapping, outer: str, inner: str, unrolled: str) -> list:
    """Per-layer trees from the stacked ``params[outer][inner]`` layout or
    the unrolled ``{unrolled}_{i}`` one."""
    if outer in params:
        stacked = params[outer][inner]
        return unstack_layer_tree(stacked, _first_leaf(stacked).shape[0])
    layers, i = [], 0
    while f"{unrolled}_{i}" in params:
        layers.append(params[f"{unrolled}_{i}"])
        i += 1
    return layers


def export_linear(p: Mapping, prefix: str, out: StateDict):
    out[f"{prefix}.weight"] = _np(p["kernel"]).T.copy()
    out[f"{prefix}.bias"] = _np(p["bias"])


def export_layernorm(p: Mapping, prefix: str, out: StateDict):
    out[f"{prefix}.weight"] = _np(p["scale"])
    out[f"{prefix}.bias"] = _np(p["bias"])


def export_mha(p: Mapping, prefix: str, out: StateDict):
    qw, kw, vw = (_np(p[n]["kernel"]).T for n in ("q_proj", "k_proj", "v_proj"))
    qb, kb, vb = (_np(p[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj"))
    if qw.shape == kw.shape == vw.shape:
        out[f"{prefix}.in_proj_weight"] = np.concatenate([qw, kw, vw], axis=0)
    else:
        out[f"{prefix}.q_proj_weight"] = qw
        out[f"{prefix}.k_proj_weight"] = kw
        out[f"{prefix}.v_proj_weight"] = vw
    out[f"{prefix}.in_proj_bias"] = np.concatenate([qb, kb, vb], axis=0)
    export_linear(p["out_proj"], f"{prefix}.out_proj", out)


def export_adaln(p: Mapping, prefix: str, out: StateDict):
    export_linear(p["emb_proj"], f"{prefix}.emb_layers.1", out)


def export_timestep_embedder(p: Mapping, prefix: str, out: StateDict):
    export_linear(p["linear1"], f"{prefix}.time_embed.0", out)
    export_linear(p["linear2"], f"{prefix}.time_embed.2", out)


def export_ffn(p: Mapping, prefix: str, out: StateDict):
    export_linear(p["linear1"], f"{prefix}.linear1", out)
    export_linear(p["linear2"], f"{prefix}.linear2", out)
    if "norm" in p:
        export_adaln(p["norm"], f"{prefix}.norm", out)


def export_transformer_block(p: Mapping, prefix: str, out: StateDict):
    export_mha(p["sa_block"]["attention"], f"{prefix}.sa_block.attention", out)
    if "norm" in p["sa_block"]:
        export_adaln(p["sa_block"]["norm"], f"{prefix}.sa_block.norm", out)
    if "ca_block" in p:
        export_mha(p["ca_block"]["attention"], f"{prefix}.ca_block.attention", out)
        export_adaln(p["ca_block"]["norm"], f"{prefix}.ca_block.norm", out)
        export_adaln(p["ca_block"]["xf_norm"], f"{prefix}.ca_block.xf_norm", out)
    export_ffn(p["ffn"], f"{prefix}.ffn", out)


def export_in2in_denoiser(params: Mapping, prefix: str = "") -> StateDict:
    out: StateDict = {}
    p = prefix + "." if prefix else ""
    export_timestep_embedder(params["embed_timestep"], f"{p}embed_timestep", out)
    export_linear(params["motion_embed"], f"{p}motion_embed", out)
    export_linear(params["text_embed"], f"{p}text_embed", out)
    export_linear(params["out"]["linear"], f"{p}out.linear", out)
    for i, tree in enumerate(_layer_list(params, "blocks", "block", "blocks")):
        export_transformer_block(tree, f"{p}blocks.{i}", out)
    return out


def export_torch_encoder(params: Mapping, prefix: str, out: StateDict):
    for i, lp in enumerate(_layer_list(params, "layers", "layer", "layers")):
        export_mha(lp["self_attn"], f"{prefix}.layers.{i}.self_attn", out)
        export_linear(lp["linear1"], f"{prefix}.layers.{i}.linear1", out)
        export_linear(lp["linear2"], f"{prefix}.layers.{i}.linear2", out)
        export_layernorm(lp["norm1"], f"{prefix}.layers.{i}.norm1", out)
        export_layernorm(lp["norm2"], f"{prefix}.layers.{i}.norm2", out)


def export_clip_post_encoder(params: Mapping, enc_prefix: str, ln_prefix: str, out: StateDict):
    export_torch_encoder(params["encoder"], enc_prefix, out)
    export_layernorm(params["ln"], ln_prefix, out)


def export_clip_text(params: Mapping, out: StateDict, prefix: str = "",
                     transformer_name: str = "transformer"):
    p = prefix + "." if prefix else ""
    out[f"{p}token_embedding.weight"] = _np(params["token_embedding"])
    out[f"{p}positional_embedding"] = _np(params["positional_embedding"])
    export_layernorm(params["ln_final"], f"{p}ln_final", out)
    if "text_projection" in params:
        out[f"{p}text_projection"] = _np(params["text_projection"])
    for i, rp in enumerate(_layer_list(params, "resblocks", "resblock", "resblocks")):
        rb = f"{p}{transformer_name}.resblocks.{i}"
        export_layernorm(rp["ln_1"], f"{rb}.ln_1", out)
        export_layernorm(rp["ln_2"], f"{rb}.ln_2", out)
        export_mha(rp["attn"], f"{rb}.attn", out)
        export_linear(rp["c_fc"], f"{rb}.mlp.c_fc", out)
        export_linear(rp["c_proj"], f"{rb}.mlp.c_proj", out)


def export_in2in_system(params: Mapping, mode: str) -> StateDict:
    """An In2INSystem param tree -> reference in2IN state dict (denoisers
    under ``decoder.net_*``, post-encoders ``clipTransEncoder_*`` /
    ``clip_ln_*``, CLIP tower at top level)."""
    sd: StateDict = {}
    if "clip" in params.get("text", {}):
        export_clip_text(params["text"]["clip"], sd, transformer_name="clip_transformer")
    if mode in ("interaction", "dual"):
        sd.update(export_in2in_denoiser(params["denoiser_interaction"], "decoder.net_interaction"))
        export_clip_post_encoder(params["text"]["post_interaction"],
                                 "clipTransEncoder_interaction", "clip_ln_interaction", sd)
    if mode in ("individual", "dual"):
        sd.update(export_in2in_denoiser(params["denoiser_individual"], "decoder.net_individual"))
        export_clip_post_encoder(params["text"]["post_individual"],
                                 "clipTransEncoder_individual", "clip_ln_individual", sd)
    return sd


def export_influence(params: Mapping, prefix: str, out: StateDict):
    export_linear(params["out"], f"{prefix}.out", out)
    for i, bp in enumerate(_layer_list(params, "blocks", "block", "blocks")):
        export_transformer_block(bp, f"{prefix}.blocks.{i}", out)


def export_mixer_core(params: Mapping, out: StateDict, prefix: str = "mixing"):
    p = prefix + "." if prefix else ""
    export_timestep_embedder(params["embed_timestep"], f"{p}embed_timestep", out)
    export_linear(params["motion_embed"], f"{p}motion_embed", out)
    export_linear(params["text_embed"], f"{p}text_embed", out)
    export_influence(params["influence"], f"{p}influence", out)


def export_discriminator(params: Mapping, prefix: str, out: StateDict):
    export_timestep_embedder(params["embed_timestep"], f"{prefix}.embed_timestep", out)
    export_linear(params["motion_embed"], f"{prefix}.motion_embed", out)
    export_linear(params["text_embed"], f"{prefix}.text_embed", out)
    export_linear(params["out"], f"{prefix}.out", out)
    for i, bp in enumerate(_layer_list(params, "blocks", "block", "blocks")):
        export_transformer_block(bp, f"{prefix}.blocks.{i}", out)


def export_mixermdm_system(params: Mapping) -> StateDict:
    """The trained parts of a MixerMDM param tree -> the reference
    MixerMDM.ckpt layout (mixer core, discriminators, post-encoder, tower)."""
    sd: StateDict = {}
    export_mixer_core(params["core"], sd, prefix="mixing")
    export_discriminator(params["disc_i"], "discriminator_i", sd)
    export_discriminator(params["disc_I"], "discriminator_I", sd)
    export_clip_post_encoder(params["text"]["post_mixer"], "clipTransEncoder", "clip_ln", sd)
    if "clip" in params.get("text", {}):
        export_clip_text(params["text"]["clip"], sd, transformer_name="clip_transformer")
    return sd


# --------------------------------------------------------------------------
# reference-layout state dicts -> this package's modules
# --------------------------------------------------------------------------

_CLIP_RENAMES = (
    ("clip_transformer.resblocks.", "text.clip.resblocks."),
    ("token_embedding.", "text.clip.token_embedding."),
    ("positional_embedding", "text.clip.positional_embedding"),
    ("ln_final.", "text.clip.ln_final."),
)


def in2in_renames(mode: str) -> tuple:
    return _CLIP_RENAMES + (
        (f"decoder.net_{mode}.", f"denoisers.{mode}."),
        (f"clipTransEncoder_{mode}.", f"text.post.{mode}.encoder."),
        (f"clip_ln_{mode}.", f"text.post.{mode}.ln."),
    )


MIXER_RENAMES = _CLIP_RENAMES + (
    ("mixing.", "core."),
    ("discriminator_i.", "disc_i."),
    ("discriminator_I.", "disc_I."),
    ("clipTransEncoder.", "text.post.mixer.encoder."),
    ("clip_ln.", "text.post.mixer.ln."),
)


def rename(sd: StateDict, renames: tuple) -> StateDict:
    """Map reference keys onto module paths by prefix; an unmatched key is
    an error."""
    out: StateDict = {}
    for key, value in sd.items():
        for old, new in renames:
            if key.startswith(old):
                out[new + key[len(old):]] = value
                break
        else:
            raise KeyError(f"no module path for reference key {key!r}")
    return out


def mixermdm_state_dict(params: Mapping) -> StateDict:
    """A whole JAX MixerMDMSystem param tree -> this package's
    MixerMDMSystem state dict (both denoisers, the mixer core, both
    discriminators, the three text pipelines)."""
    sd: StateDict = {}
    for name, mode in (("model1", "individual"), ("model2", "interaction")):
        part = rename(export_in2in_system(params[name], mode), in2in_renames(mode))
        sd.update({f"{name}.{k}": v for k, v in part.items()})
    sd.update(rename(export_mixermdm_system(params), MIXER_RENAMES))
    return sd


def released_mixermdm_state_dict(system: nn.Module) -> Dict[str, torch.Tensor]:
    """A MixerMDMSystem's trained parts in the released ``MixerMDM.ckpt``
    layout: mixer core (``mixing.``), discriminators, the mixer's
    post-encoder head (``clipTransEncoder.`` / ``clip_ln.``) and its CLIP
    tower, as f32 CPU tensors.  The frozen denoisers are left out, as the
    released file leaves them out."""
    out = {}
    for key, value in system.state_dict().items():
        for ref, port in MIXER_RENAMES:
            if key.startswith(port):
                out[ref + key[len(port):]] = value.detach().float().cpu()
                break
    return out


def load_state_dict_np(module: nn.Module, sd: StateDict, strict: bool = True) -> nn.Module:
    """Load numpy arrays into ``module`` (cast to each parameter's dtype and
    device)."""
    module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                           strict=strict)
    return module


def load_mixermdm_params(system: nn.Module, params: Mapping) -> nn.Module:
    """Load a JAX MixerMDMSystem param tree (numpy leaves) into a
    :class:`~mixermdm_tpu_torch.systems.mixermdm.MixerMDMSystem`."""
    return load_state_dict_np(system, mixermdm_state_dict(params))


def load_denoiser_params(denoiser: nn.Module, params: Mapping) -> nn.Module:
    """Load one JAX In2INDenoiser param tree into an In2INDenoiser.  An
    individual-mode denoiser has no cross-attention; trees converted from
    reference checkpoints carry it all the same, and it is left out."""
    sd = export_in2in_denoiser(params)
    if denoiser.mode == "individual":
        sd = {k: v for k, v in sd.items() if ".ca_block." not in k}
    return load_state_dict_np(denoiser, sd)
