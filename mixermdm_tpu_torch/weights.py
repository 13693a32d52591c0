"""Weights of the port: random initialisation from a seed, and the JAX
package's parameters converted into the port's state dicts.

The conversion is this package's own copy of the mapping in
``mixermdm_tpu/train/checkpoint.py`` (``export_in2in_system``,
``export_mixermdm_system``, ``export_mdm_system`` and their helpers, lines
380-620): a tree of numpy arrays in the flax layout becomes a flat state
dict with the reference PyTorch repository's key names, which the
``load_*_params`` functions rename onto this package's modules and load
strictly.  The way back, the ``released_*_state_dict`` functions, writes a
system in the released files' layout (the keys the JAX exporters write),
which the JAX package's converters and this package's
:mod:`..train.checkpoint` loaders read.  InterGen has no released layout in
either package (no converter); its mapping goes straight from the JAX tree
to the port's modules.  The InterCLIP evaluator's module names are the
reference file's, so its state dict needs no renames
(:func:`interclip_state_dict`, JAX ``export_interclip``).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from .models.clip_text import ClipTextEncoder, ClipTextTransformer
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
        elif isinstance(m, ClipTextEncoder):
            m.text_projection.normal_(0.0, m.cfg.width ** -0.5, generator=gen)
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


def export_mdm_system(params: Mapping) -> StateDict:
    """An MDMSystem param tree -> the reference MDM layout (denoiser under
    ``model.``, CLIP tower whole under ``clip_model.`` with its projection,
    ``embed_text``; reference mdm.py:71-82).  Released files hold these keys
    under one more ``model.`` (a Lightning module's)."""
    sd: StateDict = {}
    dn = params["denoiser"]
    export_timestep_embedder(dn["embed_timestep"], "model.embed_timestep", sd)
    export_linear(dn["input_process"], "model.input_process.poseEmbedding", sd)
    export_linear(dn["output_process"], "model.output_process.poseFinal", sd)
    export_torch_encoder(dn["seqTransEncoder"], "model.seqTransEncoder", sd)
    export_linear(params["embed_text"], "embed_text", sd)
    if "clip" in params:
        export_clip_text(params["clip"]["transformer"], sd, prefix="clip_model")
        sd["clip_model.text_projection"] = _np(params["clip"]["text_projection"])
    return sd


def export_intergen_system(params: Mapping) -> StateDict:
    """An InterGenSystem param tree -> a flat state dict in this package's
    own layout for it: the CLIP tower as in2IN's, the denoiser (an
    ``InterDenoiser`` tree, stacked ``blocks/block`` or unrolled
    ``blocks_{i}``) under ``denoiser.``, the post-encoder head as
    ``clipTransEncoder.`` / ``clip_ln.``."""
    sd: StateDict = {}
    if "clip" in params.get("text", {}):
        export_clip_text(params["text"]["clip"], sd, transformer_name="clip_transformer")
    sd.update(export_in2in_denoiser(params["denoiser"], "denoiser"))
    export_clip_post_encoder(params["text"]["post_interaction"], "clipTransEncoder", "clip_ln", sd)
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


def interclip_state_dict(params: Mapping) -> StateDict:
    """A JAX InterCLIP param tree -> the reference evaluator's state dict,
    which is also :class:`~mixermdm_tpu_torch.eval.interclip.InterCLIP`'s
    (JAX ``export_interclip``): ``motion_encoder.*``, ``textTransEncoder.*``,
    ``text_ln``, ``out``, ``token_embedding.weight``,
    ``positional_embedding``, ``latent_scale``."""
    out: StateDict = {}
    me = params["motion_encoder"]
    out["motion_encoder.query_token"] = _np(me["query_token"])
    export_linear(me["embed_motion"], "motion_encoder.embed_motion", out)
    export_torch_encoder(me["transformer"], "motion_encoder.transformer", out)
    export_layernorm(me["out_ln"], "motion_encoder.out_ln", out)
    export_linear(me["out"], "motion_encoder.out", out)
    out["token_embedding.weight"] = _np(params["token_embedding"])
    out["positional_embedding"] = _np(params["positional_embedding"])
    out["latent_scale"] = _np(params["latent_scale"]).reshape(())
    export_torch_encoder(params["text_encoder"], "textTransEncoder", out)
    export_layernorm(params["text_ln"], "text_ln", out)
    export_linear(params["text_out"], "out", out)
    return out


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
    """The renames of an in2IN system of ``mode``; "dual" has both
    denoisers and both heads."""
    names = ("interaction", "individual") if mode == "dual" else (mode,)
    return _CLIP_RENAMES + tuple(r for name in names for r in (
        (f"decoder.net_{name}.", f"denoisers.{name}."),
        (f"clipTransEncoder_{name}.", f"text.post.{name}.encoder."),
        (f"clip_ln_{name}.", f"text.post.{name}.ln."),
    ))


_MDM_CLIP_RENAMES = (
    ("clip_model.transformer.resblocks.", "clip.transformer.resblocks."),
    ("clip_model.token_embedding.", "clip.transformer.token_embedding."),
    ("clip_model.positional_embedding", "clip.transformer.positional_embedding"),
    ("clip_model.ln_final.", "clip.transformer.ln_final."),
    ("clip_model.text_projection", "clip.text_projection"),
)

MDM_RENAMES = _MDM_CLIP_RENAMES + (
    ("model.embed_timestep.", "denoiser.embed_timestep."),
    ("model.input_process.poseEmbedding.", "denoiser.input_process."),
    ("model.output_process.poseFinal.", "denoiser.output_process."),
    ("model.seqTransEncoder.", "denoiser.seqTransEncoder."),
    ("embed_text.", "embed_text."),
)

INTERGEN_RENAMES = _CLIP_RENAMES + (
    ("denoiser.", "denoiser."),
    ("clipTransEncoder.", "text.post.interaction.encoder."),
    ("clip_ln.", "text.post.interaction.ln."),
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


def in2in_state_dict(params: Mapping, mode: str) -> StateDict:
    """A JAX In2INSystem param tree of ``mode`` -> this package's
    In2INSystem state dict."""
    return rename(export_in2in_system(params, mode), in2in_renames(mode))


def mdm_state_dict(params: Mapping) -> StateDict:
    """A JAX MDMSystem param tree -> this package's MDMSystem state dict."""
    return rename(export_mdm_system(params), MDM_RENAMES)


def intergen_state_dict(params: Mapping) -> StateDict:
    """A JAX InterGenSystem param tree -> this package's InterGenSystem
    state dict."""
    return rename(export_intergen_system(params), INTERGEN_RENAMES)


def _submodel_state_dict(params: Mapping, kind: str) -> StateDict:
    """The mixer's submodel tree (JAX ``model1`` / ``model2``) of ``kind``
    -> its state dict under this package's adapter or in2IN system."""
    if kind == "mdm":  # JAX MDMAsIndividual's tree
        tree = {"denoiser": params["denoiser_individual"], "clip": params["clip"],
                "embed_text": params["embed_text"]}
        return {f"mdm.{k}": v for k, v in mdm_state_dict(tree).items()}
    if kind == "intergen":  # JAX InterGenAsInteraction's tree
        tree = {"denoiser": params["denoiser_interaction"], "text": params["text"]}
        return {f"intergen.{k}": v for k, v in intergen_state_dict(tree).items()}
    return in2in_state_dict(params, kind)


def mixermdm_state_dict(params: Mapping, model1: str = "individual",
                        model2: str = "interaction") -> StateDict:
    """A whole JAX MixerMDMSystem param tree -> this package's
    MixerMDMSystem state dict (both submodels, the mixer core, both
    discriminators, the mixer's text pipeline).  ``model1`` is
    "individual" (in2IN) or "mdm", ``model2`` "interaction" (in2IN) or
    "intergen"."""
    sd: StateDict = {}
    for name, kind in (("model1", model1), ("model2", model2)):
        sd.update({f"{name}.{k}": v for k, v in _submodel_state_dict(params[name], kind).items()})
    sd.update(rename(export_mixermdm_system(params), MIXER_RENAMES))
    return sd


def _released(state_dict: Mapping[str, torch.Tensor], renames: tuple,
              with_clip: bool, clip_renames: tuple = _CLIP_RENAMES) -> Dict[str, torch.Tensor]:
    """The entries of a port state dict that ``renames`` maps, under their
    released names, as f32 CPU tensors; ``with_clip=False`` leaves the CLIP
    tower (``clip_renames``) out."""
    if not with_clip:
        renames = tuple(r for r in renames if r not in clip_renames)
    out = {}
    for key, value in state_dict.items():
        for ref, port in renames:
            if key.startswith(port):
                out[ref + key[len(port):]] = value.detach().float().cpu()
                break
    return out


def released_mixermdm_state_dict(system: nn.Module,
                                 with_clip: bool = True) -> Dict[str, torch.Tensor]:
    """A MixerMDMSystem's trained parts in the released ``MixerMDM.ckpt``
    layout: mixer core (``mixing.``), discriminators, the mixer's
    post-encoder head (``clipTransEncoder.`` / ``clip_ln.``) and its CLIP
    tower (unless ``with_clip`` is off, as the released file drops it), as
    f32 CPU tensors.  The frozen denoisers are left out, as the released
    file leaves them out."""
    return _released(system.state_dict(), MIXER_RENAMES, with_clip)


def released_in2in_state_dict(in2in_system: nn.Module, mode: str,
                              with_clip: bool = True) -> Dict[str, torch.Tensor]:
    """An In2INSystem in the released in2IN layout, the keys the JAX
    package's ``export_in2in_system`` writes: the denoiser under
    ``decoder.net_<mode>.``, its post-encoder head as
    ``clipTransEncoder_<mode>.`` / ``clip_ln_<mode>.``, and the CLIP tower at
    top level (unless ``with_clip`` is off), as f32 CPU tensors.  With
    :func:`released_mixermdm_state_dict` a MixerMDMSystem writes all three
    released files (``system.model1`` individual, ``system.model2``
    interaction).  A dual (DualMDM) system writes its two files as the
    reference ships them, ``mode`` "interaction" and "individual" (each
    with the parts of that name); "dual" writes both parts in one dict."""
    return _released(in2in_system.state_dict(), in2in_renames(mode), with_clip)


def released_mdm_state_dict(mdm_system: nn.Module,
                            with_clip: bool = True) -> Dict[str, torch.Tensor]:
    """An MDMSystem in the reference MDM layout (the keys the JAX package's
    ``export_mdm_system`` writes), as f32 CPU tensors; save it as a
    Lightning checkpoint (:func:`..train.checkpoint.save_released`), whose
    ``model.`` the loaders strip."""
    return _released(mdm_system.state_dict(), MDM_RENAMES, with_clip, _MDM_CLIP_RENAMES)


def released_interclip_state_dict(interclip: nn.Module) -> Dict[str, torch.Tensor]:
    """An InterCLIP in the reference evaluator file's layout (its own
    parameter names), as f32 CPU tensors; ``latent_scale`` with the
    reference's shape (1,) (``nn.Parameter(torch.Tensor([1]))``)."""
    out = {k: v.detach().float().cpu().clone() for k, v in interclip.state_dict().items()}
    out["latent_scale"] = out["latent_scale"].reshape(1)
    return out


def without_individual_cross_attention(sd: Mapping, prefix: str = "") -> dict:
    """An individual-mode denoiser has no cross-attention; trees converted
    from reference checkpoints carry it all the same.  Drops the
    ``.ca_block.`` entries of the keys under ``prefix``."""
    return {k: v for k, v in sd.items() if not (k.startswith(prefix) and ".ca_block." in k)}


def load_state_dict_np(module: nn.Module, sd: StateDict, strict: bool = True) -> nn.Module:
    """Load numpy arrays into ``module`` (cast to each parameter's dtype and
    device)."""
    module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                           strict=strict)
    return module


def load_mixermdm_params(system: nn.Module, params: Mapping) -> nn.Module:
    """Load a JAX MixerMDMSystem param tree (numpy leaves) into a
    :class:`~mixermdm_tpu_torch.systems.mixermdm.MixerMDMSystem`, its
    submodels in2IN systems or the MDM / InterGen adapters."""
    kinds = ("mdm" if hasattr(system.model1, "mdm") else "individual",
             "intergen" if hasattr(system.model2, "intergen") else "interaction")
    return load_state_dict_np(system, mixermdm_state_dict(params, *kinds))


def load_in2in_params(system: nn.Module, params: Mapping) -> nn.Module:
    """Load a JAX In2INSystem param tree into an In2INSystem of the same
    mode."""
    return load_state_dict_np(system, in2in_state_dict(params, system.mode))


def load_mdm_params(system: nn.Module, params: Mapping) -> nn.Module:
    return load_state_dict_np(system, mdm_state_dict(params))


def load_intergen_params(system: nn.Module, params: Mapping) -> nn.Module:
    return load_state_dict_np(system, intergen_state_dict(params))


def load_interclip_params(interclip: nn.Module, params: Mapping) -> nn.Module:
    """Load a JAX InterCLIP param tree into an InterCLIP of the same
    architecture."""
    return load_state_dict_np(interclip, interclip_state_dict(params))


def load_denoiser_params(denoiser: nn.Module, params: Mapping) -> nn.Module:
    """Load one JAX In2INDenoiser param tree into an In2INDenoiser.  An
    individual-mode denoiser has no cross-attention; trees converted from
    reference checkpoints carry it all the same, and it is left out."""
    sd = export_in2in_denoiser(params)
    if denoiser.mode == "individual":
        sd = without_individual_cross_attention(sd)
    return load_state_dict_np(denoiser, sd)
