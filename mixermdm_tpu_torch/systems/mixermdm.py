"""MixerMDM system: two frozen in2IN denoisers composed per step by the
Mixer, sampled with a dual-stream CFG DDIM chain; counterpart of
``mixermdm_tpu/systems/mixermdm.py`` (``__init__``, ``encode_cond``,
``sample``; reference mixermdm.py:18-602).

As in the JAX package, CFG cond/uncond and the two person streams are
stacked into the batch, so one DDIM step runs each frozen denoiser once at
4B rows (2 CFG x 2 persons).  The networks run in ``compute_dtype`` (bf16 on
the card, f32 on the CPU); the weights are cast to it once, at
construction, as the JAX package pre-casts its frozen trees once per
sampling call.  The diffusion arithmetic and the alignment stay f32.  The
kernels take bf16 only: f32 networks on the card run inside
``ops.plain_versions()``, else the first kernel call raises.

W8A8 (``QUANT_FROZEN``, on in the shipped config): at sampling time every
network is frozen, so, as the JAX package's ``_sample_impl`` /
``_sample_body`` do, :meth:`sample` and :meth:`cfg_mixer_step` run inside
:func:`..models.layers.w8a8_scope`, where the SA, CA and FFN blocks of both
denoisers and of the mixer core at width >= 512 run their projections as
int8 (bf16 compute only).  The int8 weights are quantised from the bf16
weights in :meth:`cast_`; text encoding is never int8 (the towers run in
bf16, the post-encoder heads in f32).

Training (``compute_loss``, the JAX ``compute_loss`` / ``_loss_body``): the
two discriminators, the adversarial losses of
:func:`..diffusion.mixer_diffusion.mixer_training_losses`, the frozen
denoisers under ``torch.no_grad()`` on their fused bf16 kernels (never int8:
``QUANT_FROZEN`` gates sampling only, and ``QUANT_TRAIN`` is not ported).
Every parameter starts frozen (``requires_grad`` off) and every module in
eval mode; the trainer turns on the side it trains.  Built with
``train=True``, the trainable subtrees (``core``, ``text.post.mixer``,
``disc_i``, ``disc_I``) keep f32 master weights, cast to the compute dtype
per forward as the JAX package casts their inputs.

Not ported yet: the DPM-Solver++ sampler, trajectory control / warm start.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import MIXERMDM_DEFAULT, Config
from ..diffusion.mixer_diffusion import ddim_sample_loop_x2, mixer_training_losses
from ..diffusion.samplers import named_schedule_sampler
from ..diffusion.schedule import named_schedule, resolve_sampler_strategy
from ..models.cfg import cfg_model_x2
from ..models.clip_text import ClipTextConfig
from ..models.discriminator import DiscriminatorTransformer
from ..models.layers import Int8Block, w8a8_scope
from ..models.mixer import MixerConfig, MixerCore, make_mixer_forward
from ..utils.normalizer import Normalizer, hml3d_normalizer, interhuman_normalizer
from .in2in import In2INSystem, generate_src_mask
from .text import TextPipeline

# The subtrees each side of the adversarial training updates (the JAX
# trainer's GEN_KEYS / DISC_KEYS: the mixer core and its own post-encoder
# head; the two discriminators).  The CLIP towers and both denoisers never
# train.
GEN_MODULES = ("core", "text.post.mixer")
DISC_MODULES = ("disc_i", "disc_I")
# Probability that a training sample's conds are all zeroed (classifier-free
# guidance training; the JAX trainer's cond_mask_prob).
COND_MASK_PROB = 0.1


def resolve_compute_dtype(compute_dtype, device: torch.device) -> Optional[torch.dtype]:
    """``"auto"``: bf16 on CUDA, f32 (None) elsewhere, as the JAX package
    picks bf16 on TPU and f32 elsewhere."""
    if compute_dtype == "auto":
        return torch.bfloat16 if device.type == "cuda" else None
    if compute_dtype in ("bf16", "bfloat16", torch.bfloat16):
        return torch.bfloat16
    if compute_dtype in (None, "f32", "float32", torch.float32):
        return None
    raise ValueError(f"unknown compute_dtype {compute_dtype!r}")


class MixerMDMSystem(nn.Module):
    _FIV_FROM_CONFIG = object()  # sentinel: use the config's FORCE_INFLUENCE_VAL

    def __init__(self, cfg: Optional[Config] = None, model1: Optional[In2INSystem] = None,
                 model2: Optional[In2INSystem] = None,
                 clip_cfg: Optional[ClipTextConfig] = None, align: bool = True,
                 data_root: str = "./data", normalizer1: Optional[Normalizer] = None,
                 normalizer2: Optional[Normalizer] = None, compute_dtype="auto",
                 device="cuda", train: bool = False):
        super().__init__()
        device = torch.device(device)
        self.cfg = cfg or MIXERMDM_DEFAULT
        g = self.cfg.GENERATOR if "GENERATOR" in self.cfg else self.cfg
        d = self.cfg.DISCRIMINATOR if "DISCRIMINATOR" in self.cfg else self.cfg
        self.nfeats = int(g.INPUT_DIM)
        self.align = align
        self.compute_dtype = resolve_compute_dtype(compute_dtype, device)
        self.quant_frozen = bool(self.cfg.get("QUANT_FROZEN", False))
        self.quant_train = bool(self.cfg.get("QUANT_TRAIN", False))

        sampler_type, strategy = resolve_sampler_strategy(self.cfg)
        if sampler_type != "ddim":
            raise NotImplementedError(f"sampler {sampler_type!r} is not ported yet (ddim is)")

        with torch.device(device):
            self.model1 = (model1 if model1 is not None
                           else In2INSystem(mode="individual", clip_cfg=clip_cfg))
            self.model2 = (model2 if model2 is not None
                           else In2INSystem(mode="interaction", clip_cfg=clip_cfg))
            self.text_dim = (clip_cfg or self.model2.text.clip_cfg).width
            self.mixer_cfg = MixerConfig(
                nfeats=self.nfeats, latent_dim=int(g.LATENT_DIM), ff_size=int(g.FF_SIZE),
                n_blocks=int(g.NUM_LAYERS), n_heads=int(g.NUM_HEADS),
                mixing_mode=int(self.cfg.MIXING_MODE), align=align, text_dim=self.text_dim,
                denoiser1_text_dim=self.model1.text_dim, denoiser2_text_dim=self.model2.text_dim)
            c = self.mixer_cfg
            self.core = MixerCore(nfeats=c.nfeats, latent_dim=c.latent_dim, ff_size=c.ff_size,
                                  n_blocks=c.n_blocks, n_heads=c.n_heads, text_dim=c.text_dim,
                                  mixing_mode=c.mixing_mode,
                                  dropout=float(g.get("DROPOUT", 0.0)))
            disc = dict(latent_dim=int(d.LATENT_DIM), ff_size=int(d.FF_SIZE),
                        num_layers=int(d.NUM_LAYERS), num_heads=int(d.NUM_HEADS),
                        text_emb_dim=c.denoiser2_text_dim, dropout=float(d.get("DROPOUT", 0.0)))
            self.disc_i = DiscriminatorTransformer(self.nfeats, **disc)
            self.disc_I = DiscriminatorTransformer(2 * self.nfeats, **disc)
            # The mixer's own CLIP post-encoder for the influence conds.
            self.text = TextPipeline(clip_cfg or self.model2.text.clip_cfg, heads=("mixer",))
        self.to(device)
        self.requires_grad_(False)
        self.eval()

        steps = int(self.cfg.DIFFUSION_STEPS)
        self.sample_schedule = named_schedule(self.cfg.BETA_SCHEDULER, steps, strategy,
                                              device=device)
        self.train_schedule = named_schedule(self.cfg.BETA_SCHEDULER, steps, device=device)
        self._sample_t = named_schedule_sampler(self.cfg.get("SAMPLER", "uniform"), steps)
        self.normalizer1 = (normalizer1 if normalizer1 is not None
                            else hml3d_normalizer(data_root)).to(device)
        self.normalizer2 = (normalizer2 if normalizer2 is not None
                            else interhuman_normalizer(data_root)).to(device)
        self.cfg_weight = float(self.cfg.CFG_WEIGHT)
        fiv = self.cfg.get("FORCE_INFLUENCE_VAL", None)
        self.force_influence_val = None if fiv in (None, "None", "") else float(fiv)
        self.cast_(self.compute_dtype, train=train)

    def text_pipelines(self) -> tuple:
        """The three text pipelines: in2IN-individual's, in2IN-interaction's
        and the mixer's own."""
        return self.model1.text, self.model2.text, self.text

    def cast_(self, compute_dtype, train: bool = False) -> "MixerMDMSystem":
        """Run the networks in ``compute_dtype`` (None: f32) from now on,
        with the weights cast to it once.  The text post-encoder heads of
        all three pipelines stay f32, as the JAX package runs them on its
        f32 parameters; with ``train`` the trainable subtrees
        (:data:`GEN_MODULES`, :data:`DISC_MODULES`) keep f32 master weights
        too.  Buffers (normalizer statistics, positional tables) stay f32.
        Under ``QUANT_FROZEN`` in bf16 (not ``train``) the blocks that will
        run as int8 quantise their weights here, from the bf16 values, as
        the JAX package quantises its bf16-cast tree."""
        self.compute_dtype = compute_dtype
        f32 = [tp.post for tp in self.text_pipelines()]
        if train:
            f32 += [self.get_submodule(n) for n in GEN_MODULES + DISC_MODULES]
        keep = {id(p) for m in f32 for p in m.parameters()}
        for p in self.parameters():
            p.data = p.data.to(torch.float32 if id(p) in keep else compute_dtype or torch.float32)
        if self.quant_frozen and compute_dtype == torch.bfloat16 and not train:
            with w8a8_scope():
                for m in self.modules():
                    if isinstance(m, Int8Block) and m.runs_int8(compute_dtype):
                        m.int8_weights()
        self._mixer_forward = make_mixer_forward(
            self.mixer_cfg, self.model1.denoiser_apply("individual"),
            self.model2.denoiser_apply("interaction"), self.core,
            self.normalizer1, self.normalizer2, compute_dtype=compute_dtype)
        return self

    @property
    def device(self) -> torch.device:
        return self.core.text_embed.weight.device

    # ------------------------------------------------------------------- text
    def tokenize_batch(self, batch: dict) -> dict:
        text_inter = batch.get("text_interaction", batch.get("text"))
        return {"tokens_inter": self.text.tokenize(text_inter),
                "tokens_i1": self.text.tokenize(batch["text_individual1"]),
                "tokens_i2": self.text.tokenize(batch["text_individual2"])}

    def encode_cond(self, tokens_inter, tokens_i1, tokens_i2) -> torch.Tensor:
        """(B, 8 * 768) f32 cond, ordered [I, I_i1, I_i2, ind_i1, ind_i2,
        mix_I, mix_i1, mix_i2] (reference mixermdm.py:315-356).  The frozen
        submodels' conds are computed under ``torch.no_grad()``; the mixer's
        own head records a gradient when its parameters require one (the
        generator step)."""
        enc2 = lambda tok: self.model2.encode_tokens(tok, "interaction")  # noqa: E731
        enc1 = lambda tok: self.model1.encode_tokens(tok, "individual")  # noqa: E731
        encm = lambda tok: self.text.encode(tok, "mixer")  # noqa: E731
        with torch.no_grad():
            frozen = [enc2(tokens_inter), enc2(tokens_i1), enc2(tokens_i2),
                      enc1(tokens_i1), enc1(tokens_i2)]
        return torch.cat(frozen + [encm(tokens_inter), encm(tokens_i1), encm(tokens_i2)], dim=1)

    @torch.inference_mode()
    def generate_cond(self, batch: dict) -> torch.Tensor:
        """Host tokenisation of the three text fields, then :meth:`encode_cond`."""
        toks = self.tokenize_batch(batch)
        return self.encode_cond(toks["tokens_inter"], toks["tokens_i1"], toks["tokens_i2"])

    # ------------------------------------------------------------------- loss
    def set_train_modes(self, mode: Optional[str]) -> None:
        """Train / eval modes of one adversarial step, as the JAX loss passes
        ``train=``: the mixer core drops out on the generator step, the
        discriminators on the discriminator step; everything else (and
        everything for ``mode=None``) is in eval mode."""
        self.eval()
        self.core.train(mode == "generator")
        self.disc_i.train(mode == "discriminator")
        self.disc_I.train(mode == "discriminator")

    def compute_loss(self, motions, motion_lens, cond, *, mode: str,
                     generator: Optional[torch.Generator] = None, i_loss_factor: float = 1.0,
                     I_loss_factor: float = 2.0, l1: float = 0.1, t=None, noise=None,
                     drop=None, dropout: bool = True) -> dict:
        """Adversarial losses of one step (reference mixermdm.py:390-488; the
        JAX ``compute_loss`` / ``_loss_body``).

        ``motions`` (B, T, 524) raw, ``motion_lens`` (B,), ``cond`` from
        :meth:`encode_cond`.  The cond-drop mask (a whole row of conds
        zeroed with probability :data:`COND_MASK_PROB`), the timesteps and
        the noise are drawn from ``generator`` unless given as ``drop``
        (B, 1) bool, ``t`` (B,) and ``noise``.  ``dropout=False`` keeps every
        module in eval mode (no dropout anywhere).  Returns the loss dict
        with ``total``.
        """
        if self.quant_train:
            raise NotImplementedError("QUANT_TRAIN (int8 frozen denoisers inside the loss) is "
                                      "not ported; run with it off")
        dev = self.device
        motions = motions.to(dev, torch.float32)
        B, T = motions.shape[:2]
        if drop is None:
            drop = torch.rand((B, 1), generator=generator, device=dev) < COND_MASK_PROB
        cond = cond * (1.0 - drop.to(dev, torch.float32))
        seq_mask = generate_src_mask(T, motion_lens, B, device=dev)
        if t is None:
            t = self._sample_t(generator, B, dev)
        self.set_train_modes(mode if dropout else None)
        try:
            return mixer_training_losses(
                self._mixer_forward, self.disc_i, self.disc_I, self.train_schedule, motions,
                t.to(dev), cond, seq_mask, mode=mode, i_loss_factor=i_loss_factor,
                I_loss_factor=I_loss_factor, l1=l1, align=self.align,
                normalizer1=self.normalizer1, normalizer2=self.normalizer2,
                cond_slices=self.mixer_cfg.cond_slices(), nfeats=self.nfeats, noise=noise,
                generator=generator, compute_dtype=self.compute_dtype)
        finally:
            self.eval()

    # ----------------------------------------------------------------- sample
    def _mixer_eval(self, fiv, with_influence: bool):
        def mixer_eval(x, x2, t_orig, mask, c):
            mixed, _, _, infl = self._mixer_forward(x, t_orig, c, mask, x2, fiv)
            return (mixed, infl) if with_influence else mixed
        return mixer_eval

    @torch.inference_mode()
    def cfg_mixer_step(self, x, x2, t_orig, cond, mask=None) -> torch.Tensor:
        """One CFG-guided mixer call of the chain: raw-space mixed x0 for
        latents ``x`` (model-1 space) and ``x2`` (model-2 space)."""
        fn = cfg_model_x2(self._mixer_eval(self.force_influence_val, False), self.cfg_weight)
        with w8a8_scope(self.quant_frozen):
            return fn(x, x2, t_orig, mask, cond)

    @torch.inference_mode()
    def sample(self, cond: torch.Tensor, n_frames: int, *,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, collect_influence: bool = False,
               force_influence_val=_FIV_FROM_CONFIG):
        """Full dual-stream CFG DDIM chain (reference mixermdm.py:490-548).

        Returns raw motion (B, n_frames, 2 * 262) f32; with
        ``collect_influence`` also the per-step (infl1, infl2) histories.
        The initial noise is ``noise`` or a draw from ``generator``.
        """
        fiv = (self.force_influence_val if force_influence_val is MixerMDMSystem._FIV_FROM_CONFIG
               else force_influence_val)
        cond = cond.to(self.device, torch.float32)
        model = cfg_model_x2(self._mixer_eval(fiv, collect_influence), self.cfg_weight,
                             with_influence=collect_influence)
        with w8a8_scope(self.quant_frozen):
            return ddim_sample_loop_x2(
                model, self.sample_schedule, (cond.shape[0], n_frames, self.nfeats * 2), cond,
                normalizer1=self.normalizer1, normalizer2=self.normalizer2, align=self.align,
                noise=noise, generator=generator, nfeats=self.nfeats,
                collect_influence=collect_influence)
