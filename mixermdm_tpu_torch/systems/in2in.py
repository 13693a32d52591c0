"""in2IN system: text pipeline, denoiser(s) and CFG sampling in the modes
``individual``, ``interaction`` and ``dual`` (the DualMDM baseline);
counterpart of ``mixermdm_tpu/systems/in2in.py`` (reference
in2in.py:11-356), training (``compute_loss``, :class:`~.base.BaseModelSystem`)
included.

The mixer uses an individual and an interaction system as its frozen
submodels (``denoiser_apply``, ``encode_tokens``); standalone, a system
samples through :meth:`In2INSystem.build_cond` and :meth:`In2INSystem.sample`
(``python -m mixermdm_tpu_torch infer-in2in``).  The networks run in the
compute dtype (bf16 on the card), the post-encoder heads in f32, the
diffusion arithmetic in f32; with the config's ``QUANT`` the denoisers'
blocks run their projections as int8 at sampling time (W8A8, as the JAX
package's ``denoiser_apply(quant=True)``).  Built with ``train=True`` the
denoiser(s) and the post-encoder heads keep f32 master weights for a base
trainer; the denoisers drop out (the config's ``DROPOUT``) in training
mode only.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import IN2IN_INTERACTION_DEFAULT, Config
from ..models.cfg import cfg_dual_mdm, cfg_model, cfg_model_multiple
from ..models.clip_text import ClipTextConfig
from ..models.in2in import In2INDenoiser
from ..utils.normalizer import Normalizer, hml3d_normalizer, interhuman_normalizer
from .base import BaseModelSystem, data_parallel_sample, generate_src_mask  # noqa: F401
from .text import TextPipeline

# Denoiser name -> denoiser mode, per system mode (JAX In2INSystem.__init__).
DENOISER_MODES = {
    "interaction": {"interaction": "interaction"},
    "individual": {"individual": "individual"},
    "dual": {"interaction": "dual_interaction", "individual": "dual_individual"},
}


class In2INSystem(BaseModelSystem):
    """One mode-specialised in2IN model: its text pipeline (tower and the
    post-encoder heads named after its denoisers) and its denoiser(s).

    Built on the card in its compute dtype unless ``device`` says otherwise;
    the mixer builds it as a part (``device`` and ``compute_dtype`` None,
    :class:`~.base.BaseModelSystem`) and casts it itself.  ``normalizer``
    defaults to the mode's statistics under ``data_root``: InterHuman's for
    ``interaction``, HumanML3D's otherwise (identity where the files are
    missing).  ``train``: f32 master weights in :attr:`TRAIN_MODULES`."""

    def __init__(self, cfg: Optional[Config] = None, mode: str = "interaction",
                 clip_cfg: Optional[ClipTextConfig] = None,
                 normalizer: Optional[Normalizer] = None, data_root: str = "./data",
                 device="cuda", compute_dtype="auto", train: bool = False):
        super().__init__()
        if mode not in DENOISER_MODES:
            raise ValueError(f"unknown In2INSystem mode {mode!r} (have {tuple(DENOISER_MODES)})")
        self.cfg = cfg or IN2IN_INTERACTION_DEFAULT
        self.mode = mode
        self.nfeats = int(self.cfg.INPUT_DIM)
        self.latent_dim = int(self.cfg.LATENT_DIM)
        self.text = TextPipeline(clip_cfg, heads=tuple(DENOISER_MODES[mode]))
        self.text_dim = self.text.clip_cfg.width
        self.denoisers = torch.nn.ModuleDict({name: In2INDenoiser(
            input_feats=self.nfeats, mode=dmode, latent_dim=self.latent_dim,
            ff_size=int(self.cfg.FF_SIZE), num_layers=int(self.cfg.NUM_LAYERS),
            num_heads=int(self.cfg.NUM_HEADS), text_dim=self.text_dim,
            dropout=float(self.cfg.get("DROPOUT", 0.0)))
            for name, dmode in DENOISER_MODES[mode].items()})
        if normalizer is None:
            normalizer = (interhuman_normalizer(data_root) if mode == "interaction"
                          else hml3d_normalizer(data_root))
        self.loss_mode = "individual" if mode == "individual" else "interaction"
        self.TRAIN_MODULES = tuple(f"denoisers.{n}" for n in self.denoisers) + ("text.post",)
        self._finish_init(self.cfg, normalizer, device, compute_dtype, train)

    def f32_heads(self) -> list:
        return [self.text.post]

    def train_denoiser(self):
        """The denoiser the loss trains: the interaction one outside the
        individual mode (JAX ``compute_loss``)."""
        return self.denoisers[self.loss_mode]

    def denoiser_apply(self, name: str):
        """``apply(x, t, mask, cond)`` of the named denoiser."""
        return self.denoisers[name]

    # ------------------------------------------------------------------- text
    def encode_tokens(self, tokens: torch.Tensor, head: str) -> torch.Tensor:
        return self.text.encode(tokens, head)

    def text_process(self, texts, mode: str) -> torch.Tensor:
        """Raw strings -> pooled (B, width) f32 cond through the head
        ``mode``."""
        return self.text.encode(self.text.tokenize(texts), mode)

    def tokenize_batch(self, batch: dict) -> dict:
        out = {"tokens": self.text.tokenize(batch["text"])}
        if self.mode != "individual":
            out["tokens_i1"] = self.text.tokenize(batch["text_individual1"])
            out["tokens_i2"] = self.text.tokenize(batch["text_individual2"])
        return out

    def encode_cond_tokens(self, batch_tokens: dict) -> torch.Tensor:
        """The mode's cond from pre-tokenised text (keys ``tokens`` [+
        ``tokens_i1`` / ``tokens_i2``]): (B, width) individual; [I, i1, i2]
        through the interaction head; in dual mode those three and [i1, i2]
        through the individual head, (B, 5 * width)."""
        if self.mode == "individual":
            return self.text.encode(batch_tokens["tokens"], "individual")
        toks = [batch_tokens[k] for k in ("tokens", "tokens_i1", "tokens_i2")]
        parts = [self.text.encode(t, "interaction") for t in toks]
        if self.mode == "dual":
            parts += [self.text.encode(t, "individual") for t in toks[1:]]
        return torch.cat(parts, dim=1)

    @torch.inference_mode()
    def build_cond(self, batch: dict) -> torch.Tensor:
        """Host tokenisation of the batch's texts, then
        :meth:`encode_cond_tokens` (reference in2in.py:248-301)."""
        return self.encode_cond_tokens(self.tokenize_batch(batch))

    # ----------------------------------------------------------------- sample
    def cfg_model(self):
        """The mode's CFG-wrapped model ``fn(x, t_orig, mask, cond)`` -> x0:
        4-way CFG in interaction mode, 2-way in individual mode, DualMDM's
        blend of both denoisers in dual mode (JAX ``_sample_impl``).  As
        there, the 4-way split reads the interaction slice at 768 columns."""
        c = self.cfg
        if self.mode == "interaction":
            return cfg_model_multiple(self.cast_apply(self.denoisers["interaction"]),
                                      float(c.CFG_WEIGHT), float(c.CFG_WEIGHT_INTERACTION),
                                      float(c.CFG_WEIGHT_INDIVIDUAL))
        if self.mode == "individual":
            return cfg_model(self.cast_apply(self.denoisers["individual"]), float(c.CFG_WEIGHT))
        return cfg_dual_mdm(self.cast_apply(self.denoisers["individual"]),
                            self.cast_apply(self.denoisers["interaction"]),
                            float(c.CFG_WEIGHT_INDIVIDUAL), float(c.CFG_WEIGHT_INTERACTION),
                            c.get("W_FUNC", "const"), float(c.get("W_VALUE", 0.5)))

    @property
    def persons(self) -> int:
        return 1 if self.mode == "individual" else 2

    @torch.inference_mode()
    def sample(self, cond: torch.Tensor, n_frames: int, *,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, normalize_output: bool = True,
               traj_control=None, skip_timesteps: int = 0, init_image=None,
               mesh=None) -> torch.Tensor:
        """The whole CFG chain (reference in2in.py:285-356), DDIM or
        DPM-Solver++ by :attr:`sampler_type`: (B, n_frames, persons * 262),
        raw motion unless ``normalize_output`` is off.  The initial noise is
        ``noise`` or a draw from ``generator``.  ``traj_control`` (pinned
        every step) and ``init_image`` (the warm start, with
        ``skip_timesteps``) are in the model's normalised space.  With
        ``mesh`` the batch splits over its data axis
        (:func:`.base.data_parallel_sample`)."""
        cond = cond.to(self.device, torch.float32)
        if mesh is not None:
            return data_parallel_sample(
                self.sample, mesh, cond, (n_frames, self.nfeats * self.persons),
                generator=generator, noise=noise,
                rows=dict(traj_control=traj_control, init_image=init_image),
                normalize_output=normalize_output, skip_timesteps=skip_timesteps)
        model = self.cfg_model()
        out = self.run_chain(lambda x, t: model(x, t, None, cond),
                             (cond.shape[0], n_frames, self.nfeats * self.persons),
                             generator=generator, noise=noise, traj_control=traj_control,
                             skip_timesteps=skip_timesteps, init_image=init_image)
        return self.denormalize(out, self.persons) if normalize_output else out

    def forward_test(self, batch: dict, generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Text encoding + sampling at ``batch["motion_lens"][0]`` frames
        (reference in2in.py:92-107)."""
        return self.sample(self.build_cond(batch), int(batch["motion_lens"][0]),
                           generator=generator, noise=noise)

