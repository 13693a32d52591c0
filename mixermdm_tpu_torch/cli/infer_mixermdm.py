"""MixerMDM inference: three text prompts -> N two-person motions.

Counterpart of ``mixermdm_tpu/cli/infer_mixermdm.py`` (reference
scripts/infer/mixermdm.py:146-188).  Samples the full DDIM chain, gaussian-
smooths the output over frames and writes ``<name>_motion.npy`` and the two
influence histories as ``.npy``.  Weights are random, made from ``--seed``
(the repository holds no checkpoint).  Usage::

    python -m mixermdm_tpu_torch infer-mixermdm --name out \\
        --text-interaction "two people hug" --text-individual1 "a person hugs" \\
        --text-individual2 "a person hugs" [--num-samples 10] [--window 299]

``--tiny`` runs a miniature configuration (16 frames), ``--device cpu`` the
plain PyTorch path on the CPU (f32, so never int8).  On the card the shipped
config samples with the W8A8 projections (``QUANT_FROZEN: true``);
``--no-quant`` runs the same weights in bf16.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from ..config import (
    IN2IN_INDIVIDUAL_DEFAULT,
    IN2IN_INTERACTION_DEFAULT,
    MIXERMDM_DEFAULT,
    Config,
    load_yaml,
    tiny_config,
)
from ..models.clip_text import ClipTextConfig
from ..systems.in2in import In2INSystem
from ..systems.mixermdm import MixerMDMSystem
from ..weights import init_params_


def tiny_configs():
    """(mixer cfg, model cfg, clip cfg) of the miniature smoke system: one
    layer of width 128 and head dim 64, the smallest shape whose blocks can
    run as int8 (with the width gate lowered)."""
    c = tiny_config(latent=128, layers=1, heads=2, diffusion_steps=8)
    mcfg = Config.wrap(dict(MIXERMDM_DEFAULT))
    mcfg["DIFFUSION_STEPS"] = 8
    mcfg["STRATEGY"] = "ddim4"
    mcfg["GENERATOR"] = Config.wrap({"NUM_LAYERS": 1, "NUM_HEADS": 2, "DROPOUT": 0.0,
                                     "INPUT_DIM": 262, "LATENT_DIM": 128, "FF_SIZE": 256})
    return mcfg, c, ClipTextConfig.tiny()


def build_system(model_cfg_path: Optional[str] = None, *, align: bool = True,
                 tiny: bool = False, device="cuda", quant_frozen: Optional[bool] = None,
                 seed: int = 0, zero_init_std: float = 0.0,
                 train: bool = False) -> MixerMDMSystem:
    """The MixerMDM system of a config file (default: the shipped
    architecture), built on ``device`` with random weights from ``seed``.
    ``quant_frozen`` overrides the config's QUANT_FROZEN; ``train`` keeps
    f32 master weights in the trained subtrees."""
    if tiny:
        cfg, cfg1, clip_cfg = tiny_configs()
        cfg2 = cfg1
    else:
        cfg = load_yaml(model_cfg_path) if model_cfg_path else MIXERMDM_DEFAULT
        cfg1 = load_yaml(cfg["MODEL1"]) if "MODEL1" in cfg else IN2IN_INDIVIDUAL_DEFAULT
        cfg2 = load_yaml(cfg["MODEL2"]) if "MODEL2" in cfg else IN2IN_INTERACTION_DEFAULT
        clip_cfg = ClipTextConfig.vit_l_14()
    if quant_frozen is not None:
        cfg = Config.wrap(dict(cfg))
        cfg["QUANT_FROZEN"] = bool(quant_frozen)
    with torch.device(device):
        m1 = In2INSystem(cfg1, mode="individual", clip_cfg=clip_cfg)
        m2 = In2INSystem(cfg2, mode="interaction", clip_cfg=clip_cfg)
        system = MixerMDMSystem(cfg, model1=m1, model2=m2, clip_cfg=clip_cfg, align=align,
                                device=device, train=train)
    return init_params_(system, seed, zero_init_std)


def gaussian_smooth(motion: np.ndarray, sigma: float = 1.0, truncate: float = 4.0) -> np.ndarray:
    """Gaussian filter over frames (axis -2) with mirrored edges, as
    ``scipy.ndimage.gaussian_filter1d(motion, sigma, axis=-2)``."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-0.5 * (x / sigma) ** 2)
    w /= w.sum()
    axis = motion.ndim - 2
    T = motion.shape[axis]
    pad = [(0, 0)] * motion.ndim
    pad[axis] = (radius, radius)
    padded = np.pad(motion.astype(np.float64), pad, mode="symmetric")
    out = sum(wi * np.take(padded, np.arange(i, i + T), axis=axis) for i, wi in enumerate(w))
    return out.astype(motion.dtype)


def main(argv=None):
    parser = argparse.ArgumentParser(description="MixerMDM inference (PyTorch/CUDA port)")
    parser.add_argument("--model", type=str, default=None, help="model config yaml")
    parser.add_argument("--name", type=str, required=True, help="output name")
    parser.add_argument("--text-interaction", type=str, required=True)
    parser.add_argument("--text-individual1", type=str, required=True)
    parser.add_argument("--text-individual2", type=str, required=True)
    parser.add_argument("--num-samples", type=int, default=10)
    parser.add_argument("--window", type=int, default=299)
    parser.add_argument("--out-dir", type=str, default="results")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-align", action="store_true")
    parser.add_argument("--tiny", action="store_true", help="tiny config smoke run")
    parser.add_argument("--no-smooth", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--no-quant", action="store_true",
                        help="run every projection in bf16 (QUANT_FROZEN false) instead of "
                             "the config's W8A8 int8 projections")
    args = parser.parse_args(argv)

    system = build_system(args.model, align=not args.no_align, tiny=args.tiny,
                          device=args.device, quant_frozen=False if args.no_quant else None,
                          seed=args.seed)
    B = args.num_samples
    window = 16 if args.tiny else args.window
    batch = {"text_interaction": [args.text_interaction] * B,
             "text_individual1": [args.text_individual1] * B,
             "text_individual2": [args.text_individual2] * B}
    cond = system.generate_cond(batch)
    gen = torch.Generator(device=system.device).manual_seed(args.seed)
    sampled, (infl1, infl2) = system.sample(cond, window, generator=gen, collect_influence=True)
    motions = sampled.cpu().numpy()
    if not args.no_smooth:
        motions = gaussian_smooth(motions)

    os.makedirs(args.out_dir, exist_ok=True)
    np.save(os.path.join(args.out_dir, f"{args.name}_motion.npy"), motions)
    np.save(os.path.join(args.out_dir, f"{args.name}_influence_i1.npy"), infl1.cpu().numpy())
    np.save(os.path.join(args.out_dir, f"{args.name}_influence_i2.npy"), infl2.cpu().numpy())
    print(f"saved {B} samples of shape {motions.shape[1:]} to {args.out_dir}/")


if __name__ == "__main__":
    main()
