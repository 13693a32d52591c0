"""MDM single-person inference: a prompt -> N motions.

Counterpart of ``mixermdm_tpu/cli/infer_mdm.py`` (reference
scripts/infer/mdm.py:94-137): 196-frame window, the CLIP ViT-B/32 text cond
on MDM's 22-token context, CFG sampling, HumanML3D normalizer backward.
Usage::

    python -m mixermdm_tpu_torch infer-mdm --name out --text "a person waves" \\
        [--num-samples 4] [--window 196] [--checkpoint mdm.ckpt]

``--checkpoint`` reads a released MDM file (the denoiser under ``model.``,
the tower under ``clip_model.``, ``embed_text``, in a Lightning
checkpoint); what it does not hold keeps its random values from ``--seed``
and is listed (``--strict`` fails instead).  ``--tiny`` runs the miniature
configuration (16 frames), ``--device cpu`` the plain PyTorch path on the
CPU (f32).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import MDM_DEFAULT, load_yaml, tiny_config
from ..models.clip_text import ClipTextConfig
from ..systems import apply_sampler_overrides
from ..systems.mdm import MDMSystem
from ..train.checkpoint import load_released_mdm
from ..weights import init_params_
from .infer_in2in import report_unfilled


def build_system(model_cfg_path: Optional[str] = None, *, tiny: bool = False, device="cuda",
                 seed: int = 0, zero_init_std: float = 0.0) -> MDMSystem:
    """The MDM system of a config file (default: MDM's published
    architecture), built on ``device`` in its compute dtype with random
    weights from ``seed``."""
    if tiny:
        cfg, clip_cfg = tiny_config(), ClipTextConfig.tiny(width=64)
    else:
        cfg = load_yaml(model_cfg_path) if model_cfg_path else MDM_DEFAULT
        clip_cfg = ClipTextConfig.vit_b_32()
    system = MDMSystem(cfg, clip_cfg=clip_cfg, device=device)
    return init_params_(system, seed, zero_init_std)


def main(argv=None):
    parser = argparse.ArgumentParser(description="MDM inference (PyTorch/CUDA port)")
    parser.add_argument("--model", type=str, default=None, help="model config yaml")
    parser.add_argument("--name", type=str, required=True)
    parser.add_argument("--text", type=str, required=True)
    parser.add_argument("--num-samples", type=int, default=1)
    parser.add_argument("--window", type=int, default=196)
    parser.add_argument("--out-dir", type=str, default="results")
    parser.add_argument("--checkpoint", type=str, default=None, help="the released MDM file")
    parser.add_argument("--strict", action="store_true",
                        help="fail if any parameter is not in the checkpoint file")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--sampler", type=str, default=None, choices=("ddim", "dpmpp"),
                        help="sampling update rule: ddim (the config's default) or dpmpp "
                             "(DPM-Solver++(2M))")
    parser.add_argument("--sample-steps", type=int, default=None,
                        help="respace the sampling chain to N model calls")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    system = build_system(args.model, tiny=args.tiny, device=args.device, seed=args.seed)
    if args.checkpoint:
        report_unfilled(system, load_released_mdm(system, args.checkpoint, strict=args.strict))
    apply_sampler_overrides(system, args.sampler, args.sample_steps)
    window = 16 if args.tiny else args.window
    B = args.num_samples
    t0 = time.perf_counter()
    cond = system.text_process([args.text] * B)
    out = system.sample(cond, window,
                        generator=torch.Generator(device=system.device).manual_seed(args.seed))
    motions = out.cpu().numpy()
    print(f"sampled {B} x {window} frames in {time.perf_counter() - t0:.3f} s (text + "
          f"{system.sample_schedule.num_timesteps} {system.sampler_type} steps)")
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, f"{args.name}_motion.npy")
    np.save(path, motions)
    print(f"saved {motions.shape} to {path}")


if __name__ == "__main__":
    main()
