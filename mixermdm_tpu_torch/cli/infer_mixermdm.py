"""MixerMDM inference: an interaction prompt -> N two-person motions.

Counterpart of ``mixermdm_tpu/cli/infer_mixermdm.py`` (reference
scripts/infer/mixermdm.py:146-188).  Samples the full chain (DDIM, or
DPM-Solver++ with ``--sampler dpmpp``), gaussian-smooths the output over
frames and writes ``<name>_motion.npy`` and the two influence histories as
``.npy``, then renders a skeleton video of sample 0 and the influence plot
where matplotlib is installed (best effort, as in the JAX package).
Usage::

    python -m mixermdm_tpu_torch infer-mixermdm --name out \\
        --text-interaction "two people hug" [--text-individual1 "a person hugs"] \\
        [--text-individual2 "a person hugs"] [--num-samples 10] [--window 299] \\
        [--checkpoint MixerMDM.ckpt --ckpt-individual individual.ckpt \\
         --ckpt-interaction interaction.ckpt]

Weights: the released files, in the reference's torch layout, through
``--checkpoint`` (``MixerMDM.ckpt``: mixer core, discriminators, the
mixer's text head), ``--ckpt-individual`` and ``--ckpt-interaction`` (the
two in2IN checkpoints); whatever no file holds keeps its random values from
``--seed`` and is listed (``--strict`` fails instead).  The JAX package's
``--checkpoint`` is an orbax directory, which this CLI cannot read: a
JAX-trained system reaches the port as the same three torch-named files,
which the JAX package writes with ``train/checkpoint.py``'s
``export_mixermdm_system`` and ``export_in2in_system``.

Left out, the individual prompts are derived from the interaction prompt by
the offline decomposer (:mod:`..eval.decompose`).  ``--traj-control`` pins
the root trajectory of a given motion every step, ``--warm-start`` /
``--skip-timesteps`` start the chain from a noised motion part-way down.

``--tiny`` runs a miniature configuration (16 frames), ``--device cpu`` the
plain PyTorch path on the CPU (f32, so never int8).  On the card the shipped
config samples with the W8A8 projections (``QUANT_FROZEN: true``);
``--no-quant`` runs the same weights in bf16.
"""

from __future__ import annotations

import argparse
import os
import time
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
from ..eval.decompose import decompose_interaction_text
from ..models.clip_text import ClipTextConfig
from ..systems import apply_sampler_overrides
from ..systems.in2in import In2INSystem
from ..systems.mixermdm import SUBMODEL, MixerMDMSystem
from ..train.checkpoint import load_released_mixermdm
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
                 seed: int = 0, zero_init_std: float = 0.0, train: bool = False,
                 quant_train: Optional[bool] = None) -> MixerMDMSystem:
    """The MixerMDM system of a config file (default: the shipped
    architecture), built on ``device`` with random weights from ``seed``
    (under QUANT_FROZEN the int8 blocks quantise them at their first
    call).  ``quant_frozen`` / ``quant_train`` override the config's
    QUANT_FROZEN / QUANT_TRAIN; ``train`` keeps f32 master weights in the
    trained subtrees."""
    if tiny:
        cfg, cfg1, clip_cfg = tiny_configs()
        cfg2 = cfg1
    else:
        cfg = load_yaml(model_cfg_path) if model_cfg_path else MIXERMDM_DEFAULT
        cfg1 = load_yaml(cfg["MODEL1"]) if "MODEL1" in cfg else IN2IN_INDIVIDUAL_DEFAULT
        cfg2 = load_yaml(cfg["MODEL2"]) if "MODEL2" in cfg else IN2IN_INTERACTION_DEFAULT
        clip_cfg = ClipTextConfig.vit_l_14()
    for key, value in (("QUANT_FROZEN", quant_frozen), ("QUANT_TRAIN", quant_train)):
        if value is not None:
            cfg = Config.wrap(dict(cfg))
            cfg[key] = bool(value)
    with torch.device(device):
        m1 = In2INSystem(cfg1, mode="individual", clip_cfg=clip_cfg, **SUBMODEL)
        m2 = In2INSystem(cfg2, mode="interaction", clip_cfg=clip_cfg, **SUBMODEL)
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


def add_weight_args(parser: argparse.ArgumentParser) -> None:
    """The flags of the released checkpoint files and of the sampler,
    shared by this CLI and ``serve``."""
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="the released MixerMDM.ckpt (mixer core, discriminators, the "
                             "mixer's text head)")
    parser.add_argument("--ckpt-individual", type=str, default=None,
                        help="the individual in2IN checkpoint")
    parser.add_argument("--ckpt-interaction", type=str, default=None,
                        help="the interaction in2IN checkpoint")
    parser.add_argument("--strict", action="store_true",
                        help="fail if any parameter is in none of the checkpoint files")
    parser.add_argument("--sampler", type=str, default=None, choices=("ddim", "dpmpp"),
                        help="sampling update rule: ddim (the config's default) or dpmpp "
                             "(DPM-Solver++(2M); pair with --sample-steps 25)")
    parser.add_argument("--sample-steps", type=int, default=None,
                        help="respace the sampling chain to N model calls")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--no-quant", action="store_true",
                        help="run every projection in bf16 (QUANT_FROZEN false) instead of "
                             "the config's W8A8 int8 projections")


def system_from_args(args) -> MixerMDMSystem:
    """Build the system of ``args``, load its checkpoint files, apply the
    sampler overrides; prints what the files left unfilled."""
    system = build_system(args.model, align=not getattr(args, "no_align", False),
                          tiny=args.tiny, device=args.device,
                          quant_frozen=False if args.no_quant else None, seed=args.seed)
    files = (args.checkpoint, args.ckpt_individual, args.ckpt_interaction)
    if any(files):
        unfilled = load_released_mixermdm(system, *files, strict=args.strict)
        n_params = sum(1 for _ in system.parameters())
        print(f"loaded {n_params - len(unfilled)}/{n_params} parameters from the checkpoint "
              f"files", flush=True)
        if unfilled:
            print(f"note: {len(unfilled)} parameters keep their random values (first 10): "
                  + ", ".join(unfilled[:10]), flush=True)
    return apply_sampler_overrides(system, args.sampler, args.sample_steps)


def load_control(system: MixerMDMSystem, path: Optional[str], B: int,
                 window: int) -> Optional[torch.Tensor]:
    """A raw (T, 524) or (B, T, 524) motion ``.npy`` -> (B, window, 524) in
    model-2 (InterHuman-normalised) space on the system's device, padded
    with zeros or cropped to the window (JAX CLI ``_load_control``).  The
    chain pins / warm-starts both streams with the same values, as the
    reference pins its shared ``x_start``."""
    if path is None:
        return None
    m = np.load(path).astype(np.float32)
    if m.ndim == 2:
        m = m[None]
    m = np.broadcast_to(m, (B,) + m.shape[1:]).copy()
    if m.shape[1] < window:
        m = np.concatenate([m, np.zeros((B, window - m.shape[1], m.shape[2]), np.float32)], 1)
    m = torch.from_numpy(m[:, :window]).to(system.device)
    return system.normalizer2.forward(m.reshape(B, window, 2, -1)).reshape(B, window, -1)


def render(args, system: MixerMDMSystem, motions: np.ndarray, infl1: np.ndarray,
           infl2: np.ndarray) -> None:
    """The skeleton video of sample 0 and the influence plot, best effort
    (no matplotlib, no ffmpeg: printed and skipped, as in the JAX CLI)."""
    try:
        from ..utils.plot import plot_3d_motion

        plot_3d_motion(os.path.join(args.out_dir, f"{args.name}_sample0.mp4"), motions[0],
                       title=args.text_interaction)
    except Exception as e:  # rendering is best effort
        print(f"(skipped video render: {e})")
    try:
        from ..utils.plot import plot_influence

        pdf = plot_influence(os.path.join(args.out_dir, args.name), infl1,
                             mixing_mode=int(system.cfg.MIXING_MODE), influence2=infl2)
        print(f"influence plot: {pdf}")
    except Exception as e:
        print(f"(skipped influence plot: {e})")


def main(argv=None):
    parser = argparse.ArgumentParser(description="MixerMDM inference (PyTorch/CUDA port)")
    parser.add_argument("--model", type=str, default=None, help="model config yaml")
    parser.add_argument("--name", type=str, required=True, help="output name")
    parser.add_argument("--text-interaction", type=str, required=True)
    # Left out, the individual prompts come from the offline decomposer.
    parser.add_argument("--text-individual1", type=str, default=None)
    parser.add_argument("--text-individual2", type=str, default=None)
    parser.add_argument("--num-samples", type=int, default=10)
    parser.add_argument("--window", type=int, default=299)
    parser.add_argument("--out-dir", type=str, default="results")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-align", action="store_true")
    parser.add_argument("--tiny", action="store_true", help="tiny config smoke run")
    parser.add_argument("--no-smooth", action="store_true")
    parser.add_argument("--traj-control", type=str, default=None, metavar="NPY",
                        help="motion .npy whose root trajectory (dims 0/2 and 262/264) is "
                             "pinned every denoising step")
    parser.add_argument("--warm-start", type=str, default=None, metavar="NPY",
                        help="motion .npy to q-sample as the chain's starting point")
    parser.add_argument("--skip-timesteps", type=int, default=0,
                        help="drop the first N (respaced) denoising steps; with no "
                             "--warm-start a zero motion is used")
    add_weight_args(parser)
    args = parser.parse_args(argv)

    system = system_from_args(args)
    B = args.num_samples
    window = 16 if args.tiny else args.window
    t1, t2 = args.text_individual1, args.text_individual2
    if t1 is None or t2 is None:
        d1, d2 = decompose_interaction_text(args.text_interaction)
        t1 = d1 if t1 is None else t1
        t2 = d2 if t2 is None else t2
        print(f"decomposed individual prompts:\n  1: {t1}\n  2: {t2}")
    batch = {"text_interaction": [args.text_interaction] * B,
             "text_individual1": [t1] * B, "text_individual2": [t2] * B}
    traj = load_control(system, args.traj_control, B, window)
    warm = load_control(system, args.warm_start, B, window)
    t0 = time.perf_counter()
    cond = system.generate_cond(batch)
    gen = torch.Generator(device=system.device).manual_seed(args.seed)
    sampled, (infl1, infl2) = system.sample(
        cond, window, generator=gen, collect_influence=True, traj_control=traj,
        init_image=warm, skip_timesteps=args.skip_timesteps)
    motions = sampled.cpu().numpy()
    print(f"sampled {B} x {window} frames in {time.perf_counter() - t0:.3f} s (text + "
          f"{infl1.shape[0]} {system.sampler_type} steps)")
    if not args.no_smooth:
        motions = gaussian_smooth(motions)
    infl1, infl2 = infl1.cpu().numpy(), infl2.cpu().numpy()

    os.makedirs(args.out_dir, exist_ok=True)
    np.save(os.path.join(args.out_dir, f"{args.name}_motion.npy"), motions)
    np.save(os.path.join(args.out_dir, f"{args.name}_influence_i1.npy"), infl1)
    np.save(os.path.join(args.out_dir, f"{args.name}_influence_i2.npy"), infl2)
    print(f"saved {B} samples of shape {motions.shape[1:]} to {args.out_dir}/")
    render(args, system, motions, infl1, infl2)


if __name__ == "__main__":
    main()
