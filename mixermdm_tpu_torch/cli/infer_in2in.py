"""in2IN / DualMDM inference: a prompt -> N motions, in the modes
``interaction`` (two persons, 4-way CFG), ``individual`` (one person) and
``dual`` (the DualMDM baseline: both denoisers blended by a fixed schedule).

Counterpart of ``mixermdm_tpu/cli/infer_in2in.py`` (reference
scripts/infer/in2IN.py:111-154): 210-frame window, the mode's normalizer
backward, gaussian smoothing over frames.  Usage::

    python -m mixermdm_tpu_torch infer-in2in --name out --mode interaction \\
        --text "two people hug" [--text-individual1 "a person hugs"] \\
        [--text-individual2 "a person hugs"] [--num-samples 4] [--window 210] \\
        [--checkpoint in2IN.ckpt] [--mode dual --checkpoint in2IN.ckpt \\
         --ckpt-individual individual.ckpt --w-func const --w-value 0.5]

Weights: the released in2IN file of the mode through ``--checkpoint``; in
dual mode the interaction file there and the individual file through
``--ckpt-individual``, merged as the reference's DualMDM merges them.  What
no file holds keeps its random values from ``--seed`` and is listed
(``--strict`` fails instead).  ``--traj-control`` pins the root trajectory
of a raw motion ``.npy`` every step; ``--warm-start`` / ``--skip-timesteps``
start the chain from it part-way down.  The config's ``QUANT: true`` runs
the denoisers' projections as int8 on the card.

``--tiny`` runs the miniature configuration (16 frames), ``--device cpu``
the plain PyTorch path on the CPU (f32).  ``--pp N`` runs the denoisers'
layer stacks as a GPipe pipeline over N ranks (one per visible card, or the
world ``torchrun`` describes: :func:`..parallel.on_ranks`); rank 0 writes
the file.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import IN2IN_INDIVIDUAL_DEFAULT, IN2IN_INTERACTION_DEFAULT, Config, load_yaml, \
    tiny_config
from ..models.clip_text import ClipTextConfig
from ..parallel import make_mesh, on_ranks, pipeline_scope, world_rank, world_size
from ..systems import apply_sampler_overrides
from ..systems.in2in import In2INSystem
from ..train.checkpoint import load_released_in2in
from ..weights import init_params_
from .infer_mixermdm import gaussian_smooth


def build_system(model_cfg_path: Optional[str] = None, mode: str = "interaction", *,
                 tiny: bool = False, w_func: str = "const", w_value: float = 0.5,
                 device="cuda", seed: int = 0, zero_init_std: float = 0.0) -> In2INSystem:
    """The in2IN system of ``mode`` from a config file (default: the
    shipped architecture of the mode), built on ``device`` in its compute
    dtype with random weights from ``seed``; in dual mode the blend is
    ``w_func`` / ``w_value``."""
    if tiny:
        cfg, clip_cfg = tiny_config(), ClipTextConfig.tiny()
    else:
        default = IN2IN_INDIVIDUAL_DEFAULT if mode == "individual" else IN2IN_INTERACTION_DEFAULT
        cfg = load_yaml(model_cfg_path) if model_cfg_path else default
        clip_cfg = ClipTextConfig.vit_l_14()
    if mode == "dual":
        cfg = Config.wrap(dict(cfg, W_FUNC=w_func, W_VALUE=w_value))
    system = In2INSystem(cfg, mode=mode, clip_cfg=clip_cfg, device=device)
    return init_params_(system, seed, zero_init_std)


def report_unfilled(system, unfilled: list) -> None:
    n_params = sum(1 for _ in system.parameters())
    print(f"loaded {n_params - len(unfilled)}/{n_params} parameters from the checkpoint files",
          flush=True)
    if unfilled:
        print(f"note: {len(unfilled)} parameters keep their random values (first 10): "
              + ", ".join(unfilled[:10]), flush=True)


def load_control(system: In2INSystem, path: Optional[str], B: int,
                 window: int) -> Optional[torch.Tensor]:
    """A raw (T, D) or (B, T, D) motion ``.npy`` -> (B, window, D) in the
    mode's normalised space on the system's device, zero-padded or cropped
    to the window (JAX CLI ``_load_control``)."""
    if path is None:
        return None
    m = np.load(path).astype(np.float32)
    if m.ndim == 2:
        m = m[None]
    m = np.broadcast_to(m, (B,) + m.shape[1:]).copy()
    if m.shape[1] < window:
        m = np.concatenate([m, np.zeros((B, window - m.shape[1], m.shape[2]), np.float32)], 1)
    m = torch.from_numpy(m[:, :window]).to(system.device)
    P = system.persons
    return system.normalizer.forward(m.reshape(B, window, P, -1)).reshape(B, window, -1)


def main(argv=None):
    parser = argparse.ArgumentParser(description="in2IN / DualMDM inference (PyTorch/CUDA port)")
    parser.add_argument("--model", type=str, default=None, help="model config yaml")
    parser.add_argument("--name", type=str, required=True)
    parser.add_argument("--mode", type=str, default="interaction",
                        choices=["interaction", "individual", "dual"])
    parser.add_argument("--text", type=str, required=True)
    parser.add_argument("--text-individual1", type=str, default=None)
    parser.add_argument("--text-individual2", type=str, default=None)
    parser.add_argument("--num-samples", type=int, default=1)
    parser.add_argument("--window", type=int, default=210)
    parser.add_argument("--out-dir", type=str, default="results")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="the released in2IN file of the mode (in dual mode the "
                             "interaction file)")
    parser.add_argument("--ckpt-individual", type=str, default=None,
                        help="dual mode: the individual in2IN file, merged in")
    parser.add_argument("--strict", action="store_true",
                        help="fail if any parameter is in none of the checkpoint files")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--w-func", type=str, default="const", help="DualMDM weight schedule")
    parser.add_argument("--w-value", type=float, default=0.5)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--traj-control", type=str, default=None, metavar="NPY",
                        help="raw motion .npy whose root trajectory is pinned every step")
    parser.add_argument("--warm-start", type=str, default=None, metavar="NPY",
                        help="raw motion .npy to q-sample as the chain's starting point")
    parser.add_argument("--skip-timesteps", type=int, default=0)
    parser.add_argument("--sampler", type=str, default=None, choices=("ddim", "dpmpp"),
                        help="sampling update rule: ddim (the config's default) or dpmpp "
                             "(DPM-Solver++(2M))")
    parser.add_argument("--sample-steps", type=int, default=None,
                        help="respace the sampling chain to N model calls")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--pp", type=int, default=1,
                        help="pipeline-parallel degree: the denoiser layer stacks run as a "
                             "GPipe pipeline over a 'pipe' axis of N ranks")
    args = parser.parse_args(argv)
    return on_ranks(_run, args)


def _run(args):
    system = build_system(args.model, args.mode, tiny=args.tiny, w_func=args.w_func,
                          w_value=args.w_value, device=args.device, seed=args.seed)
    if args.checkpoint or args.ckpt_individual:
        report_unfilled(system, load_released_in2in(system, args.checkpoint,
                                                    args.ckpt_individual, strict=args.strict))
    apply_sampler_overrides(system, args.sampler, args.sample_steps)
    window = 16 if args.tiny else args.window
    B = args.num_samples
    batch = {"text": [args.text] * B}
    if args.mode != "individual":
        batch["text_individual1"] = [args.text_individual1 or args.text] * B
        batch["text_individual2"] = [args.text_individual2 or args.text] * B
    traj = load_control(system, args.traj_control, B, window)
    warm = load_control(system, args.warm_start, B, window)
    scope = contextlib.nullcontext()
    if args.pp > 1:
        if args.pp > world_size():
            raise SystemExit(f"--pp {args.pp} > {world_size()} available devices")
        pipe = make_mesh(args.pp, axis="pipe")
        if not pipe.member:
            return
        scope = pipeline_scope(pipe)
    t0 = time.perf_counter()
    cond = system.build_cond(batch)
    with scope:
        out = system.sample(cond, window, generator=torch.Generator(device=system.device)
                            .manual_seed(args.seed), traj_control=traj, init_image=warm,
                            skip_timesteps=args.skip_timesteps)
    motions = out.cpu().numpy()
    n_steps = system.sample_schedule.num_timesteps - args.skip_timesteps
    print(f"sampled {B} x {window} frames in {time.perf_counter() - t0:.3f} s (text + {n_steps} "
          f"{system.sampler_type} steps, {args.mode}"
          f"{f', pp {args.pp}' if args.pp > 1 else ''})")
    if world_rank() != 0:
        return
    motions = gaussian_smooth(motions)
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, f"{args.name}_motion.npy")
    np.save(path, motions)
    print(f"saved {motions.shape} to {path}")


if __name__ == "__main__":
    main()
