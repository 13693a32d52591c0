"""Base-model training: in2IN interaction or individual, or MDM, with the
MSE + geometric losses, one AdamW (lr 1e-4, weight decay 2e-5, no
clipping; the cosine warmup schedule in interaction mode) and the config's
schedule sampler.

Counterpart of ``mixermdm_tpu/cli/train_in2in.py`` (reference
scripts/train/in2IN.py:151-201, mdm.py:128-175).  Weights start random from
``--seed``.  Usage::

    python -m mixermdm_tpu_torch train-in2in --mode interaction|individual|mdm \\
        --data-root DIR [--model CONFIG.yaml] [--epochs 2000] [--batch-size 32] \\
        [--lr 1e-4] [--weight-decay 2e-5] [--save-epoch 100] [--max-steps N] \\
        [--resume PATH|auto] [--nan-guard N] [--log-jsonl steps.jsonl]

``interaction`` trains on an InterHuman-layout directory, ``individual``
and ``mdm`` on a HumanML3D-layout one (``joints_vec``, ``texts``,
``train.txt``).  The architecture is the mode's shipped config (in2IN,
individual; MDM's 512-d on ViT-B/32 for ``mdm``, the model ``infer-mdm``
samples) unless ``--model`` names another; MDM's text is its 22-token
context zero-padded to 77.  Every ``--save-epoch`` epochs the weights go to
``<out-dir>/epoch_N.ckpt`` in the released layout of the mode (what
``infer-in2in --checkpoint`` / ``infer-mdm --checkpoint`` read) and the full
train state (trained parameters, optimizer state, step, sampler history) to
``<out-dir>/epoch_N_state``; at the end to ``final.ckpt`` and
``final_state``.  ``--resume auto`` continues from the newest train state
under ``--out-dir``; each step's draws come from ``(seed, step)``.

``--tiny`` trains the miniature configuration on a synthetic fixture under
``<out-dir>/_synth``; ``--device cpu`` runs the plain PyTorch path (f32).
On the card the networks run in bf16 on the kernels with f32 master weights
in the trained subtrees.  Not ported: ``--tp`` / ``--sp`` / ``--fsdp``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..config import IN2IN_INDIVIDUAL_DEFAULT, IN2IN_INTERACTION_DEFAULT, MDM_DEFAULT, \
    load_yaml, tiny_config
from ..data.humanml3d import HumanML3DDataset
from ..data.interhuman import InterHumanDataset
from ..data.loader import DataLoader
from ..data.synthetic import make_hml3d_fixture, make_interhuman_fixture
from ..models.clip_text import ClipTextConfig
from ..systems.in2in import In2INSystem
from ..systems.mdm import MDMSystem
from ..train.checkpoint import restore_train_state, save_released, save_train_state
from ..train.loop import run_epochs
from ..train.optim import cosine_warmup_schedule
from ..train.trainer import BaseTrainer, step_generator
from ..weights import init_params_, released_in2in_state_dict, released_mdm_state_dict
from .train_mixermdm import resolve_resume

MODES = ("interaction", "individual", "mdm")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train in2IN / MDM base models "
                                                 "(PyTorch/CUDA port)")
    parser.add_argument("--model", type=str, default=None, help="model config yaml")
    parser.add_argument("--mode", type=str, default="interaction", choices=MODES)
    parser.add_argument("--data-root", type=str, default="./data")
    parser.add_argument("--out-dir", type=str, default="./checkpoints/base")
    parser.add_argument("--epochs", type=int, default=None, help="default 2000 (--tiny: 1)")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight-decay", type=float, default=2e-5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--resume", type=str, default=None, metavar="PATH|auto",
                        help='a *_state file, or "auto" for the newest one in --out-dir')
    parser.add_argument("--save-epoch", type=int, default=100,
                        help="save the weights and the train state every N epochs")
    parser.add_argument("--nan-guard", type=int, default=0, metavar="N",
                        help="skip updates with non-finite gradients; let them through after "
                             "N consecutive bad steps (0 = off)")
    parser.add_argument("--tiny", action="store_true", help="tiny synthetic smoke run")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--log-jsonl", type=str, default=None,
                        help="append one JSON record per step (losses, step seconds)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--init-std", type=float, default=0.0, metavar="S",
                        help="draw the zero-init layers of the random weights from N(0, S) "
                             "(default 0: zeros, as the reference initialises them)")
    return parser.parse_args(argv)


def build_system(mode: str, model_cfg_path=None, *, tiny: bool = False, device="cuda",
                 seed: int = 0, zero_init_std: float = 0.0, normalizer=None):
    """The trainable system of ``mode`` (f32 master weights in the trained
    subtrees), on ``device`` with random weights from ``seed``."""
    if tiny:
        cfg = tiny_config()
        clip_cfg = ClipTextConfig.tiny()
    else:
        default = {"interaction": IN2IN_INTERACTION_DEFAULT,
                   "individual": IN2IN_INDIVIDUAL_DEFAULT, "mdm": MDM_DEFAULT}[mode]
        cfg = load_yaml(model_cfg_path) if model_cfg_path else default
        clip_cfg = ClipTextConfig.vit_b_32() if mode == "mdm" else ClipTextConfig.vit_l_14()
    kw = dict(clip_cfg=clip_cfg, device=device, train=True, normalizer=normalizer)
    system = MDMSystem(cfg, **kw) if mode == "mdm" else In2INSystem(cfg, mode=mode, **kw)
    return init_params_(system, seed, zero_init_std)


def batch_tokens(system, mode: str, batch: dict) -> dict:
    """The token tensors of a batch: ``tokens`` [+ ``tokens_i1`` /
    ``tokens_i2`` in interaction mode]; MDM's 22-token layout padded to 77."""
    if mode == "mdm":
        return {"tokens": system.tokenize(batch["text"])}
    return system.tokenize_batch(batch)


def released_state_dict(system, mode: str) -> dict:
    return (released_mdm_state_dict(system) if mode == "mdm"
            else released_in2in_state_dict(system, mode))


def train_loop(system, trainer, mode: str, loader, args, epochs: int) -> list:
    """The epochs of a base-model run from the trainer's step, with the
    checkpoints of ``--save-epoch`` and ``final``; returns the per-step
    records."""
    dev = system.device
    records = []
    jsonl = open(args.log_jsonl, "a", buffering=1) if args.log_jsonl else None
    os.makedirs(args.out_dir, exist_ok=True)

    def fit(epoch, batch_idx, batch, step):
        t0 = time.perf_counter()
        dev_batch = {"motions": torch.from_numpy(batch["motions"].astype(np.float32)).to(dev),
                     "motion_lens": torch.from_numpy(batch["motion_lens"]).long().to(dev),
                     **batch_tokens(system, mode, batch)}
        losses = trainer.step(dev_batch, step_generator(args.seed, step, dev))
        rec = {"step": step, "epoch": epoch, "batch": batch_idx,
               "total": float(losses["total"]), "dt_s": time.perf_counter() - t0}
        records.append(rec)
        if jsonl is not None:
            jsonl.write(json.dumps(rec) + "\n")

    def save(name):
        save_released(os.path.join(args.out_dir, f"{name}.ckpt"), released_state_dict(system, mode))
        save_train_state(os.path.join(args.out_dir, f"{name}_state"), trainer)

    try:
        run_epochs(loader, epochs, trainer.step_count, args.max_steps, fit,
                   lambda epoch: save(f"epoch_{epoch}"), args.save_epoch)
    finally:
        if jsonl is not None:
            jsonl.close()
    save("final")
    return records


def run(argv=None) -> dict:
    """Train as the command line says; returns ``{"system", "trainer",
    "records", "checkpoint", "state"}``."""
    args = parse_args(argv)
    mode = args.mode
    interaction = mode == "interaction"
    epochs, batch_size, max_frames = args.epochs or 2000, args.batch_size, 300
    if args.tiny:
        args.data_root = os.path.join(args.out_dir, "_synth")
        if interaction:
            make_interhuman_fixture(args.data_root, n_clips=3, n_frames=40)
        else:
            make_hml3d_fixture(args.data_root, n_clips=3, n_frames=40)
        epochs, batch_size, max_frames = args.epochs or 1, 2, 32

    system = build_system(mode, args.model, tiny=args.tiny, device=args.device, seed=args.seed,
                          zero_init_std=args.init_std)
    dataset = (InterHumanDataset if interaction else HumanML3DDataset)(
        args.data_root, mode="train", max_gt_length=max_frames)
    if len(dataset) == 0:
        raise SystemExit(f"no data found under {args.data_root}")
    loader = DataLoader(dataset, batch_size=batch_size, seed=args.seed, reseed_dataset=True)
    schedule = None
    if interaction:
        # The reference's CosineWarmupScheduler (in2IN.py:51-58: a warmup of
        # 10 epochs over EPOCH epochs), per step as in the JAX CLI.
        per_epoch = max(1, len(dataset) // batch_size)
        schedule = cosine_warmup_schedule(args.lr, 10 * per_epoch, epochs * per_epoch)
    trainer = BaseTrainer(system, lr=args.lr, weight_decay=args.weight_decay,
                          lr_schedule=schedule, nan_guard=args.nan_guard)
    resume = resolve_resume(args.resume, args.out_dir)
    if resume:
        restore_train_state(resume, trainer)
        print(f"resumed {resume} at step {trainer.step_count}", flush=True)
    records = train_loop(system, trainer, mode, loader, args, epochs)
    return {"system": system, "trainer": trainer, "records": records,
            "checkpoint": os.path.join(args.out_dir, "final.ckpt"),
            "state": os.path.join(args.out_dir, "final_state")}


def main(argv=None):
    out = run(argv)
    last = out["records"][-1] if out["records"] else {}
    print(f"training done: {len(out['records'])} steps, last loss {last.get('total')}; "
          f"weights in {out['checkpoint']}, train state in {out['state']}")
    return 0


if __name__ == "__main__":
    main()
