"""Adversarial MixerMDM training: the mixer core and its text head against
two discriminators, with both in2IN denoisers and the CLIP towers frozen.

Counterpart of ``mixermdm_tpu/cli/train_mixermdm.py`` (reference
scripts/train/mixermdm.py:286-343).  Weights start random from ``--seed``
(the repository holds no checkpoint).  At the end the trained parts are
written as a torch state dict in the released ``MixerMDM.ckpt`` layout
(mixer core, discriminators, post-encoder head, CLIP tower) to
``<out-dir>/MixerMDM.ckpt``.  Usage::

    python -m mixermdm_tpu_torch train-mixermdm --data-root data/InterHuman \\
        [--model configs/models/MixerMDM.yaml] [--train configs/train/MixerMDM.yaml] \\
        [--batch-size 64] [--epochs 300] [--max-steps N] [--log-jsonl steps.jsonl]

``--tiny`` trains a miniature system on a synthetic fixture written under
``<out-dir>/_synth``; ``--device cpu`` runs the plain PyTorch path on the
CPU (f32).  On the card the networks run in bf16 on the kernels, with f32
master weights in the trained subtrees.  Not ported: ``--resume``,
``--quant-train``, ``--tp`` / ``--sp`` / ``--fsdp``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..config import MIXERMDM_TRAIN_DEFAULT, load_yaml
from ..data.interhuman import InterHumanDataset
from ..data.loader import DataLoader
from ..data.synthetic import make_interhuman_fixture
from ..train.trainer import MixerTrainer
from ..weights import released_mixermdm_state_dict
from .infer_mixermdm import build_system


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train MixerMDM (adversarial; PyTorch/CUDA port)")
    parser.add_argument("--model", type=str, default=None, help="model config yaml")
    parser.add_argument("--train", type=str, default=None, help="train config yaml")
    parser.add_argument("--data-root", type=str, default="./data")
    parser.add_argument("--out-dir", type=str, default="./checkpoints/mixermdm")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tiny", action="store_true", help="tiny synthetic smoke run")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--log-jsonl", type=str, default=None,
                        help="append one JSON record per fit step (losses, influence mean, "
                             "step seconds)")
    parser.add_argument("--nan-guard", type=int, default=0, metavar="N",
                        help="skip G/D updates with non-finite gradients; let them through "
                             "after N consecutive bad steps (0 = off)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--init-std", type=float, default=0.0, metavar="S",
                        help="draw the zero-init layers of the random weights from N(0, S) "
                             "(default 0: zeros, as the reference initialises them; with zero "
                             "denoiser outputs no gradient reaches the mixer)")
    return parser.parse_args(argv)


def run(argv=None) -> dict:
    """Train as the command line says; returns ``{"system", "trainer",
    "records", "checkpoint"}``."""
    args = parse_args(argv)
    tr = (load_yaml(args.train) if args.train else MIXERMDM_TRAIN_DEFAULT).TRAIN
    epochs = args.epochs or int(tr.EPOCH)
    batch_size = args.batch_size or int(tr.BATCH_SIZE)
    max_frames = 300
    if args.tiny:
        args.data_root = os.path.join(args.out_dir, "_synth")
        make_interhuman_fixture(args.data_root, n_clips=3, n_frames=40)
        epochs, batch_size, max_frames = 1, 2, 32

    torch.manual_seed(args.seed)  # dropout draws
    system = build_system(args.model, tiny=args.tiny, device=args.device, seed=args.seed,
                          zero_init_std=args.init_std, train=True)
    trainer = MixerTrainer(
        system, lr=float(tr.LR), weight_decay=float(tr.WEIGHT_DECAY),
        grad_acc_steps=int(tr.GRAD_ACC_STEPS), discriminator_steps=int(tr.DISCRIMINATOR_STEPS),
        i_loss_factor=float(tr.INDIVIDUAL_LOSS_FACTOR),
        I_loss_factor=float(tr.INTERACTION_LOSS_FACTOR), l1=float(tr.LOSS_L1),
        nan_guard=args.nan_guard)
    dataset = InterHumanDataset(args.data_root, mode="train", max_gt_length=max_frames)
    if len(dataset) == 0:
        raise SystemExit(f"no data found under {args.data_root}")
    loader = DataLoader(dataset, batch_size=batch_size, seed=args.seed)
    gen = torch.Generator(device=system.device).manual_seed(args.seed)
    jsonl = open(args.log_jsonl, "a", buffering=1) if args.log_jsonl else None
    dev = system.device
    records, step = [], 0
    try:
        for epoch in range(epochs):
            for batch_idx, batch in enumerate(loader):
                t0 = time.perf_counter()
                dev_batch = {
                    "motions": torch.from_numpy(batch["motions"].astype(np.float32)).to(dev),
                    "motion_lens": torch.from_numpy(batch["motion_lens"]).long().to(dev),
                    **system.tokenize_batch(batch)}
                g, d = trainer.fit_step(dev_batch, gen, batch_idx)
                rec = {"step": step, "epoch": epoch, "batch": batch_idx,
                       "g_total": float(g["total"]), "g_i1": float(g["generator_i1"]),
                       "g_I": float(g["generator_I"]),
                       "influence_mean": float(g["influence_mean"]),
                       "d_total": None if d is None else float(d["total"]),
                       "dt_s": time.perf_counter() - t0}
                records.append(rec)
                if jsonl is not None:
                    jsonl.write(json.dumps(rec) + "\n")
                step += 1
                if args.max_steps and step >= args.max_steps:
                    break
            if args.max_steps and step >= args.max_steps:
                break
    finally:
        if jsonl is not None:
            jsonl.close()
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, "MixerMDM.ckpt")
    torch.save({"state_dict": released_mixermdm_state_dict(system)}, path)
    return {"system": system, "trainer": trainer, "records": records, "checkpoint": path}


def main(argv=None):
    out = run(argv)
    last = out["records"][-1] if out["records"] else {}
    print(f"training done: {len(out['records'])} steps, last G loss {last.get('g_total')}, "
          f"D loss {last.get('d_total')}; trained parts in {out['checkpoint']}")
    return 0


if __name__ == "__main__":
    main()
