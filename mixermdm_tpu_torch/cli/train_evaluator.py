"""InterCLIP evaluator training: AdamW (lr 1e-4, weight decay 2e-5, no
clipping) over the symmetric contrastive loss of motions and their texts.

Counterpart of ``mixermdm_tpu/cli/train_evaluator.py`` (reference
scripts/train/evaluator.py:138-182, a script that cannot run: it imports a
``DataModuleIndividual`` that does not exist).  Usage::

    python -m mixermdm_tpu_torch train-evaluator --data-root DIR \\
        [--mode interaction|individual] [--epochs 100] [--batch-size 32] \\
        [--lr 1e-4] [--weight-decay 2e-5] [--max-steps N] [--out-dir DIR]

``interaction`` trains on an InterHuman-layout directory (two persons, the
interaction texts); ``individual`` on a HumanML3D-layout one (one person,
centred as the individual evaluator centres the persons it scores; the
JAX CLI feeds InterHuman pairs to the single-person tower, which refuses
their width).  The frozen CLIP token and positional embeddings are not
trained and not decayed: they leave the optimizer's list, as the
reference's ``torch.optim.AdamW`` skips parameters without a gradient (the
JAX CLI's ``optax.adamw`` decays them; ROADMAP Queue 3 item 5).  The
weights go to ``<out-dir>/final.ckpt`` in the reference evaluator's layout,
which ``eval-mixermdm --evaluator-checkpoint`` reads.  ``--tiny`` trains the
miniature evaluator on a synthetic fixture under ``<out-dir>/_synth``;
``--device cpu`` runs the plain PyTorch path.  Everything is f32 with TF32
off, on the card too.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..data.humanml3d import HumanML3DDataset
from ..data.interhuman import InterHumanDataset
from ..data.loader import DataLoader
from ..data.synthetic import make_hml3d_fixture, make_interhuman_fixture
from ..eval.interclip import build_interclip, full_f32
from ..eval.protocol import center_persons
from ..train.checkpoint import save_released
from ..train.loop import run_epochs
from ..train.optim import AdamW
from ..weights import released_interclip_state_dict


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train the InterCLIP evaluator "
                                                 "(PyTorch/CUDA port)")
    parser.add_argument("--data-root", type=str, default="./data")
    parser.add_argument("--out-dir", type=str, default="./checkpoints/evaluator")
    parser.add_argument("--mode", type=str, default="interaction",
                        choices=["interaction", "individual"])
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight-decay", type=float, default=2e-5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--log-jsonl", type=str, default=None,
                        help="append one JSON record per step (losses, step seconds)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def trainable(model) -> list:
    """The parameters the optimizer updates: all but the frozen embeddings."""
    return [p for p in model.parameters() if p.requires_grad]


def step(model, opt: AdamW, motions, lens, tokens) -> dict:
    """One AdamW step on the contrastive loss; returns the losses as
    floats."""
    loss, losses = model.compute_loss(motions, lens, tokens)
    opt.zero_grad()
    loss.backward()
    opt.step()
    return {k: float(v.detach()) for k, v in losses.items()}


def run(argv=None) -> dict:
    """Train as the command line says; returns ``{"model", "records",
    "checkpoint"}``."""
    args = parse_args(argv)
    individual = args.mode == "individual"
    epochs, batch_size, max_frames = args.epochs, args.batch_size, 300
    if args.tiny:
        args.data_root = os.path.join(args.out_dir, "_synth")
        (make_hml3d_fixture if individual else make_interhuman_fixture)(
            args.data_root, n_clips=3, n_frames=40)
        epochs, batch_size, max_frames = 1, 2, 32
    model = build_interclip(args.mode, tiny=args.tiny, device=args.device, seed=args.seed)
    dataset = (HumanML3DDataset if individual else InterHumanDataset)(
        args.data_root, mode="train", max_gt_length=max_frames)
    if len(dataset) == 0:
        raise SystemExit(f"no data under {args.data_root}")
    loader = DataLoader(dataset, batch_size=batch_size, seed=args.seed, reseed_dataset=True)
    opt = AdamW(trainable(model), lr=args.lr, weight_decay=args.weight_decay, clip_norm=None)
    dev = model.device
    records = []
    jsonl = open(args.log_jsonl, "a", buffering=1) if args.log_jsonl else None

    def fit(epoch, batch_idx, batch, n):
        t0 = time.perf_counter()
        motions = torch.from_numpy(batch["motions"].astype(np.float32)).to(dev)
        if individual:
            motions = center_persons(motions)
        losses = step(model, opt, motions, torch.from_numpy(batch["motion_lens"]).to(dev),
                      model.tokenize(batch["text"]))
        rec = {"step": n, "epoch": epoch, "batch": batch_idx, **losses,
               "dt_s": time.perf_counter() - t0}
        records.append(rec)
        if jsonl is not None:
            jsonl.write(json.dumps(rec) + "\n")
        if n % 10 == 0:
            print(f"step {n} epoch {epoch}: total {losses['total']:.5f}", flush=True)

    try:
        with full_f32():
            steps = run_epochs(loader, epochs, 0, args.max_steps, fit, lambda epoch: None,
                               epochs + 1)
    finally:
        if jsonl is not None:
            jsonl.close()
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, "final.ckpt")
    save_released(path, released_interclip_state_dict(model))
    print(f"evaluator training done: {steps} steps; wrote {path}", flush=True)
    return {"model": model, "records": records, "checkpoint": path}


def main(argv=None):
    run(argv)


if __name__ == "__main__":
    main()
