"""Fine-tune an interaction in2IN model from an individual one: the
individual denoiser's weights carried into the interaction denoiser (its
cross-attention blocks keep their fresh init), every ``sa_block`` frozen,
then base-model training on InterHuman.

Counterpart of ``mixermdm_tpu/cli/train_finetuned.py`` (reference
scripts/train/finetuned.py:152-247).  The individual model comes as a
released in2IN file (``--individual-checkpoint``, read by
``load_released_in2in``; the JAX CLI reads an orbax tree).  The frozen
parameters stay out of the optimizer, as the reference freezes them
(``requires_grad=False``), so they are bitwise unchanged after training
(the JAX package's ``optax.masked`` moves them by +gradient).  Usage::

    python -m mixermdm_tpu_torch train-finetuned --individual-checkpoint individual.ckpt \\
        --data-root data/InterHuman [--epochs 100] [--batch-size 32] [--lr 1e-4] \\
        [--max-steps N] [--out-dir DIR]

Writes ``<out-dir>/final.ckpt`` (the released interaction layout) and
``<out-dir>/final_state``.  ``--tiny`` / ``--device cpu`` as for
``train-in2in``.
"""

from __future__ import annotations

import argparse
import os

from ..config import IN2IN_INDIVIDUAL_DEFAULT, IN2IN_INTERACTION_DEFAULT, tiny_config
from ..data.interhuman import InterHumanDataset
from ..data.loader import DataLoader
from ..data.synthetic import make_interhuman_fixture
from ..models.clip_text import ClipTextConfig
from ..systems.in2in import In2INSystem
from ..train.checkpoint import load_released_in2in
from ..train.finetune import individual_to_interaction, sa_block_frozen
from ..train.trainer import BaseTrainer
from ..weights import init_params_
from .train_in2in import train_loop


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Fine-tune an interaction in2IN model from an "
                                                 "individual one (PyTorch/CUDA port)")
    parser.add_argument("--individual-checkpoint", type=str, default=None,
                        help="released individual in2IN file (default: random weights)")
    parser.add_argument("--data-root", type=str, default="./data")
    parser.add_argument("--out-dir", type=str, default="./checkpoints/finetuned")
    parser.add_argument("--epochs", type=int, default=None, help="default 100 (--tiny: 1)")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tiny", action="store_true", help="tiny synthetic smoke run")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--log-jsonl", type=str, default=None,
                        help="append one JSON record per step (losses, step seconds)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def run(argv=None) -> dict:
    """Fine-tune as the command line says; returns ``{"system", "trainer",
    "records", "checkpoint", "state", "transferred"}``."""
    args = parse_args(argv)
    if args.tiny:
        cfg = cfg_ind = tiny_config()
        clip_cfg = ClipTextConfig.tiny()
        args.data_root = os.path.join(args.out_dir, "_synth")
        make_interhuman_fixture(args.data_root, n_clips=3, n_frames=40)
        epochs, batch_size, max_frames = args.epochs or 1, 2, 32
    else:
        cfg, cfg_ind = IN2IN_INTERACTION_DEFAULT, IN2IN_INDIVIDUAL_DEFAULT
        clip_cfg = ClipTextConfig.vit_l_14()
        epochs, batch_size, max_frames = args.epochs or 100, args.batch_size, 300

    target = init_params_(In2INSystem(cfg, mode="interaction", clip_cfg=clip_cfg,
                                      device=args.device, train=True), args.seed)
    transferred = False
    if args.individual_checkpoint:
        # f32 on the device, so the carried weights are the file's values.
        src = In2INSystem(cfg_ind, mode="individual", clip_cfg=clip_cfg, device=args.device,
                          compute_dtype=None)
        load_released_in2in(src, args.individual_checkpoint)
        fresh = individual_to_interaction(src.denoisers["individual"],
                                          target.denoisers["interaction"])
        print(f"carried the individual denoiser over; {len(fresh)} parameters keep their "
              f"fresh init (the cross-attention blocks)", flush=True)
        transferred = True
        del src
    dataset = InterHumanDataset(args.data_root, mode="train", max_gt_length=max_frames)
    if len(dataset) == 0:
        raise SystemExit(f"no data found under {args.data_root}")
    loader = DataLoader(dataset, batch_size=batch_size, seed=args.seed, reseed_dataset=True)
    trainer = BaseTrainer(target, lr=args.lr, frozen=sa_block_frozen)
    args.save_epoch = epochs + 1  # only the final checkpoint, as the JAX CLI
    records = train_loop(target, trainer, "interaction", loader, args, epochs)
    return {"system": target, "trainer": trainer, "records": records,
            "checkpoint": os.path.join(args.out_dir, "final.ckpt"),
            "state": os.path.join(args.out_dir, "final_state"), "transferred": transferred}


def main(argv=None):
    out = run(argv)
    last = out["records"][-1] if out["records"] else {}
    print(f"finetune done: {len(out['records'])} steps, last loss {last.get('total')}; "
          f"{len(out['trainer'].frozen_names)} sa_block parameters frozen; weights in "
          f"{out['checkpoint']}")
    return 0


if __name__ == "__main__":
    main()
