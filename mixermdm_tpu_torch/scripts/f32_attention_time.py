"""Device time of the f32 attention inside the InterCLIP evaluator.

Two calls, each traced with ``torch.profiler`` (CUDA activity) after a
warm-up: one motion-tower call at the protocol's InterHuman batch (96
clips, 301 rows under a key mask, 8 layers of 8 heads of 128) and one
``train-evaluator`` step at its batch of 32 (both towers forward and
backward, AdamW).  Prints, for each, the device time of the f32 attention
kernels (names containing ``attention_f32`` or ``attn_bwd``) beside the
whole call's device time, and their launches.  Random weights at the
published width, a synthetic InterHuman set made from ``--seed`` in a
temporary directory.  Needs a card::

    python -m mixermdm_tpu_torch.scripts.f32_attention_time [--seed 0]

It measures the ``mixermdm_tpu_torch`` that Python imports first, so one
copy of the script reads two trees of the package:
``PYTHONPATH=<tree> python <path of this file>``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ATTENTION_KERNELS = ("attention_f32", "attn_bwd")
IH_CLIPS, TRAIN_B = 96, 32


def _device_ms(prof, match) -> tuple:
    """(ms, launches) of the kernels whose names contain one of ``match``
    (every kernel for an empty tuple) in a finished profile."""
    total, n = 0.0, 0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "cuda_time_total", 0.0)
        if not dev_us or evt.key.startswith("ProfilerStep"):
            continue
        if getattr(evt, "device_type", None) is not None and "CUDA" not in str(evt.device_type):
            continue
        if match and not any(m in evt.key for m in match):
            continue
        total += dev_us
        n += evt.count
    return total / 1e3, n


def _traced(fn):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    attn_ms, attn_n = _device_ms(prof, ATTENTION_KERNELS)
    all_ms, all_n = _device_ms(prof, ())
    return {"f32_attention_ms": attn_ms, "f32_attention_launches": attn_n,
            "device_ms": all_ms, "kernels": all_n}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("f32_attention_time: needs a CUDA device")
    from mixermdm_tpu_torch.cli.train_evaluator import step, trainable
    from mixermdm_tpu_torch.data.interhuman import InterHumanDataset
    from mixermdm_tpu_torch.data.loader import collate
    from mixermdm_tpu_torch.data.synthetic import make_interhuman_fixture
    from mixermdm_tpu_torch.eval.interclip import build_interclip, full_f32
    from mixermdm_tpu_torch.ops import _lib
    from mixermdm_tpu_torch.train.optim import AdamW

    import mixermdm_tpu_torch

    _lib.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    tmp = tempfile.mkdtemp(prefix="f32_attention_time_")
    try:
        rng = np.random.default_rng(args.seed + 5)
        lengths = [301] + [int(n) for n in rng.integers(40, 302, IH_CLIPS - 1)]
        make_interhuman_fixture(tmp, n_clips=IH_CLIPS, n_frames=lengths, seed=args.seed,
                                n_test=IH_CLIPS)
        data = InterHumanDataset(tmp, mode="test", max_gt_length=300)
        batch = collate([data[i] for i in range(IH_CLIPS)])
        model = build_interclip("interaction", device="cuda", seed=args.seed)
        out = {"package": os.path.dirname(mixermdm_tpu_torch.__file__), "card": card}

        def tower():
            with torch.inference_mode():
                model.encode_motion(batch["motions"], batch["motion_lens"])

        out[f"motion tower B={IH_CLIPS}"] = _traced(tower)
        motions = torch.from_numpy(batch["motions"][:TRAIN_B]).float().cuda()
        lens = torch.from_numpy(batch["motion_lens"][:TRAIN_B]).cuda()
        tokens = model.tokenize(batch["text"][:TRAIN_B])
        opt = AdamW(trainable(model), lr=1e-4, weight_decay=2e-5, clip_norm=None)

        def train_step():
            with full_f32():
                step(model, opt, motions, lens, tokens)

        out[f"train-evaluator step B={TRAIN_B}"] = _traced(train_step)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
