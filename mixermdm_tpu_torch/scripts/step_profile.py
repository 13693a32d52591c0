"""Where a mixer fit step spends its device time, ``QUANT_TRAIN`` against
bf16.  Run from the repository root on a machine with one GPU::

    python -m mixermdm_tpu_torch.scripts.step_profile [--seed 0] [--steps 3] [--top 12]

Builds the full-width training system of ``chip_smoke.py`` phase 6b (b)
(the shipped MixerMDM config with ``QUANT_TRAIN`` on, B 8, T 300, the
synthetic InterHuman fixture and its statistics) and times fit steps (one G
and one D step each) with the frozen denoisers in bf16 and as int8, in the
order bf16, int8, bf16, int8.  Each turn takes a warm-up step, then
``--steps`` steps under ``torch.profiler`` (CUDA activity only, so every
kernel of the process is traced, the port's own included) and reads:

- wall seconds per step (host clock, the device synchronised at both ends);
- device-busy seconds per step (the traced kernels' and copies' durations
  summed; one stream, so they do not overlap) and the idle share,
  1 - busy / wall;
- the kernels with the most device time, by name, with their calls.

Where the profiler records no device time, the turn says so and reads the
device's elapsed time between two CUDA events instead.  Prints one JSON line
per turn, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import json
import shutil
import subprocess
import sys
import tempfile
import time

import torch


def profile_turn(trainer, batch, seed: int, steps: int, top: int) -> dict:
    """One turn: a warm-up fit step, then ``steps`` traced ones."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    trainer.fit_step(batch, gen, 0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        for _ in range(steps):
            trainer.fit_step(batch, gen, 0)
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us > 0:
            by_name[e.key][0] += us * 1e-6 / steps
            by_name[e.key][1] += e.count // steps
    busy = sum(v[0] for v in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    out = {"wall_s_per_step": wall, "device_busy_s_per_step": busy,
           "idle_share": 1.0 - busy / wall if busy else None,
           "events_s_per_step": start.elapsed_time(end) * 1e-3 / steps,
           "top": [{"kernel": k[:120], "s_per_step": v[0], "calls_per_step": v[1]}
                   for k, v in ranked]}
    if not busy:
        print("   the profiler recorded no device time; events_s_per_step is the device's "
              "elapsed time between two CUDA events", flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_profile: no CUDA device visible; this script needs one GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from mixermdm_tpu_torch.cli.infer_mixermdm import build_system
    from mixermdm_tpu_torch.data.interhuman import InterHumanDataset
    from mixermdm_tpu_torch.data.loader import collate
    from mixermdm_tpu_torch.ops import _lib
    from mixermdm_tpu_torch.train.trainer import MixerTrainer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    _, log = _lib.build()
    print(log, flush=True)
    _lib.library()
    tmp = tempfile.mkdtemp(prefix="step_profile_")
    try:
        chip_smoke._fixture(f"{tmp}/data", args.seed)
        dataset = InterHumanDataset(f"{tmp}/data", mode="train")
        batch_np = collate([dataset[i] for i in range(chip_smoke.TRAIN_B)])
        normalizer = chip_smoke._fixture_normalizer(dataset)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    system = build_system(chip_smoke.MODEL_CFG, device="cuda", seed=args.seed,
                          zero_init_std=0.02, train=True, quant_train=True)
    system.normalizer1 = system.normalizer2 = normalizer
    trainer = MixerTrainer(system, grad_acc_steps=1)
    batch = chip_smoke._device_batch(system, batch_np)
    for quant in (False, True, False, True):
        system.quant_train = quant
        system.cast_(system.compute_dtype, train=True)
        r = profile_turn(trainer, batch, args.seed, args.steps, args.top)
        print(json.dumps({"frozen_denoisers": "int8" if quant else "bf16",
                          "batch": chip_smoke.TRAIN_B, **r}), flush=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
