"""Shuffling, batching loader over a random-access dataset; this package's
own copy of the single-worker path of ``mixermdm_tpu/data/loader.py``
(``collate``, ``DataLoader`` as the training CLIs use it: shuffled, last
partial batch dropped, augmentation reseeded per epoch, ``set_epoch``),
without the prefetch thread.  Every batch has the dataset's static padded length;
strings stay lists."""

from __future__ import annotations

import random
from typing import Iterator

import numpy as np


def collate(samples: list) -> dict:
    """Stack item dicts into a numpy batch; ``motions`` is the two persons
    concatenated on the feature axis, or the one person's motion."""
    out: dict = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = vals if isinstance(vals[0], str) else np.stack([np.asarray(v) for v in vals])
    if "motion1" in out and "motion2" in out:
        out["motions"] = np.concatenate([out["motion1"], out["motion2"]], axis=-1)
    elif "motion1" in out:
        out["motions"] = out["motion1"]
    return out


class DataLoader:
    """Full batches of ``batch_size`` items in an order shuffled from
    ``(seed, epoch)``; the dataset's augmentation draws are reseeded from
    ``(seed, epoch)`` too, so an epoch replays exactly."""

    def __init__(self, dataset, batch_size: int, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Position the loader at ``epoch``: the shuffle and the dataset's
        augmentation draws are functions of ``(seed, epoch)``, so a resumed
        run that sets the epoch it stopped in replays that epoch exactly
        (JAX ``DataLoader.set_epoch``)."""
        self.epoch = int(epoch)

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        self.dataset.rng = random.Random((self.seed + 1) * 1_000_003 + self.epoch)
        idx = np.arange(len(self.dataset))
        np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        self.epoch += 1
        for i in range(0, len(self) * self.batch_size, self.batch_size):
            yield collate([self.dataset[int(j)] for j in idx[i: i + self.batch_size]])
