"""HumanML3D dataset: single-person motions in the 262-d InterHuman layout;
this package's own copy of ``mixermdm_tpu/data/humanml3d.py`` (reference
datasets/humanml3d.py:11-149): ``joints_vec/*.npy`` motions, ``texts/*.txt``
captions (the caption before the first ``#``), a random text, a random
<= ``max_gt_length``-frame crop, zero padding.  The augmentation draws
come from ``self.rng`` (a ``random.Random``), which the loader reseeds per
epoch.  ``extended=True`` gives the two-person form the evaluation reads
(reference humanml3d.py:146-149): the motion and the text duplicated into
``motion2`` and the two individual texts."""

from __future__ import annotations

import os
import random
from os.path import join as pjoin
from typing import Optional

import numpy as np

MAX_GT_LENGTH = 300
MIN_GT_LENGTH = 15


class HumanML3DDataset:
    def __init__(self, data_root: str, mode: str = "train", max_gt_length: int = MAX_GT_LENGTH,
                 rng: Optional[random.Random] = None, extended: bool = False):
        self.extended = extended
        self.max_gt_length = max_gt_length
        self.min_length = MIN_GT_LENGTH
        self.rng = rng or random.Random(0)
        try:
            with open(os.path.join(data_root, f"{mode}.txt")) as f:
                names = {line.strip() for line in f if line.strip()}
        except OSError:
            names = set()
        self.motion_store: dict = {}
        self.items: list = []
        motion_dir = pjoin(data_root, "joints_vec")
        files = sorted(os.listdir(motion_dir)) if os.path.isdir(motion_dir) else []
        for file in files:
            stem = file.split(".")[0]
            if names and stem not in names:
                continue
            mpath = pjoin(motion_dir, file)
            tpath = mpath.replace("joints_vec", "texts").replace("npy", "txt")
            try:
                with open(tpath) as f:
                    texts = [line.strip() for line in f if line.strip()]
                motion = np.load(mpath).astype(np.float32)
            except OSError:
                continue
            if motion.shape[0] < self.min_length:
                continue
            index = len(self.items)
            self.motion_store[index] = motion
            self.items.append({"name": stem, "motion_id": index, "texts": texts})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> dict:
        item = self.items[i % len(self)]
        full = self.motion_store[item["motion_id"]]
        text = self.rng.choice(item["texts"]).split("#")[0].strip()
        length = full.shape[0]
        if length > self.max_gt_length:
            start = self.rng.randrange(0, length - self.max_gt_length)
            motion = full[start:start + self.max_gt_length]
        else:
            motion = full[:self.max_gt_length]
        gt_length = len(motion)
        if gt_length < self.max_gt_length:
            pad = np.zeros((self.max_gt_length - gt_length, motion.shape[1]), motion.dtype)
            motion = np.concatenate([motion, pad], axis=0)
        out = {"name": item["name"], "text": text, "motion1": motion.astype(np.float32),
               "motion_lens": gt_length}
        if self.extended:
            out.update(motion2=out["motion1"], text_individual1=text, text_individual2=text)
        return out
