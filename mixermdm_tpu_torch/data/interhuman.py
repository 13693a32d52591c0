"""InterHuman dataset: two-person motions with interaction and individual
texts; this package's own copy of ``mixermdm_tpu/data/interhuman.py`` on its
numpy path (the JAX package's ``process_pair_interhuman_native`` binds a C++
library; its numpy fallback is what runs here).

Reference datasets/interhuman.py and utils/preprocess.py:6-34: split files,
the left/right and clockwise swap augmentation of the texts, 62-joint raw
files reduced to 22 joints + 21 6d rotations, mirrored copies for training,
a random text choice, a random <= ``max_gt_length``-frame crop, a random
person swap, per-clip canonicalisation with person 2 in person 1's frame,
zero padding to ``max_gt_length`` frames.
"""

from __future__ import annotations

import os
import random
from os.path import join as pjoin
from typing import Optional

import numpy as np

from ..utils.features import process_motion_interhuman, qinv_np, qmul_np, qrot_np, \
    rigid_transform, swap_left_right

MAX_GT_LENGTH = 300
MIN_GT_LENGTH = 15


def _swap_text(s: str) -> str:
    """left <-> right, clockwise <-> counterclockwise (interhuman.py:76-78)."""
    s = s.replace("left", "\0").replace("right", "left").replace("\0", "right")
    return s.replace("clockwise", "\0").replace("counterclockwise", "clockwise").replace(
        "\0", "counterclockwise")


def _read_lines(path: str) -> list:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def load_raw_motion(path: str, min_length: int, swap: bool = False):
    """Raw 62-joint file -> (T, 22*3 + 21*6) [+ its mirrored copy]."""
    try:
        raw = np.load(path).astype(np.float32)
    except (OSError, ValueError):
        return None, None
    motion = np.concatenate([raw[:, : 22 * 3], raw[:, 62 * 3: 62 * 3 + 21 * 6]], axis=1)
    if motion.shape[0] < min_length:
        return None, None
    return motion, swap_left_right(motion, 22) if swap else None


def process_pair(m1: np.ndarray, m2: np.ndarray, max_len: int):
    """Canonicalise both persons, put person 2 in person 1's frame
    (interhuman.py:208-216), zero-pad to ``max_len``.  Returns
    ``(m1, m2, gt_length)``."""
    m1, quat1, pos1 = process_motion_interhuman(m1, 0.001, 0, 22)
    m2, quat2, pos2 = process_motion_interhuman(m2, 0.001, 0, 22)
    r_rel = qmul_np(quat2, qinv_np(quat1))
    angle = np.arctan2(r_rel[:, 2:3], r_rel[:, 0:1])
    xz = qrot_np(quat1, pos2 - pos1)[:, [0, 2]]
    m2 = rigid_transform(np.concatenate([angle, xz], axis=-1)[0], m2)
    gt_length = len(m1)
    if gt_length < max_len:
        pad = np.zeros((max_len - gt_length, m1.shape[1]), m1.dtype)
        m1 = np.concatenate([m1, pad], axis=0)
        m2 = np.concatenate([m2, pad], axis=0)
    return m1.astype(np.float32), m2.astype(np.float32), gt_length


class InterHumanDataset:
    """Random-access dataset over the InterHuman directory layout; items are
    dicts with ``text``, ``text_individual1``, ``text_individual2``,
    ``motion1``, ``motion2`` (``max_gt_length``, 262) and ``motion_lens``."""

    def __init__(self, data_root: str, mode: str = "train", max_gt_length: int = MAX_GT_LENGTH,
                 rng: Optional[random.Random] = None):
        self.mode = mode
        self.max_gt_length = max_gt_length
        self.rng = rng or random.Random(0)
        try:
            names = set(_read_lines(pjoin(data_root, "split", f"{mode}.txt")))
        except OSError:
            names = set()
        self.motion_store: dict = {}
        self.items: list = []
        root = pjoin(data_root, "motions_processed", "person1")
        files = sorted(os.listdir(root)) if os.path.isdir(root) else []
        index = 0
        for file in files:
            stem = file.split(".")[0]
            if names and stem not in names:
                continue
            p1 = pjoin(root, file)
            p2 = p1.replace("person1", "person2")
            text_path = p1.replace("motions_processed", "annots").replace("person1", "") \
                .replace("npy", "txt")
            t1_path = p1.replace("motions_processed", "annots_individual").replace("npy", "txt")
            t2_path = p2.replace("motions_processed", "annots_individual").replace("npy", "txt")
            if not (os.path.exists(text_path) and os.path.exists(t1_path)):
                continue
            texts, ind1, ind2 = _read_lines(text_path), _read_lines(t1_path), _read_lines(t2_path)
            train = mode == "train"
            m1, m1s = load_raw_motion(p1, MIN_GT_LENGTH, swap=train)
            m2, m2s = load_raw_motion(p2, MIN_GT_LENGTH, swap=train)
            if m1 is None or m2 is None:
                continue
            self.motion_store[index] = (m1, m2)
            self.motion_store[index + 1] = (m1s, m2s)
            self.items.append({"name": stem, "motion_id": index, "texts": texts,
                               "texts_individual1": ind1, "texts_individual2": ind2})
            if train:
                self.items.append({"name": stem + "_swap", "motion_id": index + 1,
                                   "texts": [_swap_text(t) for t in texts],
                                   "texts_individual1": [_swap_text(t) for t in ind1],
                                   "texts_individual2": [_swap_text(t) for t in ind2]})
            index += 2

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> dict:
        item = self.items[i % len(self)]
        full1, full2 = self.motion_store[item["motion_id"]]
        text = self.rng.choice(item["texts"])
        t1 = self.rng.choice(item["texts_individual1"])
        t2 = self.rng.choice(item["texts_individual2"])
        # Random crop (interhuman.py:190-200); the feature pipeline uses one
        # frame for the velocities.
        length = full1.shape[0]
        if length > self.max_gt_length:
            start = self.rng.randrange(0, length - self.max_gt_length)
            m1 = full1[start: start + self.max_gt_length]
            m2 = full2[start: start + self.max_gt_length]
        else:
            m1, m2 = full1, full2
        if self.rng.random() > 0.5:  # random person swap (interhuman.py:203-205)
            m1, m2, t1, t2 = m2, m1, t2, t1
        m1, m2, gt_length = process_pair(m1, m2, self.max_gt_length)
        return {"name": item["name"], "text": text, "text_individual1": t1,
                "text_individual2": t2, "motion1": m1, "motion2": m2, "motion_lens": gt_length}
