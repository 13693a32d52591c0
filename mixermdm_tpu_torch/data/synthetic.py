"""Synthetic datasets in the InterHuman on-disk layout
(``motions_processed/person{1,2}``, ``annots``, ``annots_individual``,
``split/*.txt``; reference datasets/interhuman.py:37-94) and the HumanML3D
one (``joints_vec``, ``texts``, ``train.txt``; humanml3d.py:38-74): this
package's own copy of ``mixermdm_tpu/data/synthetic.py``
(``make_interhuman_fixture``, ``make_hml3d_fixture``), for smoke runs with
no real data.  ``n_frames`` may be a list, one length per clip, so that a
batch holds clips shorter than the padded length."""

from __future__ import annotations

import os
from os.path import join as pjoin
from typing import Sequence, Union

import numpy as np

_TEXTS = [
    "two people walk towards each other and hug",
    "one person pushes the other on the left shoulder",
    "both persons dance clockwise holding hands",
]
_IND_TEXTS = ["a person walks forward", "a person raises the right arm"]


def random_raw_motion(rng: np.random.Generator, n_frames: int) -> np.ndarray:
    """(T, 62*3 + 21*6) raw-layout motion with a walking root."""
    pos = rng.standard_normal((n_frames, 62, 3)).astype(np.float32) * 0.05
    pos[..., 1] += 0.9
    pos[:, :, 2] += np.linspace(0, 1.5, n_frames, dtype=np.float32)[:, None]
    rot6d = (np.tile(np.asarray([1, 0, 0, 0, 1, 0], np.float32), (n_frames, 21))
             + rng.standard_normal((n_frames, 21 * 6)).astype(np.float32) * 0.05)
    return np.concatenate([pos.reshape(n_frames, -1), rot6d], axis=1)


def make_interhuman_fixture(root: str, n_clips: int = 4,
                            n_frames: Union[int, Sequence[int]] = 40, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    lengths = [n_frames] * n_clips if isinstance(n_frames, int) else list(n_frames)
    for d in ("motions_processed/person1", "motions_processed/person2", "annots",
              "annots_individual/person1", "annots_individual/person2", "split"):
        os.makedirs(pjoin(root, d), exist_ok=True)
    names = []
    for i, T in enumerate(lengths):
        name = f"clip{i:03d}"
        names.append(name)
        for p in ("person1", "person2"):
            np.save(pjoin(root, "motions_processed", p, f"{name}.npy"), random_raw_motion(rng, T))
        with open(pjoin(root, "annots", f"{name}.txt"), "w") as f:
            f.write("\n".join(_TEXTS))
        for p in ("person1", "person2"):
            with open(pjoin(root, "annots_individual", p, f"{name}.txt"), "w") as f:
                f.write("\n".join(_IND_TEXTS))
    for split, sel in (("train", names), ("val", names[:1]), ("test", names[-2:])):
        with open(pjoin(root, "split", f"{split}.txt"), "w") as f:
            f.write("\n".join(sel) + "\n")
    return names


def make_hml3d_fixture(root: str, n_clips: int = 4,
                       n_frames: Union[int, Sequence[int]] = 40, seed: int = 1) -> list:
    """``n_clips`` single-person clips of (T, 262) N(0, 0.1) features and one
    caption each, every clip in every split (JAX ``make_hml3d_fixture``)."""
    rng = np.random.default_rng(seed)
    lengths = [n_frames] * n_clips if isinstance(n_frames, int) else list(n_frames)
    os.makedirs(pjoin(root, "joints_vec"), exist_ok=True)
    os.makedirs(pjoin(root, "texts"), exist_ok=True)
    names = []
    for i, T in enumerate(lengths):
        name = f"hml{i:03d}"
        names.append(name)
        np.save(pjoin(root, "joints_vec", f"{name}.npy"),
                rng.standard_normal((T, 262)).astype(np.float32) * 0.1)
        with open(pjoin(root, "texts", f"{name}.txt"), "w") as f:
            f.write("a person does something#0.0#0.0\n")
    for split in ("train", "val", "test"):
        with open(pjoin(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return names
