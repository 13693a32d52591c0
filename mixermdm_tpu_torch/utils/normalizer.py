"""Affine motion normalizers ``(x - mean) / std``; counterpart of
``mixermdm_tpu/utils/normalizer.py``.  Statistics load from the reference's
``.npy`` files when a data directory has them, else identity."""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .constants import FEATS_DIM


class Normalizer(NamedTuple):
    mean: torch.Tensor  # (262,) f32
    std: torch.Tensor   # (262,) f32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Raw motion -> normalised model space."""
        return (x - self.mean) / self.std

    def backward(self, x: torch.Tensor) -> torch.Tensor:
        """Normalised model space -> raw motion."""
        return x * self.std + self.mean

    def to(self, device) -> "Normalizer":
        return Normalizer(self.mean.to(device), self.std.to(device))


def identity_normalizer(dim: int = FEATS_DIM, device="cpu") -> Normalizer:
    return Normalizer(torch.zeros(dim, device=device), torch.ones(dim, device=device))


def load_normalizer(mean_path: str, std_path: str, device="cpu") -> Normalizer:
    mean = np.load(mean_path).astype(np.float32).reshape(-1)
    std = np.load(std_path).astype(np.float32).reshape(-1)
    return Normalizer(torch.from_numpy(mean).to(device), torch.from_numpy(std).to(device))


def _stats_or_identity(mean_p: str, std_p: str, device) -> Normalizer:
    if os.path.exists(mean_p) and os.path.exists(std_p):
        return load_normalizer(mean_p, std_p, device)
    return identity_normalizer(device=device)


def interhuman_normalizer(data_root: str = "./data", device="cpu") -> Normalizer:
    return _stats_or_identity(os.path.join(data_root, "global_mean.npy"),
                              os.path.join(data_root, "global_std.npy"), device)


def hml3d_normalizer(data_root: str = "./data", device="cpu") -> Normalizer:
    return _stats_or_identity(os.path.join(data_root, "HumanML3D", "mean_ih_new.npy"),
                              os.path.join(data_root, "HumanML3D", "std_ih_new.npy"), device)
