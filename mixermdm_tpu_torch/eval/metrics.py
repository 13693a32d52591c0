"""Evaluation metrics: R-precision, matching score, FID, diversity,
multimodality, and the Sinkhorn Wasserstein distance; counterpart of
``mixermdm_tpu/eval/metrics.py`` (reference utils/metrics.py:11-292).

The small dense linear algebra stays numpy / scipy (the reference's
``sqrtm`` numerics), with the same seeded ``np.random`` draws for diversity
and multimodality, so the port's figures equal the JAX package's on the
same embeddings.  :func:`calculate_wasserstein` (the reference's pykeops
kernel) is a log-domain Sinkhorn loop in torch on the caller's device.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

EMB_SCALE = 6.0


def euclidean_distance_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N1, D), (N2, D) -> (N1, N2) pairwise distances."""
    d = -2 * a @ b.T + (a**2).sum(1, keepdims=True) + (b**2).sum(1)
    return np.sqrt(np.maximum(d, 0.0))


def calculate_top_k(argsorted: np.ndarray, top_k: int) -> np.ndarray:
    """Bool (N, top_k): ground-truth index within the first k columns."""
    n = argsorted.shape[0]
    gt = np.arange(n)[:, None]
    hits = argsorted[:, :top_k] == gt
    return np.cumsum(hits, axis=1) > 0


def calculate_R_precision(emb1, emb2, top_k: int, sum_all: bool = False):
    dist = euclidean_distance_matrix(emb1, emb2)
    argsorted = np.argsort(dist, axis=1)
    mat = calculate_top_k(argsorted, top_k)
    return mat.sum(axis=0) if sum_all else mat


def calculate_matching_score(emb1, emb2, sum_all: bool = False):
    dist = np.linalg.norm(emb1 - emb2, axis=1)
    return dist.sum() if sum_all else dist


def calculate_activation_statistics(activations: np.ndarray):
    activations = activations * EMB_SCALE
    mu = activations.mean(axis=0)
    cov = np.cov(activations, rowvar=False)
    return mu, cov


def calculate_diversity(activations: np.ndarray, diversity_times: int, seed=None):
    assert activations.ndim == 2 and activations.shape[0] > diversity_times
    rng = np.random.default_rng(seed)
    activations = activations * EMB_SCALE
    n = activations.shape[0]
    first = rng.choice(n, diversity_times, replace=False)
    second = rng.choice(n, diversity_times, replace=False)
    return float(
        np.linalg.norm((activations[first] - activations[second]) / 2, axis=1).mean()
    )


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6) -> float:
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    # (sqrtm's ``disp`` argument, which the JAX package passes, is gone from
    # newer SciPy; without it the call returns the same matrix)
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"imaginary component {np.max(np.abs(covmean.imag))}"
            )
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def calculate_fid(activations_gen: np.ndarray, activations_gt: np.ndarray) -> float:
    mu1, s1 = calculate_activation_statistics(activations_gen)
    mu2, s2 = calculate_activation_statistics(activations_gt)
    return calculate_frechet_distance(mu1, s1, mu2, s2)


def calculate_multimodality(activations: np.ndarray, multimodality_times: int, seed=None):
    assert activations.ndim == 3 and activations.shape[1] > multimodality_times
    rng = np.random.default_rng(seed)
    n_per = activations.shape[1]
    first = rng.choice(n_per, multimodality_times, replace=False)
    second = rng.choice(n_per, multimodality_times, replace=False)
    return float(
        np.linalg.norm(activations[:, first] - activations[:, second], axis=2).mean()
    )


def calculate_wasserstein(x, y, p: float = 2, w_x=None, w_y=None, eps: float = 1e-3,
                          max_iters: int = 100, stop_thresh: float = 1e-5,
                          device=None) -> float:
    """Entropy-regularised p-Wasserstein transport cost between point sets
    x (n, D) and y (m, D) (uniform weights unless ``w_x`` / ``w_y``): the
    log-domain Sinkhorn updates of the dual potentials f and g until both
    move less than ``stop_thresh`` or ``max_iters`` (JAX
    ``calculate_wasserstein``).  Runs in f32 on ``device`` (default: x's,
    when x is a tensor, else the CPU)."""
    if device is None:
        device = x.device if torch.is_tensor(x) else "cpu"
    def as_t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    x, y = as_t(x), as_t(y)
    n, m = x.shape[0], y.shape[0]
    w_x = torch.full((n,), 1.0 / n, device=device) if w_x is None else as_t(w_x)
    w_y = torch.full((m,), 1.0 / m, device=device) if w_y is None else as_t(w_y)
    cost = torch.sqrt(((x[:, None, :] - y[None, :, :]) ** 2).sum(-1) + 1e-12) ** p
    log_wx, log_wy = torch.log(w_x), torch.log(w_y)
    f = torch.zeros(n, device=device)
    g = torch.zeros(m, device=device)
    for _ in range(max_iters):
        f_new = -eps * torch.logsumexp((g[None, :] - cost) / eps + log_wy[None, :], dim=1)
        g_new = -eps * torch.logsumexp((f_new[:, None] - cost) / eps + log_wx[:, None], dim=0)
        err = torch.maximum((f_new - f).abs().max(), (g_new - g).abs().max())
        f, g = f_new, g_new
        if not bool(err > stop_thresh):
            break
    plan = torch.exp((f[:, None] + g[None, :] - cost) / eps + log_wx[:, None] + log_wy[None, :])
    return float((plan * cost).sum())
