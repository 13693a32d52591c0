"""Evaluation protocol: matching score, R-precision, FID, diversity,
multimodality and the dual-dataset F-score; counterpart of
``mixermdm_tpu/eval/protocol.py`` (reference scripts/eval/mixermdm.py:17-262,
evaluation/utils.py:126-383).

Generation runs in batches on the card (:mod:`.datasets`, :mod:`.driver`;
the reference generates the test set one item at a time); the embeddings
come from InterCLIP on the card, and the metrics run on the host in numpy
over the stacked embeddings.  Generation splits its rows over a data mesh
where the driver is given one (``mesh=``, :mod:`.driver`); every rank then
scores the whole gathered set, and the CLIs write from rank 0.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List

import numpy as np
import torch

from . import metrics as M
from ..utils.alignment import center_motion, ih_to_smpl, smpl_to_ih


@dataclasses.dataclass(frozen=True)
class EvalProtocol:
    """The paper's evaluation constants (scripts/eval/mixermdm.py:257-262)."""

    mm_num_samples: int = 50
    mm_num_repeats: int = 15
    mm_num_times: int = 5
    diversity_times: int = 125
    replication_times: int = 2
    num_samples: int = 250
    batch_size_interhuman: int = 96
    batch_size_hml3d: int = 32
    top_k: int = 3


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


class EvaluatorWrapper:
    """Co-embeddings of an :class:`~.interclip.InterCLIP` (reference
    utils.py:126-235).  The reference sorts each batch by length and permutes
    the texts the same way; every metric is invariant under that permutation,
    and its truncation to the longest length is the key mask here, so the
    sort is left out (as in the JAX package)."""

    def __init__(self, interclip):
        self.model = interclip

    @torch.inference_mode()
    def _encode_motion(self, motions, motion_lens) -> np.ndarray:
        return _np(self.model.encode_motion(motions, motion_lens))

    @torch.inference_mode()
    def _encode_text(self, texts: List[str]) -> np.ndarray:
        return _np(self.model.encode_text(list(texts)))

    def get_co_embeddings(self, texts: List[str], motions, motion_lens):
        return self._encode_text(texts), self._encode_motion(motions, motion_lens)

    def get_motion_embeddings(self, motions, motion_lens):
        return self._encode_motion(motions, motion_lens)


def center_persons(motions: torch.Tensor) -> torch.Tensor:
    """Per-person canonicalisation ``smpl_to_ih(center_motion(ih_to_smpl(m)))``
    of (N, T, 262) persons (reference utils.py:287-288); contacts come out
    zero (the chain's contact-drop quirk)."""
    return smpl_to_ih(center_motion(ih_to_smpl(motions)))


class EvaluatorWrapperIndividual(EvaluatorWrapper):
    """Single-person evaluator: each person centred and the persons
    interleaved into a 2B batch [p1 of item 0, p2 of item 0, ...] (reference
    utils.py:237-383); a motion already one person wide (MDM, in2IN
    individual) is only centred."""

    @torch.inference_mode()
    def _split_persons(self, motions, motion_lens):
        m = torch.as_tensor(motions).to(self.model.device, torch.float32)
        lens = np.asarray(motion_lens)
        B, T, D = m.shape
        if D == int(self.model.cfg.INPUT_DIM) + 4:
            return center_persons(m), lens
        F_ = D // 2
        persons = torch.stack([m[..., :F_], m[..., F_:]], dim=1).reshape(2 * B, T, F_)
        return center_persons(persons), np.repeat(lens, 2)

    def get_co_embeddings(self, texts: List[str], motions, motion_lens):
        persons, lens = self._split_persons(motions, motion_lens)
        return self._encode_text(texts), self._encode_motion(persons, lens)

    def get_motion_embeddings(self, motions, motion_lens):
        return self._encode_motion(*self._split_persons(motions, motion_lens))


def evaluate_matching_score(motion_sets: Dict[str, list], wrapper: EvaluatorWrapper,
                            top_k: int = 3):
    """MM-Distance and R-precision per generator (eval/mixermdm.py:17-59);
    ``motion_sets[name]`` is a list of ``(texts, motions, lens)`` batches.
    Returns (match score, R-precision, motion embeddings), each by name."""
    match_score, r_precision, activations = OrderedDict(), OrderedDict(), OrderedDict()
    for name, batches in motion_sets.items():
        embs, mm_sum, topk_count, total = [], 0.0, np.zeros(top_k), 0
        for texts, motions, lens in batches:
            t_emb, m_emb = wrapper.get_co_embeddings(texts, motions, lens)
            dist = M.euclidean_distance_matrix(t_emb, m_emb)
            mm_sum += dist.trace()
            k = min(top_k, dist.shape[1])
            hits = M.calculate_top_k(np.argsort(dist, axis=1), k).sum(axis=0)
            topk_count[:k] += hits
            if k < top_k:  # a batch narrower than k: the wider top-k saturate
                topk_count[k:] += hits[-1]
            total += t_emb.shape[0]
            embs.append(m_emb)
        match_score[name] = mm_sum / total
        r_precision[name] = topk_count / total
        activations[name] = np.concatenate(embs, axis=0)
    return match_score, r_precision, activations


def evaluate_fid(gt_batches: list, activations: Dict[str, np.ndarray], wrapper):
    """FID of each generator's embeddings against the ground truth's
    (eval/mixermdm.py:62-79)."""
    gt_embs = np.concatenate([wrapper.get_motion_embeddings(m, l) for _, m, l in gt_batches],
                             axis=0)
    gt_mu, gt_cov = M.calculate_activation_statistics(gt_embs)
    out = OrderedDict()
    for name, acts in activations.items():
        mu, cov = M.calculate_activation_statistics(acts)
        out[name] = M.calculate_frechet_distance(gt_mu, gt_cov, mu, cov)
    return out


def evaluate_diversity(activations: Dict[str, np.ndarray], diversity_times: int, seed=None):
    return OrderedDict((name, M.calculate_diversity(acts, diversity_times, seed))
                       for name, acts in activations.items())


def evaluate_multimodality(mm_sets: Dict[str, list], wrapper: EvaluatorWrapper,
                           mm_num_times: int, seed=None):
    """Multimodality over per-prompt replica sets (eval/mixermdm.py:93-114);
    ``mm_sets[name]`` is a list of ``(motions (R, T, D), lens)``."""
    out = OrderedDict()
    for name, replicas in mm_sets.items():
        if not replicas:
            out[name] = 0.0
            continue
        embs = np.stack([wrapper.get_motion_embeddings(m, l) for m, l in replicas], axis=0)
        out[name] = M.calculate_multimodality(embs, mm_num_times, seed)
    return out


def get_metric_statistics(values: np.ndarray, replication_times: int):
    mean = np.mean(values, axis=0)
    std = np.std(values, axis=0)
    return mean, 1.96 * std / np.sqrt(replication_times)


def calculate_f_score(metrics_interaction: dict, metrics_individual: dict,
                      replication_times: int = 2) -> dict:
    """Harmonic mean of the two datasets' metrics (eval/mixermdm.py:216-241),
    with 0 for the 0/0 limit (the JAX package's choice where the
    reference's bare formula gives nan)."""
    out = {}
    for metric_name in metrics_interaction:
        md_i = metrics_interaction[metric_name]
        md_h = metrics_individual.get(metric_name, {})
        out[metric_name] = {}
        for (name_i, vals_i), (_, vals_h) in zip(md_i.items(), md_h.items()):
            mean_i, ci_i = get_metric_statistics(np.asarray(vals_i), replication_times)
            mean_h, ci_h = get_metric_statistics(np.asarray(vals_h), replication_times)
            denom = mean_i + mean_h
            f = 2 * mean_i * mean_h / denom if denom != 0 else 0.0
            out[metric_name][name_i] = (f, (ci_i + ci_h) / 2)
    return out


def generate_eval_set(system, dataset, batch_size: int, num_samples: int,
                      seed: int = 0) -> list:
    """Batched generation over a ground-truth set -> list of ``(texts,
    motions, lens)``: the generated batches of
    :func:`.driver.generate_batches` (the JAX package's name for them)."""
    from .driver import generate_batches  # .driver imports this module at load

    return generate_batches(system, dataset, seed, num_samples=num_samples,
                            batch_size=batch_size, per_item=False)[1]
