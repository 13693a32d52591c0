"""Generated-motion evaluation datasets; counterpart of
``mixermdm_tpu/eval/datasets.py`` (reference evaluation/datasets.py:17-546).

:class:`EvaluationDatasetInterHuman` samples the model over a ground-truth
test set in batches (the reference samples one item at a time) through
:func:`..eval.driver.generate_batches`, the one generation loop of the
protocol; :class:`MMGeneratedDataset` the multimodality replica sets (all
replicas of one prompt in one batch), :class:`EvaluationDatasetDualMDM` the
InterHuman interaction texts crossed with random HumanML3D individual texts
under a ``force_influence_val``.  The reference's LLM text splitter
(gpt-4o-mini) is an injectable callable here:
:func:`default_text_decomposer` (identity) or
:func:`..eval.decompose.heuristic_text_decomposer`.  Where a dataset
carries no individual texts and no splitter is given, both persons get the
caption (:func:`individual_texts`, the reference's path without its LLM).

A "system" has ``generate_cond(batch)``, ``sample(cond, n_frames,
generator=..., **kwargs)`` returning raw motion, and ``device``.  Each batch
draws from its own generator, a function of ``(gen_seed, batch index,
stream)`` (:func:`batch_generator`); the JAX package's key splits
are not reproduced.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ..data.loader import collate


# Generator streams of one replication: the generated test set, the
# multimodality replica sets, the DualMDM cross sweep.
GEN_STREAM, MM_STREAM, CROSS_STREAM = 0, 1, 2


def batch_generator(seed: int, index: int, stream: int = GEN_STREAM,
                    device="cuda") -> torch.Generator:
    """The generator of batch ``index`` of ``stream`` (< 16), seeded from
    ``(seed, index, stream)`` only; a replication's seed is ``seed + 1000 *
    replication`` (as the JAX driver keys its replications)."""
    mixed = ((int(seed) * 1_000_003 + int(index)) * 16 + int(stream)) % (1 << 62)
    return torch.Generator(device=device).manual_seed(mixed)


def default_text_decomposer(interaction_texts: List[str]):
    """Identity splitter: both persons get the interaction text (the
    reference's path without the LLM); ``--decompose identity``."""
    return list(interaction_texts), list(interaction_texts)


def individual_texts(batch: dict, text_decomposer: Optional[Callable] = None) -> dict:
    """``batch`` with its per-person texts set: ``text_decomposer``'s split
    of the captions where one is given (it overrides the dataset's texts),
    else the dataset's own, else the caption for both persons."""
    if text_decomposer is not None:
        t1, t2 = text_decomposer(list(batch["text"]))
    elif "text_individual1" not in batch:
        t1, t2 = default_text_decomposer(batch["text"])
    else:
        return batch
    batch["text_individual1"], batch["text_individual2"] = list(t1), list(t2)
    return batch


def sample(system, cond, n_frames: int, generator: torch.Generator, mesh=None,
           **kwargs) -> np.ndarray:
    """One batch of generation -> (B, n_frames, D) f32 numpy (the JAX
    package's ``_sharded_sample``): on the system's card, or with ``mesh``
    its rows split over the data axis, padded with the last row to a
    multiple of it, gathered and the pad dropped
    (``systems.base.data_parallel_sample``)."""
    if mesh is not None:
        kwargs["mesh"] = mesh
    out = system.sample(cond, n_frames, generator=generator, **kwargs)
    return out.float().cpu().numpy()


def pad_frames(motions: np.ndarray, max_frames: int) -> np.ndarray:
    """(B, T, D) -> (B, max(T, max_frames), D), zeros after frame T."""
    pad = max_frames - motions.shape[1]
    return np.pad(motions, ((0, 0), (0, pad), (0, 0))) if pad > 0 else motions


class EvaluationDatasetInterHuman:
    """Generated motions over the InterHuman ground-truth test set, batch by
    batch at the batch's longest length (:func:`.driver.generate_batches`),
    zero-padded to ``max_frames``.
    ``force_influence_val`` goes to each ``sample`` call as an argument; the
    system itself is not changed."""

    def __init__(self, system, gt_dataset, gen_seed: int = 0, num_samples: int = 250,
                 batch_size: int = 32, max_frames: int = 300,
                 text_decomposer: Optional[Callable] = None,
                 force_influence_val: Optional[float] = None, stream: int = GEN_STREAM,
                 mesh=None):
        from .driver import generate_batches  # .driver imports this module at load

        fiv = {} if force_influence_val is None else {"force_influence_val": force_influence_val}
        _, generated, _ = generate_batches(
            system, gt_dataset, gen_seed, num_samples=num_samples, batch_size=batch_size,
            per_item=False, sample_kwargs=fiv, text_decomposer=text_decomposer, stream=stream,
            mesh=mesh)
        self.items = [{"text": text, "motions": m, "motion_lens": int(n)}
                      for texts, motions, lens in generated
                      for text, m, n in zip(texts, pad_frames(motions, max_frames), lens)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def batches(self, batch_size: int):
        """(texts, motions, lens) batches for the metric drivers."""
        for start in range(0, len(self.items), batch_size):
            chunk = self.items[start:start + batch_size]
            yield ([c["text"] for c in chunk], np.stack([c["motions"] for c in chunk]),
                   np.asarray([c["motion_lens"] for c in chunk]))


class MMGeneratedDataset:
    """Per-prompt replica sets for multimodality (datasets.py:187-224): for
    ``mm_num_samples`` prompts picked with ``np.random.default_rng(0)`` (as
    the JAX package picks them), ``mm_num_repeats`` samples each, in one
    batch, at the prompt's own length."""

    def __init__(self, system, gt_dataset, gen_seed: int = 0, mm_num_samples: int = 50,
                 mm_num_repeats: int = 15, max_frames: int = 300,
                 stream: int = MM_STREAM, mesh=None):
        self.replica_sets: list = []
        picks = np.random.default_rng(0).choice(
            len(gt_dataset), min(mm_num_samples, len(gt_dataset)), replace=False)
        for i, pick in enumerate(picks):
            s = gt_dataset[int(pick)]
            batch = individual_texts(collate([s] * mm_num_repeats))
            T = int(s["motion_lens"])
            motions = sample(system, system.generate_cond(batch), T,
                             batch_generator(gen_seed, i, stream, system.device), mesh)
            self.replica_sets.append((pad_frames(motions, max_frames),
                                      np.asarray([T] * mm_num_repeats)))

    def __len__(self):
        return len(self.replica_sets)

    def __getitem__(self, i):
        return self.replica_sets[i]


class EvaluationDatasetDualMDM(EvaluationDatasetInterHuman):
    """Cross-dataset composition (datasets.py:228-382): InterHuman
    interaction texts with random HumanML3D texts as the individual ones
    (picked with ``np.random.default_rng(seed)``), generated under
    ``force_influence_val``."""

    def __init__(self, system, gt_dataset, hml3d_dataset, gen_seed: int = 0,
                 force_influence_val: Optional[float] = None, seed: int = 0, **kwargs):
        picker = np.random.default_rng(seed)

        def cross_decomposer(texts):
            n = len(texts)
            idx1 = picker.integers(0, len(hml3d_dataset), n)
            idx2 = picker.integers(0, len(hml3d_dataset), n)
            return ([hml3d_dataset[int(i)]["text"] for i in idx1],
                    [hml3d_dataset[int(i)]["text"] for i in idx2])

        super().__init__(system, gt_dataset, gen_seed, text_decomposer=cross_decomposer,
                         force_influence_val=force_influence_val, **kwargs)
