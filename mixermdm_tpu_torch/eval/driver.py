"""The evaluation protocol's driver: batched generation and one dataset side;
counterpart of ``mixermdm_tpu/eval/driver.py``.

``eval-mixermdm`` and ``eval-base`` run the same code over different
generators (reference scripts/eval/mixermdm.py, interaction.py,
individual.py).  A "system" has ``generate_cond(batch)``,
``sample(cond, n_frames, generator=..., **kwargs)`` returning raw motion, and
``device``; :class:`BaseSystemAdapter` gives the base systems (in2IN in any
mode, DualMDM, MDM) that surface.  Generation draws come from
:func:`batch_generator`: a function of (seed, replication, batch), as the
port's other CLIs draw from (seed, step); the JAX package's key splits are
not reproduced.
"""

from __future__ import annotations

import time
from collections import OrderedDict, defaultdict

import numpy as np
import torch

from ..data.loader import collate
from . import protocol as P
from .datasets import CROSS_STREAM, GEN_STREAM, MM_STREAM, EvaluationDatasetDualMDM, \
    MMGeneratedDataset, batch_generator, individual_texts, pad_frames, sample


def interleave(t1, t2):
    """Per-person texts interleaved to match the 2B person batch
    (reference evaluation/utils.py:282-301)."""
    out = []
    for a, b in zip(t1, t2):
        out.extend([a, b])
    return out


def length_groups(idx_list, dataset, per_item: bool, batch_size: int):
    """Index batches; with ``per_item``, of items of one length, so that
    every item is generated at exactly its own length (the reference's
    protocol)."""
    if not per_item:
        for start in range(0, len(idx_list), batch_size):
            yield idx_list[start:start + batch_size]
        return
    by_len = defaultdict(list)
    for i in idx_list:
        by_len[int(dataset[i]["motion_lens"])].append(i)
    for _, group in sorted(by_len.items()):
        for start in range(0, len(group), batch_size):
            yield group[start:start + batch_size]


class BaseSystemAdapter:
    """A base system (in2IN in any mode, DualMDM, MDM) as an evaluation
    system: the cond of a batch through ``build_cond`` (in2IN) or
    ``text_process`` of its texts (MDM)."""

    def __init__(self, system):
        self.system = system

    @property
    def device(self) -> torch.device:
        return self.system.device

    def generate_cond(self, batch):
        if hasattr(self.system, "build_cond"):
            return self.system.build_cond(batch)
        return self.system.text_process(batch["text"])

    def sample(self, cond, n_frames, **kwargs):
        return self.system.sample(cond, n_frames, **kwargs)


def generate_batches(system, dataset, gen_seed: int, *, num_samples, batch_size, per_item,
                     sample_kwargs=None, text_decomposer=None, stream=GEN_STREAM, mesh=None):
    """Batched generation over a ground-truth set, batch i drawing from
    ``(gen_seed, i, stream)``; returns (gt batches, generated batches,
    individual-text batches), every batch ``(texts, motions (B, T, D),
    lens)`` padded to the dataset's length.  ``text_decomposer`` (captions
    -> (t1 list, t2 list)) replaces the dataset's individual texts (the
    reference's LLM splitter, evaluation/datasets.py:71-96); without it a
    dataset that has none uses the captions themselves
    (:func:`.datasets.individual_texts`).  With ``mesh`` each batch splits
    its rows over the data axis (:func:`.datasets.sample`)."""
    gt_batches, gen_batches, ind_texts = [], [], []
    n = min(num_samples, len(dataset))
    for i, idx in enumerate(length_groups(list(range(n)), dataset, per_item, batch_size)):
        batch = individual_texts(collate([dataset[j] for j in idx]), text_decomposer)
        gt_batches.append((batch["text"], batch["motions"].astype(np.float32),
                           batch["motion_lens"]))
        ind_texts.append((batch["text_individual1"], batch["text_individual2"]))
        T = int(batch["motion_lens"].max())
        motions = pad_frames(sample(system, system.generate_cond(batch), T,
                                    batch_generator(gen_seed, i, stream, system.device),
                                    mesh, **(sample_kwargs or {})), batch["motions"].shape[1])
        gen_batches.append((batch["text"], motions, batch["motion_lens"]))
    return gt_batches, gen_batches, ind_texts


def _record(all_metrics, protocol, names, match, rprec, div):
    for name in names:
        all_metrics["MM Distance"][name].append(float(match[name]))
        for k in range(protocol.top_k):
            all_metrics[f"R_precision_top{k + 1}"][name].append(float(rprec[name][k]))
        all_metrics["Diversity"][name].append(float(div[name]))


def run_side(system, gt_dataset, wrapper, protocol, *, individual, num_samples, batch_size,
             max_frames, replications, seed, per_item=False, mm_num_samples=None,
             mm_num_repeats=None, model_name="mixermdm", sample_kwargs=None,
             text_decomposer=None, mesh=None):
    """One dataset side of the protocol (reference ``evaluation()``,
    eval/mixermdm.py:124-213): per replication, the generated test set and
    the ground truth scored (MM-Distance, R-precision, FID, Diversity) and
    the multimodality replica sets.  Returns ``{metric: {name:
    [per-replication values]}}``; prints each part's seconds.

    ``individual=True`` interleaves the per-person texts to match the
    individual wrapper's 2B person batch; a single-person generator passes
    ``individual=False`` with the individual wrapper (its motions are one
    person wide, and the wrapper only centres them).  ``mesh``: generation
    splits its rows over the data axis (the JAX driver's ``mesh=``)."""
    mm_num_samples = protocol.mm_num_samples if mm_num_samples is None else mm_num_samples
    mm_num_repeats = protocol.mm_num_repeats if mm_num_repeats is None else mm_num_repeats
    all_metrics = defaultdict(lambda: defaultdict(list))
    for rep in range(replications):
        print(f"== replication {rep + 1}/{replications} ==", flush=True)
        rep_seed = seed + 1000 * rep
        t0 = time.perf_counter()
        gt_batches, gen_batches, ind_texts = generate_batches(
            system, gt_dataset, rep_seed, num_samples=num_samples, batch_size=batch_size,
            per_item=per_item, sample_kwargs=sample_kwargs, text_decomposer=text_decomposer,
            mesh=mesh)
        print(f"generation: {time.perf_counter() - t0:.3f} s "
              f"({sum(len(b[0]) for b in gen_batches)} items"
              f"{f', {mesh.size}-rank data mesh' if mesh is not None else ''})", flush=True)
        if individual:
            gen_batches = [(interleave(t1, t2), m, l)
                           for (t1, t2), (_, m, l) in zip(ind_texts, gen_batches)]
            gt_batches = [(interleave(t1, t2), m, l)
                          for (t1, t2), (_, m, l) in zip(ind_texts, gt_batches)]
        sets = OrderedDict([(model_name, gen_batches), ("ground truth", gt_batches)])
        t0 = time.perf_counter()
        match, rprec, acts = P.evaluate_matching_score(sets, wrapper, protocol.top_k)
        fid = P.evaluate_fid(gt_batches, {model_name: acts[model_name]}, wrapper)
        div_times = min(protocol.diversity_times, acts[model_name].shape[0] - 1)
        div = P.evaluate_diversity(acts, div_times, seed=seed + rep)
        print(f"scoring: {time.perf_counter() - t0:.3f} s (InterCLIP embeddings + metrics)",
              flush=True)
        _record(all_metrics, protocol, sets, match, rprec, div)
        all_metrics["FID"][model_name].append(float(fid[model_name]))
        if mm_num_samples > 0:
            t0 = time.perf_counter()
            mm_set = MMGeneratedDataset(system, gt_dataset, rep_seed,
                                        mm_num_samples=mm_num_samples,
                                        mm_num_repeats=mm_num_repeats, max_frames=max_frames,
                                        stream=MM_STREAM, mesh=mesh)
            t1 = time.perf_counter()
            # times below the replica count (protocol: 5 of 15)
            mm_times = min(protocol.mm_num_times, mm_num_repeats - 1)
            mm = P.evaluate_multimodality({model_name: list(mm_set)}, wrapper, mm_times,
                                          seed=seed + rep)
            print(f"mm generation: {t1 - t0:.3f} s ({mm_num_samples}x{mm_num_repeats} items); "
                  f"mm scoring: {time.perf_counter() - t1:.3f} s", flush=True)
            all_metrics["MultiModality"][model_name].append(float(mm[model_name]))
    return all_metrics


def collect_gt_batches(dataset, num_samples, batch_size):
    """Ground-truth ``(texts, motions, lens)`` batches, no generation."""
    out = []
    n = min(num_samples, len(dataset))
    for start in range(0, n, batch_size):
        batch = collate([dataset[i] for i in range(start, min(start + batch_size, n))])
        out.append((batch["text"], batch["motions"].astype(np.float32), batch["motion_lens"]))
    return out


def sweep_name(v) -> str:
    return "learned_influence" if v is None else f"force_influence_{v:g}"


def run_dualmdm_cross(system, gt_dataset, hml_dataset, wrapper, protocol, *, sweep, num_samples,
                      batch_size, max_frames, replications, seed, mesh=None):
    """Cross-dataset composition (reference evaluation/datasets.py:228-382):
    the mixer generates from InterHuman interaction texts crossed with random
    HumanML3D individual texts, once per ``force_influence_val`` of
    ``sweep`` (None: the learned influence; 0.0: the interaction model
    alone), each scored against the InterHuman ground truth under the
    interaction evaluator.  Every value of a replication draws the same
    noise and the same individual texts, so the values differ in the
    influence alone; the value goes to ``sample`` as an argument, and the
    system's own ``force_influence_val`` stays as it was."""
    all_metrics = defaultdict(lambda: defaultdict(list))
    for rep in range(replications):
        print(f"== dualmdm-cross replication {rep + 1}/{replications} ==", flush=True)
        gt_batches = collect_gt_batches(gt_dataset, num_samples, batch_size)
        sets = OrderedDict()
        for v in sweep:
            ds = EvaluationDatasetDualMDM(
                system, gt_dataset, hml_dataset, seed + 1000 * rep, force_influence_val=v,
                seed=seed + rep, num_samples=num_samples, batch_size=batch_size,
                max_frames=max_frames, stream=CROSS_STREAM, mesh=mesh)
            sets[sweep_name(v)] = list(ds.batches(batch_size))
        sets["ground truth"] = gt_batches
        match, rprec, acts = P.evaluate_matching_score(sets, wrapper, protocol.top_k)
        gen_names = [sweep_name(v) for v in sweep]
        fid = P.evaluate_fid(gt_batches, {n: acts[n] for n in gen_names}, wrapper)
        div_times = min(protocol.diversity_times, min(acts[n].shape[0] for n in sets) - 1)
        div = P.evaluate_diversity(acts, div_times, seed=seed + rep)
        _record(all_metrics, protocol, sets, match, rprec, div)
        for name in gen_names:
            all_metrics["FID"][name].append(float(fid[name]))
    return all_metrics


def summarize_metrics(metrics, replications):
    """``{metric: {name: [mean, 95% confidence half-width]}}``."""
    return {metric: {name: list(P.get_metric_statistics(np.asarray(v), replications))
                     for name, v in d.items()}
            for metric, d in metrics.items()}


def clean_json(o):
    """numpy values -> JSON-ready Python values, recursively."""
    if isinstance(o, dict):
        return {k: clean_json(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [clean_json(v) for v in o]
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.floating, np.integer)):
        return float(o)
    return o
