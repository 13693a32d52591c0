"""MixerMDM evaluation: the dual-dataset protocol and its F-score.

Counterpart of ``mixermdm_tpu/cli/eval_mixermdm.py`` (reference
scripts/eval/mixermdm.py:243-370).  Two evaluations: InterHuman (interaction
quality, the interaction evaluator) and HumanML3D (individual quality: the
mixer generates from HumanML3D texts, and the individual evaluator scores
each person), each with MM-Distance, R-precision top-1/2/3, FID, Diversity
and MultiModality over ``--replications``, then the harmonic-mean F-score.
``--datasets interhuman`` / ``hml3d`` runs one side (reference
scripts/eval/interaction.py / individual.py); ``--dualmdm-cross`` adds the
cross-dataset composition sweep over ``force_influence_val``.  Usage::

    python -m mixermdm_tpu_torch eval-mixermdm --data-root DIR --hml3d-root DIR \\
        [--checkpoint MixerMDM.ckpt --ckpt-individual ind.ckpt --ckpt-interaction inter.ckpt] \\
        [--evaluator-checkpoint interclip.ckpt] [--evaluator-individual-checkpoint ind.ckpt] \\
        [--strict] [--out eval_results.json]

Generation length: items are generated at their batch's longest length and
scored at their own; ``--per-item-lengths`` groups items of one length so
that each is generated at its own (the reference's protocol).  Weights: the
released mixer files through ``--checkpoint`` / ``--ckpt-*`` and the
evaluator files (the reference's InterCLIP layout) through
``--evaluator-checkpoint`` / ``--evaluator-individual-checkpoint``; what no
file holds keeps its random values from ``--seed`` and is listed
(``--strict`` fails instead).  ``--tiny`` evaluates the miniature system
with the miniature evaluators on synthetic fixtures in a temporary
directory; ``--device cpu`` runs the plain PyTorch path.

Data parallelism, as the JAX CLI over its devices: on several ranks (one
per visible card, or the world ``torchrun`` describes) every generation
batch splits its rows over them, padded with its last row to a multiple of
the rank count; the rows come back to every rank, each scores the whole
set, rank 0 writes ``--out``.  ``--no-data-parallel`` generates on one
rank.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import tempfile

import numpy as np

from ..data.humanml3d import HumanML3DDataset
from ..data.interhuman import InterHumanDataset
from ..data.synthetic import make_hml3d_fixture, make_interhuman_fixture
from ..eval.driver import clean_json, run_dualmdm_cross, run_side, summarize_metrics
from ..parallel import make_mesh, on_ranks, world_rank, world_size
from ..eval.interclip import build_interclip
from ..eval.protocol import EvalProtocol, EvaluatorWrapper, EvaluatorWrapperIndividual, \
    calculate_f_score
from ..train.checkpoint import load_released_interclip
from .infer_in2in import report_unfilled
from .infer_mixermdm import add_weight_args, system_from_args


def add_protocol_args(parser: argparse.ArgumentParser) -> None:
    """The flags ``eval-mixermdm`` and ``eval-base`` share."""
    parser.add_argument("--model", type=str, default=None, help="model config yaml")
    parser.add_argument("--evaluator-checkpoint", type=str, default=None,
                        help="the interaction InterCLIP, in the reference's file layout")
    parser.add_argument("--evaluator-individual-checkpoint", type=str, default=None,
                        help="the individual-mode InterCLIP (the reference's "
                             "configs/eval_individual.yaml is absent from its repository)")
    parser.add_argument("--data-root", type=str, default="./data")
    parser.add_argument("--hml3d-root", type=str, default="./data/HumanML3D",
                        help="HumanML3D test set for the individual-quality side")
    parser.add_argument("--num-samples", type=int, default=None)
    parser.add_argument("--replications", type=int, default=None)
    parser.add_argument("--mm-num-samples", type=int, default=None,
                        help="0 disables MultiModality")
    parser.add_argument("--mm-num-repeats", type=int, default=None)
    parser.add_argument("--per-item-lengths", action="store_true",
                        help="generate each item at its own length (the reference's "
                             "protocol, evaluation/datasets.py:116)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-data-parallel", action="store_true",
                        help="generate on one rank even where several cards are visible "
                             "(default: each batch's rows split over every rank)")
    parser.add_argument("--tiny", action="store_true")


def data_mesh(args):
    """The data mesh generation splits its rows over: every rank of the
    world (None on one rank, or with ``--no-data-parallel``)."""
    if args.no_data_parallel or world_size() == 1:
        return None
    mesh = make_mesh()
    print(f"data-parallel generation over {mesh.size} ranks", flush=True)
    return mesh


def protocol_sizes(args, protocol: EvalProtocol) -> dict:
    """num_samples, batch sizes, max_frames and the MultiModality counts of
    the run: the protocol's, or with ``--tiny`` the JAX CLIs' miniature
    ones (4 samples in batches of 2 at 16 frames, MultiModality 2 x 3)."""
    if args.tiny:
        sizes = dict(num_samples=4, batch_size=2, batch_size_hml3d=2, max_frames=16,
                     mm_num_samples=2, mm_num_repeats=3)
    else:
        sizes = dict(num_samples=args.num_samples or protocol.num_samples,
                     batch_size=protocol.batch_size_interhuman,
                     batch_size_hml3d=protocol.batch_size_hml3d, max_frames=300,
                     mm_num_samples=protocol.mm_num_samples,
                     mm_num_repeats=protocol.mm_num_repeats)
    for key in ("mm_num_samples", "mm_num_repeats"):
        if getattr(args, key) is not None:
            sizes[key] = getattr(args, key)
    return sizes


@contextlib.contextmanager
def data_roots(args):
    """``--tiny``: synthetic InterHuman and HumanML3D fixtures (4 clips of
    40 frames each) in a temporary directory, removed afterwards; else the
    given roots."""
    if not args.tiny:
        yield
        return
    with tempfile.TemporaryDirectory(prefix="eval_synth_") as root:
        args.data_root, args.hml3d_root = root, root + "/HumanML3D"
        make_interhuman_fixture(args.data_root, n_clips=4, n_frames=40)
        make_hml3d_fixture(args.hml3d_root, n_clips=4, n_frames=40)
        yield


def load_evaluator(mode: str, ckpt, args, seed: int):
    """The InterCLIP of ``mode`` (random weights from ``seed``), its file
    loaded when given."""
    evaluator = build_interclip(mode, tiny=args.tiny, device=args.device, seed=seed)
    if ckpt:
        report_unfilled(evaluator, load_released_interclip(evaluator, ckpt, strict=args.strict))
    return evaluator


def open_dataset(cls, root: str, **kwargs):
    dataset = cls(root, mode="test", **kwargs)
    if len(dataset) == 0:
        raise SystemExit(f"no test data under {root}")
    return dataset


def f_scores(metrics_ih, metrics_hml, replications) -> dict:
    return {metric: {name: [float(np.asarray(f).mean()), float(np.asarray(ci).mean())]
                     for name, (f, ci) in d.items()}
            for metric, d in calculate_f_score(metrics_ih, metrics_hml, replications).items()}


def write_summary(summary: dict, out: str) -> dict:
    """Print the summary and write it to ``out`` (rank 0)."""
    summary = clean_json(summary)
    if world_rank() != 0:
        return summary
    print(json.dumps(summary, indent=2))
    with open(out, "w") as f:
        json.dump(summary, f, indent=2)
    print(f"wrote {out}")
    return summary


def run(argv=None) -> dict:
    """Evaluate as the command line says; returns the summary written to
    ``--out``."""
    parser = argparse.ArgumentParser(description="Evaluate MixerMDM (PyTorch/CUDA port)")
    add_protocol_args(parser)
    add_weight_args(parser)
    parser.add_argument("--out", type=str, default="eval_results.json")
    parser.add_argument("--datasets", type=str, default="both",
                        choices=["both", "interhuman", "hml3d"])
    parser.add_argument("--dualmdm-cross", action="store_true",
                        help="cross-dataset composition: generate from InterHuman interaction "
                             "texts crossed with random HumanML3D individual texts, sweeping "
                             "force_influence_val (reference evaluation/datasets.py:228-382)")
    parser.add_argument("--force-influence-sweep", type=str, default="none,0",
                        help="comma list of force_influence values for --dualmdm-cross "
                             "('none' = the learned influence)")
    parser.add_argument("--decompose", type=str, default="none",
                        choices=("none", "identity", "heuristic"),
                        help="interaction-text decomposition on the InterHuman side (the "
                             "reference's LLM splitter): 'heuristic' the offline clause "
                             "splitter, 'identity' the interaction text for both persons, "
                             "'none' the dataset's individual texts")
    args = parser.parse_args(argv)
    return on_ranks(_evaluate, args, spread=not args.no_data_parallel)


def _evaluate(args) -> dict:
    protocol = EvalProtocol()
    replications = args.replications or protocol.replication_times
    sizes = protocol_sizes(args, protocol)
    system = system_from_args(args)
    mesh = data_mesh(args)
    if args.sampler or args.sample_steps:
        print(f"NON-PROTOCOL sampler override: {system.sampler_type} "
              f"{system.sample_schedule.num_timesteps} steps")
    wrapper = EvaluatorWrapper(load_evaluator("interaction", args.evaluator_checkpoint, args,
                                              args.seed + 1))
    side_kw = dict(num_samples=sizes["num_samples"], max_frames=sizes["max_frames"],
                   replications=replications, seed=args.seed, per_item=args.per_item_lengths,
                   mm_num_samples=sizes["mm_num_samples"],
                   mm_num_repeats=sizes["mm_num_repeats"], mesh=mesh)
    summary, metrics_ih, metrics_hml = {}, None, None
    with data_roots(args):
        if args.datasets in ("both", "interhuman"):
            print("===== InterHuman (interaction quality) =====", flush=True)
            decomposer = None
            if args.decompose != "none":
                from ..eval.decompose import get_decomposer

                decomposer = get_decomposer(args.decompose)
            metrics_ih = run_side(
                system, open_dataset(InterHumanDataset, args.data_root,
                                     max_gt_length=sizes["max_frames"]),
                wrapper, protocol, individual=False, batch_size=sizes["batch_size"],
                text_decomposer=decomposer, **side_kw)
        if args.datasets in ("both", "hml3d"):
            print("===== HumanML3D (individual quality) =====", flush=True)
            ind_wrapper = EvaluatorWrapperIndividual(load_evaluator(
                "individual", args.evaluator_individual_checkpoint, args, args.seed + 2))
            metrics_hml = run_side(
                system, open_dataset(HumanML3DDataset, args.hml3d_root, extended=True,
                                     max_gt_length=sizes["max_frames"]),
                ind_wrapper, protocol, individual=True, batch_size=sizes["batch_size_hml3d"],
                **side_kw)
        if args.dualmdm_cross:
            print("===== DualMDM cross-dataset sweep =====", flush=True)
            sweep = [None if v.strip().lower() in ("none", "") else float(v)
                     for v in args.force_influence_sweep.split(",")]
            cross = run_dualmdm_cross(
                system, open_dataset(InterHumanDataset, args.data_root,
                                     max_gt_length=sizes["max_frames"]),
                open_dataset(HumanML3DDataset, args.hml3d_root,
                             max_gt_length=sizes["max_frames"]),
                wrapper, protocol, sweep=sweep, num_samples=sizes["num_samples"],
                batch_size=sizes["batch_size"], max_frames=sizes["max_frames"],
                replications=replications, seed=args.seed, mesh=mesh)
            summary["dualmdm_cross"] = summarize_metrics(cross, replications)
    if metrics_ih is not None:
        summary["interhuman"] = summarize_metrics(metrics_ih, replications)
    if metrics_hml is not None:
        summary["hml3d"] = summarize_metrics(metrics_hml, replications)
    if metrics_ih is not None and metrics_hml is not None:
        summary["f_score"] = f_scores(metrics_ih, metrics_hml, replications)
    return write_summary(summary, args.out)


def main(argv=None):
    run(argv)


if __name__ == "__main__":
    main()
