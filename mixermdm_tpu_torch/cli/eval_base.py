"""Base-model evaluation: in2IN, DualMDM or MDM under the full protocol.

Counterpart of ``mixermdm_tpu/cli/eval_base.py`` (reference
scripts/eval/interaction.py:243-268 and individual.py:230-268): the
two-person models (``--mode interaction``, ``dual``) on the InterHuman test
set under the interaction evaluator, and on HumanML3D texts judged per
person by the individual evaluator; the single-person models (``--mode
individual``, ``mdm``) on HumanML3D only.  Usage::

    python -m mixermdm_tpu_torch eval-base --mode interaction [--side interhuman]
    python -m mixermdm_tpu_torch eval-base --mode dual --w-func exp --w-value 0.5 \\
        --checkpoint interaction.ckpt --ckpt-individual individual.ckpt
    python -m mixermdm_tpu_torch eval-base --mode mdm --checkpoint mdm.ckpt

Weights: the mode's released file through ``--checkpoint`` (in dual mode the
interaction file, and the individual one through ``--ckpt-individual``),
the evaluators as in ``eval-mixermdm``; ``--strict`` fails where a file
leaves a parameter unfilled.  ``--tiny``, ``--device cpu``, data
parallelism and ``--no-data-parallel`` as there.
"""

from __future__ import annotations

import argparse

from ..data.humanml3d import HumanML3DDataset
from ..data.interhuman import InterHumanDataset
from ..eval.driver import BaseSystemAdapter, run_side, summarize_metrics
from ..eval.protocol import EvalProtocol, EvaluatorWrapper, EvaluatorWrapperIndividual
from ..parallel import on_ranks
from ..systems import apply_sampler_overrides
from ..train.checkpoint import load_released_in2in, load_released_mdm
from . import infer_in2in, infer_mdm
from .eval_mixermdm import add_protocol_args, data_mesh, data_roots, load_evaluator, \
    open_dataset, protocol_sizes, write_summary
from .infer_in2in import report_unfilled

MODEL_NAMES = {"interaction": "in2IN", "dual": "DualMDM", "individual": "in2INind",
               "mdm": "MDM"}


def build_base_system(args):
    """The evaluated system of ``--mode`` with its files loaded: in2IN of
    the mode (``dual``: the DualMDM blend of ``--w-func`` / ``--w-value``)
    or MDM on its own 512-d / ViT-B/32 config, as ``infer-in2in`` /
    ``infer-mdm`` build them."""
    if args.mode == "mdm":
        system = infer_mdm.build_system(args.model, tiny=args.tiny, device=args.device,
                                        seed=args.seed)
        if args.checkpoint:
            report_unfilled(system, load_released_mdm(system, args.checkpoint,
                                                      strict=args.strict))
    else:
        system = infer_in2in.build_system(args.model, args.mode, tiny=args.tiny,
                                          w_func=args.w_func, w_value=args.w_value,
                                          device=args.device, seed=args.seed)
        if args.checkpoint or args.ckpt_individual:
            report_unfilled(system, load_released_in2in(system, args.checkpoint,
                                                        args.ckpt_individual,
                                                        strict=args.strict))
    return apply_sampler_overrides(system, args.sampler, args.sample_steps)


def run(argv=None) -> dict:
    """Evaluate as the command line says; returns the summary written to
    ``--out``."""
    parser = argparse.ArgumentParser(description="Evaluate a base model (PyTorch/CUDA port)")
    parser.add_argument("--mode", type=str, required=True,
                        choices=["interaction", "dual", "individual", "mdm"])
    add_protocol_args(parser)
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="the released file of the mode (in dual mode the interaction "
                             "file)")
    parser.add_argument("--ckpt-individual", type=str, default=None,
                        help="dual mode: the individual in2IN file, merged in")
    parser.add_argument("--strict", action="store_true",
                        help="fail if a parameter is in none of the given files")
    parser.add_argument("--side", type=str, default="auto",
                        choices=["auto", "interhuman", "hml3d", "both"],
                        help="auto: both for the two-person modes, hml3d for the "
                             "single-person ones")
    parser.add_argument("--out", type=str, default="eval_base_results.json")
    parser.add_argument("--w-func", type=str, default="const",
                        help="DualMDM w(t) schedule (exp / exp-inv / lin / const)")
    parser.add_argument("--w-value", type=float, default=0.5)
    parser.add_argument("--sampler", type=str, default=None, choices=("ddim", "dpmpp"),
                        help="override the generation sampler (not the protocol's)")
    parser.add_argument("--sample-steps", type=int, default=None,
                        help="respace the generation chain (not the protocol's)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return on_ranks(_evaluate, args, spread=not args.no_data_parallel)


def _evaluate(args) -> dict:
    two_person = args.mode in ("interaction", "dual")
    side = args.side if args.side != "auto" else ("both" if two_person else "hml3d")
    if not two_person and side in ("interhuman", "both"):
        raise SystemExit(f"--mode {args.mode} is single-person; only the hml3d side applies")
    protocol = EvalProtocol()
    replications = args.replications or protocol.replication_times
    sizes = protocol_sizes(args, protocol)
    system = BaseSystemAdapter(build_base_system(args))
    model_name = MODEL_NAMES[args.mode]
    side_kw = dict(num_samples=sizes["num_samples"], max_frames=sizes["max_frames"],
                   replications=replications, seed=args.seed, per_item=args.per_item_lengths,
                   mm_num_samples=sizes["mm_num_samples"],
                   mm_num_repeats=sizes["mm_num_repeats"], model_name=model_name,
                   mesh=data_mesh(args))
    summary = {}
    with data_roots(args):
        if side in ("interhuman", "both"):
            print(f"===== InterHuman (interaction quality, {model_name}) =====", flush=True)
            wrapper = EvaluatorWrapper(load_evaluator(
                "interaction", args.evaluator_checkpoint, args, args.seed + 1))
            metrics = run_side(
                system, open_dataset(InterHumanDataset, args.data_root,
                                     max_gt_length=sizes["max_frames"]),
                wrapper, protocol, individual=False, batch_size=sizes["batch_size"], **side_kw)
            summary["interhuman"] = summarize_metrics(metrics, replications)
        if side in ("hml3d", "both"):
            print(f"===== HumanML3D (individual quality, {model_name}) =====", flush=True)
            # Two-person models generate pairs from HumanML3D texts and are
            # judged per person (the extended items duplicate the motion into
            # a pair, reference humanml3d.py:146-149); single-person models
            # generate one person.
            wrapper = EvaluatorWrapperIndividual(load_evaluator(
                "individual", args.evaluator_individual_checkpoint, args, args.seed + 2))
            metrics = run_side(
                system, open_dataset(HumanML3DDataset, args.hml3d_root, extended=two_person,
                                     max_gt_length=sizes["max_frames"]),
                wrapper, protocol, individual=two_person, batch_size=sizes["batch_size_hml3d"],
                **side_kw)
            summary["hml3d"] = summarize_metrics(metrics, replications)
    return write_summary(summary, args.out)


def main(argv=None):
    run(argv)


if __name__ == "__main__":
    main()
