"""Evaluation: the InterCLIP evaluator, the metrics and the dual-dataset
protocol (counterpart of ``mixermdm_tpu/eval``), and the prompt decomposer."""

from . import metrics
from .interclip import InterCLIP, MotionEncoder
from .protocol import (
    EvalProtocol,
    EvaluatorWrapper,
    EvaluatorWrapperIndividual,
    calculate_f_score,
    evaluate_diversity,
    evaluate_fid,
    evaluate_matching_score,
    evaluate_multimodality,
    generate_eval_set,
    get_metric_statistics,
)

__all__ = [
    "EvalProtocol",
    "EvaluatorWrapper",
    "EvaluatorWrapperIndividual",
    "InterCLIP",
    "MotionEncoder",
    "calculate_f_score",
    "evaluate_diversity",
    "evaluate_fid",
    "evaluate_matching_score",
    "evaluate_multimodality",
    "generate_eval_set",
    "get_metric_statistics",
    "metrics",
]
