"""Evaluation-side helpers the inference surface uses (the prompt decomposer)."""
