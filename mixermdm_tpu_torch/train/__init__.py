"""Training: the optimizer, the mixer and base-model trainers, train-state
and released checkpoints, the fine-tune, the CLIs' epoch loop."""
