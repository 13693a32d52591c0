"""Adversarial mixer training: the optimizer and the trainer."""
