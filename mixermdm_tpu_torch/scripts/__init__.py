"""Measurement scripts of the port, run as ``python -m mixermdm_tpu_torch.scripts.<name>``."""
