"""Diffusion schedule and the dual-stream DDIM sampling chain."""
