"""The diffusion engine: schedules, the DDPM / DDIM / DPM-Solver++ chains,
guidance, the variational bound, and the mixer's dual-stream chains and
losses."""
