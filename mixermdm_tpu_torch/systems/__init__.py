"""User-facing assemblies: :class:`MixerMDMSystem` and the in2IN parts it
uses; :func:`apply_sampler_overrides` switches a built system's sampler and
its number of steps (the CLIs' ``--sampler`` / ``--sample-steps``)."""

from __future__ import annotations

from typing import Optional


def apply_sampler_overrides(system, sampler: Optional[str] = None,
                            sample_steps: Optional[int] = None):
    """Sampling overrides after construction (JAX
    ``mixermdm_tpu/systems/__init__.py:apply_sampler_overrides``).

    ``sampler`` switches the update rule: "ddim" (the reference's) or
    "dpmpp" (DPM-Solver++(2M)).  ``sample_steps`` rebuilds the respaced
    sampling schedule at N model calls (the ddim-strided grid both samplers
    share) on the system's device.
    """
    if sampler:
        sampler = str(sampler).lower()
        if sampler not in ("ddim", "dpmpp"):
            raise ValueError(f"unknown sampler {sampler!r}")
        system.sampler_type = sampler
    if sample_steps:
        from ..diffusion.schedule import named_schedule

        system.sample_schedule = named_schedule(
            system.cfg.BETA_SCHEDULER, int(system.cfg.DIFFUSION_STEPS),
            f"ddim{int(sample_steps)}", device=system.device)
    return system
