"""User-facing assemblies: :class:`~.mixermdm.MixerMDMSystem` and its
submodels, the base-model systems (:class:`~.in2in.In2INSystem` in its three
modes, :class:`~.mdm.MDMSystem`, :class:`~.intergen.InterGenSystem`);
:func:`apply_sampler_overrides` switches a built system's sampler and its
number of steps (the CLIs' ``--sampler`` / ``--sample-steps``);
:func:`load_dualmdm` builds the DualMDM baseline."""

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


def load_dualmdm(cfg_interaction, cfg_individual=None, **kwargs):
    """DualMDM baseline: in2IN in dual mode (reference dualmdm.py:4-17; JAX
    ``load_dualmdm``), on the card in its compute dtype unless ``device``
    says otherwise.  The two released files merge at load,
    :func:`..train.checkpoint.load_released_in2in`."""
    from .in2in import In2INSystem

    return In2INSystem(cfg_interaction, mode="dual", **kwargs)
