"""PyTorch + CUDA port of ``mixermdm_tpu`` for NVIDIA Hopper (H100).

A package of its own beside the JAX package: it imports ``torch``,
``numpy`` and the standard library only.  The JAX package is the reference
it is tested against.  What is ported so far is two-person sampling
(:class:`mixermdm_tpu_torch.systems.mixermdm.MixerMDMSystem`), with the four
Pallas entry points of that path rebuilt from three hand-written CUDA
kernels under ``csrc/``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
