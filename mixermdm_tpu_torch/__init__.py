"""PyTorch + CUDA port of ``mixermdm_tpu`` for NVIDIA Hopper (H100).

A package of its own beside the JAX package: it imports ``torch``,
``numpy`` and the standard library only.  The JAX package is the reference
it is tested against.  Ported so far: two-person sampling
(:class:`mixermdm_tpu_torch.systems.mixermdm.MixerMDMSystem`, bf16 and the
shipped W8A8 path) and adversarial mixer training
(:mod:`mixermdm_tpu_torch.train`, ``train-mixermdm``), with every Pallas
kernel of the JAX package rebuilt as a hand-written CUDA kernel under
``csrc/``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
