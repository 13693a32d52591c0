"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Kernels (``csrc/``): ``adaln_modulate`` (and its quantising form
``adaln_modulate_q8``), ``linear_epilogue`` (three routes,
counted apart: the Hopper TMA + ``wgmma`` main loop of ``gemm_sm90.cuh``,
``linear_epilogue_skinny`` for M <= 64, ``linear_epilogue_ragged`` for what
TMA cannot describe), ``attention`` (bf16 and f32 inputs; ``attention_q8``,
its quantising epilogue for the W8A8 blocks), ``attention_bwd``,
``quant_rows``, ``linear_q8`` (the same main loop on int8; counted as
``linear_q8_gelu_q8`` with the quantising GELU epilogue), and ``sa_block`` /
``sa_block_i8x``, the one-launch self-attention blocks of the kernel
experiments (:mod:`.sa_variants`, the counterparts of
``scripts/exp_kernels.py``; no model calls them).
Entry points, one per Pallas entry point of ``mixermdm_tpu/ops``:
:func:`fused_attention` and its backward :func:`attention_bwd` (with the
autograd function :class:`FusedAttention`), :func:`fused_sa_block`,
:func:`fused_ca_block`, :func:`fused_ffn_block`, and the W8A8 forms of the
three blocks (``quant=True`` there) :func:`fused_sa_block_q8`,
:func:`fused_ca_block_q8`, :func:`fused_ffn_block_q8`.  Each wrapper takes
its plain version for a CPU tensor and launches its kernel (or raises) for a
CUDA tensor; inside :func:`plain_versions` it takes its plain version on any
device.  That is the only choice between kernel and plain version in the
package.  (The modules choose between the fused entry points, where no
gradient is recorded, and the differentiable route through
:func:`differentiable_attention`; see ``models/layers.py``.)
"""

from ._lib import launches, plain_versions, reset_launch_counts
from .adaln import (
    adaln_modulate,
    adaln_modulate_plain,
    adaln_modulate_q8,
    adaln_modulate_q8_plain,
)
from .attention import (
    FusedAttention,
    attention_bwd,
    attention_q8,
    attention_q8_plain,
    attention_bwd_plain,
    differentiable_attention,
    fused_attention,
    fused_attention_plain,
    reference_attention,
)
from .fused_block import (
    fused_ca_block,
    fused_ca_block_plain,
    fused_ca_block_q8,
    fused_ca_block_q8_plain,
    fused_ffn_block,
    fused_ffn_block_plain,
    fused_ffn_block_q8,
    fused_ffn_block_q8_plain,
    fused_sa_block,
    fused_sa_block_plain,
    fused_sa_block_q8,
    fused_sa_block_q8_plain,
    row_parallel_sum,
)
from .linear import linear, linear_plain
from .linear_q8 import linear_q8, linear_q8_gelu_q8_plain, linear_q8_plain
from .quant import quant_rows, quant_rows_plain, quantize_weight

__all__ = [
    "launches", "plain_versions", "reset_launch_counts",
    "adaln_modulate", "adaln_modulate_plain", "adaln_modulate_q8", "adaln_modulate_q8_plain",
    "fused_attention", "fused_attention_plain", "reference_attention",
    "attention_bwd", "attention_bwd_plain", "FusedAttention", "differentiable_attention",
    "attention_q8", "attention_q8_plain",
    "fused_sa_block", "fused_sa_block_plain",
    "fused_ca_block", "fused_ca_block_plain",
    "fused_ffn_block", "fused_ffn_block_plain",
    "fused_sa_block_q8", "fused_sa_block_q8_plain",
    "fused_ca_block_q8", "fused_ca_block_q8_plain",
    "fused_ffn_block_q8", "fused_ffn_block_q8_plain", "row_parallel_sum",
    "linear", "linear_plain",
    "linear_q8", "linear_q8_plain", "linear_q8_gelu_q8_plain",
    "quant_rows", "quant_rows_plain", "quantize_weight",
]
