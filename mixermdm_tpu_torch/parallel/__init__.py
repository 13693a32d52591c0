"""Multi-rank sampling on ``torch.distributed``; counterpart of
``mixermdm_tpu/parallel``: rank grids and the tensor-parallel rule
(:mod:`.mesh`), the collectives (:mod:`.comm`), the GPipe schedule
(:mod:`.pipeline`) and the launcher of ranks (:mod:`.launch`)."""

from .launch import RankFailed, launch, on_ranks
from .mesh import (
    Mesh,
    RowParallel,
    TPSpec,
    data_sharded,
    fsdp_spec,
    gather_rows,
    initialize_distributed,
    make_data_mesh_for_batch,
    make_mesh,
    make_mesh_2d,
    rank_device,
    replicate,
    shard_batch,
    tp_plan,
    tp_shard_params,
    tp_spec,
    world_rank,
    world_size,
)
from .pipeline import pipeline_context, pipeline_scan, pipeline_scope

__all__ = [
    "Mesh", "RankFailed", "RowParallel", "TPSpec", "data_sharded", "fsdp_spec",
    "gather_rows", "initialize_distributed", "launch", "make_data_mesh_for_batch",
    "make_mesh", "make_mesh_2d", "on_ranks", "pipeline_context", "pipeline_scan", "pipeline_scope",
    "rank_device", "replicate", "shard_batch", "tp_plan", "tp_shard_params", "tp_spec",
    "world_rank", "world_size",
]
