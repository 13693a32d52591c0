"""Rank grids and the sharding rules of the parallel layouts; counterpart of
``mixermdm_tpu/parallel/mesh.py``.

Multi-controller: one process per rank, each holding its own card (or its
share of the CPU), joined into one ``torch.distributed`` world.  A
:class:`Mesh` is the JAX package's device mesh over ranks: a grid of global
ranks with named axes, and the process group of this rank along each axis.
Where the JAX package places an array with a ``NamedSharding``, a rank here
holds its part: the rows of its data index (:func:`data_sharded`,
:func:`shard_batch`), the columns or rows of its model index of a weight
(:func:`tp_shard_params`).  Outside a distributed world every mesh has one
rank and no process group, and every collective is the identity.

Tensor parallelism (Megatron, the JAX package's ``tp_spec`` rule on this
package's parameter names):

- column-parallel, the output features split: the attention input
  projection, torch's fused ``in_proj_weight`` (3E, E) / ``in_proj_bias``
  (3E,) split by heads (a rank holds its heads' rows of q, then of k, then
  of v: the JAX ``q_proj`` / ``k_proj`` / ``v_proj`` kernels split along
  their output), and ``linear1`` / ``c_fc`` (weight rows and bias);
- row-parallel, the input features split: ``out_proj``, ``linear2`` and
  ``c_proj`` (weight columns); their bias stays whole and is added after the
  sum of the ranks' partials (:class:`RowParallel`);
- the same for the timestep embedders' MLP (``time_embed.0`` / ``.2``,
  ``linear1`` / ``linear2`` in the JAX tree);
- everything else replicated, and so is a leaf whose dimension does not
  divide.  An attention is sharded whole or not at all: its heads must
  divide by the model axis (the JAX rule needs only E to; where E divides
  and the heads do not, the JAX package shards q/k/v and this package keeps
  the attention whole).

FSDP's rule is here as the pure function :func:`fsdp_spec`; nothing applies
it yet (sampling holds whole or tensor-parallel weights).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from . import comm

# Every process group waits at most this long for a peer.
INIT_TIMEOUT = datetime.timedelta(seconds=120)

_device: Optional[torch.device] = None  # this rank's device, where a launcher set one


def set_rank_device(device) -> torch.device:
    """Record (and, for a card, select) the device this rank runs on."""
    global _device
    _device = torch.device(device)
    if _device.type == "cuda":
        torch.cuda.set_device(_device)
    return _device


def rank_device(default="cuda") -> torch.device:
    """This rank's device: the launcher's choice, else ``default``."""
    if _device is not None and torch.device(default).type == _device.type:
        return _device
    return torch.device(default)


def initialize_distributed(device="cuda") -> bool:
    """Join the world a launcher such as ``torchrun`` described in the
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``;
    ``LOCAL_RANK`` picks the card), NCCL for cards and ``gloo`` for the CPU;
    the counterpart of ``jax.distributed.initialize``.  Returns whether a
    world of several ranks is active (one already initialised counts)."""
    if not dist.is_initialized() and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dev = torch.device(device)
        if dev.type == "cuda":
            set_rank_device(f"cuda:{int(os.environ.get('LOCAL_RANK', os.environ['RANK']))}")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://", timeout=INIT_TIMEOUT)
    return world_size() > 1


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


@dataclasses.dataclass(eq=False)
class Mesh:
    """A grid of global ranks with named axes (``ranks.shape`` along
    ``axis_names``) and this rank's process group along each axis (None
    outside a distributed world, or where this rank is not in the grid)."""

    axis_names: Tuple[str, ...]
    ranks: np.ndarray
    groups: Dict[str, object]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def member(self) -> bool:
        """Whether this rank is in the grid."""
        return world_rank() in self.ranks

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        where = np.argwhere(self.ranks == world_rank())
        if not len(where):
            raise ValueError(f"rank {world_rank()} is not in this mesh")
        return int(where[0][self.axis_names.index(axis)])

    def group(self, axis: str):
        return self.groups.get(axis)


_MESH_CACHE: dict = {}


def _new_group(ranks: Sequence[int]):
    return dist.new_group([int(r) for r in ranks], timeout=INIT_TIMEOUT)


def _mesh(ranks: np.ndarray, axes: Tuple[str, ...]) -> Mesh:
    """The mesh over ``ranks`` (one sub-group per line along each axis;
    every rank of the world creates every group, in the same order)."""
    key = (tuple(ranks.flat), ranks.shape, axes)
    mesh = _MESH_CACHE.get(key)
    if mesh is not None:
        return mesh
    groups: Dict[str, object] = {}
    if dist.is_initialized():
        me = world_rank()
        for i, axis in enumerate(axes):
            lines = np.moveaxis(ranks, i, -1).reshape(-1, ranks.shape[i])
            for line in lines:
                g = _new_group(line)
                if me in line:
                    groups[axis] = g
    mesh = _MESH_CACHE[key] = Mesh(tuple(axes), ranks, groups)
    return mesh


def destroy() -> None:
    """Leave the world: every process group, and the meshes built on it."""
    _MESH_CACHE.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` ranks (all of them)."""
    n = world_size() if n_devices is None else int(n_devices)
    if n > world_size():
        raise RuntimeError(f"need {n} devices, have {world_size()}")
    return _mesh(np.arange(n), (axis,))


def make_mesh_2d(n_data: int, n_model: int, axes: tuple = ("data", "model")) -> Mesh:
    """The dp x tp mesh, model axis innermost: ranks ``d * n_model + m``,
    so a model group is a run of neighbouring ranks (neighbouring cards)."""
    if n_data * n_model > world_size():
        raise RuntimeError(f"need {n_data * n_model} devices, have {world_size()}")
    return _mesh(np.arange(n_data * n_model).reshape(n_data, n_model), tuple(axes))


def make_data_mesh_for_batch(batch_size: int, axis: str = "data") -> Mesh:
    """The largest data mesh whose size divides the batch."""
    n = max(d for d in range(1, world_size() + 1) if batch_size % d == 0)
    return make_mesh(n, axis)


def replicate(module: nn.Module, mesh: Mesh, axis: Optional[str] = None) -> nn.Module:
    """Every parameter and buffer of ``module`` as the first rank of the
    mesh (of its ``axis`` line) holds it, in place."""
    group = mesh.group(axis or mesh.axis_names[0])
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            t.copy_(comm.broadcast(t, 0, group))
    return module


def data_sharded(mesh: Mesh, n_rows: int, axis: str = "data") -> slice:
    """The rows of this rank's data index in a batch of ``n_rows``."""
    n = mesh.shape[axis]
    if n_rows % n:
        raise ValueError(f"batch {n_rows} does not split over {n} ranks")
    per = n_rows // n
    i = mesh.index(axis)
    return slice(i * per, (i + 1) * per)


def shard_batch(batch: dict, mesh: Mesh, axis: str = "data") -> dict:
    """This rank's rows of every leaf with a leading batch dimension
    (tensors, arrays, lists)."""
    out = {}
    for k, v in batch.items():
        out[k] = v[data_sharded(mesh, len(v), axis)]
    return out


def gather_rows(t: torch.Tensor, mesh: Mesh, axis: str = "data", dim: int = 0) -> torch.Tensor:
    """The ranks' rows of ``axis`` concatenated along ``dim``."""
    return comm.all_gather(t, dim, mesh.group(axis))


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------

COLUMN_PARALLEL = frozenset({"linear1", "c_fc"})
ROW_PARALLEL = frozenset({"out_proj", "linear2", "c_proj"})
ATTENTION_INPUT = frozenset({"in_proj_weight", "in_proj_bias"})
# Layers whose names here (the reference's torch names) differ from the JAX
# names the rule reads: the timestep embedder's MLP is linear1 / linear2
# there.
JAX_NAMES = {"time_embed.0": "linear1", "time_embed.2": "linear2"}


@dataclasses.dataclass(frozen=True)
class TPSpec:
    """Where a rank's shard of a tensor lies: ``dim`` split over the model
    axis (None: replicated) in ``chunks`` equal chunks, each split alike
    (3 for the fused q / k / v rows)."""

    dim: Optional[int] = None
    chunks: int = 1

    def owner(self, shape: Sequence[int], n_model: int) -> np.ndarray:
        """The model index holding each element (-1: every rank)."""
        out = np.full(tuple(shape), -1, np.int64)
        if self.dim is None:
            return out
        size = shape[self.dim]
        i = np.arange(size) % (size // self.chunks) // (size // self.chunks // n_model)
        view = [1] * len(shape)
        view[self.dim] = size
        return np.broadcast_to(i.reshape(view), tuple(shape)).copy()

    def take(self, t: torch.Tensor, rank: int, n_model: int) -> torch.Tensor:
        """Rank ``rank``'s shard of ``t``."""
        if self.dim is None:
            return t
        parts = t.chunk(self.chunks, dim=self.dim)
        return torch.cat([p.chunk(n_model, dim=self.dim)[rank] for p in parts],
                         dim=self.dim).contiguous()


REPLICATED = TPSpec()


def tp_spec(name: str, shape: Sequence[int], n_model: int,
            num_heads: Optional[int] = None) -> TPSpec:
    """The spec of parameter ``name`` (a dotted module path) of ``shape``
    in torch layout.  ``num_heads`` is the attention's head count for its
    parameters (``in_proj_*`` and ``out_proj.*``): they shard only where
    the heads divide."""
    parts = name.split(".")
    if len(parts) < 2:
        return REPLICATED
    parent, leaf = JAX_NAMES.get(".".join(parts[-3:-1]), parts[-2]), parts[-1]
    attention = leaf in ATTENTION_INPUT or parent == "out_proj"
    if attention and (num_heads is None or num_heads % n_model):
        return REPLICATED
    if leaf in ATTENTION_INPUT:
        spec = TPSpec(0, 3)
    elif parent in COLUMN_PARALLEL:
        spec = TPSpec(0)
    elif parent in ROW_PARALLEL and leaf == "weight" and len(shape) == 2:
        spec = TPSpec(1)
    else:
        return REPLICATED
    if shape[spec.dim] % (spec.chunks * n_model):
        return REPLICATED
    return spec


def _attention_heads(module: nn.Module) -> Dict[str, int]:
    """``{module path: heads}`` of every multi-head attention in ``module``."""
    from ..models.layers import TorchMultiheadAttention

    return {name: m.num_heads for name, m in module.named_modules()
            if isinstance(m, TorchMultiheadAttention)}


def tp_plan(module: nn.Module, n_model: int) -> Dict[str, TPSpec]:
    """:func:`tp_spec` of every parameter of ``module``."""
    heads = _attention_heads(module)
    plan = {}
    for name, p in module.named_parameters():
        owner = name.rsplit(".", 2 if ".out_proj." in f".{name}" else 1)[0]
        plan[name] = tp_spec(name, p.shape, n_model, heads.get(owner))
    return plan


class RowParallel:
    """The model axis of a tensor-parallel module: the sum of its ranks'
    row-parallel partials (:meth:`reduce`) and, under sequence parallelism
    (``seq``), the gather of its column-parallel inputs along T
    (:meth:`gather`) with the sum reduce-scattered along T."""

    def __init__(self, group, size: int, rank: int, seq: bool = False):
        self.group, self.size, self.rank, self.seq = group, size, rank, seq

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        return (comm.reduce_scatter(t, 1, self.group) if self.seq
                else comm.all_reduce(t, self.group))

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return comm.all_gather(t, 1, self.group) if self.seq else t

    def seq_parallel(self) -> "RowParallel":
        return RowParallel(self.group, self.size, self.rank, seq=True)


def model_axis(mesh: Mesh, axis: str = "model") -> RowParallel:
    return RowParallel(mesh.group(axis), mesh.shape[axis], mesh.index(axis))


def tp_shard_params(module: nn.Module, mesh: Mesh, model_axis_name: str = "model") -> nn.Module:
    """Keep this rank's shard of every parameter :func:`tp_plan` splits, in
    place, and mark the modules that now hold shards: an attention gets
    ``tp`` and its local head count, a row-parallel ``Linear`` gets ``tp``
    (its forward sums the partials).  Call on a module built alike on every
    rank (same config, seed and files).  W8A8 goes off
    (``models.layers.set_tensor_parallel``): the int8 blocks hold whole
    weights."""
    from ..models.layers import TorchMultiheadAttention, set_tensor_parallel

    n = mesh.shape[model_axis_name]
    if n == 1:
        return module
    set_tensor_parallel(True)
    axis = model_axis(mesh, model_axis_name)
    plan = tp_plan(module, n)
    for name, spec in plan.items():
        if spec.dim is None:
            continue
        owner_name, leaf = name.rsplit(".", 1)
        owner = module.get_submodule(owner_name)
        p = getattr(owner, leaf)
        setattr(owner, leaf, nn.Parameter(spec.take(p.data, axis.rank, n),
                                          requires_grad=p.requires_grad))
        if spec.dim == 1:  # the row-parallel Linear
            owner.tp = axis
    for _, m in module.named_modules():
        if isinstance(m, TorchMultiheadAttention) and m.num_heads % n == 0:
            m.tp = axis
            m.local_heads = m.num_heads // n
    return module


# ---------------------------------------------------------------------------
# FSDP (the rule only)
# ---------------------------------------------------------------------------

def fsdp_spec(shape: Sequence[int], n_data: int, base: Optional[Sequence] = None,
              min_size: int = 0, data_axis: str = "data") -> tuple:
    """The JAX ``fsdp_spec`` on a shape: one axis name per dimension (None:
    not split).  ``base`` (a tensor-parallel layout) is kept; the largest
    remaining dimension that divides by ``n_data`` is split over
    ``data_axis``.  A leaf under ``min_size`` elements, or with no such
    dimension, keeps ``base``."""
    ndim = len(shape)
    spec = [None] * ndim if base is None else list(base) + [None] * (ndim - len(base))
    if int(np.prod(shape, dtype=np.int64)) < max(min_size, 1):
        return tuple(spec)
    cands = [d for d in range(ndim)
             if spec[d] is None and shape[d] >= n_data and shape[d] % n_data == 0]
    if cands:
        spec[max(cands, key=lambda d: shape[d])] = data_axis
    return tuple(spec)
