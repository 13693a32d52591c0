"""The collectives of the parallel layouts, one function each, over a
``torch.distributed`` process group.

These are the port's counterparts of what GSPMD and ``shard_map`` insert in
the JAX package: the ``psum`` of a row-parallel product
(:func:`all_reduce`), the gathers and reduce-scatters of sequence
parallelism along a dimension (:func:`all_gather`, :func:`reduce_scatter`),
the ``ppermute`` ring of the pipeline (:func:`ppermute`) and the
replication of a result (:func:`broadcast`).

Transport, a branch on the group's backend and the tensor's device:

- NCCL takes CUDA tensors for every collective here (``ppermute`` as one
  ``batch_isend_irecv``).
- ``gloo`` on CPU tensors runs each collective directly; it has no
  reduce-scatter, so :func:`reduce_scatter` is its all-reduce and the
  rank's slice.
- ``gloo`` on CUDA tensors (two ranks on one card) runs the collectives of
  :data:`GLOO_CUDA_DIRECT` on the device tensors and stages the others
  (``send`` / ``recv``) through host memory: a copy to the host, the
  collective there, a copy back.

Nothing moves between transports at run time: the branch is decided by the
backend and the device alone, and a collective that fails raises.  The
first use of each (collective, backend, device, transport) is printed and
counted in :data:`transports`.

Only :func:`all_reduce` does arithmetic, and only in f32 (the row-parallel
sums); the other collectives move bytes, so a bf16 or bool tensor travels
as its bytes (``uint8``), which every backend takes.
"""

from __future__ import annotations

import collections
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# The collectives gloo runs on CUDA tensors itself; the rest are staged
# through host memory.
GLOO_CUDA_DIRECT = frozenset({"all_reduce", "broadcast", "all_gather"})

# (collective, backend, device type, transport) -> calls.
transports: collections.Counter = collections.Counter()


def _transport(op: str, group, t: torch.Tensor, how: Optional[str] = None) -> str:
    """"direct" or "host" for ``op`` on ``t`` over ``group`` (``how`` names
    a composed form); counts and prints the first use of each
    combination."""
    backend = str(dist.get_backend(group))
    kind = "direct"
    if t.is_cuda and backend == "gloo" and op not in GLOO_CUDA_DIRECT:
        kind = "host"
    key = (op, backend, t.device.type, how or kind)
    if key not in transports:
        what = how or ("staged through host memory" if kind == "host" else "direct")
        print(f"collective {op}: {backend} on {t.device.type} tensors, {what}", flush=True)
    transports[key] += 1
    return kind


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous) as its bytes, last dimension widened."""
    t = t.contiguous()
    if t.dtype == torch.uint8:
        return t
    if t.dim() == 0:
        t = t.reshape(1)
    return t.view(torch.uint8)


def _from_bytes(b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return b if like.dtype == torch.uint8 else b.view(like.dtype).reshape(like.shape)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` (f32) over ``group``, a new tensor."""
    if group is None:
        return t
    if t.dtype != torch.float32:
        raise TypeError(f"all_reduce sums f32 only, got {t.dtype}")
    out = t.clone(memory_format=torch.contiguous_format)
    if _transport("all_reduce", group, out) == "host":
        host = out.cpu()
        dist.all_reduce(host, group=group)
        return host.to(t.device)
    dist.all_reduce(out, group=group)
    return out


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group order; every
    rank's ``t`` has the same shape."""
    if group is None:
        return t
    n = group_size(group)
    b = _as_bytes(t)
    if _transport("all_gather", group, b) == "host":
        host = b.cpu()
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        parts = [p.to(t.device) for p in parts]
    else:
        parts = [torch.empty_like(b) for _ in range(n)]
        dist.all_gather(parts, b, group=group)
    return torch.cat([_from_bytes(p, t) for p in parts], dim=dim)


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of ``t`` (f32) over
    ``group``; ``t.shape[dim]`` divides by the group's size."""
    if group is None:
        return t
    n, r = group_size(group), group_rank(group)
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} does not split "
                         f"over {n} ranks")
    if t.dtype != torch.float32:
        raise TypeError(f"reduce_scatter sums f32 only, got {t.dtype}")
    chunk = t.shape[dim] // n
    if str(dist.get_backend(group)) == "gloo":  # gloo has no reduce-scatter
        _transport("reduce_scatter", group, t, how="its all_reduce and the rank's slice")
        return all_reduce(t, group).narrow(dim, r * chunk, chunk).contiguous()
    _transport("reduce_scatter", group, t)
    parts = [p.contiguous() for p in t.split(chunk, dim=dim)]
    out = torch.empty_like(parts[r])
    dist.reduce_scatter(out, parts, group=group)
    return out


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of group rank ``src`` on every rank of ``group`` (the others
    pass a tensor of the same shape and dtype)."""
    if group is None:
        return t
    b = _as_bytes(t).clone()
    root = dist.get_global_rank(group, src)
    if _transport("broadcast", group, b) == "host":
        host = b.cpu()
        dist.broadcast(host, root, group=group)
        b = host.to(t.device)
    else:
        dist.broadcast(b, root, group=group)
    return _from_bytes(b, t)


def broadcast_object(obj, src: int, group):
    """A picklable object of group rank ``src`` on every rank (host side:
    requests, seeds, stop messages)."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, src), group=group)
    return box[0]


def ppermute(t: torch.Tensor, perm: Sequence[Tuple[int, int]], group) -> torch.Tensor:
    """``lax.ppermute``: for each (source, destination) pair of group ranks,
    the destination receives the source's ``t``; a rank that is no
    destination gets zeros."""
    if group is None or group_size(group) == 1:
        return t if (0, 0) in perm else torch.zeros_like(t)
    r = group_rank(group)
    b = _as_bytes(t)
    out = torch.zeros_like(b)
    sends = [dst for src, dst in perm if src == r]
    recvs = [src for src, dst in perm if dst == r]
    if not sends and not recvs:
        return _from_bytes(out, t)
    host = _transport("ppermute", group, b) == "host"
    sb, rb = (b.cpu(), out.cpu()) if host else (b, out)
    glob = lambda i: dist.get_global_rank(group, i)  # noqa: E731
    if str(dist.get_backend(group)) == "nccl":
        ops = ([dist.P2POp(dist.isend, sb, glob(d), group) for d in sends]
               + [dist.P2POp(dist.irecv, rb, glob(s), group) for s in recvs])
        works = dist.batch_isend_irecv(ops)
    else:
        works = ([dist.isend(sb, glob(d), group=group) for d in sends]
                 + [dist.irecv(rb, glob(s), group=group) for s in recvs])
    for w in works:
        w.wait()
    return _from_bytes(rb.to(t.device) if host else rb, t)


def ring(n: int) -> List[Tuple[int, int]]:
    """The pipeline's permutation: stage i sends to stage i + 1 (mod n)."""
    return [(i, (i + 1) % n) for i in range(n)]
