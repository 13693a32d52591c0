"""GPipe pipeline parallelism over a layer stack; counterpart of
``mixermdm_tpu/parallel/pipeline.py``.

``with pipeline_scope(mesh):`` makes the in2IN denoisers run their layer
stacks through :func:`pipeline_scan` (``models/in2in.py``), as the ``--pp``
flags of ``infer-mixermdm`` and ``infer-in2in`` set it.  Each rank of the
``pipe`` axis is one stage and runs its contiguous L/S layers; the batch
splits into M microbatches (default S), and every stage runs M + S - 1
ticks: at tick t stage s runs microbatch t - s (stage 0 takes a fresh one,
the others what the stage before sent on the ring, :func:`..comm.ppermute`).
The last stage finishes microbatch t - (S - 1) at tick t; its outputs are
then given to every stage (the JAX package sums them over the axis with
zeros elsewhere; a broadcast from the last stage gives the same values).
A stage does no work on a tick with no microbatch of its own (the bubble),
where the JAX schedule computes values it never keeps.

Every rank holds the whole stack (the weights are built alike on every
rank) and runs only its stage's layers.  Sampling only: the schedule has no
backward here.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence

import torch

from . import comm

_TLS = threading.local()


def pipeline_context():
    """The active ``(mesh, axis, n_microbatches)`` or None."""
    return getattr(_TLS, "pipeline", None)


@contextlib.contextmanager
def pipeline_scope(mesh, *, axis: str = "pipe", n_microbatches: Optional[int] = None):
    prev = getattr(_TLS, "pipeline", None)
    _TLS.pipeline = (mesh, axis, n_microbatches)
    try:
        yield
    finally:
        _TLS.pipeline = prev


def _rows(carry, start: int, n: int):
    return tuple(None if c is None else c[start:start + n] for c in carry)


def pipeline_scan(body: Callable, layers: Sequence, carry: tuple, mesh, *, axis: str = "pipe",
                  n_microbatches: Optional[int] = None) -> tuple:
    """Apply the ``L`` layers of ``layers`` to ``carry`` pipelined over
    ``mesh[axis]``: ``body(layer, carry) -> carry`` is one layer; ``carry``
    is a tuple of tensors (or None) with a leading batch B that divides
    into the microbatches (default: one per stage).  Returns the carry after
    all layers on every stage: the same math as applying the layers in
    order."""
    n_stages = mesh.shape[axis]
    group = mesh.group(axis)
    stage = mesh.index(axis)
    n_layers = len(layers)
    if n_layers % n_stages:
        raise ValueError(f"L={n_layers} layers not divisible by S={n_stages} stages")
    M = n_microbatches or n_stages
    B = next(c for c in carry if c is not None).shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    per, last = B // M, n_stages - 1
    local = layers[stage * n_layers // n_stages:(stage + 1) * n_layers // n_stages]
    perm = comm.ring(n_stages)
    outs = [None] * M
    cur = _rows(carry, 0, per)
    for t in range(M + n_stages - 1):
        m = t - stage  # this stage's microbatch at tick t
        x = _rows(carry, m * per, per) if stage == 0 and m < M else cur
        if 0 <= m < M:
            for layer in local:
                x = body(layer, x)
            if stage == last:
                outs[m] = x
        if t < M + n_stages - 2:  # the last tick's output goes to no stage
            cur = tuple(None if c is None else comm.ppermute(c, perm, group) for c in x)
    if stage == last:
        out = tuple(None if c is None else torch.cat([o[i] for o in outs], 0)
                    for i, c in enumerate(carry))
    else:
        out = tuple(None if c is None else torch.empty_like(c) for c in carry)
    # The stack's output, replicated over the axis.
    return tuple(None if c is None else comm.broadcast(c, last, group) for c in out)
