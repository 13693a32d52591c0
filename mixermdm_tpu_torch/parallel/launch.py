"""Start ranks: one process each, joined into one ``torch.distributed``
world through a ``FileStore``.

:func:`launch` is what the CLIs use to put one rank on each visible card
(NCCL), what the tests use to run several ranks on the CPU (``gloo``, the
counterpart of the JAX tests' virtual-device meshes), and what
``chip_smoke.py`` uses to run two ranks on its one card (``gloo`` with
every rank on ``cuda:0``: two ranks share a card only when the caller
names the same device for both).  The rendezvous is a file (no TCP port);
every process group waits at most :data:`.mesh.INIT_TIMEOUT` for a peer;
every rank is joined within ``timeout_s`` and killed after it, and a rank's
traceback is raised in the caller.
"""

from __future__ import annotations

import io
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import INIT_TIMEOUT, destroy, initialize_distributed, rank_device, set_rank_device, \
    world_rank

THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
# How long a CLI's ranks may run (an evaluation protocol takes hours).
CLI_TIMEOUT_S = 7 * 24 * 3600.0


class RankFailed(RuntimeError):
    """A rank raised, died or outlived its time limit."""


def _worker(fn, rank: int, nprocs: int, backend: str, store_path: str, device: str,
            threads: Optional[int], args: tuple, results) -> None:
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        set_rank_device(device)
        store = dist.FileStore(store_path, nprocs)
        dist.init_process_group(backend, store=store, rank=rank, world_size=nprocs,
                                timeout=INIT_TIMEOUT)
        out = fn(rank, *args)
        dist.barrier()
        # by value: a tensor put on the queue as it is lives in this
        # process's shared memory, gone once the rank exits
        buf = io.BytesIO()
        torch.save(out, buf)
        results.put((rank, True, buf.getvalue()))
    except BaseException:  # reported to the caller, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        destroy()


def launch(fn: Callable, nprocs: int, *, backend: str = "gloo",
           devices: Optional[Sequence[str]] = None, args: tuple = (),
           timeout_s: float = 600.0, threads: Optional[int] = None,
           store_dir: Optional[str] = None) -> List:
    """Run ``fn(rank, *args)`` on ``nprocs`` ranks (spawned processes) and
    return their results in rank order.  ``devices[r]`` is rank r's device
    (default: the CPU for ``gloo``, ``cuda:r`` for NCCL); ``threads`` sets
    each rank's torch threads and its BLAS / OpenMP pools; the
    ``FileStore`` lies in a new temporary directory (under ``store_dir``
    where given).  ``fn`` must be importable by name (a module-level
    function)."""
    if devices is None:
        devices = ["cpu"] * nprocs if backend == "gloo" else [f"cuda:{r}" for r in range(nprocs)]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_worker, daemon=True,
                             args=(fn, r, nprocs, backend, store_path, str(devices[r]),
                                   threads, tuple(args), results))
                 for r in range(nprocs)]
        # A rank's BLAS and OpenMP pools read these when they start.
        pools = {k: str(threads) for k in THREAD_VARS} if threads is not None else {}
        saved = {k: os.environ.get(k) for k in pools}
        os.environ.update(pools)
        try:
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        deadline = time.monotonic() + timeout_s
        out, failed = {}, []
        try:
            while len(out) + len(failed) < nprocs:
                left = deadline - time.monotonic()
                if left <= 0:
                    failed.append(f"ranks {sorted(set(range(nprocs)) - set(out))} still running "
                                  f"after {timeout_s:.0f} s")
                    break
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead and results.empty():
                        failed.append(f"ranks {dead} exited with "
                                      f"{[procs[r].exitcode for r in dead]} and no report")
                        break
                    continue
                if ok:
                    out[rank] = torch.load(io.BytesIO(value), weights_only=False)
                else:
                    failed.append(f"rank {rank}:\n{value}")
                    break  # its peers would wait on it: end them now
        finally:
            for p in procs:
                if not failed:
                    p.join(timeout=max(0.0, min(30.0, deadline - time.monotonic())))
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    if failed:
        raise RankFailed("\n".join(failed))
    return [out[r] for r in range(nprocs)]


def _cli_rank(rank: int, fn: Callable, args):
    if hasattr(args, "device"):
        args.device = str(rank_device(args.device))
    return fn(args)


def on_ranks(fn: Callable, args, spread: bool = True, device: Optional[str] = None):
    """Run a CLI's ``fn(args)`` on its ranks and return rank 0's result:
    in the world that is already there (a caller's, or the one ``torchrun``
    described: :func:`.mesh.initialize_distributed`), else with ``spread``
    on one rank per visible card (NCCL; the JAX CLIs' ``jax.devices()``),
    else once in this process.  ``device`` (default ``args.device``) is
    the CLI's device flag; ``args.device``, where there is one, becomes the
    rank's device."""
    device = device or args.device
    if initialize_distributed(device):
        return _cli_rank(world_rank(), fn, args)
    n = (torch.cuda.device_count()
         if torch.device(device).type == "cuda" and torch.cuda.is_available() else 1)
    if spread and n > 1 and not dist.is_initialized():
        return launch(_cli_rank, n, backend="nccl", args=(fn, args),
                      timeout_s=CLI_TIMEOUT_S)[0]
    return fn(args)
