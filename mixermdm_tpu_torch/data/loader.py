"""Shuffling, batching, prefetching loader over a random-access dataset; this
package's own copy of ``mixermdm_tpu/data/loader.py``.  Every batch has the
dataset's static padded length; strings stay lists.

Batches are built by ``num_workers`` threads (one by default) at most
``prefetch`` batches ahead of the consumer and delivered in index order, so
an epoch's batch sequence is the same for any number of workers.  The items
of the InterHuman dataset are one native call each, which releases the
interpreter lock (:mod:`.native`), so the threads run in parallel.  A
worker's exception is raised in the consumer; an abandoned iteration stops
its workers.
"""

from __future__ import annotations

import random
import threading
from typing import Callable, Iterator, Optional

import numpy as np


def collate(samples: list) -> dict:
    """Stack item dicts into a numpy batch; ``motions`` is the two persons
    concatenated on the feature axis, or the one person's motion."""
    out: dict = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = vals if isinstance(vals[0], str) else np.stack([np.asarray(v) for v in vals])
    if "motion1" in out and "motion2" in out:
        out["motions"] = np.concatenate([out["motion1"], out["motion2"]], axis=-1)
    elif "motion1" in out:
        out["motions"] = out["motion1"]
    return out


class _WorkerError:
    """A worker thread's exception, carried to the consumer in its batch's
    slot."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _Epoch:
    """One iteration's shared state: the next batch to build, the batches
    built and not yet taken, and the consumer's position."""

    def __init__(self, n: int):
        self.n = n
        self.next_task = 0
        self.taken = 0
        self.done: dict = {}
        self.stopped = False
        self.cv = threading.Condition()


class DataLoader:
    """Batches of ``batch_size`` items in an order shuffled from ``(seed,
    epoch)`` (``shuffle``), the last partial batch dropped (``drop_last``),
    each passed through ``transform`` where given.  With ``reseed_dataset``
    the dataset's augmentation RNG (its ``rng``) is reseeded from ``(seed,
    epoch)`` at each epoch, so with one worker an epoch replays exactly;
    with more, the workers interleave their draws and only the index order
    is fixed."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, prefetch: int = 2,
                 transform: Optional[Callable[[dict], dict]] = None, num_workers: int = 1,
                 reseed_dataset: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self.transform = transform
        self.num_workers = max(1, num_workers)
        self.reseed_dataset = reseed_dataset
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Position the loader at ``epoch``: the shuffle and (with
        ``reseed_dataset``) the dataset's augmentation draws are functions of
        ``(seed, epoch)``, so a resumed run that sets the epoch it stopped in
        replays that epoch exactly (JAX ``DataLoader.set_epoch``)."""
        self.epoch = int(epoch)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self) -> list:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return [idx[i: i + self.batch_size] for i in range(0, len(idx), self.batch_size)
                ][: len(self)]

    def _make(self, indices) -> dict:
        batch = collate([self.dataset[int(i)] for i in indices])
        return self.transform(batch) if self.transform is not None else batch

    def _work(self, batches: list, ep: _Epoch) -> None:
        """A worker: take the next batch index, build it, wait until it is
        within ``prefetch`` of the consumer, store it; an exception is
        stored in its slot."""
        while True:
            with ep.cv:
                if ep.stopped or ep.next_task >= ep.n:
                    return
                i = ep.next_task
                ep.next_task += 1
            try:
                batch = self._make(batches[i])
            except BaseException as e:  # noqa: BLE001 - relayed to the consumer, raised there
                batch = _WorkerError(e)
            with ep.cv:
                while not ep.stopped and i >= ep.taken + self.prefetch:
                    ep.cv.wait()
                ep.done[i] = batch
                ep.cv.notify_all()

    def __iter__(self) -> Iterator[dict]:
        if self.reseed_dataset and hasattr(self.dataset, "rng"):
            self.dataset.rng = random.Random((self.seed + 1) * 1_000_003 + self.epoch)
        batches = self._index_batches()
        self.epoch += 1
        ep = _Epoch(len(batches))
        workers = [threading.Thread(target=self._work, args=(batches, ep), daemon=True)
                   for _ in range(min(self.num_workers, len(batches)))]
        for w in workers:
            w.start()
        try:
            for i in range(ep.n):
                with ep.cv:
                    while i not in ep.done:
                        ep.cv.wait()
                    batch = ep.done.pop(i)
                    ep.taken = i + 1
                    ep.cv.notify_all()
                if isinstance(batch, _WorkerError):
                    raise batch.exc
                yield batch
        finally:
            with ep.cv:
                ep.stopped = True
                ep.cv.notify_all()
