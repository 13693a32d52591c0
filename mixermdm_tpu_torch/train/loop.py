"""The epoch loop the training CLIs share (JAX ``cli/train_mixermdm.py``
and ``cli/train_in2in.py``): resume at the step a train state holds, save
every ``save_epoch`` epochs, stop after ``max_steps`` steps."""

from __future__ import annotations

from typing import Callable, Optional


def run_epochs(loader, epochs: int, start_step: int, max_steps: Optional[int],
               fit: Callable, save: Callable, save_epoch: int) -> int:
    """Call ``fit(epoch, batch_idx, batch, step)`` for every batch from the
    global step ``start_step`` on, and ``save(epoch + 1)`` after every
    ``save_epoch``-th whole epoch; returns the step reached.

    A resumed run starts in the epoch its step falls in (the JAX CLIs'
    fast-forward) and passes over the batches of that epoch the saved run
    already took: the loader replays the epoch (``set_epoch``), so those
    batches are drawn and dropped, and the next one is the batch the
    unbroken run took next."""
    if max_steps and start_step >= max_steps:
        return start_step
    per_epoch = max(1, len(loader))
    start_epoch = min(start_step // per_epoch, epochs)
    skip = start_step - start_epoch * per_epoch
    loader.set_epoch(start_epoch)
    step = start_step
    for epoch in range(start_epoch, epochs):
        for batch_idx, batch in enumerate(loader):
            if epoch == start_epoch and batch_idx < skip:
                continue
            fit(epoch, batch_idx, batch, step)
            step += 1
            if max_steps and step >= max_steps:
                return step
        if (epoch + 1) % max(1, save_epoch) == 0:
            save(epoch + 1)
    return step
