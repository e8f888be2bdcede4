"""Learning-rate schedule: linear warmup + stepped decay.

Port of ``refinedet_tpu/train/schedule.py``: a ``warmup_epochs`` linear
warmup from ``warmup_init`` to the base lr, then ``gamma**k`` decay at
the integer boundaries ``max_epoch*2//3*epoch_size`` and
``max_epoch*8//9*epoch_size``. A pure function of the global step, so a
resumed run follows the same schedule. The optimizer's step t (counted
before the step, from 0) uses lr(t).
"""

from __future__ import annotations

from typing import Callable


def make_lr_schedule(base_lr: float, gamma: float, epoch_size: int,
                     max_epoch: int, warmup_epochs: int = 5,
                     warmup_init: float = 1e-6) -> Callable[[int], float]:
    """Return lr(step) for the global iteration ``step``."""
    warmup_iters = warmup_epochs * epoch_size
    step_iters = (max_epoch * 2 // 3 * epoch_size,
                  max_epoch * 8 // 9 * epoch_size)

    def schedule(step: int) -> float:
        if step < warmup_iters:
            return warmup_init + (base_lr - warmup_init) * step / warmup_iters
        k = sum(1 for s in step_iters if step >= s)
        return base_lr * gamma ** k

    return schedule
