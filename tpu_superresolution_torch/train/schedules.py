"""Learning-rate schedules as functions of the update step (port of
``tpu_superresolution_tpu/train/schedules.py``):

- onecycle (reference train.py:308-319): torch OneCycleLR, max_lr = lr,
  pct_start 0.1, cosine anneal, div_factor 10, final_div_factor 100,
  stepped per batch;
- exponential (train.py:321-328): gamma = 0.5 ** (1/50) per epoch;
- cosine (finetune_swinir.py:307-309): CosineAnnealingLR with T_max =
  epochs and eta_min = min_lr, per epoch.

Per-epoch schedules are constant within an epoch.  The step is the
number of updates already applied (0 for the first), as optax counts.
"""

from __future__ import annotations

import math
from typing import Callable


def onecycle(lr: float, total_steps: int, pct_start: float = 0.1,
             div_factor: float = 10.0, final_div_factor: float = 100.0):
    initial = lr / div_factor
    final = initial / final_div_factor
    warm_end = float(pct_start * total_steps) - 1.0
    last = float(total_steps - 1)

    def cos(a, b, t):
        return b + (a - b) * (1 + math.cos(math.pi * t)) / 2.0

    def sched(step: int) -> float:
        step = min(float(step), last)
        if step <= warm_end:
            return cos(initial, lr, min(max(step / max(warm_end, 1e-9), 0.0), 1.0))
        return cos(lr, final, min(max((step - warm_end) / max(last - warm_end, 1e-9), 0.0), 1.0))

    return sched


def exponential_per_epoch(lr: float, steps_per_epoch: int, drop_every: int = 50,
                          decay_factor: float = 0.5):
    gamma = decay_factor ** (1.0 / drop_every)
    return lambda step: lr * gamma ** (step // max(1, steps_per_epoch))


def cosine_per_epoch(lr: float, epochs: int, steps_per_epoch: int, min_lr: float):
    def sched(step: int) -> float:
        epoch = min(step // max(1, steps_per_epoch), epochs)
        return min_lr + (lr - min_lr) * (1 + math.cos(math.pi * epoch / max(1, epochs))) / 2.0

    return sched


def build_schedule(name: str, lr: float, epochs: int, steps_per_epoch: int,
                   min_lr: float = 1e-7) -> Callable[[int], float]:
    name = name.lower()
    if name in ("none", ""):
        return lambda step: lr
    if name == "onecycle":
        return onecycle(lr, epochs * steps_per_epoch)
    if name == "exponential":
        return exponential_per_epoch(lr, steps_per_epoch)
    if name == "cosine":
        return cosine_per_epoch(lr, epochs, steps_per_epoch, min_lr)
    raise ValueError(f"Unknown scheduler '{name}'")
