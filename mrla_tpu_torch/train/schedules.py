"""Learning-rate schedules (the JAX package's ``train/schedules.py``), as
plain functions of the global step (0 for the first update): each
``*_with_warmup`` returns ``schedule(step) -> lr``.

  * step_with_warmup: linear warm-up for ``warmup_epochs``, then
    lr·0.1^(epoch // 30), evaluated per step;
  * cosine_with_warmup: per-step cosine after a linear warm-up from near 0;
  * multistep_with_warmup: decay at milestone epochs;
  * exponential_decay_with_warmup: timm's 'step' scheduler of the
    EfficientNet recipe (×0.97 every 2.4 epochs).

The arithmetic is float32, as the JAX schedules', so that a decay boundary
that float32 rounding moves (7.2 / 2.4 epochs is 2.9999998 in float32)
falls on the same step in both packages.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

Schedule = Callable[[int], float]
f32 = np.float32


def step_with_warmup(base_lr: float, steps_per_epoch: int,
                     warmup_epochs: int = 3, decay_every_epochs: int = 30,
                     decay_factor: float = 0.1) -> Schedule:
    def schedule(step: int) -> float:
        epoch = f32(step) / f32(steps_per_epoch)
        if warmup_epochs > 0 and epoch < warmup_epochs:
            return float(f32(base_lr) * (epoch + f32(1e-8))
                         / f32(warmup_epochs))
        return float(f32(base_lr) * f32(decay_factor) ** np.floor(
            epoch / f32(decay_every_epochs)))

    return schedule


def cosine_with_warmup(base_lr: float, total_epochs: int,
                       steps_per_epoch: int, warmup_epochs: int = 5,
                       min_lr: float = 0.0) -> Schedule:
    total_steps = total_epochs * steps_per_epoch
    warmup_steps = warmup_epochs * steps_per_epoch

    def schedule(step: int) -> float:
        if warmup_steps > 0 and step < warmup_steps:
            return float(f32(base_lr) * f32(step + 1) / f32(warmup_steps))
        t = f32(step - warmup_steps) / f32(max(total_steps - warmup_steps,
                                               1))
        return float(f32(min_lr) + f32(0.5) * f32(base_lr - min_lr)
                     * (f32(1) + np.cos(f32(np.pi) * t)))

    return schedule


def multistep_with_warmup(base_lr: float, steps_per_epoch: int,
                          milestones_epochs: Sequence[int] = (30, 60, 90),
                          decay_factor: float = 0.1,
                          warmup_epochs: int = 5) -> Schedule:
    def schedule(step: int) -> float:
        epoch = f32(step) / f32(steps_per_epoch)
        if warmup_epochs > 0 and epoch < warmup_epochs:
            return float(f32(base_lr) * f32(step + 1)
                         / f32(warmup_epochs * steps_per_epoch))
        n = f32(sum(epoch >= m for m in milestones_epochs))
        return float(f32(base_lr) * f32(decay_factor) ** n)

    return schedule


def exponential_decay_with_warmup(base_lr: float, steps_per_epoch: int,
                                  decay_epochs: float = 2.4,
                                  decay_factor: float = 0.97,
                                  warmup_epochs: int = 3,
                                  warmup_lr: float = 1e-6) -> Schedule:
    def schedule(step: int) -> float:
        epoch = f32(step) / f32(steps_per_epoch)
        if warmup_epochs > 0 and epoch < warmup_epochs:
            return float(f32(warmup_lr) + f32(base_lr - warmup_lr) * epoch
                         / f32(warmup_epochs))
        return float(f32(base_lr) * f32(decay_factor) ** np.floor(
            epoch / f32(decay_epochs)))

    return schedule
