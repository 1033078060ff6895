"""Learning-rate schedules (paper: step decay ×0.1 at 60%/80% of training).

The port's runners call the schedule on the host once per step, so each
returns a Python float: the reference's value in float64 where the
reference computes in float32 (``cosine``, ``constant``).
"""
from __future__ import annotations

import math


def step_decay(base_lr: float, total_steps: int, milestones=(0.6, 0.8),
               factor: float = 0.1):
    ms = [m * total_steps for m in milestones]

    def lr(step: int) -> float:
        k = sum(step >= m for m in ms)
        return base_lr * (factor ** k)

    return lr


def cosine(base_lr: float, total_steps: int, warmup: int = 0,
           min_frac: float = 0.1):
    def lr(step: int) -> float:
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        t = min(max((step - warmup) / max(total_steps - warmup, 1), 0.0),
                1.0)
        return base_lr * (min_frac + (1 - min_frac) * 0.5 *
                          (1 + math.cos(math.pi * t)))

    return lr


def constant(base_lr: float):
    return lambda step: float(base_lr)
