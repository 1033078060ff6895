"""Learning-rate schedules (paper: step decay ×0.1 at 60%/80% of training).

The port's runners call the schedule on the host once per step, so it
returns a Python float.
"""
from __future__ import annotations


def step_decay(base_lr: float, total_steps: int, milestones=(0.6, 0.8),
               factor: float = 0.1):
    ms = [m * total_steps for m in milestones]

    def lr(step: int) -> float:
        k = sum(step >= m for m in ms)
        return base_lr * (factor ** k)

    return lr
