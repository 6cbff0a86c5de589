"""Learning-rate schedules (port of ``repro/optim/schedules.py``).

Each returns a function of the step giving a float32 learning rate,
computed on the host with the reference's float32 operations (the cosine
in float64, correctly rounded to float32, as ``DSTSchedule`` takes it).
"""
from __future__ import annotations

import math

import numpy as np

f32 = np.float32


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_lr: float = 0.0):
    def lr(step) -> np.float32:
        s = f32(int(step))
        if s < warmup_steps:
            return f32(base_lr) * s / f32(max(warmup_steps, 1))
        t = (s - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1))
        t = min(max(t, f32(0.0)), f32(1.0))
        cos = f32(math.cos(float(f32(np.pi) * t)))
        return f32(min_lr) + f32(0.5 * (base_lr - min_lr)) * (f32(1.0) + cos)
    return lr


def warmup_step(base_lr: float, warmup_steps: int, boundaries: tuple, factor: float = 0.1):
    """Step decay (the paper's ResNet recipe: /10 at epochs 30/70/90)."""
    def lr(step) -> np.float32:
        s = f32(int(step))
        if s < warmup_steps:
            return f32(base_lr) * s / f32(max(warmup_steps, 1))
        mult = f32(1.0)
        for b in boundaries:
            if s >= b:
                mult = mult * f32(factor)
        return f32(base_lr) * mult
    return lr
