"""Learning-rate schedules: ``fam_scheduler2``, the reference's live
FAMScheduler2 (linear warmup from ``warmup_start`` to the base rate,
a hold, then a cosine to ``eta_min`` with a 1e-8 offset), and
``fam_scheduler``, its epoch-based FAMScheduler (a linear warmup, then a
cosine to ``eta_min``), as the JAX package computes them
(``asr_model_tpu/optim/schedules.py``): functions of the 0-based step or
epoch, in float32 arithmetic, evaluated on the host."""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np

f32 = np.float32


def fam_scheduler2(base_lr: float, warmup_steps: int = 1000,
                   total_steps: int = 100000,
                   decay_start: Optional[int] = None,
                   warmup_start: float = 1e-6,
                   eta_min: float = 1e-6) -> Callable[[float], float]:
    """lr(step): the rate train step ``step`` uses."""
    ds = decay_start if decay_start is not None else warmup_steps
    span = max(total_steps - ds, 1)

    def schedule(step) -> float:
        s = f32(step)
        if s < warmup_steps:
            return float(f32(warmup_start) + (f32(base_lr) - f32(
                warmup_start)) * (s / f32(warmup_steps)))
        if s < ds:
            return float(f32(base_lr))
        cos = np.cos(f32(math.pi) * (s - f32(ds)) / f32(span), dtype=f32)
        return float(f32(eta_min) + (f32(base_lr) - f32(eta_min))
                     * (f32(1) + cos) / f32(2) + f32(1e-8))

    return schedule


def fam_scheduler(base_lr: float, warmup_epochs: int, max_epochs: int,
                  warmup_start_lr: float = 1e-8,
                  eta_min: float = 1e-8) -> Callable[[float], float]:
    """lr(epoch): linear from ``warmup_start_lr`` over ``warmup_epochs``,
    then a cosine to ``eta_min`` at ``max_epochs``."""
    span = max(max_epochs - warmup_epochs, 1)

    def schedule(epoch) -> float:
        e = f32(epoch)
        if e < warmup_epochs:
            return float(f32(warmup_start_lr) + (f32(base_lr) - f32(
                warmup_start_lr)) * (e / f32(warmup_epochs)))
        cos = np.cos(f32(math.pi) * (e - f32(warmup_epochs)) / f32(span),
                     dtype=f32)
        return float(f32(eta_min) + (f32(base_lr) - f32(eta_min))
                     * (f32(1) + cos) / f32(2))

    return schedule
