"""Learning-rate schedules as plain functions of the optimizer's step count,
the counterparts of the JAX package's ``training/lr_schedules.py``."""

from __future__ import annotations

import math
from typing import Callable

__all__ = ["cosine_schedule", "constant_with_warmup"]


def cosine_schedule(base_lr: float, final_lr: float, steps_per_epoch: int,
                    epochs: int, warmup_steps: int = 0,
                    warmup_start_lr: float = 0.0) -> Callable[[int], float]:
    """Linear warmup, then cosine decay to ``final_lr`` at the last step."""
    total = epochs * steps_per_epoch

    def fn(step: int) -> float:
        step = min(step, total - 1)
        if step < warmup_steps:
            return warmup_start_lr + step / max(warmup_steps, 1) * (
                base_lr - warmup_start_lr)
        prog = (step - warmup_steps) / max(total - warmup_steps, 1)
        return final_lr + 0.5 * (base_lr - final_lr) * (
            1 + math.cos(math.pi * prog))

    return fn


def constant_with_warmup(base_lr: float, warmup_steps: int = 0,
                         warmup_start_lr: float = 0.0
                         ) -> Callable[[int], float]:
    """Linear warmup, then constant."""

    def fn(step: int) -> float:
        if step < warmup_steps:
            return warmup_start_lr + step / max(warmup_steps, 1) * (
                base_lr - warmup_start_lr)
        return base_lr

    return fn
