"""Learning-rate schedules (counterpart of the JAX package's
``solver/lr_scheduler.py``; the reference's ``WarmupMultiStepLR``,
``WarmupCosineLR`` and the DeepLab poly schedule).

A schedule is a plain ``step -> lr`` function. The optimizer evaluates it at
the count of updates already made, as optax does: the first update uses
``schedule(0)`` (``solver/build.py`` wraps it in a ``LambdaLR``).
"""

import math
from typing import Callable, Sequence


def _warmup_factor(step: int, method: str, warmup_iters: int, warmup_factor: float) -> float:
    if warmup_iters <= 0 or step >= warmup_iters:
        return 1.0
    if method == "constant":
        return warmup_factor
    if method == "linear":
        alpha = step / warmup_iters
        return warmup_factor * (1.0 - alpha) + alpha
    raise ValueError(f"Unknown warmup method: {method}")


def warmup_multistep_lr(base_lr: float, steps: Sequence[int], gamma: float = 0.1,
                        warmup_factor: float = 0.001, warmup_iters: int = 1000,
                        warmup_method: str = "linear") -> Callable[[int], float]:
    """lr(step) = base_lr * warmup * gamma ^ (milestones passed)."""
    milestones = sorted(steps)

    def schedule(step: int) -> float:
        passed = sum(step >= m for m in milestones)
        return base_lr * _warmup_factor(step, warmup_method, warmup_iters, warmup_factor) * gamma ** passed

    return schedule


def warmup_cosine_lr(base_lr: float, max_iters: int, warmup_factor: float = 0.001,
                     warmup_iters: int = 1000, warmup_method: str = "linear") -> Callable[[int], float]:
    """lr(step) = base_lr * warmup * 0.5 * (1 + cos(pi * step / max_iters))."""

    def schedule(step: int) -> float:
        w = _warmup_factor(step, warmup_method, warmup_iters, warmup_factor)
        return base_lr * w * 0.5 * (1.0 + math.cos(math.pi * step / max_iters))

    return schedule


def warmup_poly_lr(base_lr: float, max_iters: int, power: float = 0.9, constant_ending: float = 0.0,
                   warmup_factor: float = 0.001, warmup_iters: int = 1000,
                   warmup_method: str = "linear") -> Callable[[int], float]:
    """lr(step) = base_lr * warmup * (1 - step / max_iters) ^ power, held at
    ``constant_ending`` once past the warmup and below it."""

    def schedule(step: int) -> float:
        w = _warmup_factor(step, warmup_method, warmup_iters, warmup_factor)
        poly = min(max(1.0 - step / max_iters, 0.0), 1.0) ** power
        if constant_ending > 0 and w == 1.0 and poly < constant_ending:
            poly = constant_ending
        return base_lr * w * poly

    return schedule
