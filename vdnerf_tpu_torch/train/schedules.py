"""Learning-rate schedules, computed on the host in f32 as the JAX package's.

Counterpart of ``vdnerf_tpu/train/schedules.py``:

- :func:`neus_lr_schedule`: the main optimizer's; linear warm-up, then
  cosine decay to ``alpha * base_lr``, held at that floor past the horizon.
- :func:`multistep_schedule`: the learned cameras' (torch ``MultiStepLR``),
  ``base_lr * gamma ** (milestones passed)``. The pose milestones are every
  ``step_size`` steps from ``warm_up_end``; the focal ones are the
  reference's literal tuple ``(warm_up_end, end_iter, step_size)`` (it
  passes a tuple where it meant a range), kept as it is.
"""

from __future__ import annotations

import math

import numpy as np


def neus_lr_schedule(base_lr: float, warm_up_end: int, end_iter: int, alpha: float):
    """step -> learning rate, computed in f32 as the JAX schedule is."""
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        warm = step / f32(max(warm_up_end, 1))
        progress = np.clip((step - f32(warm_up_end)) / f32(max(end_iter - warm_up_end, 1)),
                           f32(0.0), f32(1.0))
        cos = (np.cos(f32(math.pi) * progress) + f32(1.0)) * f32(0.5) * f32(1 - alpha) + f32(alpha)
        factor = cos if warm_up_end == 0 or step >= warm_up_end else warm
        return float(f32(base_lr) * f32(factor))

    return schedule


def multistep_schedule(base_lr: float, milestones: tuple[int, ...], gamma: float):
    """step -> ``base_lr * gamma ** n`` in f32, n the milestones <= step.
    The power is f32(gamma) ** n correctly rounded to f32; XLA's f32 power
    gives the same at the shipped gamma 0.9 for every n up to 69 (it can be
    an ulp off elsewhere, as at 0.95 ** 58)."""
    f32 = np.float32
    ms = sorted(milestones)

    def schedule(step: int) -> float:
        n = sum(step >= m for m in ms)
        return float(f32(base_lr) * f32(float(f32(gamma)) ** n))

    return schedule


def pose_lr_milestones(warm_up_end: int, end_iter: int, step_size: int) -> tuple[int, ...]:
    return tuple(range(warm_up_end, end_iter, max(step_size, 1)))


def focal_lr_milestones(warm_up_end: int, end_iter: int, step_size: int) -> tuple[int, ...]:
    return (warm_up_end, end_iter, step_size)
