"""Learning-rate schedule of the main optimizer.

Counterpart of ``neus_lr_schedule`` in ``vdnerf_tpu/train/schedules.py``:
linear warm-up, then cosine decay to ``alpha * base_lr``, held at that floor
past the horizon. The pose/focal multistep schedules come with learned
cameras.
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
