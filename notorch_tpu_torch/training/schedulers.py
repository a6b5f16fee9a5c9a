"""Learning-rate schedules.

Port of ``notorch_tpu.training.schedulers``: the chemprop-lineage
"Noam-like" schedule, linear warmup ``init_lr -> max_lr`` over
``warmup_steps``, exponential decay ``max_lr -> final_lr`` over
``cooldown_steps``, then constant ``final_lr``. Here it is a plain function
of the update count that a ``torch.optim.lr_scheduler.LambdaLR`` drives
(:mod:`notorch_tpu_torch.training.optim`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def noam_like_schedule(
    warmup_steps: int,
    cooldown_steps: int,
    init_lr: float,
    max_lr: float,
    final_lr: float,
) -> Callable[[int], float]:
    """The rate of update ``step`` (0 for the first update). Computed in
    float32, as the JAX schedule is, so that both packages use the same
    rate at every step."""
    warmup_steps = max(int(warmup_steps), 1)
    cooldown_steps = max(int(cooldown_steps), 1)
    f32 = np.float32
    slope = f32(max_lr - init_lr)
    gamma = f32((final_lr / max_lr) ** (1.0 / cooldown_steps))

    def schedule(step: int) -> float:
        s = f32(step)
        if s < warmup_steps:
            return float(f32(init_lr) + slope * s / f32(warmup_steps))
        if s < warmup_steps + cooldown_steps:
            return float(f32(max_lr) * gamma ** (s - f32(warmup_steps)))
        return float(f32(final_lr))

    return schedule
