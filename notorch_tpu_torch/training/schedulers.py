"""Learning-rate schedules.

Port of ``notorch_tpu.training.schedulers``: the chemprop-lineage
"Noam-like" schedule, linear warmup ``init_lr -> max_lr`` over
``warmup_steps``, exponential decay ``max_lr -> final_lr`` over
``cooldown_steps``, then constant ``final_lr``; and the two cosine
schedules a config's ``optimizer.schedule`` may name, written out from
optax's definitions (``cosine_decay_schedule``,
``warmup_cosine_decay_schedule``). Each is a plain function of the update
count (0 for the first update), computed in float32 as the JAX schedules
are, that a ``torch.optim.lr_scheduler.LambdaLR`` drives
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


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0) -> Callable[[int], float]:
    """optax's cosine decay: ``init_value * ((1 - alpha) * c ** exponent +
    alpha)`` with ``c = (1 + cos(pi * min(step, decay_steps) /
    decay_steps)) / 2``. Every operation is rounded to float32 where XLA
    rounds it; ``cos`` and ``**`` are taken in float64 and rounded once
    (numpy's float32 versions differ from XLA's by up to 1.5e-6 relative
    where ``c`` is small)."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got decay_steps={decay_steps}.")
    f32 = np.float32
    steps = f32(decay_steps)

    def schedule(step: int) -> float:
        angle = f32(np.pi) * min(f32(step), steps) / steps
        c = f32(0.5) * (f32(1) + f32(np.cos(np.float64(angle))))
        decayed = (f32(1) - f32(alpha)) * f32(np.float64(c) ** exponent) + f32(alpha)
        return float(f32(init_value) * decayed)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0, exponent: float = 1.0) -> Callable[[int], float]:
    """optax's linear warmup ``init_value -> peak_value`` over
    ``warmup_steps``, then :func:`cosine_decay_schedule` from ``peak_value``
    over the remaining ``decay_steps - warmup_steps`` towards
    ``end_value``."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha, exponent)

    def schedule(step: int) -> float:
        if step >= warmup_steps:
            return cosine(step - warmup_steps)
        if warmup_steps <= 0:
            return float(f32(init_value))
        frac = f32(1) - f32(max(step, 0)) / f32(warmup_steps)
        return float(f32(init_value - peak_value) * frac + f32(peak_value))

    return schedule
