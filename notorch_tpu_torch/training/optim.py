"""Optimizers: what a config's ``optimizer`` section asks for, built into a
``torch.optim`` optimizer once the parameters exist.

The JAX package builds an optax transformation (``notorch_tpu.cli.train.
build_optimizer``); the port matches its updates:

- ``adam`` and ``adamw`` with optax's defaults (betas 0.9/0.999, eps 1e-8;
  adamw's decoupled weight decay 1e-4);
- ``sgd`` as ``optax.sgd(lr)``: ``p - lr * g``, no momentum;
- a schedule is a function of the update count; ``LambdaLR`` over a base
  rate of 1 makes the rate of every update the schedule's value, and the
  first update uses ``schedule(0)``, as optax evaluates its schedule at the
  count before it increments;
- ``clip_norm`` is optax's ``clip_by_global_norm``: the gradients are scaled
  by ``max_norm / norm`` only when ``norm >= max_norm``, with no ``+1e-6``
  (``torch.nn.utils.clip_grad_norm_`` adds one, so the clip is written here).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

import torch

NAMES = ("adam", "adamw", "sgd")
ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default


@dataclass(frozen=True)
class OptimizerSpec:
    name: str = "adam"
    lr: float | Callable[[int], float] = 1e-4
    clip_norm: float | None = None

    def __post_init__(self):
        if self.name not in NAMES:
            raise ValueError(f"unknown optimizer {self.name!r}; options: {list(NAMES)}")

    def build(self, params: Iterable[torch.nn.Parameter]):
        """``(optimizer, scheduler)``; the scheduler is ``None`` for a
        constant rate."""
        params = list(params)
        schedule = self.lr if callable(self.lr) else None
        lr = 1.0 if schedule is not None else float(self.lr)
        if self.name == "adam":
            opt = torch.optim.Adam(params, lr=lr)
        elif self.name == "sgd":
            opt = torch.optim.SGD(params, lr=lr)
        else:
            opt = torch.optim.AdamW(params, lr=lr, weight_decay=ADAMW_WEIGHT_DECAY)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, schedule) if schedule is not None else None
        return opt, sched


def clip_by_global_norm_(params: Iterable[torch.nn.Parameter], max_norm: float) -> torch.Tensor:
    """Scale the gradients in place as optax's ``clip_by_global_norm``
    does: ``g / norm * max_norm`` where the global norm is not below
    ``max_norm``. Stays on the device (no host sync). Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm
