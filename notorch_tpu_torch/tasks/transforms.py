"""Task-side output/target transforms on tensors.

Port of ``notorch_tpu.tasks.transforms`` for regression: the affine
Normalize/InverseNormalize pair computed from *training* target statistics,
``build(task_type, values)``, and the JSON records of :func:`serialize` /
:func:`deserialize`, which are the same as the JAX package's so that one
``predict_meta.json`` reads the same in both.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

TASK_TYPES = ("regression", "classification", "multiclass", "mve", "evidential", "dirichlet")

# transforms of the other task types, named so that their records are
# recognised and refused with a clear message until their slice lands
_NOT_PORTED = ("MVE", "Evidential", "Dirichlet", "Sigmoid", "Softmax")


def _vec(values: tuple, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=like.device)


@dataclass(frozen=True)
class Normalize:
    loc: tuple
    scale: tuple

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return (x - _vec(self.loc, x)) / _vec(self.scale, x)


@dataclass(frozen=True)
class InverseNormalize:
    loc: tuple
    scale: tuple

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x * _vec(self.scale, x) + _vec(self.loc, x)


def build(task_type: str | None, values: np.ndarray) -> dict[str, Callable | None]:
    """Compute per-target transforms from training-target statistics.

    ``values``: [n, t] training targets (may contain NaN for missing entries —
    statistics are computed with nan-aware reductions)."""
    if task_type is None:
        return {"preds": None, "targets": None}
    if task_type == "regression":
        values = np.asarray(values, dtype=np.float64)
        mean = tuple(np.nanmean(values, axis=0).astype(np.float32).tolist())
        std_arr = np.nanstd(values, axis=0, ddof=1)
        std = tuple(np.where(std_arr > 0, std_arr, 1.0).astype(np.float32).tolist())
        return {"preds": InverseNormalize(mean, std), "targets": Normalize(mean, std)}
    if task_type in TASK_TYPES:
        raise NotImplementedError(
            f"task type {task_type!r} is not ported yet; only regression is"
        )
    raise ValueError(f"invalid task type {task_type!r}; expected one of {TASK_TYPES}")


_TRANSFORM_CLASSES = {cls.__name__: cls for cls in (Normalize, InverseNormalize)}


def serialize(transform) -> dict | None:
    """JSON-able record of a task transform (for predict-from-checkpoint)."""
    if transform is None:
        return None
    name = type(transform).__name__
    if name not in _TRANSFORM_CLASSES:
        raise TypeError(f"cannot serialize task transform {name!r}")
    rec = {"kind": name}
    for f in dataclasses.fields(transform):
        rec[f.name] = list(getattr(transform, f.name))
    return rec


def deserialize(rec: dict | None):
    """Inverse of :func:`serialize`."""
    if rec is None:
        return None
    rec = dict(rec)
    kind = rec.pop("kind")
    if kind in _NOT_PORTED:
        raise NotImplementedError(f"task transform {kind!r} is not ported yet")
    if kind not in _TRANSFORM_CLASSES:
        raise ValueError(f"unknown task transform {kind!r}")
    return _TRANSFORM_CLASSES[kind](**{k: tuple(v) for k, v in rec.items()})
