"""Task-side output/target transforms on tensors.

Port of ``notorch_tpu.tasks.transforms``: the affine Normalize/
InverseNormalize pair computed from *training* target statistics, the
MVE/Evidential denormalizers, Dirichlet alpha -> (probs, uncertainty), the
Sigmoid and Softmax of the classification heads, ``build(task_type,
values)``, and the JSON records of :func:`serialize` / :func:`deserialize`,
which are the same as the JAX package's so that one ``predict_meta.json``
reads the same in both.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

TASK_TYPES = ("regression", "classification", "multiclass", "mve", "evidential", "dirichlet")


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


@dataclass(frozen=True)
class MVE:
    """Denormalize (mean, var) heads: mean affine, var by scale^2."""

    loc: tuple
    scale: tuple

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        loc, scale = _vec(self.loc, x), _vec(self.scale, x)
        return torch.stack([x[..., 0] * scale + loc, x[..., 1] * scale**2], dim=-1)


@dataclass(frozen=True)
class Evidential:
    """Activate + denormalize (mean, var, alpha, beta) evidential heads."""

    loc: tuple
    scale: tuple

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        loc, scale = _vec(self.loc, x), _vec(self.scale, x)
        mean, var, alpha, beta = x.unbind(-1)
        return torch.stack([mean * scale + loc, F.softplus(var) * scale**2, F.softplus(alpha) + 1,
                            F.softplus(beta)], dim=-1)


@dataclass(frozen=True)
class Dirichlet:
    """alpha -> per-class probabilities plus the k/S uncertainty channel."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        alpha = F.softplus(x) + 1
        S = alpha.sum(-1, keepdim=True)
        return torch.cat([alpha / S, x.shape[-1] / S], dim=-1)


@dataclass(frozen=True)
class Sigmoid:
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(x)


@dataclass(frozen=True)
class Softmax:
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(x, dim=-1)


def build(task_type: str | None, values: np.ndarray) -> dict[str, Callable | None]:
    """Compute per-target transforms from training-target statistics.

    ``values``: [n, t] training targets (may contain NaN for missing entries —
    statistics are computed with nan-aware reductions)."""
    if task_type is None:
        return {"preds": None, "targets": None}
    if task_type in ("regression", "mve", "evidential"):
        values = np.asarray(values, dtype=np.float64)
        mean = tuple(np.nanmean(values, axis=0).astype(np.float32).tolist())
        std_arr = np.nanstd(values, axis=0, ddof=1)
        std = tuple(np.where(std_arr > 0, std_arr, 1.0).astype(np.float32).tolist())
        preds = {"regression": InverseNormalize, "mve": MVE, "evidential": Evidential}[task_type](mean, std)
        return {"preds": preds, "targets": Normalize(mean, std)}
    if task_type == "classification":
        return {"preds": Sigmoid(), "targets": None}
    if task_type == "multiclass":
        return {"preds": Softmax(), "targets": None}
    if task_type == "dirichlet":
        return {"preds": Dirichlet(), "targets": None}
    raise ValueError(f"invalid task type {task_type!r}; expected one of {TASK_TYPES}")


_TRANSFORM_CLASSES = {
    cls.__name__: cls for cls in (Normalize, InverseNormalize, MVE, Evidential, Dirichlet, Sigmoid, Softmax)
}


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
    if kind not in _TRANSFORM_CLASSES:
        raise ValueError(f"unknown task transform {kind!r}")
    return _TRANSFORM_CLASSES[kind](**{k: tuple(v) for k, v in rec.items()})
