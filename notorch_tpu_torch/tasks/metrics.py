"""Evaluation metrics: device-side masked metrics on tensors and host-side
ranking metrics on numpy.

Port of ``notorch_tpu.tasks.metrics``: ``MAE``, ``RMSE``, their bounded
variants, ``R2`` and ``Accuracy`` on
:func:`~notorch_tpu_torch.tasks.losses.masked_reduce`, and the host
functions ``auroc``, ``auprc`` and ``f1_score`` behind ``AUROC``,
``AUPRC`` and ``F1``. The host functions are plain numpy, kept here as the
port's own copy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from notorch_tpu_torch.tasks.losses import _apply_bounds, masked_reduce

__all__ = [
    "MAE",
    "RMSE",
    "BoundedMAE",
    "BoundedRMSE",
    "R2",
    "Accuracy",
    "auroc",
    "auprc",
    "f1_score",
    "AUROC",
    "AUPRC",
    "F1",
]


# -- device-side (tensors, maskable) -----------------------------------------


@dataclass(frozen=True)
class MAE:
    def __call__(self, preds, targets, *, mask=None, sample_weights=None, **kw):
        return masked_reduce((preds - targets).abs(), mask, sample_weights)


@dataclass(frozen=True)
class RMSE:
    def __call__(self, preds, targets, *, mask=None, sample_weights=None, **kw):
        return masked_reduce((preds - targets) ** 2, mask, sample_weights).sqrt()


@dataclass(frozen=True)
class BoundedMAE:
    def __call__(self, preds, targets, *, lt_mask, gt_mask, mask=None, sample_weights=None, **kw):
        preds = _apply_bounds(preds, targets, lt_mask, gt_mask)
        return masked_reduce((preds - targets).abs(), mask, sample_weights)


@dataclass(frozen=True)
class BoundedRMSE:
    def __call__(self, preds, targets, *, lt_mask, gt_mask, mask=None, sample_weights=None, **kw):
        preds = _apply_bounds(preds, targets, lt_mask, gt_mask)
        return masked_reduce((preds - targets) ** 2, mask, sample_weights).sqrt()


@dataclass(frozen=True)
class R2:
    """Coefficient of determination per target, averaged."""

    def __call__(self, preds, targets, *, mask=None, sample_weights=None, **kw):
        if mask is None:
            mask = torch.ones_like(targets, dtype=torch.bool)
        w = mask.to(preds.dtype)
        if sample_weights is not None:
            w = w * sample_weights[:, None]
        wsum = w.sum(0).clamp_min(1e-12)
        target_mean = (w * targets).sum(0) / wsum
        rss = (w * (preds - targets) ** 2).sum(0)
        tss = (w * (targets - target_mean) ** 2).sum(0)
        return (1 - rss / tss.clamp_min(1e-12)).mean()


@dataclass(frozen=True)
class Accuracy:
    task: str = "binary"
    threshold: float = 0.5

    def __call__(self, preds, targets, *, mask=None, sample_weights=None, **kw):
        if self.task == "binary":
            hard = (preds > self.threshold).to(preds.dtype)
        else:
            hard = preds.argmax(-1).to(preds.dtype)
        return masked_reduce((hard == targets).to(preds.dtype), mask, sample_weights)


# -- host-side ranking metrics (numpy) ---------------------------------------


def _as_masked_columns(preds, targets, mask):
    preds = np.asarray(preds, dtype=np.float64)
    targets = np.asarray(targets)
    if preds.ndim == 1:
        preds, targets = preds[:, None], targets[:, None]
        mask = None if mask is None else np.asarray(mask)[:, None]
    if mask is None:
        mask = ~np.isnan(np.asarray(targets, dtype=np.float64))
    return preds, targets, np.asarray(mask, dtype=bool)


def _binary_auroc(scores: np.ndarray, labels: np.ndarray) -> float:
    pos = scores[labels == 1]
    neg = scores[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    # Mann-Whitney U with tie correction via average ranks
    all_scores = np.concatenate([pos, neg])
    order = np.argsort(all_scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(all_scores) + 1)
    sorted_scores = all_scores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = ranks[order[i : j + 1]].mean()
        i = j + 1
    r_pos = ranks[: len(pos)].sum()
    n_p, n_n = len(pos), len(neg)
    return float((r_pos - n_p * (n_p + 1) / 2) / (n_p * n_n))


def _binary_auprc(scores: np.ndarray, labels: np.ndarray) -> float:
    if labels.sum() == 0:
        return float("nan")
    order = np.argsort(-scores, kind="mergesort")
    labels = labels[order]
    tp = np.cumsum(labels)
    precision = tp / np.arange(1, len(labels) + 1)
    # average precision: the precision at each positive hit
    return float((precision * labels).sum() / labels.sum())


def _per_column(score, preds, targets, mask) -> float:
    """The mean over columns of ``score(preds, int labels)`` on each
    column's masked rows; columns with no rows or a NaN score are left out."""
    preds, targets, mask = _as_masked_columns(preds, targets, mask)
    vals = []
    for t in range(preds.shape[1]):
        m = mask[:, t]
        if m.sum() == 0:
            continue
        v = score(preds[m, t], np.asarray(targets[m, t], dtype=np.int64))
        if not np.isnan(v):
            vals.append(v)
    return float(np.mean(vals)) if vals else float("nan")


def auroc(preds, targets, *, mask=None, task: str = "binary") -> float:
    """Masked multilabel/binary AUROC, macro-averaged over targets."""
    return _per_column(_binary_auroc, preds, targets, mask)


def auprc(preds, targets, *, mask=None, task: str = "binary") -> float:
    """Masked multilabel/binary average precision, macro-averaged."""
    return _per_column(_binary_auprc, preds, targets, mask)


def f1_score(preds, targets, *, mask=None, threshold: float = 0.5, task: str = "binary") -> float:
    def f1(scores, y):
        hard = scores > threshold
        tp = float((hard & (y == 1)).sum())
        fp = float((hard & (y == 0)).sum())
        fn = float((~hard & (y == 1)).sum())
        denom = 2 * tp + fp + fn
        return 2 * tp / denom if denom > 0 else 0.0

    return _per_column(f1, preds, targets, mask)


@dataclass(frozen=True)
class AUROC:
    task: str = "binary"

    def __call__(self, preds, targets, *, mask=None, **kw):
        return auroc(preds, targets, mask=mask, task=self.task)


@dataclass(frozen=True)
class AUPRC:
    task: str = "binary"

    def __call__(self, preds, targets, *, mask=None, **kw):
        return auprc(preds, targets, mask=mask, task=self.task)


@dataclass(frozen=True)
class F1:
    task: str = "binary"
    threshold: float = 0.5

    def __call__(self, preds, targets, *, mask=None, **kw):
        return f1_score(preds, targets, mask=mask, threshold=self.threshold, task=self.task)
