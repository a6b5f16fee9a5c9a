"""Device-side masked metrics.

Port of the regression metrics of ``notorch_tpu.tasks.metrics`` (``MAE``,
``RMSE``), on :func:`~notorch_tpu_torch.tasks.losses.masked_reduce`. The
host-side ranking metrics (AUROC, AUPRC, F1) come with classification.
"""

from __future__ import annotations

from dataclasses import dataclass

from notorch_tpu_torch.tasks.losses import masked_reduce

__all__ = ["MAE", "RMSE"]


@dataclass(frozen=True)
class MAE:
    def __call__(self, preds, targets, *, mask=None, sample_weights=None, **kw):
        return masked_reduce((preds - targets).abs(), mask, sample_weights)


@dataclass(frozen=True)
class RMSE:
    def __call__(self, preds, targets, *, mask=None, sample_weights=None, **kw):
        return masked_reduce((preds - targets) ** 2, mask, sample_weights).sqrt()
