"""Loss functions as maskable torch callables.

Port of the regression losses of ``notorch_tpu.tasks.losses``. Every loss
takes ``(preds, targets, *, mask, sample_weights)`` and returns a scalar
through :func:`masked_reduce`: masked elements contribute nothing and the
normalizer is the (weighted) mask sum, which makes batch padding free. The
other losses come with the other task types (``ROADMAP.md`` queue A).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["masked_reduce", "MSE", "MAE"]


def masked_reduce(loss: torch.Tensor, mask=None, sample_weights=None) -> torch.Tensor:
    """Masked, sample-weighted MEAN of an elementwise loss.

    The result is a true weighted mean, ``sum(w * m * loss) / sum(w * m)``:
    the normalizer includes the sample weights, with and without a mask, so
    weights re-weight samples rather than re-scale the loss (the semantics
    the JAX package pins; the reference's ``_reduce``, which normalizes by
    the element count, is deliberately not matched). ``sample_weights`` is
    per-sample ``[B]``, broadcast over trailing task dims.
    """
    if mask is None and sample_weights is None:
        return loss.mean()
    w = torch.ones_like(loss) if mask is None else mask.to(loss.dtype).expand_as(loss)
    if sample_weights is not None:
        sw = sample_weights.reshape(sample_weights.shape + (1,) * (loss.dim() - 1))
        w = w * sw.to(loss.dtype)
    return (loss * w).sum() / w.sum().clamp_min(1e-9)


@dataclass(frozen=True)
class MSE:
    def __call__(self, preds, targets, *, mask=None, sample_weights=None, **kw):
        return masked_reduce((preds - targets) ** 2, mask, sample_weights)


@dataclass(frozen=True)
class MAE:
    def __call__(self, preds, targets, *, mask=None, sample_weights=None, **kw):
        return masked_reduce((preds - targets).abs(), mask, sample_weights)
