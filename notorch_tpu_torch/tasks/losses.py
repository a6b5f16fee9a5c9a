"""Loss functions as maskable torch callables.

Port of ``notorch_tpu.tasks.losses``. Every loss takes ``(preds, targets,
*, mask, sample_weights)`` and returns a scalar through
:func:`masked_reduce`: masked elements contribute nothing and the
normalizer is the (weighted) mask sum, which makes batch padding free.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

__all__ = [
    "masked_reduce",
    "SelfSupervisedLoss",
    "MSE",
    "BoundedMSE",
    "MAE",
    "BoundedMAE",
    "MVE",
    "MeanVarianceEstimation",
    "Evidential",
    "BinaryCrossEntropy",
    "BCE",
    "CrossEntropy",
    "XENT",
    "Dirichlet",
    "BinaryMCCLoss",
    "MulticlassMCCLoss",
    "SID",
    "Wasserstein",
    "PNorm",
    "RankNContrastLoss",
]


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
class SelfSupervisedLoss:
    """Pass-through for scalar self-supervised/auxiliary loss terms."""

    def __call__(self, inputs, **kwargs):
        return torch.as_tensor(inputs).reshape(())


def _apply_bounds(preds, targets, lt_mask, gt_mask):
    """Censored-regression clamping: inside the bound the error is zeroed."""
    preds = torch.where((preds < targets) & lt_mask, targets, preds)
    return torch.where((preds > targets) & gt_mask, targets, preds)


@dataclass(frozen=True)
class MSE:
    def __call__(self, preds, targets, *, mask=None, sample_weights=None, **kw):
        return masked_reduce((preds - targets) ** 2, mask, sample_weights)


@dataclass(frozen=True)
class MAE:
    def __call__(self, preds, targets, *, mask=None, sample_weights=None, **kw):
        return masked_reduce((preds - targets).abs(), mask, sample_weights)


@dataclass(frozen=True)
class BoundedMSE:
    def __call__(self, preds, targets, *, lt_mask, gt_mask, mask=None, sample_weights=None, **kw):
        preds = _apply_bounds(preds, targets, lt_mask, gt_mask)
        return masked_reduce((preds - targets) ** 2, mask, sample_weights)


@dataclass(frozen=True)
class BoundedMAE:
    def __call__(self, preds, targets, *, lt_mask, gt_mask, mask=None, sample_weights=None, **kw):
        preds = _apply_bounds(preds, targets, lt_mask, gt_mask)
        return masked_reduce((preds - targets).abs(), mask, sample_weights)


@dataclass(frozen=True)
class MeanVarianceEstimation:
    """Gaussian NLL of Nix & Weigend (1994), Eq. 9. ``preds``: [b, t, 2]
    (mean, var)."""

    eps: float = 1e-8

    def __call__(self, preds, targets, *, mask=None, sample_weights=None, **kw):
        mean, var = preds[..., 0], preds[..., 1].clamp_min(self.eps)
        nll = (mean - targets) ** 2 / (2 * var)
        kl = torch.log(2 * math.pi * var) / 2
        return masked_reduce(nll + kl, mask, sample_weights)


@dataclass(frozen=True)
class Evidential:
    """Deep evidential regression (Soleimany et al. 2021). ``preds``:
    [b, t, 4] raw (mean, v, alpha, beta) heads, through the positivity
    transforms the preds-side ``Evidential`` transform uses at inference."""

    v_kl: float = 0.2
    eps: float = 1e-8

    def __call__(self, preds, targets, *, mask=None, sample_weights=None, **kw):
        mean, v, alpha, beta = preds.unbind(-1)
        v = F.softplus(v) + self.eps
        alpha = F.softplus(alpha) + 1
        beta = F.softplus(beta) + self.eps
        residuals = targets - mean
        two_b_lambda = 2 * beta * (1 + v)
        nll = (
            0.5 * torch.log(math.pi / v)
            - alpha * torch.log(two_b_lambda)
            + (alpha + 0.5) * torch.log(v * residuals**2 + two_b_lambda)
            + torch.lgamma(alpha)
            - torch.lgamma(alpha + 0.5)
        )
        reg = (2 * v + alpha) * residuals.abs()
        return masked_reduce(nll + self.v_kl * (reg - self.eps), mask, sample_weights)


@dataclass(frozen=True)
class BinaryCrossEntropy:
    """BCE with logits."""

    def __call__(self, preds, targets, *, mask=None, sample_weights=None, **kw):
        # numerically stable log-sigmoid formulation
        L = preds.clamp_min(0) - preds * targets + torch.log1p(torch.exp(-preds.abs()))
        return masked_reduce(L, mask, sample_weights)


@dataclass(frozen=True)
class CrossEntropy:
    """Softmax cross-entropy over the trailing class axis of ``preds``
    [b, t, k] against integer ``targets`` [b, t]."""

    def __call__(self, preds, targets, *, mask=None, sample_weights=None, **kw):
        logp = torch.log_softmax(preds, dim=-1)
        tgt = targets.to(torch.int64)
        L = -torch.gather(logp, -1, tgt.unsqueeze(-1)).squeeze(-1)
        return masked_reduce(L, mask, sample_weights)


def _one_hot(targets: torch.Tensor, k: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an id outside ``[0, k)`` gives a row of zeros."""
    return (targets.to(torch.int64).unsqueeze(-1) == torch.arange(k, device=targets.device)).to(dtype)


@dataclass(frozen=True)
class Dirichlet:
    """Evidential Dirichlet classification loss (Sensoy et al. 2018).
    ``preds``: [b, t, k] pre-evidence logits."""

    v_kl: float = 0.2
    num_classes: int = 2

    def __call__(self, preds, targets, *, mask=None, sample_weights=None, **kw):
        alphas = F.softplus(preds) + 1
        onehot = _one_hot(targets, alphas.shape[-1], alphas.dtype)

        S = alphas.sum(-1, keepdim=True)
        probs = alphas / S
        A = ((onehot - probs) ** 2).sum(-1)
        B = (probs * (1 - probs) / (S + 1)).sum(-1)
        L_mse = A + B

        alpha_tilde = onehot + (1 - onehot) * alphas
        beta = torch.ones_like(alpha_tilde)
        S_alpha = alpha_tilde.sum(-1)
        S_beta = beta.sum(-1)
        ln_alpha = torch.lgamma(S_alpha) - torch.lgamma(alpha_tilde).sum(-1)
        ln_beta = torch.lgamma(beta).sum(-1) - torch.lgamma(S_beta)
        dg0 = torch.digamma(alpha_tilde)
        dg1 = torch.digamma(S_alpha).unsqueeze(-1)
        L_kl = ln_alpha + ln_beta + ((alpha_tilde - beta) * (dg0 - dg1)).sum(-1)

        return masked_reduce(L_mse + self.v_kl * L_kl, mask, sample_weights)


@dataclass(frozen=True)
class BinaryMCCLoss:
    """Soft Matthews-correlation loss for (multitask) binary classification:
    ``1 - MCC`` from soft confusion counts, per task, mean over tasks.
    ``from_logits`` is a static flag (no data-dependent branch)."""

    from_logits: bool = True
    eps: float = 1e-8

    def __call__(self, preds, targets, *, mask=None, sample_weights=None, task_weights=None, **kw):
        p = torch.sigmoid(preds) if self.from_logits else preds
        y = targets.to(p.dtype)
        w = torch.ones_like(p)
        if mask is not None:
            w = w * mask.to(p.dtype)
        if sample_weights is not None:
            w = w * sample_weights[:, None]
        TP = (y * p * w).sum(0)
        FP = ((1 - y) * p * w).sum(0)
        TN = ((1 - y) * (1 - p) * w).sum(0)
        FN = (y * (1 - p) * w).sum(0)
        denom = torch.sqrt((TP + FP) * (TP + FN) * (TN + FP) * (TN + FN))
        mcc = (TP * TN - FP * FN) / denom.clamp_min(self.eps)
        L = 1 - mcc
        if task_weights is not None:
            L = L * task_weights
        return L.mean()


@dataclass(frozen=True)
class MulticlassMCCLoss:
    """Multiclass MCC loss (sklearn's covariance form), ``1 - MCC``.
    ``preds``: [b, t, k] probabilities (or logits with ``from_logits``);
    ``targets``: [b, t] int class ids. The hard-argmax confusion counts make
    this a training signal mostly through the ``s`` term."""

    from_logits: bool = True
    eps: float = 1e-12

    def __call__(self, preds, targets, *, mask=None, sample_weights=None, task_weights=None, **kw):
        p = torch.softmax(preds, dim=-1) if self.from_logits else preds
        k = p.shape[-1]
        bin_t = _one_hot(targets, k, p.dtype)
        bin_p = _one_hot(p.argmax(-1), k, p.dtype)
        w = torch.ones(p.shape[:2], dtype=p.dtype, device=p.device)
        if mask is not None:
            w = w * mask.to(p.dtype)
        if sample_weights is not None:
            w = w * sample_weights[:, None]
        w = w.unsqueeze(-1)
        pc = (bin_p * w).sum(0)  # [t, k]
        tc = (bin_t * w).sum(0)
        c = (bin_p * bin_t * w).sum()
        s = (p * w).sum()
        cov_ytyp = c * s - (pc * tc).sum()
        cov_ypyp = s * s - (pc * pc).sum()
        cov_ytyt = s * s - (tc * tc).sum()
        x = cov_ypyp * cov_ytyt
        mcc = torch.where(x <= self.eps, torch.zeros_like(x), cov_ytyp / torch.sqrt(x.clamp_min(self.eps)))
        L = 1 - mcc
        if task_weights is not None:
            L = L * torch.as_tensor(task_weights, dtype=p.dtype, device=p.device).mean()
        return L


@dataclass(frozen=True)
class SID:
    """Spectral information divergence for spectra-valued targets: symmetric
    KL between the (mask-)normalized predicted spectrum and the target.
    ``preds``/``targets``: [b, s] nonnegative spectra; masked bins are
    filled with 1 so they contribute ``log(1) * 1 = 0``."""

    threshold: float | None = None

    def __call__(self, preds, targets, *, mask=None, sample_weights=None, **kw):
        if self.threshold is not None:
            preds = preds.clamp_min(self.threshold)
        m = torch.ones_like(preds, dtype=torch.bool) if mask is None else mask.to(torch.bool)
        preds_norm = preds / (preds * m.to(preds.dtype)).sum(1, keepdim=True)
        one = torch.ones((), dtype=preds.dtype, device=preds.device)
        t = torch.where(m, targets, one)
        pn = torch.where(m, preds_norm, one)
        L = torch.log(pn / t) * pn + torch.log(t / pn) * t
        return masked_reduce(L, mask, sample_weights)


@dataclass(frozen=True)
class Wasserstein:
    """Earth-mover distance between cumulative spectra."""

    threshold: float | None = None

    def __call__(self, preds, targets, *, mask=None, sample_weights=None, **kw):
        if self.threshold is not None:
            preds = preds.clamp_min(self.threshold)
        mf = torch.ones_like(preds) if mask is None else mask.to(preds.dtype)
        preds_norm = preds / (preds * mf).sum(1, keepdim=True)
        L = (torch.cumsum(targets, dim=1) - torch.cumsum(preds_norm, dim=1)).abs()
        return masked_reduce(L, mask, sample_weights)


# reference-compatible aliases
MVE = MeanVarianceEstimation
BCE = BinaryCrossEntropy
XENT = CrossEntropy


def _cdist(A, B, p: float):
    diff = (A.unsqueeze(-2) - B.unsqueeze(-3)).abs()
    if p == 1.0:
        return diff.sum(-1)
    if p == 2.0:
        return torch.sqrt((diff**2).sum(-1).clamp_min(1e-12))
    return (diff**p).sum(-1) ** (1.0 / p)


@dataclass(frozen=True)
class PNorm:
    p: float = 2.0
    negate: bool = False

    def __call__(self, A, B=None):
        X = _cdist(A, A if B is None else B, self.p)
        return -X if self.negate else X


@dataclass(frozen=True)
class RankNContrastLoss:
    """Rank-N-Contrast regression-contrastive loss: for each anchor i and
    positive j, the normalizer runs over the samples k whose label-distance
    to i is at least that of j."""

    distance: PNorm = field(default_factory=lambda: PNorm(p=1.0))
    similarity: PNorm = field(default_factory=lambda: PNorm(p=2.0, negate=True))
    temp: float = 2.0
    eps: float = 1e-6

    def __call__(self, inputs, targets, *, mask=None, sample_weights=None, **kw):
        N = targets.shape[0]
        dists = self.distance(targets)  # [N, N]
        sims = self.similarity(inputs) / self.temp  # [N, N]
        scores = torch.exp(sims)

        off_diag = ~torch.eye(N, dtype=torch.bool, device=targets.device)
        # include[i, j, k] where d(i, k) >= d(i, j), k != i
        include = (dists[:, None, :] >= dists[:, :, None]) & off_diag[:, None, :]
        denom = (scores[:, None, :] * include).sum(-1) + self.eps  # [N, N]
        nll = -(sims - torch.log(denom))
        return (nll * off_diag).sum() / off_diag.sum().clamp_min(1)
