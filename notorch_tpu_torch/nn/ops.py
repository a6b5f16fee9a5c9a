"""Segment reductions over the flat layout.

Port of ``notorch_tpu.nn.ops``: the JAX package's ``jax.ops.segment_*``
with a static ``num_segments`` become ``index_add`` and
``scatter_reduce(include_self=False)`` here, with the same semantics: an
empty segment gives 0 for max and min (and for sum and mean), the mean
divides by the element count floored at 1. Segment ids must lie in
``[0, num_segments)``; padding elements carry the id one past the real
range (see :mod:`notorch_tpu_torch.data.graph`), so callers ignore the
trailing "trash" row and need no masks.
"""

from __future__ import annotations

import torch

__all__ = [
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_softmax",
    "segment_reduce",
]


def _expand(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids.long(), data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    totals = segment_sum(data, segment_ids, num_segments)
    ones = torch.ones(segment_ids.shape, dtype=data.dtype, device=data.device)
    counts = segment_sum(ones, segment_ids, num_segments)
    return totals / _expand(counts.clamp_min(1.0), totals)


def _segment_extreme(data, segment_ids, num_segments: int, reduce: str, empty: float) -> torch.Tensor:
    """``scatter_reduce`` over the leading axis; an empty segment reads
    ``empty`` (the reduction's identity)."""
    index = _expand(segment_ids.long(), data).expand_as(data)
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), empty)
    return out.scatter_reduce(0, index, data, reduce, include_self=False)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Max-reduce; empty segments yield 0 (an empty segment is always
    padding here, so 0 keeps downstream math finite)."""
    out = _segment_extreme(data, segment_ids, num_segments, "amax", float("-inf"))
    return torch.where(torch.isneginf(out), 0.0, out)


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    out = _segment_extreme(data, segment_ids, num_segments, "amin", float("inf"))
    return torch.where(torch.isposinf(out), 0.0, out)


def segment_softmax(
    scores: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Numerically stable softmax within each segment. ``mask`` (optional,
    bool over elements) excludes elements from both the max and the
    normalizer; masked elements get weight 0."""
    if mask is not None:
        scores = torch.where(_expand(mask, scores), scores, float("-inf"))
    seg_max = _segment_extreme(scores, segment_ids, num_segments, "amax", float("-inf"))
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    exp = torch.exp(scores - seg_max[segment_ids.long()])
    if mask is not None:
        exp = torch.where(_expand(mask, exp), exp, 0.0)
    denom = segment_sum(exp, segment_ids, num_segments)
    return exp / denom.clamp_min(1e-12)[segment_ids.long()]


_REDUCERS = {
    "sum": segment_sum,
    "mean": segment_mean,
    "max": segment_max,
    "min": segment_min,
}


def segment_reduce(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, reduce: str = "sum"
) -> torch.Tensor:
    """Dispatch on the reduction's name, as the JAX package does."""
    try:
        fn = _REDUCERS[reduce]
    except KeyError:
        raise ValueError(f"unknown reduction {reduce!r}; expected one of {list(_REDUCERS)}") from None
    return fn(data, segment_ids, num_segments)
