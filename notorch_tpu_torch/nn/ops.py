"""Segment reductions over the flat layout.

Port of ``notorch_tpu.nn.ops``: the JAX package's ``jax.ops.segment_*``
with a static ``num_segments`` become ``index_add`` and
``scatter_reduce(include_self=False)`` here, with the same semantics: an
empty segment gives 0 for max and min (and for sum and mean), the mean
divides by the element count floored at 1. Segment ids must lie in
``[0, num_segments)``; padding elements carry the id one past the real
range (see :mod:`notorch_tpu_torch.data.graph`), so callers ignore the
trailing "trash" row and need no masks.

Every sum of more than one term per output in the port's glue, and every
gather that takes a gradient, goes through :func:`segment_sum` and
:func:`take`, so that a run repeats bit for bit. On the CPU they are
``index_add`` and ``index_select``, whose backwards add each output's terms
in ascending index order (``x[idx]``'s backward adds by float atomics across
threads there). On a CUDA device ``index_add_``, ``index_select``'s backward
and ``torch.gather``'s add by float atomics in no fixed order, so both
functions sum through the row-pointer kernel (TPU kernel row 8, :func:`~
notorch_tpu_torch.kernels.csr_segment.segment_sum_in_order`) over the
stable sort of the ids: each output element is one ascending chain of adds
from zero, the CPU's order, so a sum on the card has the CPU's bits.
``scatter_reduce`` with ``amax``/``amin`` is exact in any order and stays.

bf16 data (a model at ``dtype=bfloat16``) is summed as XLA sums it: from
zero in ascending index order, the running sum rounded to bf16 after every
add (``jax.ops.segment_sum`` of bf16 data, and the VJP of a bf16 gather, are
such scatter-adds; on the CPU the JAX package's results are these bits). So
both functions take the ordered route for bf16 on either device: row 8's
bf16 mode on the card, its plain version
(:func:`~notorch_tpu_torch.kernels.csr_segment.bf16_chain_sum_reference`)
on the CPU, where ``index_add`` would round once.
"""

from __future__ import annotations

import torch

from notorch_tpu_torch.kernels.csr_segment import segment_sum_in_order_reference, sorted_segments, sum_in_order

__all__ = [
    "scalar",
    "take",
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_softmax",
    "segment_reduce",
]


def scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim tensor of ``like``'s dtype on its device: a
    divisor that acts as JAX's weakly typed Python scalar does (rounded to
    the data's dtype, bf16 included) and that the card divides by, where a
    host scalar becomes a multiplication by its reciprocal."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _expand(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


# the sorts of the last few ids summed over on the card, newest first:
# (ids, its version, num_segments, order, row_ptr)
_SORTS: list[tuple] = []
_KEPT_SORTS = 4


def _sorted(ids: torch.Tensor, key: torch.Tensor, num_segments: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``sorted_segments(ids, num_segments)``, taken once while the same
    unchanged ``key`` (the caller's ids tensor) comes back: a step sums over
    one index several times (a readout's sum and count; a segment softmax's
    max, denominator and weighted sum; the flat block's ``src`` and ``rev``
    in every layer)."""
    if key.is_inference():  # such a tensor keeps no version to tell a change by
        return sorted_segments(ids, num_segments)
    for i, (k, version, n, order, row_ptr) in enumerate(_SORTS):
        if k is key and version == key._version and n == num_segments:
            _SORTS.insert(0, _SORTS.pop(i))
            return order, row_ptr
    order, row_ptr = sorted_segments(ids, num_segments)
    _SORTS.insert(0, (key, key._version, num_segments, order, row_ptr))
    del _SORTS[_KEPT_SORTS:]
    return order, row_ptr


def _ordered(data: torch.Tensor) -> bool:
    """Whether sums of ``data`` take the ordered route (the card, or bf16)."""
    return data.is_cuda or data.dtype == torch.bfloat16


def _sum(data: torch.Tensor, order: torch.Tensor, row_ptr: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The ordered sum: row 8 on the card, its plain version on the CPU."""
    if data.is_cuda:
        return sum_in_order(data, order, row_ptr, num_segments)
    return segment_sum_in_order_reference(data, order, row_ptr, num_segments)


class SegmentSumFn(torch.autograd.Function):
    """The ordered segment sum: forward the row-pointer kernel (or its plain
    version) over the stable sort of the ids, backward the gather ``g[ids]``
    (one term an element, so exact in any order)."""

    @staticmethod
    def forward(ctx, data, ids, key, num_segments: int):
        ctx.save_for_backward(ids)
        return _sum(data, *_sorted(ids, key, num_segments), num_segments)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return g.index_select(0, ids), None, None, None


class TakeFn(torch.autograd.Function):
    """The ordered gather: forward ``index_select``, backward the
    row-pointer kernel's segment sum (or its plain version) of the gradient
    over the ids, through the sort order taken in the forward."""

    @staticmethod
    def forward(ctx, x, ids, key):
        order, row_ptr = _sorted(ids, key, x.shape[0])
        ctx.save_for_backward(order, row_ptr)
        return x.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        order, row_ptr = ctx.saved_tensors
        return _sum(g.contiguous(), order, row_ptr, row_ptr.shape[0] - 1), None, None


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[s] = sum of data[i]`` over ``segment_ids[i] == s``, in ascending
    ``i``: ``index_add`` on the CPU, :class:`SegmentSumFn` (row 8) on a CUDA
    device; bf16 data the ordered bf16 chain on either (see the module
    docstring)."""
    ids = segment_ids.long()
    if _ordered(data):
        if torch.is_grad_enabled() and data.requires_grad:
            return SegmentSumFn.apply(data, ids, segment_ids, num_segments)
        return _sum(data, *_sorted(ids, segment_ids, num_segments), num_segments)
    return data.new_zeros((num_segments,) + tuple(data.shape[1:])).index_add(0, ids, data)


def take(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``x[ids]`` along the leading axis: ``[N, ...]`` x ``ids [...]`` ->
    ``[*ids.shape, ...]``. ``index_select``; its backward sums each row's
    terms in ascending order (on a CUDA device or for bf16, where a
    gradient is taken, through :class:`TakeFn`)."""
    flat = ids.reshape(-1).long()
    if _ordered(x) and torch.is_grad_enabled() and x.requires_grad:
        out = TakeFn.apply(x, flat, ids)
    else:
        out = x.index_select(0, flat)
    return out.reshape(*ids.shape, *x.shape[1:])


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
    exp = torch.exp(scores - take(seg_max, segment_ids))
    if mask is not None:
        exp = torch.where(_expand(mask, exp), exp, 0.0)
    denom = segment_sum(exp, segment_ids, num_segments)
    return exp / take(denom.clamp_min(1e-12), segment_ids)


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
