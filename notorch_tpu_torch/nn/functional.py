"""Small functional ops.

Port of ``notorch_tpu.nn.functional``: the multilinear inner product (MIP),
the elementwise product over a set of tensors summed over the feature axis;
and ``jax.nn``'s ``sigmoid`` and ``silu`` as XLA computes them on data
below f32 (each step rounded to the dtype), where ``torch.sigmoid`` and
``F.silu`` round once.
"""

from __future__ import annotations

import torch


def multilinear_inner_product(*tensors: torch.Tensor, axis: int = -1) -> torch.Tensor:
    out = tensors[0]
    for t in tensors[1:]:
        out = out * t
    return out.sum(dim=axis)


MIP = multilinear_inner_product


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: below f32 XLA takes ``1 / (1 + exp(-x))`` with each
    step rounded to the dtype."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return one / (one + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``, ``x * sigmoid(x)`` (:func:`sigmoid`'s steps below f32)."""
    if x.dtype == torch.float32:
        return torch.nn.functional.silu(x)
    return x * sigmoid(x)
