"""Initializers with flax's families, drawn from an explicit generator.

The port's modules start from the same distributions as the JAX package's
(``flax.linen`` defaults), not from the same numbers: a ``torch.Generator``
and a JAX key give different draws from one seed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from notorch_tpu_torch.nn.dropout import Dropout
from notorch_tpu_torch.utils import compute_dtype

# std of a unit normal truncated to [-2, 2]; flax divides by it so that the
# truncated draw keeps the requested variance
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator | None = None):
    """``flax.linen.initializers.lecun_normal``: truncated normal with
    variance ``1 / fan_in``, cut at two standard deviations."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return torch.nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Dense(torch.nn.Linear):
    """``nn.Linear`` computing in ``compute`` (float32 or bfloat16) as
    flax's ``Dense(dtype=compute)`` does: the input, the kernel and the bias
    cast to it, the product rounded to it and then the bias add; the
    parameters stay float32 and get their gradients through the casts. At
    float32 it is ``nn.Linear`` itself."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, compute=None, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute = compute_dtype(compute)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute == torch.float32 and x.dtype == torch.float32:
            return super().forward(x)
        dt = self.compute
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


def dense(in_features: int, out_features: int, bias: bool = True, dtype=None) -> Dense:
    """A :class:`Dense` computing in ``dtype`` whose storage is left empty:
    its values come from :func:`reset_dense_`, never from the global RNG."""
    return Dense(in_features, out_features, bias=bias, compute=dtype, device="meta").to_empty(device="cpu")


@torch.no_grad()
def reset_dense_(layer: torch.nn.Linear, generator: torch.Generator | None = None) -> None:
    """``flax.linen.Dense``'s defaults: a lecun-normal kernel and a zero bias."""
    lecun_normal_(layer.weight, layer.in_features, generator)
    if layer.bias is not None:
        layer.bias.zero_()


@torch.no_grad()
def embed_normal_(weight: torch.Tensor, generator: torch.Generator | None = None):
    """``flax.linen.Embed``'s default: normal with variance ``1 / features``
    for a ``[num_embeddings, features]`` table."""
    return weight.normal_(0.0, math.sqrt(1.0 / weight.shape[-1]), generator=generator)


@torch.no_grad()
def reset_module_(module: torch.nn.Module, generator: torch.Generator | None = None) -> None:
    """flax's defaults for every dense layer (lecun-normal kernel, zero
    bias) and LayerNorm (unit scale, zero bias) below ``module``, and the
    mask stream of every :class:`~notorch_tpu_torch.nn.dropout.Dropout`
    (none at rate 0), in declaration order."""
    for m in module.modules():
        if isinstance(m, torch.nn.Linear):
            reset_dense_(m, generator)
        elif isinstance(m, torch.nn.LayerNorm):
            torch.nn.init.ones_(m.weight)
            torch.nn.init.zeros_(m.bias)
        elif isinstance(m, Dropout):
            m.reset_parameters(generator)
