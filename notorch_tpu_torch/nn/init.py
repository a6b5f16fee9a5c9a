"""Initializers with flax's families, drawn from an explicit generator.

The port's modules start from the same distributions as the JAX package's
(``flax.linen`` defaults), not from the same numbers: a ``torch.Generator``
and a JAX key give different draws from one seed.
"""

from __future__ import annotations

import math

import torch

from notorch_tpu_torch.nn.dropout import Dropout

# std of a unit normal truncated to [-2, 2]; flax divides by it so that the
# truncated draw keeps the requested variance
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator | None = None):
    """``flax.linen.initializers.lecun_normal``: truncated normal with
    variance ``1 / fan_in``, cut at two standard deviations."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return torch.nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def dense(in_features: int, out_features: int, bias: bool = True) -> torch.nn.Linear:
    """An ``nn.Linear`` whose storage is left empty: its values come from
    :func:`reset_dense_`, never from the global RNG."""
    return torch.nn.Linear(in_features, out_features, bias=bias, device="meta").to_empty(device="cpu")


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
