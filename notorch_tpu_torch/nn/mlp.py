"""Configurable MLP head: ``[Dense, act] * L`` then ``Dense``, with dropout
ahead of every dense layer but the first, and an optional unflatten of the
output (e.g. ``[t, 2]`` heads). Port of ``notorch_tpu.nn.mlp.MLP``; the
layers are named ``dense_{i}`` as there, and the dropout is the port's
:class:`~notorch_tpu_torch.nn.dropout.Dropout` (flax's semantics, masks from
the module's own generator). ``dtype`` is the layers' compute dtype (f32
parameters), as the JAX ``MLP(dtype=...)``'s."""

from __future__ import annotations

from collections.abc import Sequence
from math import prod

import torch
from torch import nn

from notorch_tpu_torch.conf import DEFAULT_HIDDEN_DIM
from notorch_tpu_torch.nn.dropout import Dropout
from notorch_tpu_torch.nn.init import dense, reset_dense_


class MLP(nn.Module):
    def __init__(
        self,
        input_dim: int,
        output_size: int | Sequence[int] = 1,
        hidden_dim: int = DEFAULT_HIDDEN_DIM,
        num_layers: int = 1,
        dropout: float = 0.0,
        dtype=None,
    ):
        super().__init__()
        if isinstance(output_size, int):
            output_dim, self.unflatten = output_size, None
        else:
            output_dim, self.unflatten = prod(output_size), tuple(output_size)
        dims = [input_dim] + [hidden_dim] * num_layers + [output_dim]
        for i in range(len(dims) - 1):
            self.add_module(f"dense_{i}", dense(dims[i], dims[i + 1], dtype=dtype))
        self.n_layers = len(dims) - 1
        self.dropout = Dropout(dropout)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for i in range(self.n_layers):
            reset_dense_(getattr(self, f"dense_{i}"), generator)
        self.dropout.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n_layers):
            if i > 0:
                h = self.dropout(torch.relu(h))
            h = getattr(self, f"dense_{i}")(h)
        if self.unflatten is not None:
            h = h.reshape(h.shape[:-1] + self.unflatten)
        return h
