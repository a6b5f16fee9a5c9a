"""PaiNN's gated equivariant block.

Port of ``notorch_tpu.nn.spatial.painn`` (arXiv:2102.03150): two channel
mixings of the vectors (``W_1``, ``W_2``, no bias, over the vector axis),
a scalar MLP (``mlp_0``, ``act``, ``mlp_1``) over the scalars beside the
norms of the first mixing, whose output splits into the scalar update and
a gate that scales the second mixing. Rotation-equivariant in the vectors.

flax infers the input widths at the first call; the port is told them:
``in_scalar`` and ``in_vector`` (default ``scalar_dim`` and
``vector_dim``). ``dtype`` is every dense layer's compute dtype, as
flax's ``Dense(dtype=...)``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from notorch_tpu_torch.nn.functional import silu
from notorch_tpu_torch.nn.init import dense, reset_module_

EPS = 1e-8


class GatedEquivariantBlock(nn.Module):
    def __init__(self, scalar_dim: int, vector_dim: int, act: Callable = silu, dtype=None,
                 in_scalar: int | None = None, in_vector: int | None = None):
        super().__init__()
        self.scalar_dim, self.vector_dim, self.act = scalar_dim, vector_dim, act
        in_v = in_vector or vector_dim
        self.W_1 = dense(in_v, vector_dim, bias=False, dtype=dtype)
        self.W_2 = dense(in_v, vector_dim, bias=False, dtype=dtype)
        self.mlp_0 = dense((in_scalar or scalar_dim) + vector_dim, scalar_dim + vector_dim, dtype=dtype)
        self.mlp_1 = dense(scalar_dim + vector_dim, scalar_dim + vector_dim, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        reset_module_(self, generator)

    def forward(self, sv: tuple[torch.Tensor, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        s, v = sv  # [N, ds], [N, 3, dv]
        w1, w2 = self.W_1(v), self.W_2(v)
        norms = torch.sqrt((w1**2).sum(dim=-2) + EPS)  # [N, dv]
        h = self.mlp_1(self.act(self.mlp_0(torch.cat([s, norms], dim=-1))))
        s_out, gate = h[..., : self.scalar_dim], h[..., self.scalar_dim:]
        return s_out, w2 * gate[..., None, :]


GEB = GatedEquivariantBlock
