"""Per-cloud readout over ``batch_index``: ``P -> [n_graphs, d]``.

Port of ``notorch_tpu.nn.spatial.agg`` (registered as ``SpatialSum``,
``SpatialMean``, ``SpatialMax`` and ``SpatialGated``): segment reductions
over the padded batch, whose padding points carry the id one past the real
graph slots, so the trailing trash row is sliced off and no mask is
needed, but by the softmax of ``Gated`` and ``SDPAttention``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from notorch_tpu_torch.conf import DEFAULT_HIDDEN_DIM
from notorch_tpu_torch.data.point_cloud import BatchedPointCloud
from notorch_tpu_torch.nn.init import dense, reset_dense_
from notorch_tpu_torch.nn.ops import segment_max, segment_mean, segment_softmax, segment_sum, take

__all__ = ["Sum", "Mean", "Max", "Gated", "SDPAttention"]


def _n(P: BatchedPointCloud) -> int:
    return P.n_graphs + 1


class Sum(nn.Module):
    def forward(self, P: BatchedPointCloud) -> torch.Tensor:
        return segment_sum(P.node_feats, P.batch_index, _n(P))[: P.n_graphs]


class Mean(nn.Module):
    def forward(self, P: BatchedPointCloud) -> torch.Tensor:
        return segment_mean(P.node_feats, P.batch_index, _n(P))[: P.n_graphs]


class Max(nn.Module):
    def forward(self, P: BatchedPointCloud) -> torch.Tensor:
        return segment_max(P.node_feats, P.batch_index, _n(P))[: P.n_graphs]


class Gated(nn.Module):
    """Learned softmax-attention pooling over each cloud's real points, the
    score layer ``a`` computing in ``dtype``."""

    def __init__(self, input_dim: int = DEFAULT_HIDDEN_DIM, dtype=None):
        super().__init__()
        self.a = dense(input_dim, 1, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        reset_dense_(self.a, generator)

    def forward(self, P: BatchedPointCloud) -> torch.Tensor:
        scores = self.a(P.node_feats).squeeze(-1)
        alpha = segment_softmax(scores, P.batch_index, _n(P), mask=P.node_mask)
        return segment_sum(alpha[:, None] * P.node_feats, P.batch_index, _n(P))[: P.n_graphs]


class SDPAttention(nn.Module):
    """Scaled-dot-product pooling against a per-cloud query ``Q
    [n_graphs, d]`` wired from another module (no learned query, as in the
    JAX module)."""

    def __init__(self, key_dim: int = DEFAULT_HIDDEN_DIM):
        super().__init__()
        self.key_dim = key_dim

    def forward(self, P: BatchedPointCloud, Q: torch.Tensor) -> torch.Tensor:
        q_full = torch.cat([Q, torch.zeros_like(Q[:1])])
        scores = (take(q_full, P.batch_index) * P.node_feats).sum(-1) / math.sqrt(float(self.key_dim))
        alpha = segment_softmax(scores, P.batch_index, _n(P), mask=P.node_mask)
        return segment_sum(alpha[:, None] * P.node_feats, P.batch_index, _n(P))[: P.n_graphs]
