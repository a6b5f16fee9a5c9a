"""Per-graph readout (pooling) over a flat batch: ``G -> [n_graphs, d]``.

Port of ``notorch_tpu.nn.agg``: ``Sum``, ``Mean``, ``Max``, ``Gated``
(learned softmax-attention pooling, its score layer an ``nn.Linear(d, 1)``
named ``a``) and ``SDPAttention`` (scaled-dot-product pooling against a
per-graph query, by default the learned ``query [1, d]``). Segment ids of
padding nodes point at the trailing trash slot, which is sliced off, so no
masking is needed; ``Mean``'s denominators count real nodes, floored at 1.
``psum_axis`` (node-sharded batches) raises ``NotImplementedError``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from notorch_tpu_torch.conf import DEFAULT_HIDDEN_DIM
from notorch_tpu_torch.data.graph import BatchedGraph
from notorch_tpu_torch.nn.chemprop import PARALLEL_SLICE
from notorch_tpu_torch.nn.init import dense, lecun_normal_, reset_dense_
from notorch_tpu_torch.nn.ops import scalar, segment_max, segment_softmax, segment_sum, take

__all__ = ["Sum", "Mean", "Max", "Gated", "SDPAttention"]


def _num_segments(G: BatchedGraph) -> int:
    return G.n_graphs + 1  # + trash slot for padding


def _no_psum(psum_axis: str | None) -> None:
    if psum_axis is not None:
        raise NotImplementedError(
            f"psum_axis={psum_axis!r} (node-sharded readout) comes with {PARALLEL_SLICE}"
        )


def _weighted_sum(alpha: torch.Tensor, G: BatchedGraph) -> torch.Tensor:
    return segment_sum(alpha[:, None] * G.node_feats, G.node_graph, _num_segments(G))[: G.n_graphs]


class Sum(nn.Module):
    def __init__(self, psum_axis: str | None = None):
        _no_psum(psum_axis)
        super().__init__()

    def forward(self, G: BatchedGraph) -> torch.Tensor:
        return segment_sum(G.node_feats, G.node_graph, _num_segments(G))[: G.n_graphs]


class Mean(nn.Module):
    def __init__(self, psum_axis: str | None = None):
        _no_psum(psum_axis)
        super().__init__()

    def forward(self, G: BatchedGraph) -> torch.Tensor:
        n = _num_segments(G)
        totals = segment_sum(G.node_feats, G.node_graph, n)[: G.n_graphs]
        counts = segment_sum(G.node_mask.to(G.node_feats.dtype), G.node_graph, n)[: G.n_graphs]
        return totals / counts.clamp_min(1.0)[:, None]


class Max(nn.Module):
    def __init__(self, psum_axis: str | None = None):
        _no_psum(psum_axis)
        super().__init__()

    def forward(self, G: BatchedGraph) -> torch.Tensor:
        return segment_max(G.node_feats, G.node_graph, _num_segments(G))[: G.n_graphs]


class Gated(nn.Module):
    """Learned softmax-attention pooling: ``alpha = softmax_graph(a(h))``
    over each graph's real nodes, then ``sum alpha * h``; the score layer
    ``a`` computes in ``dtype``."""

    def __init__(self, input_dim: int = DEFAULT_HIDDEN_DIM, psum_axis: str | None = None, dtype=None):
        _no_psum(psum_axis)
        super().__init__()
        self.a = dense(input_dim, 1, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        reset_dense_(self.a, generator)

    def forward(self, G: BatchedGraph) -> torch.Tensor:
        scores = self.a(G.node_feats).squeeze(-1)
        alpha = segment_softmax(scores, G.node_graph, _num_segments(G), G.node_mask)
        return _weighted_sum(alpha, G)


class SDPAttention(nn.Module):
    """Query-conditioned scaled-dot-product pooling. ``Q`` is the per-graph
    query ``[n_graphs, d]`` (wired from any upstream module); when omitted, a
    learned query ``[1, d]`` (``d = key_dim``) is broadcast to every graph.
    The parameter exists whether or not ``Q`` is wired, where the JAX module
    creates it only on the first call without one."""

    def __init__(self, key_dim: int = DEFAULT_HIDDEN_DIM, psum_axis: str | None = None):
        _no_psum(psum_axis)
        super().__init__()
        self.key_dim = key_dim
        self.query = nn.Parameter(torch.empty(1, key_dim))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        # flax's lecun_normal on a [1, d] parameter: fan_in = 1
        lecun_normal_(self.query, 1, generator)

    def queries(self, Q: torch.Tensor | None, n: int, like: torch.Tensor) -> torch.Tensor:
        """``Q``, or the learned query broadcast to ``n`` graphs."""
        d = like.shape[-1]
        if Q is not None:
            return Q
        if d != self.key_dim:
            raise ValueError(f"the learned query is {self.key_dim} wide, the node hiddens {d}")
        return self.query.expand(n, d).to(like.dtype)

    def forward(self, G: BatchedGraph, Q: torch.Tensor | None = None) -> torch.Tensor:
        Q = self.queries(Q, G.n_graphs, G.node_feats)
        # the trash slot gets a zero query
        q_full = torch.cat([Q, torch.zeros_like(Q[:1])])
        scores = (take(q_full, G.node_graph) * G.node_feats).sum(-1) / scalar(math.sqrt(float(self.key_dim)),
                                                                                   G.node_feats)
        alpha = segment_softmax(scores, G.node_graph, _num_segments(G), G.node_mask)
        return _weighted_sum(alpha, G)
