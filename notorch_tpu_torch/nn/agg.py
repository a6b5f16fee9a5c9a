"""Per-graph readout (pooling) over a flat batch: ``G -> [n_graphs, d]``.

Port of ``notorch_tpu.nn.agg``: ``Sum``, ``Mean``, ``Max``, ``Gated``
(learned softmax-attention pooling, its score layer an ``nn.Linear(d, 1)``
named ``a``) and ``SDPAttention`` (scaled-dot-product pooling against a
per-graph query, by default the learned ``query [1, d]``). Segment ids of
padding nodes point at the trailing trash slot, which is sliced off, so no
masking is needed; ``Mean``'s denominators count real nodes, floored at 1.

``psum_axis``: when a batch's *nodes* are sharded over a mesh axis (the
``molecule`` and ``halo`` partitions of :mod:`notorch_tpu_torch.parallel`),
each shard holds a disjoint node subset labelled with GLOBAL graph ids, and
the local reduction is combined over the axis's ranks by one ``psum`` of
the ``[G, d]`` partials (``Mean`` also of the counts; ``Max`` by an
``all_gather`` and a max, which trains; the softmax of ``Gated`` and
``SDPAttention`` by a ``pmax`` of the segment maxima, which take no
gradient, and a ``psum`` of the normalisers), as in the JAX readouts.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from notorch_tpu_torch.conf import DEFAULT_HIDDEN_DIM
from notorch_tpu_torch.data.graph import BatchedGraph
from notorch_tpu_torch.nn.init import dense, lecun_normal_, reset_dense_
from notorch_tpu_torch.nn.ops import _segment_extreme, scalar, segment_max, segment_softmax, segment_sum, take
from notorch_tpu_torch.parallel.collectives import all_gather, pmax, psum

__all__ = ["Sum", "Mean", "Max", "Gated", "SDPAttention"]


def _num_segments(G: BatchedGraph) -> int:
    return G.n_graphs + 1  # + trash slot for padding


def _combined(x: torch.Tensor, psum_axis: str | None) -> torch.Tensor:
    return x if psum_axis is None else psum(x, psum_axis)


def _weighted_sum(alpha: torch.Tensor, G: BatchedGraph, psum_axis: str | None = None) -> torch.Tensor:
    out = segment_sum(alpha[:, None] * G.node_feats, G.node_graph, _num_segments(G))[: G.n_graphs]
    return _combined(out, psum_axis)


def _softmax(scores: torch.Tensor, G: BatchedGraph, psum_axis: str | None) -> torch.Tensor:
    """The segment softmax over each graph's real nodes; over a node-sharded
    batch its max and normaliser span every shard (the max shifts for
    stability only, so it takes no gradient, as JAX's ``stop_gradient``)."""
    n = _num_segments(G)
    if psum_axis is None:
        return segment_softmax(scores, G.node_graph, n, G.node_mask)
    scores = torch.where(G.node_mask, scores, float("-inf"))
    seg_max = pmax(_segment_extreme(scores.detach(), G.node_graph, n, "amax", float("-inf")), psum_axis)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    exp = torch.where(G.node_mask, torch.exp(scores - take(seg_max, G.node_graph)), 0.0)
    denom = psum(segment_sum(exp, G.node_graph, n), psum_axis)
    return exp / take(denom.clamp_min(1e-12), G.node_graph)


class Sum(nn.Module):
    def __init__(self, psum_axis: str | None = None):
        super().__init__()
        self.psum_axis = psum_axis

    def forward(self, G: BatchedGraph) -> torch.Tensor:
        return _combined(segment_sum(G.node_feats, G.node_graph, _num_segments(G))[: G.n_graphs], self.psum_axis)


class Mean(nn.Module):
    def __init__(self, psum_axis: str | None = None):
        super().__init__()
        self.psum_axis = psum_axis

    def forward(self, G: BatchedGraph) -> torch.Tensor:
        n = _num_segments(G)
        totals = segment_sum(G.node_feats, G.node_graph, n)[: G.n_graphs]
        counts = segment_sum(G.node_mask.to(G.node_feats.dtype), G.node_graph, n)[: G.n_graphs]
        # partial sums AND partial counts, so a graph that straddles shards
        # averages over its global node count
        totals, counts = _combined(totals, self.psum_axis), _combined(counts, self.psum_axis)
        return totals / counts.clamp_min(1.0)[:, None]


class Max(nn.Module):
    def __init__(self, psum_axis: str | None = None):
        super().__init__()
        self.psum_axis = psum_axis

    def forward(self, G: BatchedGraph) -> torch.Tensor:
        if self.psum_axis is None:
            return segment_max(G.node_feats, G.node_graph, _num_segments(G))[: G.n_graphs]
        # -inf for locally empty graphs until after the max over the shards
        out = _segment_extreme(G.node_feats, G.node_graph, _num_segments(G), "amax", float("-inf"))[: G.n_graphs]
        out = all_gather(out, self.psum_axis).amax(dim=0)
        return torch.where(torch.isneginf(out), 0.0, out)


class Gated(nn.Module):
    """Learned softmax-attention pooling: ``alpha = softmax_graph(a(h))``
    over each graph's real nodes, then ``sum alpha * h``; the score layer
    ``a`` computes in ``dtype``."""

    def __init__(self, input_dim: int = DEFAULT_HIDDEN_DIM, psum_axis: str | None = None, dtype=None):
        super().__init__()
        self.psum_axis = psum_axis
        self.a = dense(input_dim, 1, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        reset_dense_(self.a, generator)

    def forward(self, G: BatchedGraph) -> torch.Tensor:
        scores = self.a(G.node_feats).squeeze(-1)
        return _weighted_sum(_softmax(scores, G, self.psum_axis), G, self.psum_axis)


class SDPAttention(nn.Module):
    """Query-conditioned scaled-dot-product pooling. ``Q`` is the per-graph
    query ``[n_graphs, d]`` (wired from any upstream module); when omitted, a
    learned query ``[1, d]`` (``d = key_dim``) is broadcast to every graph.
    The parameter exists whether or not ``Q`` is wired, where the JAX module
    creates it only on the first call without one."""

    def __init__(self, key_dim: int = DEFAULT_HIDDEN_DIM, psum_axis: str | None = None):
        super().__init__()
        self.key_dim, self.psum_axis = key_dim, psum_axis
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
        return _weighted_sum(_softmax(scores, G, self.psum_axis), G, self.psum_axis)
