"""D-MPNN (bond-message / "chemprop") message passing over the flat layout.

Port of ``notorch_tpu.nn.chemprop``. Recurrence per layer:

    h         = relu(edge_hiddens)
    m_v       = node_reduce(h)                      # E -> V
    m_e       = m_v[src] - h[rev]                   # subtract reverse message
    edge_hid' = m_e @ W (+ b)                       # (+ residual)

Block: initial edge hiddens = node_feats[src] + edge_feats, ``depth``
layers (optionally weight-shared / residual), then a final E -> V reduction
into node hiddens.

The E -> V reduction (:func:`node_reduce`) dispatches as the JAX
``_node_reduce`` does, on ``impl`` and ``reduce``:

- ``"csr"`` with ``reduce="sum"``: the tile-packed segment sum,
  :func:`~notorch_tpu_torch.kernels.csr_segment.csr_segment_sum_packed` (a
  hand-written kernel on the card; on bf16 messages its bf16 mode, which
  rounds as the TPU kernel's grid does). The batch must carry the packing
  (``DataLoader(csr_pack=True)``); a batch without it raises, where the JAX
  package falls back to the segment ops and so never reaches its kernel
  when serving. Mean and max with ``impl="csr"`` take the segment ops;
- ``"gather"`` with the batch's ``in_edges`` and sum, mean or max: the
  fixed-degree take-and-reduce;
- otherwise the segment ops of :mod:`notorch_tpu_torch.nn.ops`.

``csr`` packs only real edges, so the sink node's row holds no padding
messages, where ``segment`` and ``gather`` sum the padding edges into it:
the impls agree on real nodes and edges, not on padded lanes.

The block keeps its per-layer weights stacked, as the dense blocks do:
``weight`` ``[depth, d, d]`` in the JAX ``[in, out]`` layout and ``bias``
``[depth, d]`` (``[d, d]`` and ``[d]`` when ``shared``; no ``bias`` with
``bias=False``). Edge dropout acts on each layer's update, before the
residual add, as in the JAX layer; one
:class:`~notorch_tpu_torch.nn.dropout.Dropout` of the block draws every
layer's mask (outside the recomputed layer under ``remat``, so the backward
sees the forward's masks).

``psum_axis``: when a batch's *edges* are sharded over a mesh axis and its
nodes replicated (the ``replicate`` partition of
:mod:`notorch_tpu_torch.parallel.partition`), every E->V reduction is
combined over the axis's ranks inside the forward (:func:`reduce_and_combine`:
a ``psum`` of sums, a ``psum`` of sums and of real-edge counts for the mean,
a ``pmax`` for max, which, as in JAX, does not train), as the JAX layer
does; the axis name resolves to the group a sharded trainer binds
(:mod:`notorch_tpu_torch.parallel.collectives`).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from notorch_tpu_torch.conf import DEFAULT_HIDDEN_DIM
from notorch_tpu_torch.data.graph import BatchedGraph
from notorch_tpu_torch.kernels.csr_segment import csr_segment_sum_packed
from notorch_tpu_torch.nn.dropout import Dropout
from notorch_tpu_torch.nn.init import lecun_normal_
from notorch_tpu_torch.nn.ops import segment_reduce, segment_sum, take
from notorch_tpu_torch.parallel.collectives import pmax_nondiff, psum
from notorch_tpu_torch.utils import compute_dtype

IMPLS = ("gather", "segment", "csr")
REDUCES = ("sum", "mean", "max", "min")


def _check_options(reduce: str, impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; options: {list(IMPLS)}")
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduce {reduce!r}; options: {list(REDUCES)}")


def node_reduce(messages: torch.Tensor, G: BatchedGraph, reduce: str, impl: str) -> torch.Tensor:
    """E -> V reduction of ``messages [E, d]`` into ``[V, d]`` (see the
    module docstring for the dispatch)."""
    if impl == "csr" and reduce == "sum":
        if G.csr_perm is None:
            raise ValueError(
                "impl='csr' reduces through the tile-packed CSR kernel, and this batch carries "
                "no packing: build it with DataLoader(csr_pack=True) (or with_csr_packing), "
                "as run and run_predict do for impl: csr"
            )
        return csr_segment_sum_packed(messages, G.csr_perm, G.csr_dst, num_nodes=G.num_nodes,
                                      dst=G.dst, edge_mask=G.edge_mask)
    if impl == "gather" and G.in_edges is not None and reduce in ("sum", "mean", "max"):
        ext = torch.cat([messages, messages.new_zeros(1, messages.shape[1])])
        gathered = take(ext, G.in_edges)  # [V, K, d]
        if reduce == "sum":
            return gathered.sum(dim=1)
        valid = (G.in_edges < messages.shape[0])[..., None]
        if reduce == "mean":
            return gathered.sum(dim=1) / valid.sum(dim=1).clamp_min(1)
        # empty in-edge sets give 0 and negative maxima stay, as segment_max
        out = torch.where(valid, gathered, float("-inf")).amax(dim=1)
        return torch.where(torch.isneginf(out), 0.0, out)
    return segment_reduce(messages, G.dst, G.num_nodes, reduce)


def reduce_and_combine(values: torch.Tensor, G: BatchedGraph, reduce: str, impl: str,
                       axis: str | None) -> torch.Tensor:
    """:func:`node_reduce`, combined over the ranks of ``axis`` when the
    batch's edges are sharded over it. A sharded mean sums the ranks' sums
    and their real-edge counts and divides once (the count floored at 1, as
    ``segment_mean``), as the JAX ``_reduce_and_combine``."""
    if axis is None:
        return node_reduce(values, G, reduce, impl)
    if reduce == "mean":
        sums = psum(node_reduce(values, G, "sum", impl), axis)
        ones = values.new_ones(values.shape[0], 1)
        counts = psum(segment_sum(ones, G.dst, G.num_nodes), axis)
        return sums / counts.clamp_min(1.0)
    if reduce == "sum":
        return psum(node_reduce(values, G, reduce, impl), axis)
    if reduce == "max":
        return pmax_nondiff(node_reduce(values, G, reduce, impl), axis)
    raise NotImplementedError(f"edge-partitioned reduce={reduce!r} (sum, mean and max combine over shards)")


def chemprop_layer(edge_hiddens, G: BatchedGraph, weight, bias, reduce: str, impl: str,
                   dtype: torch.dtype = torch.float32, axis: str | None = None) -> torch.Tensor:
    """One D-MPNN layer; ``weight`` ``[d_in, d]`` (the JAX ``[in, out]``
    layout), ``bias`` ``[d]`` or ``None``; the update computes in ``dtype``
    as flax's ``Dense`` (the product rounded, then the bias add); ``axis``
    combines the E->V reduction over an edge-sharded batch's ranks."""
    messages = torch.relu(edge_hiddens)
    node_messages = reduce_and_combine(messages, G, reduce, impl, axis)
    edge_messages = take(node_messages, G.src) - take(messages, G.rev)
    out = edge_messages.to(dtype) @ weight.to(dtype)
    return out if bias is None else out + bias.to(dtype)


class ChempropLayer(nn.Module):
    """One D-MPNN layer as a module: ``(edge_hiddens, G) -> update``, its
    dense layer an ``nn.Linear`` named ``update`` as in the JAX layer,
    computing in ``dtype``, and ``dropout`` on the update."""

    def __init__(
        self,
        hidden_dim: int = DEFAULT_HIDDEN_DIM,
        bias: bool = True,
        dropout: float = 0.0,
        reduce: str = "sum",
        psum_axis: str | None = None,
        impl: str = "gather",
        dtype=None,
    ):
        _check_options(reduce, impl)
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.psum_axis = psum_axis
        # torch.empty: values come from reset_parameters, never the global RNG
        self.update = nn.Linear(hidden_dim, hidden_dim, bias=bias, device="meta").to_empty(device="cpu")
        self.dropout = Dropout(dropout)
        self.reduce, self.impl = reduce, impl

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        lecun_normal_(self.update.weight, self.update.in_features, generator)
        if self.update.bias is not None:
            nn.init.zeros_(self.update.bias)
        self.dropout.reset_parameters(generator)

    def forward(self, edge_hiddens: torch.Tensor, G: BatchedGraph) -> torch.Tensor:
        return self.dropout(chemprop_layer(edge_hiddens, G, self.update.weight.T, self.update.bias,
                                           self.reduce, self.impl, self.dtype, self.psum_axis))


class ChempropBlock(nn.Module):
    """The D-MPNN block over a flat batch: ``G -> G`` with node hiddens
    ``[V, d]`` and edge hiddens ``[E, d]``. ``remat`` recomputes each layer
    in the backward (``torch.utils.checkpoint``, non-reentrant) instead of
    keeping its activations, as the JAX block's ``nn.remat``. ``dtype`` is
    each layer's compute dtype (float32 or bfloat16, every impl; f32
    parameters)."""

    def __init__(
        self,
        hidden_dim: int = DEFAULT_HIDDEN_DIM,
        bias: bool = True,
        dropout: float = 0.0,
        depth: int = 3,
        residual: bool = True,
        shared: bool = False,
        reduce: str = "sum",
        psum_axis: str | None = None,
        impl: str = "gather",
        remat: bool = False,
        dtype=None,
    ):
        _check_options(reduce, impl)
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.psum_axis = psum_axis
        self.hidden_dim, self.depth = hidden_dim, depth
        self.residual, self.shared, self.reduce, self.impl, self.remat = residual, shared, reduce, impl, remat
        stack = () if shared else (depth,)
        self.weight = nn.Parameter(torch.empty(*stack, hidden_dim, hidden_dim))
        self.bias = nn.Parameter(torch.empty(*stack, hidden_dim)) if bias else None
        self.dropout = Dropout(dropout)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for w in [self.weight] if self.shared else self.weight:
            lecun_normal_(w, self.hidden_dim, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)
        self.dropout.reset_parameters(generator)

    def _layer_params(self, layer: int):
        if self.shared:
            return self.weight, self.bias
        return self.weight[layer], None if self.bias is None else self.bias[layer]

    def forward(self, G: BatchedGraph) -> BatchedGraph:
        edge_hiddens = take(G.node_feats, G.src) + G.edge_feats
        for layer in range(self.depth):
            args = (edge_hiddens, G, *self._layer_params(layer), self.reduce, self.impl, self.dtype, self.psum_axis)
            if self.remat and torch.is_grad_enabled():
                out = checkpoint(chemprop_layer, *args, use_reentrant=False)
            else:
                out = chemprop_layer(*args)
            out = self.dropout(out)
            edge_hiddens = edge_hiddens + out if self.residual else out
        node_hiddens = reduce_and_combine(edge_hiddens, G, self.reduce, self.impl, self.psum_axis)
        return G.update(node_feats=node_hiddens, edge_feats=edge_hiddens)
