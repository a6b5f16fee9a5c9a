"""D-MPNN over the dense per-molecule and bin-packed layouts.

Port of ``notorch_tpu.nn.chemprop_dense``: the graph embedding, the plain
block (the oracle of the fused one), the block backed by the hand-written
kernels (forward and backward, block alone or the whole encoder), and the
readouts: sum, mean, max, gated and scaled-dot-product, per molecule on
the ``dense`` layout (``Dense*``) and on bin-packed batches (``Packed*``,
segment ops over ``node_graph``).

Both blocks keep the per-layer weights stacked, as the kernel consumes
them: ``weight`` ``[depth, d, d]`` in the JAX ``[in, out]`` layout and
``bias`` ``[depth, d]`` (one ``[d, d]`` and ``[d]`` for the plain block's
``shared``; see :func:`notorch_tpu_torch.model.convert.params_from_jax` for
the mapping from the JAX ``layer_i/update`` tree).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from notorch_tpu_torch.conf import DEFAULT_HIDDEN_DIM
from notorch_tpu_torch.data.dense import DenseBatchedGraph, rev_pair_swap
from notorch_tpu_torch.kernels.dense_mpnn import (
    FusedDenseEncoderFn,
    FusedDenseMpnnBlockFn,
    fused_dense_encoder_fwd,
    fused_dense_mpnn_block,
    operand_dtype,
)
from notorch_tpu_torch.nn.dropout import Dropout
from notorch_tpu_torch.nn.embed import EmbeddingBagSum
from notorch_tpu_torch.nn.agg import Gated, SDPAttention
from notorch_tpu_torch.nn.init import lecun_normal_
from notorch_tpu_torch.nn.ops import scalar, segment_max, segment_softmax, segment_sum, take
from notorch_tpu_torch.utils import compute_dtype


class _StackedLayers(nn.Module):
    """``depth`` dense layers ``[d, d]`` with biases, stored stacked for the
    kernel."""

    def __init__(self, hidden_dim: int, depth: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.depth = depth
        self.weight = nn.Parameter(torch.empty(depth, hidden_dim, hidden_dim))
        self.bias = nn.Parameter(torch.empty(depth, hidden_dim))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for layer in range(self.depth):
            lecun_normal_(self.weight[layer], self.hidden_dim, generator)
        with torch.no_grad():
            self.bias.zero_()


def _mean_scale(G: DenseBatchedGraph, like: torch.Tensor) -> torch.Tensor:
    """``[B, V, 1]`` real in-degree of every node slot, floored at 1."""
    B, V = G.node_mask.shape
    ones = torch.ones(G.dst.numel(), dtype=like.dtype, device=like.device)
    counts = segment_sum(ones, _scatter_ids(G), B * V + 1)
    return counts[: B * V].reshape(B, V, 1).clamp_min(1.0)


def _scatter_ids(G: DenseBatchedGraph) -> torch.Tensor:
    """Flat node slot ``b * V + dst`` of every edge lane; padding lanes go to
    the trash slot ``B * V``."""
    B, V = G.node_mask.shape
    ids = G.dst.long() + V * torch.arange(B, device=G.dst.device)[:, None]
    return torch.where(G.edge_mask, ids, B * V).reshape(-1)


class DenseChempropBlock(nn.Module):
    """The D-MPNN block in plain tensor ops (one-hot ``bmm`` gathers and
    scatters and the pair swap): the JAX package's jnp ``DenseChempropBlock``,
    which the ``dense`` layout trains and ``dense_packed`` takes for edge
    dropout or ``reduce="max"``, and the oracle of
    :class:`FusedDenseChempropBlock`.

    ``reduce``: ``"sum"`` and ``"mean"`` (the real in-degree, floored at 1)
    as one-hot products, ``"max"`` as one
    :func:`~notorch_tpu_torch.nn.ops.segment_max` over the flattened batch
    (padding lanes to a sink segment, empty segments 0). ``dropout`` acts on
    each layer's update before the residual add. Parameters: ``weight``
    ``[depth, d, d]`` (``[in, out]``) and ``bias`` ``[depth, d]``, or one
    ``[d, d]`` and ``[d]`` reused ``depth`` times when ``shared``; no
    ``bias`` with ``bias=False`` (the JAX ``layer_i/update`` or
    ``layer/update`` tree, :mod:`notorch_tpu_torch.model.convert`).

    ``dtype=bfloat16`` runs the block in bf16 as the JAX block does: the
    one-hot operators, the features and every product and sum in bf16 (each
    ``bmm`` rounded once), each layer's update as flax's ``Dense``: the
    product rounded, then the bias add; the parameters stay float32."""

    def __init__(
        self,
        hidden_dim: int = DEFAULT_HIDDEN_DIM,
        depth: int = 3,
        residual: bool = True,
        reduce: str = "sum",
        dropout: float = 0.0,
        bias: bool = True,
        shared: bool = False,
        dtype=None,
    ):
        if reduce not in ("sum", "mean", "max"):
            raise NotImplementedError(f"unknown reduce {reduce!r}")
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.hidden_dim, self.depth = hidden_dim, depth
        self.residual, self.reduce, self.shared = residual, reduce, shared
        stack = () if shared else (depth,)
        self.weight = nn.Parameter(torch.empty(*stack, hidden_dim, hidden_dim))
        self.bias = nn.Parameter(torch.empty(*stack, hidden_dim)) if bias else None
        self.dropout = Dropout(dropout)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for w in [self.weight] if self.shared else self.weight:
            lecun_normal_(w, self.hidden_dim, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()
        self.dropout.reset_parameters(generator)

    def _node_reduce(self, G: DenseBatchedGraph, S: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """E -> V: ``[B, E, d]`` messages into ``[B, V, d]`` node slots."""
        if self.reduce == "max":
            B, V = G.node_mask.shape
            out = segment_max(m.reshape(-1, m.shape[-1]), _scatter_ids(G), B * V + 1)
            return out[: B * V].reshape(B, V, -1)
        out = torch.bmm(S, m)
        if self.reduce == "mean":
            out = out / S.sum(dim=-1, keepdim=True).clamp_min(1.0)
        return out

    def forward(self, G: DenseBatchedGraph) -> DenseBatchedGraph:
        dt = self.dtype
        S = G.scatter_matrix(dt)  # [B, V, E]
        Gm = G.gather_matrix(dt)  # [B, E, V]
        h = torch.bmm(Gm, G.node_feats.to(dt)) + G.edge_feats.to(dt)
        for layer in range(self.depth):
            W = self.weight if self.shared else self.weight[layer]
            b = self.bias if self.shared or self.bias is None else self.bias[layer]
            m = torch.relu(h)
            em = torch.bmm(Gm, self._node_reduce(G, S, m)) - rev_pair_swap(m)
            out = torch.matmul(em, W.to(dt))
            out = self.dropout(out if b is None else out + b.to(dt))
            h = h + out if self.residual else out
        return G.update(node_feats=self._node_reduce(G, S, h), edge_feats=h)


def refuse_bf16_state(what: str) -> None:
    """Raise ``NotImplementedError`` for a bf16 state in the fused D-MPNN
    block (``what`` says where it came from), as the reference cannot run
    one: in its fused kernels layer 0's f32 bias add promotes a bf16 state
    to f32, and the kernel's bf16 output store refuses the f32 value
    (``notorch_tpu/kernels/dense_mpnn.py:179-185``)."""
    raise NotImplementedError(
        f"{what}: the fused D-MPNN block takes a float32 state only, as in the JAX package, whose "
        "fused kernels cannot store a bf16 state that their f32 bias promoted to f32 "
        "(notorch_tpu/kernels/dense_mpnn.py:179-185); a bf16 D-MPNN runs on layout 'dense' (the plain "
        "block) or 'flat'"
    )


class FusedDenseChempropBlock(_StackedLayers):
    """D-MPNN block backed by the hand-written kernels
    (:mod:`notorch_tpu_torch.kernels.dense_mpnn`), trainable.

    With ``fuse_ends=False`` the ``h0 = G @ node_feats + edge_feats``
    gather and the final E->V scatter stay plain tensor ops around the
    kernels, as they lie outside the Pallas kernels in the JAX package, so
    autograd carries gradients through them to the embeddings. Under
    ``torch.no_grad()`` or ``inference_mode()`` (or with no parameter or
    input that needs a gradient) the block runs the forward kernel alone;
    otherwise it runs
    :class:`~notorch_tpu_torch.kernels.dense_mpnn.FusedDenseMpnnBlockFn`:

    - ``backward="stash"`` (the default, as in the JAX block): the forward
      stashes h1..h_{depth-1} and the backward reads them back;
    - ``backward="recompute"``: the backward replays the forward from h0;
    - ``backward="jnp"`` (the JAX package's debug path): the forward kernel,
      and a backward that replays the block's plain forward under autograd
      (:func:`~notorch_tpu_torch.kernels.dense_mpnn.
      dense_mpnn_block_reference`), in plain PyTorch on the card too.

    With ``fuse_ends=True`` (the JAX package's whole-encoder kernel; only
    with ``backward="stash"``) the gather and the scatter run inside the
    kernels too: :func:`~notorch_tpu_torch.kernels.dense_mpnn.
    fused_dense_encoder_fwd` without autograd, else
    :class:`~notorch_tpu_torch.kernels.dense_mpnn.FusedDenseEncoderFn`,
    whose backward gives the gradients of both feature inputs.

    Padded-lane contract: the kernels fold the reverse-message subtraction
    into their operator, so ``edge_feats`` on PADDED edge lanes differ from
    :class:`DenseChempropBlock`'s; real lanes and the masked scatter agree,
    and the scatter gives the backward a cotangent that is zero on padded
    lanes, which makes its gradients those of the unfolded block.

    ``matmul_dtype="bfloat16"`` rounds the kernels' operands to bf16 where
    the JAX kernels round them (products and sums stay f32, and so does the
    state); ``stash_dtype="bfloat16"`` keeps the stash in bf16 (halving its
    bytes; the backward reads the rounded values). Both go to every kernel
    the block runs (:mod:`notorch_tpu_torch.kernels.dense_mpnn`); ``None``
    is the exact f32 path.
    """

    def __init__(
        self,
        hidden_dim: int = DEFAULT_HIDDEN_DIM,
        depth: int = 3,
        residual: bool = True,
        reduce: str = "sum",
        backward: str = "stash",
        matmul_dtype: str | None = None,
        stash_dtype: str | None = None,
        fuse_ends: bool = False,
    ):
        if reduce not in ("sum", "mean"):
            raise NotImplementedError(
                "the fused block implements reduce='sum' and 'mean' (both fold into "
                "its linear edge operator); max is non-foldable"
            )
        if backward not in ("stash", "recompute", "jnp"):
            raise ValueError(f"backward must be 'stash', 'recompute' or 'jnp', got {backward!r}")
        operand_dtype(matmul_dtype)
        operand_dtype(stash_dtype, "stash_dtype")
        if fuse_ends and backward != "stash":
            raise ValueError("fuse_ends requires backward='stash'")
        super().__init__(hidden_dim, depth)
        self.residual = residual
        self.reduce = reduce
        self.backward = backward
        self.fuse_ends = fuse_ends
        self.matmul_dtype, self.stash_dtype = matmul_dtype, stash_dtype

    def _needs_grad(self, *inputs: torch.Tensor) -> bool:
        return torch.is_grad_enabled() and any(
            t.requires_grad for t in (*inputs, self.weight, self.bias)
        )

    def forward(self, G: DenseBatchedGraph) -> DenseBatchedGraph:
        if G.node_feats.dtype != torch.float32 or G.edge_feats.dtype != torch.float32:
            refuse_bf16_state(f"{G.node_feats.dtype} node and {G.edge_feats.dtype} edge features")
        if self.fuse_ends:
            return self._encoder(G)
        B, V, d = G.node_feats.shape
        slots = G.src.long() + V * torch.arange(B, device=G.src.device)[:, None]  # flat node slot b * V + src
        h0 = (take(G.node_feats.reshape(B * V, d), slots) + G.edge_feats).contiguous()
        args = (h0, G.src, G.dst, G.edge_mask, self.weight, self.bias)
        if self._needs_grad(h0):
            edge_hiddens = FusedDenseMpnnBlockFn.apply(
                *args, self.depth, V, self.residual, self.reduce, self.backward, self.matmul_dtype,
                self.stash_dtype,
            )
        else:
            edge_hiddens = fused_dense_mpnn_block(
                *args, depth=self.depth, n_nodes=V, residual=self.residual, reduce=self.reduce,
                matmul_dtype=self.matmul_dtype,
            )
        nodes = segment_sum(edge_hiddens.reshape(-1, d), _scatter_ids(G), B * V + 1)
        node_hiddens = nodes[: B * V].reshape(B, V, d)
        if self.reduce == "mean":
            node_hiddens = node_hiddens / _mean_scale(G, node_hiddens)
        return G.update(node_feats=node_hiddens, edge_feats=edge_hiddens)

    def _encoder(self, G: DenseBatchedGraph) -> DenseBatchedGraph:
        nf, ef = G.node_feats.contiguous(), G.edge_feats.contiguous()
        args = (nf, ef, G.src, G.dst, G.edge_mask, self.weight, self.bias)
        if self._needs_grad(nf, ef):
            node_hiddens, edge_hiddens = FusedDenseEncoderFn.apply(
                *args, self.depth, self.residual, self.reduce, self.matmul_dtype, self.stash_dtype
            )
        else:
            node_hiddens, edge_hiddens, _ = fused_dense_encoder_fwd(
                *args, depth=self.depth, residual=self.residual, reduce=self.reduce,
                matmul_dtype=self.matmul_dtype,
            )
        return G.update(node_feats=node_hiddens, edge_feats=edge_hiddens)


class DenseGraphEmbedding(nn.Module):
    """Type-index embedding of a dense batch's node and edge type ids, in
    ``dtype`` (f32 tables)."""

    def __init__(self, num_node_types: int, num_edge_types: int, hidden_dim: int = DEFAULT_HIDDEN_DIM,
                 dtype=None):
        super().__init__()
        self.node = EmbeddingBagSum(num_node_types, hidden_dim, dtype)
        self.edge = EmbeddingBagSum(num_edge_types, hidden_dim, dtype)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.node.reset_parameters(generator)
        self.edge.reset_parameters(generator)

    def forward(self, G: DenseBatchedGraph) -> DenseBatchedGraph:
        return G.update(node_feats=self.node(G.node_feats), edge_feats=self.edge(G.edge_feats))


class DenseSum(nn.Module):
    """Per-graph masked sum over the node axis: [B, V, d] -> [B, d]."""

    def forward(self, G: DenseBatchedGraph) -> torch.Tensor:
        mask = G.node_mask[..., None].to(G.node_feats.dtype)
        return (G.node_feats * mask).sum(dim=1)


class DenseMean(nn.Module):
    """Per-graph masked mean over the node axis: [B, V, d] -> [B, d]."""

    def forward(self, G: DenseBatchedGraph) -> torch.Tensor:
        mask = G.node_mask[..., None].to(G.node_feats.dtype)
        total = (G.node_feats * mask).sum(dim=1)
        return total / mask.sum(dim=1).clamp_min(1.0)


class DenseMax(nn.Module):
    """Per-graph masked max over the node axis: [B, V, d] -> [B, d]; a graph
    with no real node reads 0."""

    def forward(self, G: DenseBatchedGraph) -> torch.Tensor:
        neg = torch.where(G.node_mask[..., None], G.node_feats, float("-inf"))
        out = neg.amax(dim=1)
        return torch.where(torch.isfinite(out), out, 0.0)


def _masked_node_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the node axis of ``[B, V]`` scores, padding slots left
    out; a row of padding only gives zero weights."""
    neg = torch.where(mask, scores, float("-inf"))
    mx = neg.amax(dim=1, keepdim=True)
    ex = torch.where(mask, torch.exp(neg - torch.where(torch.isfinite(mx), mx, 0.0)), 0.0)
    return ex / ex.sum(dim=1, keepdim=True).clamp_min(1e-12)


def _packed_segments(G: DenseBatchedGraph) -> tuple[torch.Tensor, torch.Tensor, int]:
    """``([NB * V_b, d] node hiddens, [NB * V_b] molecule ids, n_mols)`` of
    a ``pack_graphs_dense`` batch; padding slots carry the id ``n_mols``."""
    if G.n_mols is None:
        raise ValueError("packed readout needs a pack_graphs_dense batch")
    if G.n_shards != 1:
        raise ValueError(
            f"this packed batch carries {G.n_shards} chunk-local shards "
            "(pack_graphs_dense(n_shards>1)); its node_graph ids are only "
            "meaningful per shard — pack with n_shards=1"
        )
    d = G.node_feats.shape[-1]
    return G.node_feats.reshape(-1, d), G.node_graph.reshape(-1).long(), G.n_mols


class DenseGated(Gated):
    """Learned softmax-attention pooling over the dense node axis:
    ``[B, V, d] -> [B, d]``, with the score layer ``a`` of the flat
    :class:`~notorch_tpu_torch.nn.agg.Gated`."""

    def __init__(self, input_dim: int = DEFAULT_HIDDEN_DIM, dtype=None):
        super().__init__(input_dim, dtype=dtype)

    def forward(self, G: DenseBatchedGraph) -> torch.Tensor:
        alpha = _masked_node_softmax(self.a(G.node_feats).squeeze(-1), G.node_mask)
        return (alpha[..., None] * G.node_feats.to(alpha.dtype)).sum(dim=1)


class DenseSDPAttention(SDPAttention):
    """Scaled-dot-product pooling over the dense node axis against the
    per-graph query ``Q [B, d]`` (the learned query of the flat
    :class:`~notorch_tpu_torch.nn.agg.SDPAttention` when omitted)."""

    def forward(self, G: DenseBatchedGraph, Q: torch.Tensor | None = None) -> torch.Tensor:
        Q = self.queries(Q, G.n_graphs, G.node_feats)
        scores = (Q[:, None, :] * G.node_feats).sum(-1) / scalar(math.sqrt(float(self.key_dim)), G.node_feats)
        alpha = _masked_node_softmax(scores, G.node_mask)
        return (alpha[..., None] * G.node_feats).sum(dim=1)


class PackedSum(nn.Module):
    """Per-MOLECULE sum over a bin-packed batch: ``[NB, V_b, d] -> [n_mols,
    d]`` by one segment sum over ``node_graph`` (padding slots land in the
    extra trash row, which is dropped). Falls back to :class:`DenseSum` on a
    batch without packing metadata; so do the other packed readouts."""

    def forward(self, G: DenseBatchedGraph) -> torch.Tensor:
        if G.node_graph is None:
            return DenseSum()(G)
        flat, ids, M = _packed_segments(G)
        return segment_sum(flat, ids, M + 1)[:-1]


class PackedMean(nn.Module):
    """Per-molecule mean over a bin-packed batch, the count of real node
    slots floored at 1."""

    def forward(self, G: DenseBatchedGraph) -> torch.Tensor:
        if G.node_graph is None:
            return DenseMean()(G)
        flat, ids, M = _packed_segments(G)
        total = segment_sum(flat, ids, M + 1)[:-1]
        counts = segment_sum(G.node_mask.reshape(-1).to(flat.dtype), ids, M + 1)[:-1]
        return total / counts[:, None].clamp_min(1.0)


class PackedMax(nn.Module):
    """Per-molecule max over a bin-packed batch; a molecule with no node
    reads 0."""

    def forward(self, G: DenseBatchedGraph) -> torch.Tensor:
        if G.node_graph is None:
            return DenseMax()(G)
        flat, ids, M = _packed_segments(G)
        return segment_max(flat, ids, M + 1)[:-1]


class PackedGated(DenseGated):
    """Gated pooling over a bin-packed batch: a segment softmax of the
    scores over ``node_graph``, real slots only."""

    def forward(self, G: DenseBatchedGraph) -> torch.Tensor:
        if G.node_graph is None:
            return super().forward(G)
        flat, ids, M = _packed_segments(G)
        alpha = segment_softmax(self.a(flat).squeeze(-1), ids, M + 1, mask=G.node_mask.reshape(-1))
        return segment_sum(alpha[:, None] * flat, ids, M + 1)[:-1]


class PackedSDPAttention(DenseSDPAttention):
    """Scaled-dot-product pooling over a bin-packed batch against the
    per-molecule query ``Q [n_mols, d]`` (the learned query when omitted)."""

    def forward(self, G: DenseBatchedGraph, Q: torch.Tensor | None = None) -> torch.Tensor:
        if G.node_graph is None:
            return super().forward(G, Q)
        flat, ids, M = _packed_segments(G)
        Q = self.queries(Q, M, flat)
        q_full = torch.cat([Q, torch.zeros_like(Q[:1])])  # the trash row's query
        scores = (take(q_full, ids) * flat).sum(-1) / scalar(math.sqrt(float(self.key_dim)), flat)
        alpha = segment_softmax(scores, ids, M + 1, mask=G.node_mask.reshape(-1))
        return segment_sum(alpha[:, None] * flat, ids, M + 1)[:-1]
