"""Boundary-exchange edge partitioning for graphs larger than a shard.

Port of ``notorch_tpu.parallel.halo``. A graph's nodes are sharded in
contiguous blocks and its edges, kept in reverse pairs, go to the shard
that owns a pair's first endpoint; only the boundary node rows cross
between ranks. Each D-MPNN layer makes two exchanges of ``[n_shards, B,
d]`` boundary rows (``B`` the largest boundary of a shard pair) by
:func:`~notorch_tpu_torch.parallel.collectives.all_to_all` over the graph
axis:

1. **scatter**: a shard's partial E->V sums of the boundary nodes it does
   not own go to their owners, which add them to their own block;
2. **gather**: owners send back the transformed node messages that the
   other shards' edges read through ``src``.

The layer uses ``reduce(m) @ W == reduce(m @ W)``, so the E-sized ``m @ W``
(the reverse-message term) does not wait on exchange 1. Gradients are
exact: the exchange's backward is the same exchange, and the sums and
gathers are the port's :func:`~notorch_tpu_torch.nn.ops.segment_sum` and
:func:`~notorch_tpu_torch.nn.ops.take`, so on the card they launch TPU
kernel row 8 in a fixed order, and a run repeats bit for bit.

:func:`partition_edges_halo` is the JAX package's numpy code; its shards
equal JAX's array for array.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from notorch_tpu_torch.conf import DEFAULT_HIDDEN_DIM
from notorch_tpu_torch.data.graph import BatchedGraph
from notorch_tpu_torch.data.halo import HaloShard
from notorch_tpu_torch.nn.ops import segment_sum, take
from notorch_tpu_torch.parallel.collectives import all_to_all

__all__ = [
    "HaloShard",
    "partition_edges_halo",
    "halo_reduce",
    "halo_gather",
    "halo_mpnn_block",
    "HaloChempropBlock",
    "comm_bytes_per_step",
]


def partition_edges_halo(
    bg: BatchedGraph,
    n_shards: int,
    pair_cap: int | None = None,
    b_cap: int | None = None,
    h_cap: int | None = None,
) -> list[HaloShard]:
    """Split a host (numpy) padded batch into halo shards.

    Nodes go in contiguous blocks of ``V / n``; each real reverse PAIR goes
    to the shard that owns its first endpoint, so ``rev`` stays a local
    pairwise swap; per-shard edge lists are padded to one even cap.
    ``pair_cap``/``b_cap``/``h_cap`` override the computed capacities (at
    least the computed minimums) so that the shards of several batches share
    one shape. Boundary metadata comes from the real edges; padding slots
    map to trash slots on both sides."""
    V = bg.num_nodes
    if V % n_shards:
        raise ValueError(f"node cap {V} must divide into {n_shards} shards")
    v_loc = V // n_shards
    src, dst = np.asarray(bg.src), np.asarray(bg.dst)
    emask, rev = np.asarray(bg.edge_mask), np.asarray(bg.rev)

    real_pairs = np.nonzero(emask[0::2])[0]
    if not (rev[2 * real_pairs] == 2 * real_pairs + 1).all():
        raise ValueError("halo partitioning requires interleaved reverse pairs")
    pair_owner = src[2 * real_pairs] // v_loc
    assigned = [real_pairs[pair_owner == s] for s in range(n_shards)]
    pair_cap_min = max((len(a) for a in assigned), default=0)
    pair_cap_min = max(-(-pair_cap_min // 4) * 4, 4)  # even e_loc, 8-aligned
    if pair_cap is None:
        pair_cap = pair_cap_min
    elif pair_cap < pair_cap_min:
        raise ValueError(f"pair_cap {pair_cap} < required {pair_cap_min}")
    e_loc = 2 * pair_cap

    # boundary[s][p]: nodes owned by p that shard s touches; pairs are
    # co-located, so one set serves both exchanges
    sel_edges = []
    boundary: list[list[np.ndarray]] = []
    for s in range(n_shards):
        eids = np.stack([2 * assigned[s], 2 * assigned[s] + 1], axis=1).reshape(-1)
        sel = np.full(e_loc, -1, dtype=np.int64)
        sel[: len(eids)] = eids
        sel_edges.append(sel)
        touched = np.unique(np.concatenate([src[eids], dst[eids]]))
        boundary.append([touched[(touched // v_loc) == p] if p != s else np.empty(0, np.int64)
                         for p in range(n_shards)])

    b_cap_min = max((len(r) for rows in boundary for r in rows), default=0)
    h_cap_min = max((sum(len(r) for r in rows) for rows in boundary), default=0)
    if b_cap is None:
        b_cap = b_cap_min
    elif b_cap < b_cap_min:
        raise ValueError(f"b_cap {b_cap} < required {b_cap_min}")
    if h_cap is None:
        h_cap = h_cap_min
    elif h_cap < h_cap_min:
        raise ValueError(f"h_cap {h_cap} < required {h_cap_min}")

    rev_local = np.arange(e_loc, dtype=np.int32)
    rev_local[0::2] += 1
    rev_local[1::2] -= 1

    t_e = np.asarray(bg.edge_feats).shape[1]
    shards = []
    for s in range(n_shards):
        sel = sel_edges[s]
        real = sel >= 0
        safe = np.maximum(sel, 0)
        trash_partial = v_loc + h_cap

        halo_slot: dict[int, int] = {}  # halo-out slot of node v (owner-major, id-sorted)
        for p in range(n_shards):
            for v in boundary[s][p]:
                halo_slot[int(v)] = v_loc + len(halo_slot)

        d_global = np.where(real, dst[safe], 0)
        dst_slot = np.full(e_loc, trash_partial, dtype=np.int32)
        own_d = (d_global // v_loc) == s
        dst_slot[real & own_d] = (d_global - s * v_loc)[real & own_d]
        for e in np.nonzero(real & ~own_d)[0]:
            dst_slot[e] = halo_slot[int(d_global[e])]

        s_global = np.where(real, src[safe], 0)
        src_slot = np.full(e_loc, v_loc, dtype=np.int32)  # padding -> zero row
        own_s = (s_global // v_loc) == s
        src_slot[real & own_s] = (s_global - s * v_loc)[real & own_s]
        halo_in_pos = {int(v): v_loc + 1 + q * b_cap + b
                       for q in range(n_shards) for b, v in enumerate(boundary[s][q])}
        for e in np.nonzero(real & ~own_s)[0]:
            src_slot[e] = halo_in_pos[int(s_global[e])]

        scatter_send = np.full((n_shards, max(b_cap, 1)), trash_partial, np.int32)
        scatter_recv = np.full((n_shards, max(b_cap, 1)), v_loc, np.int32)
        gather_send = np.full((n_shards, max(b_cap, 1)), v_loc, np.int32)
        for p in range(n_shards):
            for b, v in enumerate(boundary[s][p]):  # rows I send to owner p
                scatter_send[p, b] = halo_slot[int(v)]
            for b, v in enumerate(boundary[p][s]):  # p's rows of my nodes, in p's order
                scatter_recv[p, b] = int(v) - s * v_loc
                gather_send[p, b] = int(v) - s * v_loc

        edge_feats = np.where(real[:, None], np.asarray(bg.edge_feats)[safe], np.zeros((1, t_e))).astype(
            np.asarray(bg.edge_feats).dtype)
        edge_graph = np.where(real, np.asarray(bg.edge_graph)[safe], bg.n_graphs).astype(np.int32)
        block = slice(s * v_loc, (s + 1) * v_loc)
        shards.append(HaloShard(
            node_feats=np.asarray(bg.node_feats)[block],
            edge_feats=edge_feats,
            node_graph=np.asarray(bg.node_graph)[block],
            node_mask=np.asarray(bg.node_mask)[block],
            edge_mask=real,
            edge_graph=edge_graph,
            edge_ids=sel.astype(np.int32),
            rev=rev_local,
            src_slot=src_slot,
            dst_slot=dst_slot,
            scatter_send_slot=scatter_send,
            scatter_recv_tgt=scatter_recv,
            gather_send_slot=gather_send,
            num_graphs_real=np.asarray(bg.num_graphs_real),
            v_loc=v_loc, h_cap=h_cap, b_cap=b_cap, n_shards=n_shards, n_graphs=bg.n_graphs,
        ))
    return shards


def halo_reduce(m: torch.Tensor, shard: HaloShard, axis: str) -> torch.Tensor:
    """E->V sums with the boundary scatter: the COMPLETE message sums of
    this shard's own node block ``[v_loc, d]``."""
    partial = segment_sum(m, shard.dst_slot, shard.v_loc + shard.h_cap + 1)
    own = partial[: shard.v_loc]
    if shard.b_cap == 0:
        return own
    recv = all_to_all(take(partial, shard.scatter_send_slot), axis)  # [n, B, d]
    own_ext = torch.cat([own, own.new_zeros(1, m.shape[-1])])
    own_ext = own_ext + segment_sum(recv.reshape(-1, m.shape[-1]), shard.scatter_recv_tgt.reshape(-1),
                                    shard.v_loc + 1)
    return own_ext[: shard.v_loc]


def halo_gather(x_own: torch.Tensor, shard: HaloShard, axis: str) -> torch.Tensor:
    """V->E preparation: the own rows, a zero row and the halo-in rows
    fetched from their owners; index it with ``shard.src_slot``."""
    ext0 = torch.cat([x_own, x_own.new_zeros(1, x_own.shape[-1])])
    if shard.b_cap == 0:
        return ext0
    halo = all_to_all(take(ext0, shard.gather_send_slot), axis)  # [n, B, d]
    return torch.cat([ext0, halo.reshape(-1, x_own.shape[-1])])


def halo_mpnn_block(
    node_embed: torch.Tensor,  # [v_loc, d]
    edge_embed: torch.Tensor,  # [e_loc, d]
    shard: HaloShard,
    weights: torch.Tensor,  # [depth, d, d], [in, out]
    biases: torch.Tensor,  # [depth, d]
    axis: str,
    residual: bool = True,
    act: Callable = torch.relu,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The D-MPNN block over a halo shard: ``(node_hiddens [v_loc, d],
    edge_hiddens [e_loc, d])``, whose real rows are the unsharded
    recurrence's (``(m_v[src] - m[rev]) @ W == (m_v @ W)[src] - (m @
    W)[rev]``)."""
    ext = halo_gather(node_embed, shard, axis)
    h = take(ext, shard.src_slot) + edge_embed
    for layer in range(weights.shape[0]):
        m = act(h)
        mW = m @ weights[layer]  # E-sized; needs no exchange
        m_v = halo_reduce(m, shard, axis)  # exchange 1
        ext = halo_gather(m_v @ weights[layer], shard, axis)  # exchange 2
        out = take(ext, shard.src_slot) - take(mW, shard.rev) + biases[layer]
        h = h + out if residual else out
    return halo_reduce(h, shard, axis), h


class HaloChempropBlock(nn.Module):
    """The D-MPNN block over a :class:`HaloShard` (``shard -> shard``, node
    and edge hiddens updated), in place of ``ChempropBlock`` in a composed
    model. Its stacked parameters keep the JAX names and layout: ``weights
    [depth, d, d]`` (``[in, out]``) drawn uniform in ``±1/sqrt(d)`` and
    ``biases [depth, d]`` at zero."""

    def __init__(self, axis: str, hidden_dim: int = DEFAULT_HIDDEN_DIM, depth: int = 3, residual: bool = True,
                 act: Callable = torch.relu):
        super().__init__()
        self.axis, self.residual, self.act = axis, residual, act
        self.hidden_dim, self.depth = hidden_dim, depth
        self.weights = nn.Parameter(torch.empty(depth, hidden_dim, hidden_dim))
        self.biases = nn.Parameter(torch.empty(depth, hidden_dim))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        scale = 1.0 / np.sqrt(self.hidden_dim)
        with torch.no_grad():
            self.weights.uniform_(-scale, scale, generator=generator)
            self.biases.zero_()

    def forward(self, shard: HaloShard) -> HaloShard:
        node_h, edge_h = halo_mpnn_block(shard.node_feats, shard.edge_feats, shard, self.weights, self.biases,
                                         self.axis, residual=self.residual, act=self.act)
        return shard.update(node_feats=node_h, edge_feats=edge_h)


def comm_bytes_per_step(shard: HaloShard, hidden_dim: int, depth: int, dtype_bytes: int = 4) -> int:
    """Bytes each shard exchanges a step: two exchanges a layer plus the
    first gather and the last reduce (``depth + 1`` of each)."""
    return 2 * (depth + 1) * shard.n_shards * shard.b_cap * hidden_dim * dtype_bytes
