"""One shard of a halo-partitioned batch.

The batch type of :mod:`notorch_tpu_torch.parallel.halo` (port of
``notorch_tpu.parallel.halo.HaloShard``), kept in the data layer so that
batching moves it to a device as it does the other batch types.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

__all__ = ["HaloShard"]


@dataclass
class HaloShard:
    """One shard of a halo-partitioned batch. It has enough of
    :class:`~notorch_tpu_torch.data.graph.BatchedGraph` (``node_feats``,
    ``edge_feats``, ``node_graph``, ``node_mask``, ``n_graphs``, ``update``,
    ``to``) that the embedding and the psum-aware readouts take it as it
    is; the message passing is :func:`halo_mpnn_block`.

    Slot layouts (all local): the partial buffer ``[v_loc + h_cap + 1]``
    (own block, halo-out slots, trash); the accumulate buffer ``[v_loc +
    1]`` (own block, trash); the gather buffer ``[v_loc + 1 + n * b_cap]``
    (own block, a zero row, the halo-in rows, owner-major)."""

    node_feats: Any  # [v_loc, t] i32 types or [v_loc, d] float
    edge_feats: Any  # [e_loc, t] / [e_loc, d]
    node_graph: Any  # [v_loc] GLOBAL graph ids (padding -> n_graphs)
    node_mask: Any  # [v_loc] bool
    edge_mask: Any  # [e_loc] bool
    edge_graph: Any  # [e_loc]
    edge_ids: Any  # [e_loc] global edge id (-1 for padding slots)
    rev: Any  # [e_loc] local reverse-edge index
    src_slot: Any  # [e_loc] into the gather buffer
    dst_slot: Any  # [e_loc] into the partial buffer
    scatter_send_slot: Any  # [n, b_cap] into the partial buffer
    scatter_recv_tgt: Any  # [n, b_cap] into the accumulate buffer
    gather_send_slot: Any  # [n, b_cap] into [v_loc] + zero row
    num_graphs_real: Any  # [] i32
    v_loc: int = 0
    h_cap: int = 0
    b_cap: int = 0
    n_shards: int = 1
    n_graphs: int = 1

    _ARRAYS = ("node_feats", "edge_feats", "node_graph", "node_mask", "edge_mask", "edge_graph", "edge_ids", "rev",
               "src_slot", "dst_slot", "scatter_send_slot", "scatter_recv_tgt", "gather_send_slot",
               "num_graphs_real")

    @property
    def num_nodes(self) -> int:
        return self.v_loc

    @property
    def num_edges(self) -> int:
        return self.edge_mask.shape[-1]

    def update(self, **kwargs) -> "HaloShard":
        return dataclasses.replace(self, **kwargs)

    def to(self, device) -> "HaloShard":
        """Every array field on ``device`` (numpy fields become tensors)."""

        def move(x):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x if x.flags.c_contiguous else x.copy())
            return x.to(device)

        return self.update(**{k: move(getattr(self, k)) for k in self._ARRAYS})
