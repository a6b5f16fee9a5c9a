"""Dense per-molecule and bin-packed graph layouts.

Same formats as ``notorch_tpu.data.dense``: arrays shaped ``[B, E_m, ...]``
/ ``[B, V_m, ...]`` with molecule-local (or bin-local) node indices, edges
interleaved in reverse pairs so that ``rev(e) = e XOR 1``, and one reserved
padding-sink node slot ``V_m - 1`` that padding edges point at.

The builders run on the host in numpy. With ``np_out=False`` they wrap the
arrays as CPU tensors (no copy); :meth:`DenseBatchedGraph.to` moves a batch
to the device.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from notorch_tpu_torch.data.graph import Graph

__all__ = [
    "DenseBatchedGraph",
    "pack_graphs_dense",
    "pad_graphs_dense",
    "plan_bins",
    "rev_pair_swap",
]


@dataclass
class DenseBatchedGraph:
    """A batch of molecules as dense per-molecule blocks.

    ``node_feats``: [B, V_m, t_v] ints (type ids) or [B, V_m, d] floats.
    ``src``/``dst``: [B, E_m] molecule-local indices; padding edges point at
    node ``V_m - 1`` (a padding slot — real molecules never use it because
    collation reserves it).

    When built by :func:`pack_graphs_dense`, each row is a BIN holding
    several bin-packed molecules (node ids offset per molecule so that the
    edge-to-edge compares cannot match across molecules); ``node_graph``
    then maps every node slot to its molecule's batch row (``n_mols`` for
    padding slots) and per-molecule readouts segment-sum over it.

    Fields are tensors, or numpy arrays when built with ``np_out=True``.
    """

    node_feats: Any
    edge_feats: Any
    src: Any  # [B, E_m] int32
    dst: Any  # [B, E_m] int32
    node_mask: Any  # [B, V_m] bool
    edge_mask: Any  # [B, E_m] bool
    graph_mask: Any  # [B] bool — False for batch-padding slots
    # packed-bin extras (None for the per-molecule layout)
    node_graph: Any = None  # [B, V_m] int32 molecule id per slot
    n_mols: int | None = None
    # > 1 only for pack_graphs_dense(n_shards=k) batches, whose node_graph
    # carries CHUNK-LOCAL molecule ids; per-molecule readouts refuse them.
    n_shards: int = 1

    _ARRAYS = ("node_feats", "edge_feats", "src", "dst", "node_mask", "edge_mask",
               "graph_mask", "node_graph")

    @property
    def n_graphs(self) -> int:
        return self.node_feats.shape[0]

    @property
    def nodes_per_graph(self) -> int:
        return self.node_feats.shape[1]

    @property
    def edges_per_graph(self) -> int:
        return self.src.shape[1]

    def __len__(self) -> int:
        return self.n_graphs

    def update(self, **kwargs) -> "DenseBatchedGraph":
        return dataclasses.replace(self, **kwargs)

    def to(self, device) -> "DenseBatchedGraph":
        """Move every array field to ``device`` (numpy fields become tensors)."""

        def move(x):
            if x is None:
                return None
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x)
            return x.to(device)

        return self.update(**{k: move(getattr(self, k)) for k in self._ARRAYS})

    def scatter_matrix(self, dtype=torch.float32) -> torch.Tensor:
        """[B, V_m, E_m] with S[b, v, e] = 1 iff dst[b, e] == v and edge is
        real. ``S @ messages`` = per-node incoming sum."""
        v_ids = torch.arange(self.nodes_per_graph, device=self.dst.device)[None, :, None]
        S = (self.dst[:, None, :] == v_ids) & self.edge_mask[:, None, :]
        return S.to(dtype)

    def gather_matrix(self, dtype=torch.float32) -> torch.Tensor:
        """[B, E_m, V_m] with G[b, e, v] = 1 iff src[b, e] == v."""
        v_ids = torch.arange(self.nodes_per_graph, device=self.src.device)[None, None, :]
        return (self.src[:, :, None] == v_ids).to(dtype)


def rev_pair_swap(edge_values: torch.Tensor) -> torch.Tensor:
    """messages[rev] for the interleaved pair layout: a pure reshape."""
    B, E = edge_values.shape[:2]
    rest = tuple(edge_values.shape[2:])
    paired = edge_values.reshape(B, E // 2, 2, *rest)
    return paired.flip(2).reshape(B, E, *rest)


def _out(arrays: dict, np_out: bool) -> dict:
    return arrays if np_out else {k: torch.from_numpy(v) for k, v in arrays.items()}


def pad_graphs_dense(
    graphs: Iterable[Graph],
    nodes_per_graph: int,
    edges_per_graph: int,
    graph_cap: int | None = None,
    np_out: bool = False,
) -> DenseBatchedGraph:
    """Pad each molecule into its own [V_m, E_m] block.

    ``nodes_per_graph`` must exceed the largest molecule by 1 (the padding
    sink slot); ``edges_per_graph`` must be even (pair layout).
    """
    graphs = list(graphs)
    B = graph_cap if graph_cap is not None else len(graphs)
    if len(graphs) > B:
        raise ValueError(f"{len(graphs)} graphs exceed graph_cap={B}")
    if edges_per_graph % 2 != 0:
        raise ValueError("edges_per_graph must be even (interleaved pair layout)")
    V_m, E_m = nodes_per_graph, edges_per_graph

    t_v = graphs[0].node_types.shape[1] if graphs else 1
    t_e = graphs[0].edge_types.shape[1] if graphs else 1

    node_types = np.zeros((B, V_m, t_v), dtype=np.int32)
    edge_types = np.zeros((B, E_m, t_e), dtype=np.int32)
    src = np.full((B, E_m), V_m - 1, dtype=np.int32)
    dst = np.full((B, E_m), V_m - 1, dtype=np.int32)
    node_mask = np.zeros((B, V_m), dtype=bool)
    edge_mask = np.zeros((B, E_m), dtype=bool)
    graph_mask = np.zeros(B, dtype=bool)

    for i, g in enumerate(graphs):
        V, E = g.num_nodes, g.num_edges
        if V + 1 > V_m:
            raise ValueError(f"molecule {i} has {V} nodes; nodes_per_graph={V_m} (1 reserved)")
        if E > E_m:
            raise ValueError(f"molecule {i} has {E} edges; edges_per_graph={E_m}")
        node_types[i, :V] = g.node_types
        edge_types[i, :E] = g.edge_types
        src[i, :E] = g.src
        dst[i, :E] = g.dst
        node_mask[i, :V] = True
        edge_mask[i, :E] = True
        graph_mask[i] = True

    return DenseBatchedGraph(**_out(dict(
        node_feats=node_types, edge_feats=edge_types, src=src, dst=dst,
        node_mask=node_mask, edge_mask=edge_mask, graph_mask=graph_mask,
    ), np_out))


def plan_bins(graphs: list[Graph], nodes_per_bin: int, edges_per_bin: int) -> list[list[int]]:
    """First-fit-decreasing bin plan (by edges; ties broken by nodes):
    returns molecule-index lists, one per bin, under the (nodes_per_bin - 1,
    edges_per_bin) capacities (one node slot reserved as the padding sink)."""
    V_b, E_b = nodes_per_bin, edges_per_bin
    order = sorted(
        range(len(graphs)),
        key=lambda i: (graphs[i].num_edges, graphs[i].num_nodes),
        reverse=True,
    )
    bins: list[list[int]] = []
    free: list[tuple[int, int]] = []  # (free_nodes, free_edges) per bin
    for i in order:
        g = graphs[i]
        need_v, need_e = g.num_nodes, g.num_edges
        for b, (fv, fe) in enumerate(free):
            if need_v <= fv and need_e <= fe:
                bins[b].append(i)
                free[b] = (fv - need_v, fe - need_e)
                break
        else:
            bins.append([i])
            free.append((V_b - 1 - need_v, E_b - need_e))
    return bins


def pack_graphs_dense(
    graphs: Iterable[Graph],
    nodes_per_bin: int,
    edges_per_bin: int,
    mol_cap: int | None = None,
    bin_cap: int | None = None,
    np_out: bool = False,
    n_shards: int = 1,
) -> DenseBatchedGraph:
    """Bin-pack molecules into fixed [V_bin, E_bin] blocks (first-fit
    decreasing by edges).

    Several molecules share a bin with per-molecule node-id offsets, so the
    edge-to-edge compares (``src(e) == dst(e')``) cannot match across
    molecules while most edge lanes hold real edges.

    ``node_graph[bin, v]`` maps node slots back to the molecule's batch row
    (``n_mols`` for padding slots) for per-molecule readouts. Slot
    ``V_bin - 1`` in every bin is the padding-edge sink.

    ``n_shards > 1`` splits the molecules into ``n_shards`` contiguous equal
    chunks, packs each into its own equal-count run of bins, and gives
    ``node_graph`` CHUNK-LOCAL molecule ids (``n_mols`` becomes the
    per-shard count), as ``notorch_tpu.data.dense.pack_graphs_dense`` does
    for its data-parallel trainer.
    """
    graphs = list(graphs)
    if edges_per_bin % 2 != 0:
        raise ValueError("edges_per_bin must be even (interleaved pair layout)")
    V_b, E_b = nodes_per_bin, edges_per_bin
    M = mol_cap if mol_cap is not None else len(graphs)
    if len(graphs) > M:
        raise ValueError(f"{len(graphs)} graphs exceed mol_cap={M}")
    if M % n_shards != 0:
        raise ValueError(f"mol_cap {M} not divisible by n_shards {n_shards}")
    for i, g in enumerate(graphs):
        if g.num_nodes > V_b - 1 or g.num_edges > E_b:
            raise ValueError(
                f"molecule {i} ({g.num_nodes} nodes, {g.num_edges} edges) "
                f"exceeds bin caps ({V_b - 1} nodes, {E_b} edges)"
            )
        # molecules are appended at cumulative edge offsets, so ONE graph
        # with an odd (non-pair-interleaved) edge list would shift the
        # reverse-pair alignment of every molecule packed after it
        if g.num_edges % 2 != 0:
            raise ValueError(
                f"molecule {i} has an odd edge count ({g.num_edges}); packing "
                "requires the (u,v),(v,u) interleaved reverse-pair layout"
            )

    M_local = M // n_shards
    chunks = [graphs[s * M_local : (s + 1) * M_local] for s in range(n_shards)]
    plans = [plan_bins(c, V_b, E_b) for c in chunks]
    need = max((len(p) for p in plans), default=0) * n_shards
    NB = bin_cap if bin_cap is not None else need
    if need > NB:
        raise ValueError(f"packing needs {need} bins; bin_cap={NB}")
    if NB % n_shards != 0:
        raise ValueError(f"bin_cap {NB} not divisible by n_shards {n_shards}")
    NB_local = NB // n_shards

    t_v = graphs[0].node_types.shape[1] if graphs else 1
    t_e = graphs[0].edge_types.shape[1] if graphs else 1
    node_types = np.zeros((NB, V_b, t_v), dtype=np.int32)
    edge_types = np.zeros((NB, E_b, t_e), dtype=np.int32)
    src = np.full((NB, E_b), V_b - 1, dtype=np.int32)
    dst = np.full((NB, E_b), V_b - 1, dtype=np.int32)
    node_mask = np.zeros((NB, V_b), dtype=bool)
    edge_mask = np.zeros((NB, E_b), dtype=bool)
    graph_mask = np.zeros(NB, dtype=bool)
    node_graph = np.full((NB, V_b), M_local, dtype=np.int32)

    for s, (chunk, plan) in enumerate(zip(chunks, plans)):
        for b_local, members in enumerate(plan):
            b = s * NB_local + b_local
            v0 = e0 = 0
            for i in members:  # i is chunk-local
                g = chunk[i]
                V, E = g.num_nodes, g.num_edges
                node_types[b, v0 : v0 + V] = g.node_types
                edge_types[b, e0 : e0 + E] = g.edge_types
                src[b, e0 : e0 + E] = np.asarray(g.src) + v0
                dst[b, e0 : e0 + E] = np.asarray(g.dst) + v0
                node_mask[b, v0 : v0 + V] = True
                edge_mask[b, e0 : e0 + E] = True
                node_graph[b, v0 : v0 + V] = i
                v0 += V
                e0 += E
            graph_mask[b] = True

    return DenseBatchedGraph(
        **_out(dict(
            node_feats=node_types, edge_feats=edge_types, src=src, dst=dst,
            node_mask=node_mask, edge_mask=edge_mask, graph_mask=graph_mask,
            node_graph=node_graph,
        ), np_out),
        n_mols=M_local,
        n_shards=n_shards,
    )
