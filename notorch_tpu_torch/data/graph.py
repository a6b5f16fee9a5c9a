"""Graph data model: ragged host graphs and the flat padded batch.

Port of ``notorch_tpu.data.graph``. The host :class:`Graph` is ragged
numpy; :class:`BatchedGraph` is the flat layout, one disjoint-union graph
padded to static caps:

- padding nodes occupy trailing node slots; padding edges point at the last
  (padding) node slot and at themselves via ``rev``, so garbage stays confined
  to padding slots without per-op masking;
- segment ids of padding elements point at one extra "trash" graph slot
  (``n_graphs``), so segment reductions need no masking either;
- ``node_mask``/``edge_mask`` are carried for ops that do need true counts.

The functions (:func:`pad_graphs`, :func:`build_in_edges`,
:func:`sort_edges_by_dst`, :func:`csr_row_ptr`, :func:`with_csr_packing`)
run on the host in numpy and give the JAX package's arrays, array for
array; :meth:`BatchedGraph.to` makes the fields tensors on a device. The
dense layouts live in :mod:`notorch_tpu_torch.data.dense`.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable, Sequence
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from notorch_tpu_torch.kernels.csr_segment import pack_edges_by_tile

__all__ = [
    "Graph",
    "BatchedGraph",
    "build_in_edges",
    "pad_graphs",
    "bucket_caps",
    "sort_edges_by_dst",
    "csr_row_ptr",
    "with_csr_packing",
]


@dataclass
class Graph:
    """A single (host-side, ragged) graph of integer type-index features.

    ``rev[e]`` is the index of the reverse directed edge of ``e`` — the
    D-MPNN essential. With interleaved (u,v),(v,u) edge construction this is
    the pairwise swap permutation [1,0,3,2,...].
    """

    node_types: np.ndarray  # [V, t_v] int32
    edge_types: np.ndarray  # [E, t_e] int32
    src: np.ndarray  # [E] int32
    dst: np.ndarray  # [E] int32
    rev: np.ndarray  # [E] int32

    @property
    def num_nodes(self) -> int:
        return len(self.node_types)

    @property
    def num_edges(self) -> int:
        return len(self.edge_types)

    def __repr__(self) -> str:
        return (
            f"Graph(V={self.num_nodes}, E={self.num_edges}, "
            f"node_types=[{self.num_nodes}, {self.node_types.shape[1]}], "
            f"edge_types=[{self.num_edges}, {self.edge_types.shape[1]}])"
        )


@dataclass
class BatchedGraph:
    """A padded batch of graphs in the flat layout.

    ``node_feats``/``edge_feats`` start as integer type indices and are
    replaced by float hiddens as the model runs (:meth:`update`). Fields are
    numpy arrays as :func:`pad_graphs` gives them, or tensors after :meth:`to`.
    """

    node_feats: Any  # [V_cap, t_v] i32 or [V_cap, d] float
    edge_feats: Any  # [E_cap, t_e] i32 or [E_cap, d] float
    src: Any  # [E_cap] i32
    dst: Any  # [E_cap] i32
    rev: Any  # [E_cap] i32
    node_graph: Any  # [V_cap] i32, padding -> n_graphs (trash slot)
    edge_graph: Any  # [E_cap] i32, padding -> n_graphs
    node_mask: Any  # [V_cap] bool
    edge_mask: Any  # [E_cap] bool
    num_graphs_real: Any  # [] i32
    in_edges: Any = None  # [V_cap, K] incoming edge ids, pad=E_cap
    # tile-packed CSR metadata (with_csr_packing): slot -> edge id / dst,
    # fixed edge budget per 128-node tile, -1 in padding slots
    csr_perm: Any = None  # [n_tiles * budget] i32
    csr_dst: Any = None  # [n_tiles * budget] i32
    n_graphs: int = 1  # graph slots (static)

    _ARRAYS = ("node_feats", "edge_feats", "src", "dst", "rev", "node_graph", "edge_graph",
               "node_mask", "edge_mask", "num_graphs_real", "in_edges", "csr_perm", "csr_dst")

    @property
    def num_nodes(self) -> int:
        return self.node_feats.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_feats.shape[0]

    def __len__(self) -> int:
        return self.n_graphs

    def update(self, **kwargs) -> "BatchedGraph":
        return dataclasses.replace(self, **kwargs)

    def to(self, device) -> "BatchedGraph":
        """Move every array field to ``device`` (numpy fields become tensors)."""

        def move(x):
            if x is None:
                return None
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x if x.flags.c_contiguous else x.copy())
            return x.to(device)

        return self.update(**{k: move(getattr(self, k)) for k in self._ARRAYS})

    def __repr__(self) -> str:
        extras = [name for name in ("in_edges", "csr_perm", "csr_dst") if getattr(self, name) is not None]
        tail = f", extras={extras}" if extras else ""
        return (
            f"BatchedGraph(V_cap={self.num_nodes}, E_cap={self.num_edges}, "
            f"graph_slots={self.n_graphs}, feats={self.node_feats.dtype}{tail})"
        )


def build_in_edges(dst: np.ndarray, edge_mask: np.ndarray, node_cap: int, min_k: int = 8) -> np.ndarray:
    """Fixed-degree incoming-edge table: ``out[v, k]`` = id of the k-th real
    edge with ``dst == v`` (in edge order), padded with ``E_cap`` (a
    sentinel row of zeros in the extended message array). ``K`` is the
    largest in-degree, at least ``min_k``."""
    E = len(dst)
    real = np.nonzero(np.asarray(edge_mask))[0]
    d = np.asarray(dst)[real]
    order = np.argsort(d, kind="stable")
    d_sorted = d[order]
    e_sorted = real[order].astype(np.int32)
    starts = np.searchsorted(d_sorted, np.arange(node_cap))
    pos = np.arange(len(d_sorted)) - starts[d_sorted]
    K = max(min_k, int(pos.max()) + 1 if len(pos) else 1)
    out = np.full((node_cap, K), E, dtype=np.int32)
    out[d_sorted, pos] = e_sorted
    return out


def sort_edges_by_dst(bg: BatchedGraph) -> tuple[BatchedGraph, np.ndarray]:
    """Permute a host (numpy) padded batch into dst-sorted (padded-CSR) edge
    order. Returns ``(sorted_graph, perm)`` where ``perm`` maps new -> old
    edge ids; ``rev`` is rebased through the permutation and ``in_edges``
    rebuilt. Padding edges target the sink node (last slot), so they sort to
    the tail. :func:`csr_row_ptr` of the sorted ``dst`` gives the row
    pointers."""
    dst = np.asarray(bg.dst)
    perm = np.argsort(dst, kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    edge_mask = np.asarray(bg.edge_mask)[perm]
    sorted_bg = bg.update(
        edge_feats=np.asarray(bg.edge_feats)[perm],
        src=np.asarray(bg.src)[perm],
        dst=dst[perm],
        rev=inv[np.asarray(bg.rev)[perm]],
        edge_graph=np.asarray(bg.edge_graph)[perm],
        edge_mask=edge_mask,
        in_edges=build_in_edges(
            dst[perm], edge_mask, bg.num_nodes,
            min_k=bg.in_edges.shape[1] if bg.in_edges is not None else 8,
        ),
    )
    return sorted_bg, perm


def with_csr_packing(bg: BatchedGraph, tile_v: int = 128, budget: int | None = None) -> BatchedGraph:
    """Attach tile-packed CSR metadata (host-side, once per batch topology)
    for :func:`~notorch_tpu_torch.kernels.csr_segment.csr_segment_sum_packed`
    (``impl="csr"``).

    Each ``tile_v``-node tile gets a fixed budget of edge slots; only REAL
    (unmasked) edges are packed — padding edges feed the sink node, whose row
    is masked downstream anyway. ``num_nodes`` must be a multiple of
    ``tile_v``: the flat node ladder's 192 rung is not, and a batch that
    lands on it raises here as it does in the JAX package.
    """
    if bg.num_nodes % tile_v != 0:
        raise ValueError(
            f"node cap {bg.num_nodes} must be a multiple of tile_v={tile_v} "
            "for CSR packing (use 128-aligned node caps; a flat batch whose node total "
            "lands on the ladder's 192 rung needs another batch size)"
        )
    dst = np.asarray(bg.dst)
    real_ids = np.nonzero(np.asarray(bg.edge_mask))[0].astype(np.int32)
    perm_r, packed_dst, _ = pack_edges_by_tile(dst[real_ids], num_nodes=bg.num_nodes, tile_v=tile_v,
                                               budget=budget)
    # re-express slot -> edge id through the real-edge subset
    perm = np.where(perm_r >= 0, real_ids[np.clip(perm_r, 0, None)], -1).astype(np.int32)
    return bg.update(csr_perm=perm, csr_dst=packed_dst)


def csr_row_ptr(sorted_dst: np.ndarray, num_nodes: int) -> np.ndarray:
    """Row pointers for dst-sorted edges: edges of node v live in
    ``[ptr[v], ptr[v+1])``."""
    return np.searchsorted(np.asarray(sorted_dst), np.arange(num_nodes + 1), side="left").astype(np.int32)


def bucket_caps(
    num_nodes: int, num_edges: int, node_buckets: Sequence[int], edge_buckets: Sequence[int]
) -> tuple[int, int]:
    """The smallest bucket caps that fit (num_nodes+1, num_edges) — one node
    slot is always reserved for the padding sink; past the buckets, the
    next power of two."""
    v_cap = next((b for b in node_buckets if b >= num_nodes + 1), None)
    e_cap = next((b for b in edge_buckets if b >= num_edges), None)
    if v_cap is None:
        v_cap = int(2 ** np.ceil(np.log2(max(num_nodes + 1, 2))))
    if e_cap is None:
        e_cap = int(2 ** np.ceil(np.log2(max(num_edges, 2))))
    return v_cap, e_cap


def pad_graphs(
    graphs: Iterable[Graph],
    node_cap: int,
    edge_cap: int,
    graph_cap: int | None = None,
    np_out: bool = False,
) -> BatchedGraph:
    """Disjoint-union batch + pad to static caps.

    The last node slot (``node_cap - 1``) is the padding sink: padded edges
    have ``src = dst = node_cap - 1`` and ``rev`` pointing at themselves.
    With ``np_out=False`` the fields are CPU tensors (no copy).
    """
    graphs = list(graphs)
    n_graphs = len(graphs)
    graph_cap = graph_cap if graph_cap is not None else n_graphs
    if n_graphs > graph_cap:
        raise ValueError(f"{n_graphs} graphs exceed graph_cap={graph_cap}")

    total_v = sum(g.num_nodes for g in graphs)
    total_e = sum(g.num_edges for g in graphs)
    if total_v + 1 > node_cap:
        raise ValueError(f"{total_v} nodes exceed node_cap={node_cap} (one pad slot reserved)")
    if total_e > edge_cap:
        raise ValueError(f"{total_e} edges exceed edge_cap={edge_cap}")

    t_v = graphs[0].node_types.shape[1] if graphs else 1
    t_e = graphs[0].edge_types.shape[1] if graphs else 1

    node_types = np.zeros((node_cap, t_v), dtype=np.int32)
    edge_types = np.zeros((edge_cap, t_e), dtype=np.int32)
    src = np.full(edge_cap, node_cap - 1, dtype=np.int32)
    dst = np.full(edge_cap, node_cap - 1, dtype=np.int32)
    rev = np.arange(edge_cap, dtype=np.int32)
    node_graph = np.full(node_cap, graph_cap, dtype=np.int32)
    edge_graph = np.full(edge_cap, graph_cap, dtype=np.int32)
    node_mask = np.zeros(node_cap, dtype=bool)
    edge_mask = np.zeros(edge_cap, dtype=bool)

    v_off = e_off = 0
    for i, g in enumerate(graphs):
        V, E = g.num_nodes, g.num_edges
        node_types[v_off : v_off + V] = g.node_types
        edge_types[e_off : e_off + E] = g.edge_types
        src[e_off : e_off + E] = g.src + v_off
        dst[e_off : e_off + E] = g.dst + v_off
        rev[e_off : e_off + E] = g.rev + e_off
        node_graph[v_off : v_off + V] = i
        edge_graph[e_off : e_off + E] = i
        node_mask[v_off : v_off + V] = True
        edge_mask[e_off : e_off + E] = True
        v_off += V
        e_off += E

    bg = BatchedGraph(
        node_feats=node_types,
        edge_feats=edge_types,
        src=src,
        dst=dst,
        rev=rev,
        node_graph=node_graph,
        edge_graph=edge_graph,
        node_mask=node_mask,
        edge_mask=edge_mask,
        num_graphs_real=np.asarray(n_graphs, dtype=np.int32),
        in_edges=build_in_edges(dst, edge_mask, node_cap),
        n_graphs=graph_cap,
    )
    return bg if np_out else bg.to("cpu")
