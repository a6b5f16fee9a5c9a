"""Graph partitioning for multi-process training: the host builders.

Port of ``notorch_tpu.parallel.partition``, plain numpy on the port's
:class:`~notorch_tpu_torch.data.graph.BatchedGraph`; every array equals the
JAX package's. Three schemes:

- **molecule partitioning** (the production graph axis): whole molecules go
  to shards, nodes and edges together, so message passing is local and the
  only cross-shard traffic is the readout's ``psum`` of ``[G, d]`` partials
  (:func:`partition_molecules`, :func:`build_molecule_spmd_batch`);
- **edge partitioning with replicated nodes** (``replicate``): one batch's
  edge array split over the shards, the E->V sums combined by a ``psum``
  every layer (:func:`shard_graph_edges`, :func:`build_spmd_batch`);
- **boundary halo exchange** for graphs larger than a shard
  (:mod:`notorch_tpu_torch.parallel.halo`, :func:`build_halo_spmd_batch`).

The builders give JAX's stacked batch, every leaf ``[n_data, n_graph,
...]``. A rank trains on its own entry alone: :func:`local_entry` copies it
out into fresh contiguous arrays (a view at an offset of the stacked array
could start off the 16-byte alignment the kernels need).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from notorch_tpu_torch.data.graph import BatchedGraph, Graph, build_in_edges, pad_graphs

__all__ = [
    "shard_graph_edges",
    "build_spmd_batch",
    "stack_pytrees",
    "partition_molecules",
    "shard_graph_molecules",
    "build_molecule_spmd_batch",
    "build_halo_spmd_batch",
    "halo_spmd_caps",
    "local_entry",
]


def _fields(x) -> list[str] | None:
    """The array fields of a batch dataclass, None for anything else."""
    return list(x._ARRAYS) if dataclasses.is_dataclass(x) and hasattr(x, "_ARRAYS") else None


def stack_pytrees(trees: list):
    """Stack identical trees (dicts, batch dataclasses, arrays) along a new
    leading axis; a ``None`` field stays ``None`` and the static fields of a
    dataclass are the first tree's, as ``jax.tree.map(np.stack, ...)``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_pytrees([t[k] for t in trees]) for k in first}
    fields = _fields(first)
    if fields is not None:
        return first.update(**{f: None if getattr(first, f) is None else np.stack([getattr(t, f) for t in trees])
                               for f in fields})
    return np.stack([np.asarray(t) for t in trees])


def local_entry(tree, index: tuple[int, ...]):
    """Entry ``index`` of a stacked tree (``tree[...][index]`` of every
    array), each array a fresh contiguous copy: numpy stays numpy, a tensor
    stays on its device."""
    def take(x):
        if isinstance(x, torch.Tensor):
            return x[index].clone(memory_format=torch.contiguous_format)
        if isinstance(x, np.ndarray):
            return np.array(x[index], copy=True, order="C")
        return x

    if isinstance(tree, dict):
        return {k: local_entry(v, index) for k, v in tree.items()}
    fields = _fields(tree)
    if fields is not None:
        return tree.update(**{f: take(getattr(tree, f)) for f in fields})
    return take(tree)


def shard_graph_edges(bg: BatchedGraph, n_shards: int) -> list[BatchedGraph]:
    """Split a host (numpy) padded batch into ``n_shards`` edge shards.

    Node arrays are replicated; edge arrays are contiguous slices of length
    ``E_cap / n_shards`` (it must divide evenly and be even, so that reverse
    pairs stay together); ``rev`` is rebased to shard-local indices and
    each shard gets its own incoming-edge table."""
    E = bg.num_edges
    if E % n_shards != 0:
        raise ValueError(f"edge_cap {E} not divisible by {n_shards} shards")
    per = E // n_shards
    if per % 2 != 0:
        raise ValueError(f"per-shard edge count {per} must be even to keep rev pairs local")
    min_k = bg.in_edges.shape[1] if bg.in_edges is not None else 8
    shards = []
    for i in range(n_shards):
        sl = slice(i * per, (i + 1) * per)
        dst, mask = np.asarray(bg.dst[sl]), np.asarray(bg.edge_mask[sl])
        shards.append(bg.update(
            edge_feats=bg.edge_feats[sl], src=bg.src[sl], dst=bg.dst[sl], rev=bg.rev[sl] - i * per,
            edge_graph=bg.edge_graph[sl], edge_mask=bg.edge_mask[sl],
            in_edges=build_in_edges(dst, mask, bg.num_nodes, min_k=min_k),
        ))
    return shards


def partition_molecules(graphs: list[Graph], n_shards: int) -> list[list[int]]:
    """Assign whole molecules to shards, balancing by edge count (LPT greedy
    bin packing over a stable argsort). Returns per-shard lists of molecule
    indices, each sorted ascending."""
    order = np.argsort([-g.num_edges for g in graphs], kind="stable")
    loads = np.zeros(n_shards, dtype=np.int64)
    assign: list[list[int]] = [[] for _ in range(n_shards)]
    for i in order:
        s = int(np.argmin(loads))
        assign[s].append(int(i))
        loads[s] += max(graphs[i].num_edges, 1)
    return [sorted(a) for a in assign]


def shard_graph_molecules(
    graphs: list[Graph],
    n_shards: int,
    node_cap: int,
    edge_cap: int,
    graph_cap: int,
    assign: list[list[int]] | None = None,
) -> list[BatchedGraph]:
    """Partition molecules over ``n_shards``, each shard padded to the same
    per-shard caps, graph ids relabelled to GLOBAL slots (molecule ``j``'s
    index in ``graphs``; padding the trash slot ``graph_cap``), so the
    shards' readout partials ``psum`` into the global ``[graph_cap, d]``
    embedding. An empty shard holds one dummy molecule of pure padding."""
    if assign is None:
        assign = partition_molecules(graphs, n_shards)
    shards = []
    for idx in assign:
        sub = [graphs[i] for i in idx]
        if sub:
            bg = pad_graphs(sub, node_cap, edge_cap, graph_cap=len(sub), np_out=True)
            lut = np.asarray(idx + [graph_cap], dtype=np.int32)  # local -> global
        else:
            t_v = graphs[0].node_types.shape[1] if graphs else 1
            t_e = graphs[0].edge_types.shape[1] if graphs else 1
            dummy = Graph(node_types=np.zeros((1, t_v), np.int32), edge_types=np.zeros((0, t_e), np.int32),
                          src=np.zeros(0, np.int32), dst=np.zeros(0, np.int32), rev=np.zeros(0, np.int32))
            bg = pad_graphs([dummy], node_cap, edge_cap, graph_cap=1, np_out=True)
            lut = np.asarray([graph_cap, graph_cap], dtype=np.int32)
            bg = bg.update(node_mask=np.zeros_like(bg.node_mask), edge_mask=np.zeros_like(bg.edge_mask),
                           num_graphs_real=np.asarray(0, np.int32))
        shards.append(bg.update(node_graph=lut[np.asarray(bg.node_graph)], edge_graph=lut[np.asarray(bg.edge_graph)],
                                n_graphs=graph_cap))
    return shards


def _tiled(x: np.ndarray, n: int) -> np.ndarray:
    return np.broadcast_to(x, (n,) + x.shape).copy()


def _entry_extras(entry: dict, gi: int, target_arrays, extra_inputs, n: int) -> None:
    """Targets (NaN -> 0 with a mask) and extra inputs of data group ``gi``,
    tiled over the ``n`` graph shards."""
    for name, arr in (target_arrays or {}).items():
        rows = np.asarray(arr[gi], dtype=np.float32)
        entry[f"targets.{name}"] = _tiled(np.nan_to_num(rows, nan=0.0), n)
        entry[f"targets.{name}_mask"] = _tiled(~np.isnan(rows), n)
    for name, arrs in (extra_inputs or {}).items():
        entry[f"inputs.{name}"] = _tiled(np.asarray(arrs[gi]), n)


def build_molecule_spmd_batch(
    graph_groups: list[list[Graph]],
    target_arrays: dict[str, np.ndarray] | None,
    node_cap: int,
    edge_cap: int,
    graph_cap: int,
    n_graph_shards: int = 1,
    extra_inputs: dict[str, list[np.ndarray]] | None = None,
    node_attrs: tuple[str, ...] = (),
):
    """:func:`build_spmd_batch` with MOLECULE partitions on the graph axis
    (per-shard caps ``node_cap``/``edge_cap``). Targets are tiled over the
    graph axis. ``node_attrs`` names per-node int attributes of the ragged
    graphs (the masked pretraining's ``node_labels``), collated per shard in
    its node layout as ``inputs.<name>`` (padding -1)."""
    data_entries = []
    for gi, graphs in enumerate(graph_groups):
        assign = partition_molecules(graphs, n_graph_shards)
        shards = shard_graph_molecules(graphs, n_graph_shards, node_cap, edge_cap, graph_cap, assign=assign)
        entry = {"inputs.G": stack_pytrees(shards)}
        _entry_extras(entry, gi, target_arrays, extra_inputs, n_graph_shards)
        for attr in node_attrs or ():
            rows = []
            for idx in assign:
                vals = np.full(node_cap, -1, dtype=np.int32)
                off = 0
                for i in idx:
                    v = np.asarray(getattr(graphs[i], attr))
                    vals[off : off + len(v)] = v
                    off += len(v)
                rows.append(vals)
            entry[f"inputs.{attr}"] = np.stack(rows)
        data_entries.append(entry)
    return stack_pytrees(data_entries)


def build_halo_spmd_batch(
    graph_groups: list[list[Graph]],
    target_arrays: dict[str, np.ndarray] | None,
    node_cap: int,
    edge_cap: int,
    graph_cap: int,
    n_shards: int = 1,
    extra_inputs: dict[str, list[np.ndarray]] | None = None,
    pair_cap: int | None = None,
    b_cap: int | None = None,
    h_cap: int | None = None,
):
    """:func:`build_molecule_spmd_batch` with boundary-HALO edge partitions
    on the graph axis: each data group padded into ONE flat graph
    (``node_cap`` divisible by ``n_shards``) and split by
    :func:`~notorch_tpu_torch.parallel.halo.partition_edges_halo`, the
    capacities the maxima over the groups unless given (pass
    :func:`halo_spmd_caps`' for one shape over a whole run)."""
    from notorch_tpu_torch.parallel.halo import partition_edges_halo

    if node_cap % n_shards:
        raise ValueError(f"node_cap {node_cap} must divide into {n_shards} halo shards")
    bgs = [pad_graphs(graphs, node_cap, edge_cap, graph_cap=graph_cap, np_out=True) for graphs in graph_groups]
    if len(bgs) > 1 and (pair_cap is None or b_cap is None or h_cap is None):
        probes = [partition_edges_halo(bg, n_shards) for bg in bgs]
        pair_cap = pair_cap or max(p[0].num_edges // 2 for p in probes)
        b_cap = b_cap if b_cap is not None else max(p[0].b_cap for p in probes)
        h_cap = h_cap if h_cap is not None else max(p[0].h_cap for p in probes)
    data_entries = []
    for gi, bg in enumerate(bgs):
        shards = partition_edges_halo(bg, n_shards, pair_cap=pair_cap, b_cap=b_cap, h_cap=h_cap)
        entry = {"inputs.G": stack_pytrees(shards)}
        _entry_extras(entry, gi, target_arrays, extra_inputs, n_shards)
        data_entries.append(entry)
    return stack_pytrees(data_entries)


def halo_spmd_caps(all_graph_groups, node_cap: int, edge_cap: int, graph_cap: int,
                   n_shards: int) -> tuple[int, int, int]:
    """The largest ``(pair_cap, b_cap, h_cap)`` over every prospective
    batch, for one step shape over a whole run."""
    from notorch_tpu_torch.parallel.halo import partition_edges_halo

    pc = bc = hc = 0
    for groups in all_graph_groups:
        for graphs in groups:
            bg = pad_graphs(graphs, node_cap, edge_cap, graph_cap=graph_cap, np_out=True)
            s = partition_edges_halo(bg, n_shards)[0]
            pc, bc, hc = max(pc, s.num_edges // 2), max(bc, s.b_cap), max(hc, s.h_cap)
    return pc, bc, hc


def build_spmd_batch(
    graph_groups: list[list[Graph]],
    target_arrays: dict[str, np.ndarray] | None,
    node_cap: int,
    edge_cap: int,
    graph_cap: int,
    n_edge_shards: int = 1,
    extra_inputs: dict[str, list[np.ndarray]] | None = None,
):
    """The stacked batch ``[n_data, n_edge_shards, ...]`` of replicated-node
    edge shards: ``graph_groups[i]`` the molecules of data shard ``i``,
    ``target_arrays[name][i]`` its ``[graph_cap, t]`` target rows,
    ``extra_inputs[name][i]`` node-side inputs (``inputs.<name>``); node
    and target leaves tiled over the edge-shard axis."""
    data_entries = []
    for gi, graphs in enumerate(graph_groups):
        bg = pad_graphs(graphs, node_cap, edge_cap, graph_cap=graph_cap, np_out=True)
        entry = {"inputs.G": stack_pytrees(shard_graph_edges(bg, n_edge_shards))}
        _entry_extras(entry, gi, target_arrays, extra_inputs, n_edge_shards)
        data_entries.append(entry)
    return stack_pytrees(data_entries)
