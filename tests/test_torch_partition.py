"""The host builders of the parallel package against the JAX package's, array
for array and bit for bit, on ``tests/data/smis.csv`` (and a lipo head for
the loader) at 2 and 4 shards. No processes are started.

- ``partition_molecules`` (LPT over a stable argsort), ``shard_graph_edges``,
  ``build_spmd_batch`` (NaN targets, extra inputs), ``build_molecule_spmd_batch``
  (with the masked pretraining's ``node_labels``, and a shard left empty),
  ``partition_edges_halo``, ``build_halo_spmd_batch`` and ``halo_spmd_caps``;
- ``host_local_slice`` for every process of worlds of 1 to 5;
- ``ShardedDataLoader``'s stacked batches for two shuffled epochs;
- ``local_entry``: a rank's entry, contiguous and fresh.
"""

import numpy as np
import pytest
import torch

from notorch_tpu.models.pretrain import MaskAtoms as JaxMaskAtoms
from notorch_tpu.parallel import distributed as jax_distributed
from notorch_tpu.parallel import halo as jax_halo
from notorch_tpu.parallel import loader as jax_loader
from notorch_tpu.parallel import partition as jax_partition
from notorch_tpu.transforms import MolToGraph as JaxMolToGraph
from notorch_tpu.transforms import Pipeline as JaxPipeline
from notorch_tpu.transforms import SmiToMol as JaxSmiToMol
from notorch_tpu_torch.cli.train import read_table
from notorch_tpu_torch.data.graph import pad_graphs
from notorch_tpu_torch.models.pretrain import MaskAtoms
from notorch_tpu_torch.parallel import distributed, partition
from notorch_tpu_torch.parallel.halo import HaloShard, partition_edges_halo
from notorch_tpu_torch.parallel.loader import ShardedDataLoader
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol

from .test_torch_gat import ROOT, datasets, lipo_csv  # noqa: F401 (fixtures)

SHARDS = [2, 4]
PER = 5


@pytest.fixture(scope="module")
def graphs():
    smiles = read_table(f"{ROOT}/tests/data/smis.csv")["smiles"][:40]
    jpipe, pipe = JaxPipeline(JaxSmiToMol(), JaxMolToGraph()), Pipeline(SmiToMol(), MolToGraph())
    return [pipe(s) for s in smiles], [jpipe(s) for s in smiles]


def assert_same(ours, ref, where="batch"):
    """Every array of ``ours`` equals ``ref``'s (same dtype, same bits); the
    static fields too."""
    if isinstance(ours, dict):
        assert sorted(ours) == sorted(ref), where
        for k in ours:
            assert_same(ours[k], ref[k], f"{where}[{k}]")
        return
    if isinstance(ours, list):
        assert len(ours) == len(ref), where
        for i, (a, b) in enumerate(zip(ours, ref)):
            assert_same(a, b, f"{where}[{i}]")
        return
    if hasattr(ours, "_ARRAYS"):
        for f in ours._ARRAYS:
            a, b = getattr(ours, f), getattr(ref, f)
            assert (a is None) == (b is None), f"{where}.{f}"
            if a is not None:
                assert_same(a, b, f"{where}.{f}")
        statics = ("v_loc", "h_cap", "b_cap", "n_shards", "n_graphs") if isinstance(ours, HaloShard) else ("n_graphs",)
        for f in statics:
            assert getattr(ours, f) == getattr(ref, f), f"{where}.{f}"
        return
    a, b = np.asarray(ours), np.asarray(ref)
    assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=where)


def caps(*groups, quantum=64) -> tuple[int, int]:
    """Node and edge caps that hold the largest of ``groups`` (multiples of
    ``quantum``)."""
    v = max(sum(g.num_nodes for g in grp) for grp in groups) + 1
    e = max(sum(g.num_edges for g in grp) for grp in groups)
    return -(-v // quantum) * quantum, -(-e // quantum) * quantum


def groups_of(gs, n_data, per=PER, start=0):
    return [gs[start + i * per : start + (i + 1) * per] for i in range(n_data)]


def targets(n_data, per=PER, seed=0):
    y = np.random.default_rng(seed).normal(size=(n_data, per, 2)).astype(np.float32)
    y[0, 1, 0] = np.nan  # a missing label: target 0, mask False
    return {"y": y}


@pytest.mark.parametrize("n", SHARDS)
def test_partition_molecules_and_edge_shards_equal_jax(graphs, n):
    ours, ref = graphs
    assert partition.partition_molecules(ours[:13], n) == jax_partition.partition_molecules(ref[:13], n)
    V, E = caps(ours[:6])
    bg = pad_graphs(ours[:6], V, E, graph_cap=6, np_out=True)
    jbg = jax_partition.pad_graphs(ref[:6], V, E, graph_cap=6, np_out=True)
    assert_same(partition.shard_graph_edges(bg, n), jax_partition.shard_graph_edges(jbg, n))


@pytest.mark.parametrize("n", SHARDS)
def test_build_spmd_batch_equals_jax(graphs, n):
    ours, ref = graphs
    V, E = caps(*groups_of(ours, 2))
    extra = {"w": [np.arange(V, dtype=np.int32) + i for i in range(2)]}
    kw = dict(node_cap=V, edge_cap=E, graph_cap=PER, n_edge_shards=n, extra_inputs=extra)
    batch = partition.build_spmd_batch(groups_of(ours, 2), targets(2), **kw)
    assert_same(batch, jax_partition.build_spmd_batch(groups_of(ref, 2), targets(2), **kw))
    assert batch["inputs.G"].src.shape == (2, n, E // n) and batch["targets.y"].shape == (2, n, PER, 2)


@pytest.mark.parametrize("n", SHARDS)
def test_build_molecule_spmd_batch_equals_jax(graphs, n):
    """With the masked pretraining's labels collated per shard; the last
    data group has fewer molecules than shards on 4, so a shard is empty
    (one dummy molecule of pure padding)."""
    ours, ref = graphs
    mask, jmask = MaskAtoms(mask_rate=0.3, seed=3), JaxMaskAtoms(mask_rate=0.3, seed=3)
    groups = [[mask(g) for g in grp] for grp in groups_of(ours, 2)] + [[mask(g) for g in ours[20:23]]]
    jgroups = [[jmask(g) for g in grp] for grp in groups_of(ref, 2)] + [[jmask(g) for g in ref[20:23]]]
    V, E = caps(*groups)
    kw = dict(node_cap=V, edge_cap=E, graph_cap=PER, n_graph_shards=n, node_attrs=("node_labels",))
    y = {"y": np.concatenate([targets(2)["y"], np.ones((1, PER, 2), np.float32)])}
    batch = partition.build_molecule_spmd_batch(groups, y, **kw)
    assert_same(batch, jax_partition.build_molecule_spmd_batch(jgroups, y, **kw))
    if n == 4:
        assert not batch["inputs.G"].node_mask[2, 3].any() and (batch["inputs.node_labels"][2, 3] == -1).all()


@pytest.mark.parametrize("n", SHARDS)
def test_halo_partition_and_batch_equal_jax(graphs, n):
    """``partition_edges_halo`` of one padded batch; ``build_halo_spmd_batch``
    over three data groups at the caps of ``halo_spmd_caps`` (and at the
    groups' own maxima); the boundary is not empty."""
    ours, ref = graphs
    node_cap, E = caps(ours[:12], quantum=8 * n)
    bg = pad_graphs(ours[:8], node_cap, E, graph_cap=8, np_out=True)
    jbg = jax_partition.pad_graphs(ref[:8], node_cap, E, graph_cap=8, np_out=True)
    shards = partition_edges_halo(bg, n)
    assert_same(shards, jax_halo.partition_edges_halo(jbg, n))
    assert shards[0].b_cap > 0
    all_groups = [[groups_of(ours, 3, 4, start)] for start in (0, 12)]
    jall = [[groups_of(ref, 3, 4, start)] for start in (0, 12)]
    halo_caps = partition.halo_spmd_caps([g[0] for g in all_groups], node_cap, E, 4, n)
    assert halo_caps == jax_partition.halo_spmd_caps([g[0] for g in jall], node_cap, E, 4, n)
    y = {"y": np.random.default_rng(1).normal(size=(3, 4, 1)).astype(np.float32)}
    for kw in ({}, dict(zip(("pair_cap", "b_cap", "h_cap"), halo_caps))):
        batch = partition.build_halo_spmd_batch(all_groups[0][0], y, node_cap, E, 4, n_shards=n, **kw)
        assert_same(batch, jax_partition.build_halo_spmd_batch(jall[0][0], y, node_cap, E, 4, n_shards=n, **kw))


@pytest.mark.parametrize("count", [1, 2, 3, 4, 5])
def test_host_local_slice_equals_jax(monkeypatch, count):
    for pid in range(count):
        monkeypatch.setattr(distributed, "process_info", lambda p=pid: (p, count))
        monkeypatch.setattr(jax_distributed, "process_info", lambda p=pid: (p, count))
        for n in (0, 1, 7, 16, 103):
            assert distributed.host_local_slice(n) == jax_distributed.host_local_slice(n)


def test_sharded_loader_equals_jax_for_two_epochs(datasets):  # noqa: F811
    ds, jds = datasets
    kw = dict(n_data=2, per_shard_graphs=6, n_edge_shards=2, shuffle=True, seed=4)
    loader, jloader = ShardedDataLoader(ds, **kw), jax_loader.ShardedDataLoader(jds, **kw)
    assert len(loader) == len(jloader) > 1
    for epoch in range(2):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        batches, ref = list(loader), list(jloader)
        assert len(batches) == len(ref)
        assert_same(batches, ref, f"epoch {epoch}")


def test_local_entry_is_a_fresh_contiguous_copy(graphs):
    batch = partition.build_spmd_batch(groups_of(graphs[0], 2), targets(2), *caps(*groups_of(graphs[0], 2)), PER,
                                       n_edge_shards=2)
    entry = partition.local_entry(batch, (1, 1))
    G = entry["inputs.G"]
    assert G.src.flags.c_contiguous and not np.shares_memory(G.src, batch["inputs.G"].src)
    np.testing.assert_array_equal(G.src, batch["inputs.G"].src[1, 1])
    t = partition.local_entry({"x": torch.arange(24).reshape(2, 3, 4)[:, :, 1:]}, (1, 2))["x"]
    assert t.is_contiguous() and t.tolist() == [21, 22, 23]
