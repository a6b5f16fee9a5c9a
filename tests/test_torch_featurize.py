"""The port featurizes and packs bit for bit like the JAX package: Graph
arrays, pack_graphs_dense arrays and dense_packed loader batches."""

import csv
import os

import numpy as np
import pytest
import torch

from notorch_tpu.data.batching import DataLoader as JaxDataLoader
from notorch_tpu.data.dataset import MolecularDataset as JaxDataset
from notorch_tpu.data.dataset import TargetSpec as JaxTargetSpec
from notorch_tpu.data.dataset import TransformManager as JaxTM
from notorch_tpu.data.dense import pack_graphs_dense as jax_pack
from notorch_tpu.data.dense import pad_graphs_dense as jax_pad
from notorch_tpu.transforms import MolToGraph as JaxMolToGraph
from notorch_tpu.transforms import Pipeline as JaxPipeline
from notorch_tpu.transforms import SmiToMol as JaxSmiToMol
from notorch_tpu_torch.data.batching import DataLoader, bucket_ladder, round_up_ladder
from notorch_tpu_torch.data.dataset import MolecularDataset, TargetSpec, TransformManager
from notorch_tpu_torch.data.dense import pack_graphs_dense, pad_graphs_dense, rev_pair_swap
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol

DATA = os.path.join(os.path.dirname(__file__), "data")
PIPE = Pipeline(SmiToMol(), MolToGraph())
JAX_PIPE = JaxPipeline(JaxSmiToMol(), JaxMolToGraph())
GRAPH_FIELDS = ("node_types", "edge_types", "src", "dst", "rev")
DENSE_FIELDS = ("node_feats", "edge_feats", "src", "dst", "node_mask", "edge_mask",
                "graph_mask", "node_graph")


def _column(name, col, n=None):
    with open(os.path.join(DATA, name)) as f:
        rows = [row[col] for row in csv.DictReader(f)]
    return rows[:n] if n else rows


def _lipo(n):
    with open(os.path.join(DATA, "lipo.csv")) as f:
        rows = list(csv.DictReader(f))[:n]
    return {"smiles": [r["smiles"] for r in rows], "lipo": [float(r["lipo"]) for r in rows]}


@pytest.mark.parametrize("table,n", [("smis.csv", None), ("lipo.csv", 200)])
def test_graph_arrays_equal(table, n):
    for smi in _column(table, "smiles", n):
        g, ref = PIPE(smi), JAX_PIPE(smi)
        for f in GRAPH_FIELDS:
            a, b = getattr(g, f), getattr(ref, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (smi, f)


def _assert_dense_equal(G, ref):
    for f in DENSE_FIELDS:
        a, b = getattr(G, f), getattr(ref, f)
        if b is None:
            assert a is None, f
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f
    assert (G.n_mols, G.n_shards) == (ref.n_mols, ref.n_shards)


@pytest.mark.parametrize("n_shards", [1, 2])
def test_pack_graphs_dense_equal(n_shards):
    smis = _column("lipo.csv", "smiles", 64)
    graphs = [PIPE(s) for s in smis]
    jax_graphs = [JAX_PIPE(s) for s in smis]
    G = pack_graphs_dense(graphs, 72, 128, mol_cap=64, bin_cap=32, np_out=True, n_shards=n_shards)
    ref = jax_pack(jax_graphs, 72, 128, mol_cap=64, bin_cap=32, np_out=True, n_shards=n_shards)
    _assert_dense_equal(G, ref)
    # np_out=False gives the same arrays as CPU tensors
    _assert_dense_equal(pack_graphs_dense(graphs, 72, 128, mol_cap=64, bin_cap=32,
                                          n_shards=n_shards), ref)


def test_pad_graphs_dense_equal():
    smis = _column("smis.csv", "smiles", 10)
    G = pad_graphs_dense([PIPE(s) for s in smis], 64, 128, graph_cap=12, np_out=True)
    ref = jax_pad([JAX_PIPE(s) for s in smis], 64, 128, graph_cap=12, np_out=True)
    _assert_dense_equal(G, ref)


def test_dense_packed_loader_batches_equal():
    table = _lipo(128)
    ds = MolecularDataset(table, {"graph": TransformManager(PIPE, "smiles", "G")},
                          targets={"y": TargetSpec(["lipo"])})
    ref_ds = JaxDataset(table, {"graph": JaxTM(JAX_PIPE, "smiles", "G")},
                        targets={"y": JaxTargetSpec(["lipo"])})
    batches = list(DataLoader(ds, batch_size=64, layout="dense_packed"))
    ref_batches = list(JaxDataLoader(ref_ds, batch_size=64, layout="dense_packed"))
    assert len(batches) == len(ref_batches) == 2
    for b, rb in zip(batches, ref_batches):
        assert sorted(b) == sorted(rb)
        _assert_dense_equal(b["inputs.G"], rb["inputs.G"])
        for k in ("targets.y", "targets.y_mask"):
            assert b[k].dtype == rb[k].dtype and np.array_equal(b[k], rb[k])


def test_loader_pads_last_batch_and_ladders():
    table = _lipo(70)
    ds = MolecularDataset(table, {"graph": TransformManager(PIPE, "smiles", "G")},
                          targets={"y": TargetSpec(["lipo"])})
    last = list(DataLoader(ds, batch_size=64))[-1]
    assert last["targets.y_mask"].sum() == 6 and last["inputs.G"].n_mols == 64
    assert bucket_ladder(32, 300) == [32, 48, 64, 96, 128, 192, 256, 384, 512]
    assert round_up_ladder(129, bucket_ladder(32, 300)) == 192


def test_rev_pair_swap():
    x = torch.arange(2 * 6 * 3).reshape(2, 6, 3)
    y = rev_pair_swap(x)
    assert torch.equal(y[:, 0], x[:, 1]) and torch.equal(y[:, 5], x[:, 4])


def test_loader_rejects_unported_layouts():
    """Every layout of the JAX loader is ported (flat, dense, dense_packed);
    any other name, such as the model-side "auto", is refused with the list."""
    ds = MolecularDataset(_lipo(4), {"graph": PIPE})
    with pytest.raises(ValueError, match="flat"):
        DataLoader(ds, layout="auto")
