"""The flat padded layout against the JAX package, array for array:
``pad_graphs`` (and ``MolToGraph.collate``), ``build_in_edges``,
``sort_edges_by_dst``, ``csr_row_ptr``, ``pack_edges_by_tile``,
``with_csr_packing`` and ``DataLoader(layout="flat", csr_pack=True)`` over
lipo, in order and shuffled; the packing's budget error, and the node
ladder's 192 rung, which CSR packing refuses in both packages."""

import os

import numpy as np
import pytest
import torch

from notorch_tpu.data import graph as jax_graph
from notorch_tpu.data.batching import DataLoader as JaxDataLoader
from notorch_tpu.data.dataset import MolecularDataset as JaxDataset
from notorch_tpu.data.dataset import TargetSpec as JaxTargetSpec
from notorch_tpu.data.dataset import TransformManager as JaxTM
from notorch_tpu.kernels.csr_segment import pack_edges_by_tile as jax_pack_edges_by_tile
from notorch_tpu.transforms import MolToGraph as JaxMolToGraph
from notorch_tpu.transforms import Pipeline as JaxPipeline
from notorch_tpu.transforms import SmiToMol as JaxSmiToMol
from notorch_tpu_torch.cli.train import build_dataset
from notorch_tpu_torch.data import graph
from notorch_tpu_torch.data.batching import DataLoader, Subset, bucket_ladder
from notorch_tpu_torch.kernels.csr_segment import pack_edges_by_tile
from notorch_tpu_torch.training.loop import to_device
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIPE, JAX_PIPE = Pipeline(SmiToMol(), MolToGraph()), JaxPipeline(JaxSmiToMol(), JaxMolToGraph())
SMIS = ["CCO", "c1ccccc1C(=O)O", "NC(=O)c1ccccc1", "CCCCCCCC", "O", "CC(=O)Nc1ccc(O)cc1"]
FIELDS = ("node_feats", "edge_feats", "src", "dst", "rev", "node_graph", "edge_graph", "node_mask",
          "edge_mask", "num_graphs_real", "in_edges", "csr_perm", "csr_dst")
N = 256


def assert_graphs_equal(bg, ref):
    assert bg.n_graphs == ref.n_graphs
    for f in FIELDS:
        a, r = getattr(bg, f), getattr(ref, f)
        if r is None:
            assert a is None, f
            continue
        a, r = np.asarray(a), np.asarray(r)
        assert a.dtype == r.dtype and a.shape == r.shape and np.array_equal(a, r), f


def _graphs(smis=SMIS):
    return [PIPE(s) for s in smis], [JAX_PIPE(s) for s in smis]


@pytest.mark.parametrize("caps", [(64, 128, 8), (None, None, None)])
def test_pad_graphs_equal(caps):
    graphs, jgraphs = _graphs()
    node_cap, edge_cap, graph_cap = caps
    if node_cap is None:
        bg, ref = MolToGraph.collate(graphs), JaxMolToGraph.collate(jgraphs)
        assert isinstance(bg.src, torch.Tensor)  # tensors unless np_out
    else:
        bg = graph.pad_graphs(graphs, node_cap, edge_cap, graph_cap=graph_cap, np_out=True)
        ref = jax_graph.pad_graphs(jgraphs, node_cap, edge_cap, graph_cap=graph_cap, np_out=True)
        assert isinstance(bg.src, np.ndarray)
    assert_graphs_equal(bg, ref)
    with pytest.raises(ValueError, match="node_cap"):
        graph.pad_graphs(graphs, 8, 128)
    with pytest.raises(ValueError, match="graph_cap"):
        graph.pad_graphs(graphs, 64, 128, graph_cap=2)


def test_build_in_edges_sort_and_row_ptr_equal():
    graphs, jgraphs = _graphs()
    bg = graph.pad_graphs(graphs, 128, 256, graph_cap=6, np_out=True)
    ref = jax_graph.pad_graphs(jgraphs, 128, 256, graph_cap=6, np_out=True)
    np.testing.assert_array_equal(graph.build_in_edges(bg.dst, bg.edge_mask, 128, min_k=2),
                                  jax_graph.build_in_edges(ref.dst, ref.edge_mask, 128, min_k=2))
    sorted_bg, perm = graph.sort_edges_by_dst(bg)
    sorted_ref, ref_perm = jax_graph.sort_edges_by_dst(ref)
    np.testing.assert_array_equal(perm, ref_perm)
    assert_graphs_equal(sorted_bg, sorted_ref)
    dst = np.asarray(sorted_bg.dst)
    assert (np.diff(dst) >= 0).all()
    rev = np.asarray(sorted_bg.rev)
    assert (rev[rev] == np.arange(len(rev))).all() and (np.asarray(sorted_bg.src)[rev] == dst).all()
    np.testing.assert_array_equal(graph.csr_row_ptr(dst, 128), jax_graph.csr_row_ptr(dst, 128))
    assert graph.bucket_caps(100, 300, [64, 128], [256]) == jax_graph.bucket_caps(100, 300, [64, 128], [256])
    assert graph.bucket_caps(200, 300, [64], [256]) == jax_graph.bucket_caps(200, 300, [64], [256])


@pytest.mark.parametrize("V,E,tile_v,budget", [(256, 1024, 128, None), (300, 700, 64, 512), (128, 0, 128, None)])
def test_pack_edges_by_tile_equal(V, E, tile_v, budget):
    dst = np.random.default_rng(V + E).integers(0, V, size=E).astype(np.int32)
    got = pack_edges_by_tile(dst, num_nodes=V, tile_v=tile_v, budget=budget)
    ref = jax_pack_edges_by_tile(dst, num_nodes=V, tile_v=tile_v, budget=budget)
    for a, r in zip(got[:2], ref[:2]):
        assert a.dtype == r.dtype and np.array_equal(a, r)
    assert got[2] == ref[2]
    # every edge lands once, in its own tile's budget, in edge order
    perm, packed_dst, b = got
    real = perm[perm >= 0]
    assert np.array_equal(np.sort(real), np.arange(E))
    slots = np.nonzero(perm >= 0)[0]
    assert (packed_dst[slots] == dst[perm[slots]]).all() and (dst[perm[slots]] // tile_v == slots // b).all()


def test_pack_budget_overflow_raises_in_both():
    dst = np.zeros(300, np.int32)  # all edges land in tile 0
    for pack in (pack_edges_by_tile, jax_pack_edges_by_tile):
        with pytest.raises(ValueError, match="exceeds budget"):
            pack(dst, num_nodes=256, tile_v=128, budget=256)


def test_with_csr_packing_equal():
    graphs, jgraphs = _graphs()
    bg = graph.with_csr_packing(graph.pad_graphs(graphs, 128, 256, graph_cap=6, np_out=True))
    ref = jax_graph.with_csr_packing(jax_graph.pad_graphs(jgraphs, 128, 256, graph_cap=6, np_out=True))
    assert_graphs_equal(bg, ref)
    # exactly the real edges are packed, each once: the sink gets no padding edge
    perm = np.asarray(bg.csr_perm)
    assert sorted(perm[perm >= 0].tolist()) == np.nonzero(bg.edge_mask)[0].tolist()
    assert "csr_perm" in repr(bg)
    moved = bg.to("cpu")
    assert moved.csr_perm.dtype == torch.int32 and moved.edge_mask.dtype == torch.bool
    assert moved.num_graphs_real.shape == () and moved.n_graphs == 6
    batch = to_device({"inputs.G": bg, "targets.y": np.zeros((6, 1), np.float32)}, "cpu")
    assert isinstance(batch["inputs.G"].dst, torch.Tensor) and isinstance(batch["targets.y"], torch.Tensor)


@pytest.fixture(scope="module")
def datasets():
    ds = build_dataset({"csv": os.path.join(ROOT, "tests", "data", "lipo.csv"),
                        "targets": {"y": {"columns": ["lipo"]}}})
    sub = Subset(ds, np.arange(N))
    table = {"smiles": [ds.records[i]["smiles"] for i in range(N)],
             "lipo": [float(ds.records[i]["lipo"]) for i in range(N)]}
    jds = JaxDataset(table, {"graph": JaxTM(JAX_PIPE, "smiles", "G")}, targets={"y": JaxTargetSpec(["lipo"])})
    return sub, jds


def _assert_batches_equal(batches, ref_batches):
    assert len(batches) == len(ref_batches)
    for b, rb in zip(batches, ref_batches):
        assert sorted(b) == sorted(rb)
        assert_graphs_equal(b["inputs.G"], rb["inputs.G"])
        for k in ("targets.y", "targets.y_mask"):
            assert np.array_equal(b[k], np.asarray(rb[k])) and b[k].dtype == np.asarray(rb[k]).dtype


@pytest.mark.parametrize("shuffle", [False, True])
def test_flat_csr_loader_equals_jax(datasets, shuffle):
    """The flat batches with CSR packing equal the JAX loader's array for
    array and in order, over two epochs when shuffled; batch 64 gives the
    caps V = 2048, E = 4096 and a budget of 384 slots a tile."""
    sub, jds = datasets
    kw = dict(batch_size=64, shuffle=shuffle, seed=5, layout="flat", csr_pack=True)
    loader, jloader = DataLoader(sub, **kw), JaxDataLoader(jds, **kw)
    for epoch in range(2 if shuffle else 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        batches = list(loader)
        _assert_batches_equal(batches, list(jloader))
    G = batches[0]["inputs.G"]
    assert G.node_feats.shape[0] in bucket_ladder(128, 1 << 22) and G.edge_feats.shape[0] in bucket_ladder(256, 1 << 23)
    if not shuffle:
        assert (G.num_nodes, G.num_edges, len(G.csr_perm) // (G.num_nodes // 128)) == (2048, 4096, 384)


def test_flat_loader_without_packing_and_padded_last_batch(datasets):
    sub, jds = datasets
    kw = dict(batch_size=60, layout="flat", node_quantum=64, edge_quantum=128)
    batches = list(DataLoader(sub, **kw))
    _assert_batches_equal(batches, list(JaxDataLoader(jds, **kw)))
    last = batches[-1]
    assert last["inputs.G"].csr_perm is None and last["targets.y_mask"].sum() == N % 60
    assert int(last["inputs.G"].num_graphs_real) == N % 60 and last["inputs.G"].n_graphs == 60


def test_node_ladder_192_rung_refuses_csr_packing_in_both(datasets):
    """The flat node ladder runs 128, 192, 256, ...: a batch whose node
    total lands on 192 is not 128-aligned, and CSR packing raises the same
    error in both packages (the port keeps the JAX loader's batches)."""
    sub, jds = datasets
    assert bucket_ladder(128, 1 << 22)[:4] == [128, 192, 256, 384]
    size = next(b for b in range(2, 16)
                if next(iter(DataLoader(sub, batch_size=b, layout="flat")))["inputs.G"].num_nodes == 192)
    for loader in (DataLoader(sub, batch_size=size, layout="flat", csr_pack=True),
                   JaxDataLoader(jds, batch_size=size, layout="flat", csr_pack=True)):
        with pytest.raises(ValueError, match="multiple of tile_v=128"):
            next(iter(loader))


def test_loader_refuses_unknown_layout(datasets):
    with pytest.raises(ValueError, match="auto"):
        DataLoader(datasets[0], layout="auto")
