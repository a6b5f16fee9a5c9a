"""Declarative ``model.modules`` configs on the per-molecule dense layout,
against the JAX package: the registry's names and refusals, the ``dense``
collate and the ``sort_by_size`` batch order, the parameter mapping of a
declarative model, one train step of the whole-encoder config (loss and
every gradient), ``run``/``run_predict`` on the CPU, and
``build_dmpnn(layout="dense_fused")``.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port
runs its plain versions. Tolerances: losses and predictions at rtol = atol
= 1e-5 (f32, another summation order, d = 16); gradients at rtol = 1e-4 and
atol 1e-4 times the tensor's largest magnitude (the weight gradients sum
over every edge lane of the batch).
"""

import csv
import os

import jax
import numpy as np
import pytest
import torch

from notorch_tpu.cli import registry as jax_registry
from notorch_tpu.cli.train import build_model as jax_build_model
from notorch_tpu.cli.train import build_optimizer as jax_build_optimizer
from notorch_tpu.data.batching import DataLoader as JaxDataLoader
from notorch_tpu.data.dataset import MolecularDataset as JaxDataset
from notorch_tpu.data.dataset import TargetSpec as JaxTargetSpec
from notorch_tpu.data.dataset import TransformManager as JaxTM
from notorch_tpu.models.dmpnn import build_dmpnn as jax_build_dmpnn
from notorch_tpu.training.loop import predict as jax_predict
from notorch_tpu.transforms import MolToGraph as JaxMolToGraph
from notorch_tpu.transforms import Pipeline as JaxPipeline
from notorch_tpu.transforms import SmiToMol as JaxSmiToMol
from notorch_tpu_torch.cli import registry
from notorch_tpu_torch.cli.predict import run_predict
from notorch_tpu_torch.cli.train import build_dataset, build_model, build_optimizer, prepare, run
from notorch_tpu_torch.data.batching import DataLoader, bucket_ladder
from notorch_tpu_torch.model.convert import params_from_jax, params_to_jax
from notorch_tpu_torch.models.dmpnn import build_dmpnn
from notorch_tpu_torch.nn.chemprop_dense import DenseMean, FusedDenseChempropBlock
from notorch_tpu_torch.training.loop import predict, to_device
from notorch_tpu_torch.training.optim import OptimizerSpec
from notorch_tpu_torch.transforms.vocab import DEFAULT_NUM_ATOM_TYPES, DEFAULT_NUM_BOND_TYPES
from tests.test_torch_spatial import spatial_names_build_and_equal_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BATCH, D = 96, 16, 16
TOL = dict(rtol=1e-5, atol=1e-5)
KEYS = {"preds": "ffn.preds", "targets": "targets.y", "mask": "targets.y_mask"}
NOAM = {"warmup_steps": 100, "cooldown_steps": 1500, "init_lr": 1e-4, "max_lr": 1e-3, "final_lr": 1e-4}
OPT_CFG = {"name": "adam", "schedule": {"noam": NOAM}}


def slice_model_cfg(d=D, depth=3):
    """The slice's declarative model: embedding, the whole-encoder block,
    the per-molecule mean readout and the MLP head, on layout: dense."""
    return {
        "layout": "dense",
        "pred_key": "ffn.preds",
        "modules": {
            "embed": {"class": "DenseGraphEmbedding",
                      "args": {"num_node_types": DEFAULT_NUM_ATOM_TYPES,
                               "num_edge_types": DEFAULT_NUM_BOND_TYPES, "hidden_dim": d},
                      "in_keys": ["inputs.G"], "out_keys": ["G"]},
            "mp": {"class": "FusedDenseChempropBlock",
                   "args": {"hidden_dim": d, "depth": depth, "fuse_ends": True},
                   "in_keys": ["embed.G"], "out_keys": ["G"]},
            "readout": {"class": "DenseMean", "in_keys": ["mp.G"], "out_keys": ["H"]},
            "ffn": {"class": "MLP",
                    "args": {"input_dim": d, "output_size": 1, "hidden_dim": d, "num_layers": 1},
                    "in_keys": ["readout.H"], "out_keys": ["preds"]},
        },
        "losses": {"mse": {"class": "MSE", "in_keys": dict(KEYS)}},
        "metrics": {"rmse": {"class": "RMSE", "in_keys": dict(KEYS)},
                    "mae": {"class": "MetricMAE", "in_keys": dict(KEYS)}},
    }


@pytest.fixture(scope="module")
def lipo_csv(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "lipo_head.csv"
    with open(os.path.join(ROOT, "tests", "data", "lipo.csv")) as f:
        rows = list(csv.reader(f))[: N + 1]
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return path


@pytest.fixture(scope="module")
def datasets(lipo_csv):
    ds = build_dataset({"csv": str(lipo_csv), "targets": {"y": {"columns": ["lipo"]}}})
    table = {"smiles": [r["smiles"] for r in ds.records], "lipo": [float(r["lipo"]) for r in ds.records]}
    jds = JaxDataset(table, {"graph": JaxTM(JaxPipeline(JaxSmiToMol(), JaxMolToGraph()), "smiles", "G")},
                     targets={"y": JaxTargetSpec(["lipo"])})
    return ds, jds


# -- the registry ---------------------------------------------------------------

def test_registry_names_match_jax_and_refuse_later_slices():
    """Every name of the JAX registry resolves in the port (the spatial
    names, the last refused, build and equal JAX's); the port registers no
    name of its own."""
    assert set(registry.REGISTRY) == set(jax_registry.REGISTRY)
    for name in jax_registry.REGISTRY:
        assert callable(registry.resolve(name))
    for name in ("DenseGraphEmbedding", "DenseChempropBlock", "FusedDenseChempropBlock", "DenseSum",
                 "DenseMean", "DenseMax", "MLP", "MSE", "MAE", "RMSE", "MetricMAE", "adam", "adamw",
                 "BinaryCrossEntropy", "CrossEntropy", "Dirichlet", "Evidential", "MVE", "AUROC", "AUPRC", "F1",
                 "R2", "Accuracy", "sgd"):
        assert name in registry.REGISTRY, name
    for name in ("MolToFP", "RxnToGraph", "MoEMLP", "MixtureOfExperts", "SparseRouter", "BatchNorm", "Cat"):
        assert name in registry.REGISTRY, name
    spatial_names_build_and_equal_jax()
    # MetricMAE is the metric, MAE the loss, as in the JAX registry
    assert registry.resolve("MetricMAE").__module__.endswith("tasks.metrics")
    assert registry.resolve("MAE").__module__.endswith("tasks.losses")
    # the optimizers are the port's own, called with the rate as optax.adam is
    assert registry.resolve("adamw")(1e-3) == OptimizerSpec("adamw", 1e-3)
    assert registry.resolve("sgd")(1e-2) == OptimizerSpec("sgd", 1e-2)
    with pytest.raises(KeyError, match="unknown component"):
        registry.resolve("NoSuchBlock")


def test_registry_build_nests_and_gates_imports(monkeypatch):
    block = registry.build({"class": "FusedDenseChempropBlock",
                            "args": {"hidden_dim": 8, "depth": 2, "fuse_ends": True}})
    assert isinstance(block, FusedDenseChempropBlock) and block.fuse_ends and block.depth == 2
    assert isinstance(registry.build("DenseMean"), DenseMean)
    monkeypatch.delenv(registry.TRUSTED_MODULES_ENV, raising=False)
    monkeypatch.setattr(registry, "_ALLOW_IMPORTS", False)
    spec = {"class": "collections.OrderedDict", "args": {"inner": {"class": "DenseMean"}}}
    with pytest.raises(PermissionError, match=registry.TRUSTED_MODULES_ENV):
        registry.build(spec)
    monkeypatch.setenv(registry.TRUSTED_MODULES_ENV, "numpy, collections")
    built = registry.build(spec)  # nested {"class": ...} args are built first
    assert isinstance(built["inner"], DenseMean)
    monkeypatch.delenv(registry.TRUSTED_MODULES_ENV)
    registry.allow_imports()
    try:
        assert registry.resolve("collections.OrderedDict") is not None
    finally:
        registry.allow_imports(False)


# -- the dense collate and sort_by_size -------------------------------------------

DENSE_FIELDS = ("node_feats", "edge_feats", "src", "dst", "node_mask", "edge_mask", "graph_mask")


def _assert_batches_equal(batches, ref_batches):
    assert len(batches) == len(ref_batches)
    for b, rb in zip(batches, ref_batches):
        assert sorted(b) == sorted(rb)
        for f in DENSE_FIELDS:
            a, r = np.asarray(getattr(b["inputs.G"], f)), np.asarray(getattr(rb["inputs.G"], f))
            assert a.dtype == r.dtype and a.shape == r.shape and np.array_equal(a, r), f
        for k in ("targets.y", "targets.y_mask"):
            assert np.array_equal(b[k], rb[k]) and b[k].dtype == rb[k].dtype


@pytest.mark.parametrize("keyed", [True, False])
def test_sorted_dense_loader_equals_jax_over_two_epochs(datasets, keyed):
    """The per-molecule dense batches, sorted by size and shuffled by
    chunk, equal the JAX loader's array for array and in order, epoch by
    epoch: keyed by set_epoch, or drawing on from one epoch to the next."""
    ds, jds = datasets
    kw = dict(batch_size=BATCH, shuffle=True, seed=3, layout="dense", sort_by_size=True)
    loader, jloader = DataLoader(ds, **kw), JaxDataLoader(jds, **kw)
    for epoch in range(2):
        if keyed:
            loader.set_epoch(epoch)
            jloader.set_epoch(epoch)
        batches = list(loader)
        _assert_batches_equal(batches, list(jloader))
        # sorted by size: the batches' edge caps are rungs of the edge ladder, and differ
        edges = [b["inputs.G"].src.shape[1] for b in batches]
        assert set(edges) <= set(bucket_ladder(32, 1 << 17)) and len(set(edges)) > 1


def test_unsorted_dense_loader_pads_to_the_ladders(datasets):
    ds, jds = datasets
    batches = list(DataLoader(ds, batch_size=BATCH + 3, layout="dense"))
    _assert_batches_equal(batches, list(JaxDataLoader(jds, batch_size=BATCH + 3, layout="dense")))
    G = batches[-1]["inputs.G"]
    assert G.src.shape[0] == BATCH + 3 and not G.graph_mask.all()  # the last batch is padded


# -- the model --------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair(datasets):
    """The JAX declarative model and its initial params, and the port's
    model of the same config carrying those weights."""
    ds, jds = datasets
    cfg = slice_model_cfg()
    jmodel = jax_build_model(cfg, jds.build_task_transform_configs(), jax_build_optimizer(OPT_CFG))
    jbatches = list(JaxDataLoader(jds, batch_size=BATCH, layout="dense"))
    state = jmodel.init(jax.random.PRNGKey(0), jbatches[0])

    def port_model():
        model = build_model(cfg, ds.build_task_transform_configs(),
                            generator=torch.Generator().manual_seed(0), optimizer=build_optimizer(OPT_CFG))
        model.network.load_state_dict(params_from_jax(jax.device_get(state.params)))
        return model

    return {"jmodel": jmodel, "state": state, "jbatches": jbatches, "port_model": port_model,
            "batches": list(DataLoader(ds, batch_size=BATCH, layout="dense"))}


def test_declarative_params_round_trip(pair):
    """params_from_jax maps every modules__<name> group by its own keys,
    whatever the module's name, onto the port network's state_dict, and
    params_to_jax gives the tree back leaf for leaf."""
    tree = jax.device_get(pair["state"].params)
    network = pair["port_model"]().network
    assert sorted(tree) == ["modules__embed", "modules__ffn", "modules__mp"]  # the readout has none
    sd = params_from_jax(tree)
    assert {k: v.shape for k, v in sd.items()} == {k: v.shape for k, v in network.state_dict().items()}
    back = params_to_jax(sd)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(leaf), flat_back[path])
    renamed = {"modules__encoder" if k == "modules__mp" else k: v for k, v in tree.items()}
    assert set(params_from_jax(renamed)) >= {"encoder.weight", "encoder.bias"}
    with pytest.raises(ValueError, match="encoder"):
        params_from_jax({"modules__encoder": {"other_0": {}}})


def test_declarative_train_step_matches_jax(pair):
    """One train step of the slice's config: the loss and every parameter
    gradient equal the JAX model's."""
    jmodel, state, jbatch = pair["jmodel"], pair["state"], pair["jbatches"][0]

    def loss_fn(params):
        out = jmodel.network.apply({"params": params}, dict(jbatch), training=True,
                                   rngs={"dropout": jax.random.PRNGKey(1)})
        terms = jmodel._loss_terms(jmodel._apply_transforms(out, "targets"))
        return sum(jmodel.train_loss_weights[k] * v for k, v in terms.items()), terms

    (loss, terms), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    model = pair["port_model"]()
    logs = model.train_step(to_device(pair["batches"][0], "cpu"))
    np.testing.assert_allclose(float(logs["train/mse"]), float(terms["mse"]), **TOL)
    np.testing.assert_allclose(float(logs["train/loss"]), float(loss), **TOL)
    ref = params_from_jax(jax.device_get(grads))
    got = {name: p.grad for name, p in model.network.named_parameters()}
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        r = r.numpy()
        np.testing.assert_allclose(got[name].numpy(), r, rtol=1e-4, atol=1e-4 * float(np.abs(r).max()),
                                   err_msg=name)


def test_declarative_predictions_match_jax(pair, datasets):
    ds, jds = datasets
    preds = predict(pair["port_model"](), DataLoader(ds, batch_size=BATCH, layout="dense"),
                    keys=["ffn.preds"])["ffn.preds"]
    ref = jax_predict(pair["jmodel"], pair["state"].params,
                      JaxDataLoader(jds, batch_size=BATCH, layout="dense"), keys=["ffn.preds"])["ffn.preds"]
    assert preds.shape == (N, 1)
    np.testing.assert_allclose(preds, np.asarray(ref), **TOL)


def test_run_writes_a_checkpoint_run_predict_serves(lipo_csv, tmp_path):
    """run(cfg, device="cpu") of the slice's config trains on the sorted
    dense loader and writes a checkpoint whose meta records the declarative
    model; run_predict rebuilds it and serves it on the dense layout."""
    ckpt = tmp_path / "ckpt"
    cfg = {
        "data": {"csv": str(lipo_csv), "smiles_col": "smiles",
                 "targets": {"y": {"columns": ["lipo"], "task": "regression"}},
                 "split": {"fractions": [0.8, 0.1, 0.1], "seed": 0}},
        "model": slice_model_cfg(),
        "optimizer": OPT_CFG,
        "trainer": {"epochs": 2, "batch_size": BATCH, "seed": 0, "checkpoint_dir": str(ckpt)},
    }
    out = run(cfg, device="cpu")
    assert len(out["history"]) == 2 and np.isfinite(out["test"]["val/rmse"])
    served = run_predict(ckpt, lipo_csv, batch_size=BATCH, device="cpu")["lipo"]
    assert served.shape == (N,) and np.isfinite(served).all()
    again = run_predict(ckpt, lipo_csv, batch_size=BATCH + 8, device="cpu")["lipo"]
    np.testing.assert_allclose(again, served, **TOL)  # the batch's padding does not leak


def test_flat_declarative_layout_is_refused(lipo_csv):
    """The flat layout (a declarative config's default) with edge dropout in
    the flat block, which the port refused until the plain dense slice, now
    trains: the block's dropout is in the run's model and the losses are
    finite."""
    model = {k: v for k, v in slice_model_cfg().items() if k != "layout"}
    model["modules"] = {**model["modules"], "embed": {**model["modules"]["embed"], "class": "GraphEmbedding"},
                        "mp": {"class": "ChempropBlock", "args": {"hidden_dim": D, "dropout": 0.1},
                               "in_keys": ["embed.G"], "out_keys": ["G"]},
                        "readout": {"class": "Mean", "in_keys": ["mp.G"], "out_keys": ["H"]}}
    cfg = {"data": {"csv": str(lipo_csv), "targets": {"y": {"columns": ["lipo"]}},
                    "split": {"fractions": [0.8, 0.1, 0.1], "seed": 0}},
           "model": model, "optimizer": OPT_CFG, "trainer": {"epochs": 1, "batch_size": BATCH, "seed": 0}}
    assert prepare(cfg, "cpu")["model"].network["mp"].dropout.rate == 0.1
    out = run(cfg, device="cpu")
    assert len(out["history"]) == 1 and np.isfinite(out["test"]["val/rmse"])


# -- build_dmpnn(layout="dense_fused") ----------------------------------------------

@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_dense_fused_layout_matches_jax(datasets, reduce):
    ds, jds = datasets
    kw = dict(hidden_dim=D, depth=3, reduce=reduce, layout="dense_fused")
    jmodel = jax_build_dmpnn(transforms=jds.build_task_transform_configs(), **kw)
    jloader = JaxDataLoader(jds, batch_size=BATCH, layout="dense")
    params = jmodel.init(jax.random.PRNGKey(1), next(iter(jloader))).params
    model = build_dmpnn(transforms=ds.build_task_transform_configs(), **kw)
    assert type(model.network["readout"]).__name__ == "DenseMean"
    assert not model.network["mp"].fuse_ends
    model.network.load_state_dict(params_from_jax(jax.device_get(params)))
    preds = predict(model, DataLoader(ds, batch_size=BATCH, layout="dense"), keys=["ffn.preds"])
    ref = jax_predict(jmodel, params, jloader, keys=["ffn.preds"])
    np.testing.assert_allclose(preds["ffn.preds"], np.asarray(ref["ffn.preds"]), **TOL)


def test_dense_fused_refusals():
    with pytest.raises(ValueError, match="dropout"):
        build_dmpnn(hidden_dim=8, layout="dense_fused", dropout=0.1)
    with pytest.raises(ValueError, match="max"):
        build_dmpnn(hidden_dim=8, layout="dense_fused", reduce="max")
    # max and the plain dense layout, refused until the plain dense slice,
    # now build the plain block (over packed bins, or per molecule)
    model = build_dmpnn(hidden_dim=8, layout="dense_packed", reduce="max")
    assert [type(model.network[k]).__name__ for k in ("mp", "readout")] == ["DenseChempropBlock", "PackedMean"]
    model = build_dmpnn(hidden_dim=8, layout="dense")
    assert [type(model.network[k]).__name__ for k in ("mp", "readout")] == ["DenseChempropBlock", "DenseMean"]
