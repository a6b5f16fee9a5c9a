"""The attention model family against the JAX package: the loader's
attention bins, ``build_gat`` for both recipes on every layout, the
declarative graph transformer on the kernel path, training and serving
through ``run``/``run_predict`` on the CPU, and serving an ``impl: csr``
checkpoint whose last batch lands on the flat node ladder's 192 rung.

The JAX side runs its Pallas kernels in interpret mode. Tolerances for whole
models: losses and predictions at rtol = atol = 1e-4; gradients at rtol =
1e-4 and atol 1e-4 times the tensor's largest magnitude, the biases that
move no softmax (``W_k``, ``W_bias``, GATv2's ``a``) at the scale of all
gradients, since theirs are zero in exact arithmetic.
"""

import csv
import os

import jax
import numpy as np
import pytest
import torch

from notorch_tpu.cli.train import build_model as jax_build_model
from notorch_tpu.cli.train import build_optimizer as jax_build_optimizer
from notorch_tpu.data.batching import DataLoader as JaxDataLoader
from notorch_tpu.data.dataset import MolecularDataset as JaxDataset
from notorch_tpu.data.dataset import TargetSpec as JaxTargetSpec
from notorch_tpu.data.dataset import TransformManager as JaxTM
from notorch_tpu.models import gat as jax_gat
from notorch_tpu.models.dmpnn import build_dmpnn as jax_build_dmpnn
from notorch_tpu.training.loop import predict as jax_predict
from notorch_tpu.transforms import MolToGraph as JaxMolToGraph
from notorch_tpu.transforms import Pipeline as JaxPipeline
from notorch_tpu.transforms import SmiToMol as JaxSmiToMol
from notorch_tpu_torch.cli.predict import run_predict
from notorch_tpu_torch.cli.train import build_dataset, build_model, build_optimizer, run, save_predict_meta
from notorch_tpu_torch.data.batching import DataLoader
from notorch_tpu_torch.model.convert import params_from_jax, params_to_jax
from notorch_tpu_torch.models import gat
from notorch_tpu_torch.models.dmpnn import build_dmpnn
from notorch_tpu_torch.training.checkpoint import Checkpointer
from notorch_tpu_torch.training.loop import predict, to_device
from notorch_tpu_torch.transforms.vocab import DEFAULT_NUM_ATOM_TYPES, DEFAULT_NUM_BOND_TYPES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BATCH, D, H = 96, 32, 16, 2
TOL = dict(rtol=1e-4, atol=1e-4)
NOAM = {"warmup_steps": 100, "cooldown_steps": 1500, "init_lr": 1e-4, "max_lr": 1e-3, "final_lr": 1e-4}
OPT_CFG = {"name": "adam", "schedule": {"noam": NOAM}}
KEYS = {"preds": "ffn.preds", "targets": "targets.y", "mask": "targets.y_mask"}
ZERO_GRADS = ("W_k.bias", "W_bias.bias", "a.bias")


def declarative_attention_cfg(d=D, depth=2, heads=H, interpret=True):
    """The declarative graph transformer on the kernel path: the attention
    core fused, its forward the kernel (``fwd_impl: pallas``), on the
    per-molecule dense layout (``interpret`` for the JAX side on the CPU)."""
    return {
        "layout": "dense",
        "pred_key": "ffn.preds",
        "modules": {
            "embed": {"class": "DenseGraphEmbedding",
                      "args": {"num_node_types": DEFAULT_NUM_ATOM_TYPES, "num_edge_types": DEFAULT_NUM_BOND_TYPES,
                               "hidden_dim": d},
                      "in_keys": ["inputs.G"], "out_keys": ["G"]},
            "mp": {"class": "DenseGATBlock",
                   "args": {"attention": "sdp", "impl": "fused", "fwd_impl": "pallas", "hidden_dim": d,
                            "depth": depth, "num_heads": heads, "interpret": interpret},
                   "in_keys": ["embed.G"], "out_keys": ["G"]},
            "readout": {"class": "DenseMean", "in_keys": ["mp.G"], "out_keys": ["H"]},
            "ffn": {"class": "MLP", "args": {"input_dim": d, "output_size": 1, "hidden_dim": d, "num_layers": 1},
                    "in_keys": ["readout.H"], "out_keys": ["preds"]},
        },
        "losses": {"mse": {"class": "MSE", "in_keys": dict(KEYS)}},
        "metrics": {"rmse": {"class": "RMSE", "in_keys": dict(KEYS)},
                    "mae": {"class": "MetricMAE", "in_keys": dict(KEYS)}},
    }


def lipo_head(path, n):
    with open(os.path.join(ROOT, "tests", "data", "lipo.csv")) as f:
        rows = list(csv.reader(f))[: n + 1]
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return path


@pytest.fixture(scope="module")
def lipo_csv(tmp_path_factory):
    return lipo_head(tmp_path_factory.mktemp("data") / "lipo_head.csv", N)


def datasets_of(path):
    ds = build_dataset({"csv": str(path), "targets": {"y": {"columns": ["lipo"]}}})
    table = {"smiles": [r["smiles"] for r in ds.records], "lipo": [float(r["lipo"]) for r in ds.records]}
    pipe = JaxPipeline(JaxSmiToMol(), JaxMolToGraph())
    jds = JaxDataset(table, {"graph": JaxTM(pipe, "smiles", "G")}, targets={"y": JaxTargetSpec(["lipo"])})
    return ds, jds


@pytest.fixture(scope="module")
def datasets(lipo_csv):
    return datasets_of(lipo_csv)


# -- the loader -----------------------------------------------------------------------------

FIELDS = ("node_feats", "edge_feats", "src", "dst", "node_mask", "edge_mask", "graph_mask", "node_graph")


@pytest.mark.parametrize("kw", [{"bin_edges": 256, "bin_nodes": 128}, {"bin_edges": 256},
                                {"bin_edges": 64, "bin_nodes": 40, "shuffle": True, "seed": 5}])
def test_attention_bins_loader_equals_jax(datasets, kw):
    """DataLoader(dense_packed, bin_edges, bin_nodes): batch for batch the
    JAX loader's arrays, in order."""
    ds, jds = datasets
    batches = list(DataLoader(ds, batch_size=BATCH, layout="dense_packed", **kw))
    ref = list(JaxDataLoader(jds, batch_size=BATCH, layout="dense_packed", **kw))
    assert len(batches) == len(ref) == N // BATCH
    for b, rb in zip(batches, ref):
        G, jG = b["inputs.G"], rb["inputs.G"]
        assert G.n_mols == jG.n_mols
        for f in FIELDS:
            a, r = np.asarray(getattr(G, f)), np.asarray(getattr(jG, f))
            assert a.dtype == r.dtype and a.shape == r.shape and np.array_equal(a, r), f
        np.testing.assert_array_equal(b["targets.y"], rb["targets.y"])
    if kw.get("bin_nodes") == 128:
        assert {b["inputs.G"].node_mask.shape[1] for b in batches} == {128}
        assert {b["inputs.G"].src.shape[1] for b in batches} == {256}


def test_layout_and_loader_kwargs_match_jax():
    for layout in ("auto", "dense_packed", "dense", "flat"):
        for attention in ("sdp", "gatv2"):
            assert gat.resolve_gat_layout(layout, attention=attention) == jax_gat.resolve_gat_layout(
                layout, attention=attention)
        assert gat.gat_loader_kwargs(layout) == jax_gat.gat_loader_kwargs(layout)


# -- the models -----------------------------------------------------------------------------


def check_model(jmodel, model, jbatches, batches, params):
    """Predictions over all batches, then one train step on the first: the
    loss and every parameter gradient."""
    preds = predict(model, batches, keys=["ffn.preds"])["ffn.preds"]
    ref = jax_predict(jmodel, params, jbatches, keys=["ffn.preds"])["ffn.preds"]
    assert preds.shape == (N, 1)
    np.testing.assert_allclose(preds, np.asarray(ref), **TOL)

    def loss_fn(params):
        out = jmodel.network.apply({"params": params}, dict(jbatches[0]), training=True,
                                   rngs={"dropout": jax.random.PRNGKey(1)})
        terms = jmodel._loss_terms(jmodel._apply_transforms(out, "targets"))
        return sum(jmodel.train_loss_weights[k] * v for k, v in terms.items())

    loss, grads = jax.value_and_grad(loss_fn)(params)
    logs = model.train_step(to_device(batches[0], "cpu"))
    np.testing.assert_allclose(float(logs["train/loss"]), float(loss), **TOL)
    ref = params_from_jax(jax.device_get(grads))
    got = {name: p.grad for name, p in model.network.named_parameters()}
    assert sorted(got) == sorted(ref)
    scale = max(float(r.abs().max()) for r in ref.values())
    for name, r in ref.items():
        atol = 1e-4 * (scale if name.endswith(ZERO_GRADS) else float(r.abs().max()))
        np.testing.assert_allclose(got[name].numpy(), r.numpy(), rtol=1e-4, atol=atol, err_msg=name)


RECIPES = [("sdp", "dense_packed", "mean"), ("gatv2", "dense_packed", "mean"), ("sdp", "dense", "sum"),
           ("gatv2", "dense", "max"), ("sdp", "flat", "mean"), ("gatv2", "flat", "gated"),
           ("sdp", "dense_packed", "sdp"), ("sdp", "dense_packed", "gated")]


@pytest.mark.parametrize("attention, layout, aggregation", RECIPES)
def test_build_gat_matches_jax(datasets, attention, layout, aggregation):
    """build_gat in both packages on carried weights: the model's modules,
    its predictions and one train step, on the loader the CLI gives it."""
    ds, jds = datasets
    kw = dict(hidden_dim=D, depth=2, num_heads=H, attention=attention, layout=layout, aggregation=aggregation)
    jmodel = jax_gat.build_gat(transforms=jds.build_task_transform_configs(), **kw)
    data = {"layout": "dense" if layout == "dense" else layout, **gat.gat_loader_kwargs(layout)}
    jbatches = list(JaxDataLoader(jds, batch_size=BATCH, **data))
    params = jmodel.init(jax.random.PRNGKey(0), jbatches[0]).params
    model = gat.build_gat(transforms=ds.build_task_transform_configs(), **kw)
    block = {"flat": "GATBlock"}.get(layout, "DenseGATBlock")
    assert type(model.network["mp"]).__name__ == block
    model.network.load_state_dict(params_from_jax(jax.device_get(params)))
    check_model(jmodel, model, jbatches, list(DataLoader(ds, batch_size=BATCH, **data)), params)


def test_declarative_attention_config_matches_jax(datasets):
    """The declarative graph transformer (DenseGATBlock with impl: fused,
    fwd_impl: pallas) built by name in both packages: predictions and one
    train step, the port's core through FusedDenseAttentionFn."""
    ds, jds = datasets
    cfg = declarative_attention_cfg()
    jmodel = jax_build_model(cfg, jds.build_task_transform_configs(), jax_build_optimizer(OPT_CFG))
    jbatches = list(JaxDataLoader(jds, batch_size=BATCH, layout="dense"))
    params = jmodel.init(jax.random.PRNGKey(0), jbatches[0]).params
    model = build_model(cfg, ds.build_task_transform_configs(), optimizer=build_optimizer(OPT_CFG))
    mp = model.network["mp"]
    assert [mp.attn_0.impl, mp.attn_0.fwd_impl] == ["fused", "pallas"]
    model.network.load_state_dict(params_from_jax(jax.device_get(params)))
    check_model(jmodel, model, jbatches, list(DataLoader(ds, batch_size=BATCH, layout="dense")), params)


def test_build_gat_refusals():
    with pytest.raises(TypeError, match="impl"):
        gat.build_gat(hidden_dim=8, impl="csr")  # no such argument, as in the JAX package
    model = gat.build_gat(hidden_dim=8, dropout=0.1)  # dropout is ported: the block's and the FFN's
    assert model.network["mp"].dropout.rate == 0.1 and model.network["ffn"].dropout.rate == 0.1
    with pytest.raises(ValueError, match="dtype"):  # bfloat16 is ported
        gat.build_gat(hidden_dim=8, dtype="float16")
    with pytest.raises(ValueError, match="unknown task"):
        gat.build_gat(hidden_dim=8, task="ranking")
    with pytest.raises(ValueError, match="aggregation"):
        gat.build_gat(hidden_dim=8, aggregation="median")
    # the spatial kind, once refused, builds the JAX recipe's default: SchNet,
    # its tree under the JAX names (held equal to JAX's in test_torch_spatial.py)
    spatial = params_to_jax(build_model({"kind": "spatial", "hidden_dim": 8}, None).network.state_dict())
    assert sorted(spatial["modules__backbone"]) == ["interaction_0", "interaction_1", "interaction_2"]
    with pytest.raises(ValueError, match="unknown model kind"):
        build_model({"kind": "transformer"}, None)


# -- run and run_predict on the CPU -----------------------------------------------------------


def recipe_cfg(name, csv_path, ckpt, epochs=2):
    import yaml

    with open(os.path.join(ROOT, "configs", f"{name}.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["data"]["csv"] = str(csv_path)
    cfg["model"].update(hidden_dim=D, depth=2, num_heads=H)
    cfg["trainer"].update(epochs=epochs, batch_size=BATCH, checkpoint_dir=str(ckpt))
    return cfg


@pytest.mark.parametrize("name", ["graph_transformer_regression", "gat_regression", "declarative"])
def test_run_and_run_predict_on_the_cpu(datasets, lipo_csv, tmp_path, name):
    """run(cfg, device="cpu") trains the config and writes a checkpoint;
    run_predict serves it, with the predictions of the JAX model built from
    the same predict_meta and the checkpoint's weights, on the JAX loader's
    batches."""
    import json

    from notorch_tpu.tasks import transforms as jax_task_transforms

    ds, jds = datasets
    ckpt = tmp_path / "ckpt"
    cfg = recipe_cfg("graph_transformer_regression" if name == "declarative" else name, lipo_csv, ckpt)
    if name == "declarative":
        cfg["model"] = declarative_attention_cfg()
    out = run(cfg, device="cpu")
    assert len(out["history"]) == 2 and np.isfinite(out["test"]["val/rmse"])
    served = run_predict(ckpt, lipo_csv, batch_size=BATCH, device="cpu")["lipo"]
    assert served.shape == (N,) and np.isfinite(served).all()

    meta = json.loads((ckpt / "predict_meta.json").read_text())
    layout = "dense" if name == "declarative" else "dense_packed"
    assert meta["model"].get("layout") == layout
    transforms = {k: {"preds": {"module": jax_task_transforms.deserialize(v["preds"]), "key": "ffn.preds"},
                      "targets": {"module": jax_task_transforms.deserialize(v["targets"]), "key": f"targets.{k}"}}
                  for k, v in meta["transforms"].items()}
    jmodel = jax_build_model(meta["model"], transforms, jax_build_optimizer(OPT_CFG))
    jloader = JaxDataLoader(jds, batch_size=BATCH, layout=layout, **jax_gat.gat_loader_kwargs(layout))
    ref = jax_predict(jmodel, params_to_jax(Checkpointer(ckpt).restore()), jloader, keys=["ffn.preds"])
    np.testing.assert_allclose(served, np.asarray(ref["ffn.preds"])[:N, 0], **TOL)


def test_serving_a_csr_checkpoint_past_the_192_rung(tmp_path):
    """The first 70 lipo molecules at batch 64: the last batch (6 molecules,
    133 node slots with the sink) lands on the training ladder's 192 rung,
    which CSR packing refuses. run_predict of an impl: csr checkpoint serves
    the request on its ladder of multiples of 128, with the JAX model's
    predictions (served there unpacked, through the segment ops)."""
    csv_path = lipo_head(tmp_path / "lipo70.csv", 70)
    ds, jds = datasets_of(csv_path)
    with pytest.raises(ValueError, match="128"):
        list(DataLoader(ds, batch_size=64, layout="flat", csr_pack=True))
    kw = dict(hidden_dim=D, depth=2, impl="csr", layout="flat")
    transforms = ds.build_task_transform_configs()
    model = build_dmpnn(transforms=transforms, generator=torch.Generator().manual_seed(0), **kw)
    ckpt = tmp_path / "ckpt"
    Checkpointer(ckpt).save(model.network.state_dict(), step=0)
    save_predict_meta(ckpt, {"model": {"kind": "dmpnn", **kw}, "data": {"smiles_col": "smiles"}}, transforms, ds,
                      "ffn.preds")
    served = run_predict(ckpt, csv_path, batch_size=64, device="cpu")["lipo"]
    jmodel = jax_build_dmpnn(transforms=jds.build_task_transform_configs(), **kw)
    ref = jax_predict(jmodel, params_to_jax(model.network.state_dict()), JaxDataLoader(jds, batch_size=64, layout="flat"),
                      keys=["ffn.preds"])["ffn.preds"]
    assert served.shape == (70,)
    np.testing.assert_allclose(served, np.asarray(ref)[:70, 0], **TOL)
