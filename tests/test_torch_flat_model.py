"""The flat-layout modules and models against the JAX package, on carried
weights and the same numpy inputs.

- ``ChempropBlock`` for every impl (gather, segment, csr) and reduce (sum,
  mean, max), residual on and off, and its options (shared, depth 1, no
  bias, remat): node and edge hiddens on EVERY lane, padded ones included,
  at the same impl (``csr`` packs only real edges in both packages, so its
  sink row differs from the other impls', not from JAX's), and the
  gradients of the weights and both feature inputs.
- The five readouts and ``GraphEmbedding``, in outputs and gradients.
- ``build_dmpnn(layout="flat", impl="csr")`` and the network of
  ``configs/declarative_example.yaml`` built through the registry:
  predictions, the train step's loss and every parameter gradient.
- ``params_from_jax``/``params_to_jax`` round trips for every flat group.
- Training and serving through the CLIs on the CPU for ``model.impl=csr``
  and for the declarative example; serving an ``impl: csr`` checkpoint
  packs its batches, so it reduces through the CSR kernel's path (the JAX
  ``run_predict`` does not pack, and its block falls back to the segment
  ops), and its predictions agree with the JAX model's on the same weights.

The JAX side runs its Pallas kernels with ``interpret=True``. Tolerances:
outputs, losses and predictions at rtol = atol = 1e-4; gradients at rtol =
1e-4 and atol 1e-4 times the tensor's largest magnitude (the weight
gradients sum over every edge of the batch).
"""

import csv
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from notorch_tpu.cli import registry as jax_registry
from notorch_tpu.cli.train import build_model as jax_build_model
from notorch_tpu.cli.train import build_optimizer as jax_build_optimizer
from notorch_tpu.data import graph as jax_graph
from notorch_tpu.data.batching import DataLoader as JaxDataLoader
from notorch_tpu.data.dataset import MolecularDataset as JaxDataset
from notorch_tpu.data.dataset import TargetSpec as JaxTargetSpec
from notorch_tpu.data.dataset import TransformManager as JaxTM
from notorch_tpu.models.dmpnn import build_dmpnn as jax_build_dmpnn
from notorch_tpu.tasks import transforms as jax_task_transforms
from notorch_tpu.training.loop import predict as jax_predict
from notorch_tpu.transforms import MolToGraph as JaxMolToGraph
from notorch_tpu.transforms import Pipeline as JaxPipeline
from notorch_tpu.transforms import SmiToMol as JaxSmiToMol
from notorch_tpu_torch.cli import registry
from notorch_tpu_torch.cli.predict import run_predict
from notorch_tpu_torch.cli.train import build_dataset, build_model, build_optimizer
from notorch_tpu_torch.data import graph
from notorch_tpu_torch.data.batching import DataLoader
from notorch_tpu_torch.model.convert import params_from_jax, params_to_jax
from notorch_tpu_torch.models.dmpnn import build_dmpnn
from notorch_tpu_torch.nn import chemprop
from notorch_tpu_torch.nn.chemprop import ChempropBlock
from notorch_tpu_torch.training.checkpoint import Checkpointer
from notorch_tpu_torch.training.loop import predict, to_device
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, N = 16, 96
TOL = dict(rtol=1e-4, atol=1e-4)
PIPE, JAX_PIPE = Pipeline(SmiToMol(), MolToGraph()), JaxPipeline(JaxSmiToMol(), JaxMolToGraph())
SMIS = ["CCO", "c1ccccc1C(=O)O", "NC(=O)c1ccccc1", "CCCCCCCC", "CC(=O)Nc1ccc(O)cc1", "O"]


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def assert_grad_close(got, ref, name="", scale=None):
    """``scale`` (default: the tensor's own largest magnitude) sets atol;
    a gradient that is zero in exact arithmetic (the gated readout's score
    bias: a softmax does not move with a shift) is compared at the scale of
    the other gradients instead, since all it holds is rounding."""
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max()) if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-4, atol=1e-4 * scale, err_msg=name)


def _scale(name, grads) -> float | None:
    return max(float(np.abs(np.asarray(g)).max()) for g in grads) if name.endswith("a.bias") else None


@pytest.fixture(scope="module")
def pair():
    """One flat batch of six molecules in 8 graph slots with CSR packing,
    in both packages, random float features on every node and edge lane,
    and random cotangents for both outputs."""
    rng = np.random.default_rng(0)
    bg = graph.with_csr_packing(graph.pad_graphs([PIPE(s) for s in SMIS], 128, 256, graph_cap=8, np_out=True))
    jbg = jax_graph.with_csr_packing(
        jax_graph.pad_graphs([JAX_PIPE(s) for s in SMIS], 128, 256, graph_cap=8, np_out=True))
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return {"G": bg.to("cpu"), "jG": jax.tree.map(jnp.asarray, jbg), "nf": f(128, D), "ef": f(256, D),
            "gn": f(128, D), "ge": f(256, D), "gh": f(8, D)}


def _port_params(params: dict, module: torch.nn.Module) -> None:
    sd = params_from_jax({"modules__m": jax.device_get(params)})
    module.load_state_dict({k.removeprefix("m."): v for k, v in sd.items()})


def _check_block(pair, **kw):
    jG, nf, ef, gn, ge = (pair[k] for k in ("jG", "nf", "ef", "gn", "ge"))
    jblock = jax_registry.build({"class": "ChempropBlock", "args": {"hidden_dim": D, **kw}})
    params = jblock.init(jax.random.PRNGKey(0), jG.replace(node_feats=nf, edge_feats=ef))["params"]

    def f(params, nf, ef):
        out = jblock.apply({"params": params}, jG.replace(node_feats=nf, edge_feats=ef))
        return (out.node_feats * gn).sum() + (out.edge_feats * ge).sum(), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(nf), jnp.asarray(ef))
    block = ChempropBlock(hidden_dim=D, **kw)
    _port_params(params, block)
    x_n, x_e = t(nf).requires_grad_(), t(ef).requires_grad_()
    got = block(pair["G"].update(node_feats=x_n, edge_feats=x_e))
    ((got.node_feats * t(gn)).sum() + (got.edge_feats * t(ge)).sum()).backward()
    np.testing.assert_allclose(got.node_feats.detach().numpy(), np.asarray(out.node_feats), **TOL)
    np.testing.assert_allclose(got.edge_feats.detach().numpy(), np.asarray(out.edge_feats), **TOL)
    ref = params_from_jax({"modules__m": jax.device_get(grads[0])})
    for name, p in block.named_parameters():
        assert_grad_close(p.grad.numpy(), ref[f"m.{name}"].numpy(), name)
    assert_grad_close(x_n.grad.numpy(), grads[1], "node_feats")
    assert_grad_close(x_e.grad.numpy(), grads[2], "edge_feats")


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("impl", ["gather", "segment", "csr"])
def test_block_matches_jax(pair, impl, reduce, residual):
    _check_block(pair, impl=impl, reduce=reduce, residual=residual, depth=3)


@pytest.mark.parametrize("kw", [dict(shared=True, impl="csr"), dict(shared=True, depth=1, impl="gather"),
                                dict(depth=1, impl="csr", bias=False), dict(depth=2, impl="segment", remat=True),
                                dict(depth=2, impl="csr", remat=True)],
                         ids=["shared-csr", "shared-depth1", "depth1-nobias", "remat-segment", "remat-csr"])
def test_block_options_match_jax(pair, kw):
    _check_block(pair, **kw)


def test_impls_agree_on_real_lanes_only(pair):
    """csr packs only real edges: its sink row holds no padding messages,
    where segment and gather sum them in. Compared through the masks."""
    G = pair["G"].update(node_feats=t(pair["nf"]), edge_feats=t(pair["ef"]))
    outs = {}
    for impl in ("csr", "segment", "gather"):
        block = ChempropBlock(hidden_dim=D, depth=2, impl=impl)
        block.reset_parameters(torch.Generator().manual_seed(1))
        outs[impl] = block(G)
    vmask, emask = G.node_mask, G.edge_mask
    for impl in ("segment", "gather"):
        torch.testing.assert_close(outs["csr"].node_feats[vmask], outs[impl].node_feats[vmask], **TOL)
        torch.testing.assert_close(outs["csr"].edge_feats[emask], outs[impl].edge_feats[emask], **TOL)
    sink = G.num_nodes - 1
    assert not outs["csr"].node_feats[sink].any() and outs["segment"].node_feats[sink].abs().sum() > 0


def test_csr_block_refuses_a_batch_without_packing(pair):
    """No fallback hides the kernel: impl="csr" with reduce="sum" on a batch
    without the packing raises, naming csr_pack."""
    G = pair["G"].update(node_feats=t(pair["nf"]), edge_feats=t(pair["ef"]), csr_perm=None, csr_dst=None)
    with pytest.raises(ValueError, match="csr_pack"):
        ChempropBlock(hidden_dim=D, impl="csr")(G)
    ChempropBlock(hidden_dim=D, impl="csr", reduce="mean")(G)  # mean and max take the segment ops


def test_block_refusals(pair):
    assert ChempropBlock(hidden_dim=D, dropout=0.1).dropout.rate == 0.1  # edge dropout is ported
    # an axis name resolves inside a sharded trainer's step alone, as in JAX
    G = pair["G"].update(node_feats=t(pair["nf"]), edge_feats=t(pair["ef"]))
    with pytest.raises(NameError, match="unbound axis name: graph"):
        ChempropBlock(hidden_dim=D, psum_axis="graph")(G)
    with pytest.raises(NameError, match="unbound axis name: graph"):
        registry.build({"class": "Mean", "args": {"psum_axis": "graph"}})(G)
    with pytest.raises(ValueError, match="impl"):
        ChempropBlock(hidden_dim=D, impl="dense")


def test_chemprop_layer_matches_jax(pair):
    jG, ef, ge = pair["jG"], pair["ef"], pair["ge"]
    jlayer = jax_registry.build({"class": "ChempropLayer", "args": {"hidden_dim": D, "impl": "csr"}})
    params = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(ef), jG)["params"]
    out, vjp = jax.vjp(lambda p, x: jlayer.apply({"params": p}, x, jG), params, jnp.asarray(ef))
    g_params, g_x = vjp(jnp.asarray(ge))
    layer = registry.build({"class": "ChempropLayer", "args": {"hidden_dim": D, "impl": "csr"}})
    _port_params(params, layer)
    x = t(ef).requires_grad_()
    got = layer(x, pair["G"])
    got.backward(t(ge))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    ref = params_from_jax({"modules__m": jax.device_get(g_params)})
    for name, p in layer.named_parameters():
        assert_grad_close(p.grad.numpy(), ref[f"m.{name}"].numpy(), name)
    assert_grad_close(x.grad.numpy(), g_x)


@pytest.mark.parametrize("name", ["Sum", "Mean", "Max", "Gated", "SDPAttention"])
def test_readout_matches_jax(pair, name):
    """Every readout over 6 molecules in 8 graph slots: outputs and the
    gradients of the node hiddens and the parameters."""
    args = {"Gated": {"input_dim": D}, "SDPAttention": {"key_dim": D}}.get(name, {})
    jmod = jax_registry.build({"class": name, "args": args})
    jG, nf, gh = pair["jG"], jnp.asarray(pair["nf"]), jnp.asarray(pair["gh"])
    params = jmod.init(jax.random.PRNGKey(2), jG.replace(node_feats=nf)).get("params", {})
    out, vjp = jax.vjp(lambda p, x: jmod.apply({"params": p}, jG.replace(node_feats=x)), params, nf)
    g_params, g_x = vjp(gh)
    mod = registry.build({"class": name, "args": args})
    if params:
        _port_params(params, mod)
    x = t(pair["nf"]).requires_grad_()
    got = mod(pair["G"].update(node_feats=x))
    got.backward(t(pair["gh"]))
    assert got.shape == (8, D)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    assert_grad_close(x.grad.numpy(), g_x)
    if params:
        ref = params_from_jax({"modules__m": jax.device_get(g_params)})
        for pname, p in mod.named_parameters():
            assert_grad_close(p.grad.numpy(), ref[f"m.{pname}"].numpy(), pname, _scale(pname, [g_x]))


def test_graph_embedding_matches_jax(pair):
    jG = pair["jG"]
    jmod = jax_registry.build({"class": "GraphEmbedding", "args": {"hidden_dim": D}})
    params = jmod.init(jax.random.PRNGKey(3), jG)["params"]
    gn, ge = jnp.asarray(pair["gn"]), jnp.asarray(pair["ge"])

    def f(p):
        out = jmod.apply({"params": p}, jG)
        return (out.node_feats * gn).sum() + (out.edge_feats * ge).sum(), out

    (_, out), grads = jax.value_and_grad(f, has_aux=True)(params)
    mod = registry.build({"class": "GraphEmbedding", "args": {"hidden_dim": D}})
    _port_params(params, mod)
    got = mod(pair["G"])
    ((got.node_feats * t(pair["gn"])).sum() + (got.edge_feats * t(pair["ge"])).sum()).backward()
    np.testing.assert_allclose(got.node_feats.detach().numpy(), np.asarray(out.node_feats), **TOL)
    np.testing.assert_allclose(got.edge_feats.detach().numpy(), np.asarray(out.edge_feats), **TOL)
    ref = params_from_jax({"modules__m": jax.device_get(grads)})
    for name, p in mod.named_parameters():
        assert_grad_close(p.grad.numpy(), ref[f"m.{name}"].numpy(), name)


@pytest.mark.parametrize("spec", [
    ("GraphEmbedding", {"hidden_dim": D}),
    ("ChempropBlock", {"hidden_dim": D, "impl": "csr"}),
    ("ChempropBlock", {"hidden_dim": D, "shared": True}),
    ("ChempropBlock", {"hidden_dim": D, "depth": 2, "bias": False}),
    ("ChempropBlock", {"hidden_dim": D, "depth": 1, "shared": True, "bias": False}),
    ("Gated", {"input_dim": D}),
    ("SDPAttention", {"key_dim": D}),
    ("ChempropLayer", {"hidden_dim": D}),
    ("ChempropLayer", {"hidden_dim": D, "bias": False}),
], ids=lambda s: f"{s[0]}-{'-'.join(f'{k}={v}' for k, v in s[1].items() if k != 'hidden_dim')}")
def test_flat_params_round_trip(pair, spec):
    """Every flat group maps onto the port module's state_dict (strict:
    every key, every shape) and back, leaf for leaf."""
    name, args = spec
    jmod = jax_registry.build({"class": name, "args": args})
    G = pair["jG"].replace(node_feats=jnp.asarray(pair["nf"]), edge_feats=jnp.asarray(pair["ef"]))
    if name == "GraphEmbedding":
        G = pair["jG"]
    inputs = (jnp.asarray(pair["ef"]), G) if name == "ChempropLayer" else (G,)
    tree = {"modules__m": jax.device_get(jmod.init(jax.random.PRNGKey(4), *inputs)["params"])}
    mod = registry.build({"class": name, "args": args})
    _port_params(tree["modules__m"], mod)
    back = params_to_jax({f"m.{k}": v for k, v in mod.state_dict().items()})
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(leaf), flat_back[path])


# -- whole models ----------------------------------------------------------------------------


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
    jds = JaxDataset(table, {"graph": JaxTM(JAX_PIPE, "smiles", "G")}, targets={"y": JaxTargetSpec(["lipo"])})
    return ds, jds


def declarative_model_cfg(d: int = D) -> dict:
    """The model section of configs/declarative_example.yaml at width d."""
    with open(os.path.join(ROOT, "configs", "declarative_example.yaml")) as f:
        model = yaml.safe_load(f)["model"]
    for m in model["modules"].values():
        m["args"] = {k: d if v == 128 else v for k, v in (m.get("args") or {}).items()}
    return model


def _check_model(jmodel, model, jbatches, batches, params):
    """One train step (loss and every gradient) on the first batch, and the
    predictions over all batches."""
    jbatch = jbatches[0]

    def loss_fn(params):
        out = jmodel.network.apply({"params": params}, dict(jbatch), training=True,
                                   rngs={"dropout": jax.random.PRNGKey(1)})
        terms = jmodel._loss_terms(jmodel._apply_transforms(out, "targets"))
        return sum(jmodel.train_loss_weights[k] * v for k, v in terms.items())

    loss, grads = jax.value_and_grad(loss_fn)(params)
    logs = model.train_step(to_device(batches[0], "cpu"))
    np.testing.assert_allclose(float(logs["train/loss"]), float(loss), **TOL)
    ref = params_from_jax(jax.device_get(grads))
    got = {name: p.grad for name, p in model.network.named_parameters()}
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        assert_grad_close(got[name].numpy(), r.numpy(), name, _scale(name, ref.values()))


@pytest.mark.parametrize("aggregation", ["mean", "gated"])
def test_flat_csr_dmpnn_matches_jax(datasets, aggregation):
    """build_dmpnn(layout="flat", impl="csr"): predictions over the packed
    lipo batches, then the loss and every gradient of a train step."""
    ds, jds = datasets
    kw = dict(hidden_dim=D, depth=3, impl="csr", layout="flat", aggregation=aggregation)
    jmodel = jax_build_dmpnn(transforms=jds.build_task_transform_configs(), **kw)
    jbatches = list(JaxDataLoader(jds, batch_size=32, layout="flat", csr_pack=True))
    params = jmodel.init(jax.random.PRNGKey(0), jbatches[0]).params
    model = build_dmpnn(transforms=ds.build_task_transform_configs(), **kw)
    assert [type(model.network[k]).__name__ for k in ("embed", "mp", "readout")] == [
        "GraphEmbedding", "ChempropBlock", {"mean": "Mean", "gated": "Gated"}[aggregation]]
    model.network.load_state_dict(params_from_jax(jax.device_get(params)))
    batches = list(DataLoader(ds, batch_size=32, layout="flat", csr_pack=True))
    preds = predict(model, batches, keys=["ffn.preds"])["ffn.preds"]
    ref = jax_predict(jmodel, params, jbatches, keys=["ffn.preds"])["ffn.preds"]
    assert preds.shape == (N, 1)
    np.testing.assert_allclose(preds, np.asarray(ref), **TOL)
    _check_model(jmodel, model, jbatches, batches, params)


def test_declarative_example_network_matches_jax(datasets):
    """configs/declarative_example.yaml (GraphEmbedding -> ChempropBlock with
    the default impl -> Gated -> MLP) built by name in both packages."""
    ds, jds = datasets
    cfg = declarative_model_cfg()
    opt = {"name": "adam", "lr": 1e-3}
    jmodel = jax_build_model(cfg, jds.build_task_transform_configs(), jax_build_optimizer(opt))
    jbatches = list(JaxDataLoader(jds, batch_size=32, layout="flat"))
    params = jmodel.init(jax.random.PRNGKey(0), jbatches[0]).params
    model = build_model(cfg, ds.build_task_transform_configs(), optimizer=build_optimizer(opt))
    model.network.load_state_dict(params_from_jax(jax.device_get(params)))
    batches = list(DataLoader(ds, batch_size=32, layout="flat"))
    preds = predict(model, batches, keys=["ffn.preds"])["ffn.preds"]
    np.testing.assert_allclose(preds, np.asarray(jax_predict(jmodel, params, jbatches, keys=["ffn.preds"])["ffn.preds"]),
                               **TOL)
    _check_model(jmodel, model, jbatches, batches, params)


def test_flat_model_refusals():
    """Graph-axis partitioning builds as in JAX (molecule: the readout sums
    over the axis; halo: the halo block and the readout; replicate: the
    block), on the flat layout only; the halo block refuses dropout and any
    reduce but sum, as there; a partition without a graph axis changes
    nothing."""
    molecule = build_dmpnn(hidden_dim=8, layout="flat", graph_axis="graph").network
    assert molecule["readout"].psum_axis == "graph" and molecule["mp"].psum_axis is None
    assert type(build_dmpnn(hidden_dim=8, graph_axis="graph", partition="halo").network["mp"]).__name__ == (
        "HaloChempropBlock")
    assert isinstance(build_dmpnn(hidden_dim=8, layout="flat", partition="halo").network["mp"], ChempropBlock)
    for kwargs, match in (({"layout": "dense"}, "flat layout"), ({"partition": "halo", "dropout": 0.1}, "dropout"),
                          ({"partition": "halo", "reduce": "mean"}, "reduce"), ({"partition": "edges"}, "partition")):
        with pytest.raises(ValueError, match=match):
            build_dmpnn(hidden_dim=8, graph_axis="graph", **kwargs)
        with pytest.raises(ValueError, match=match):
            jax_build_dmpnn(hidden_dim=8, graph_axis="graph", **kwargs)
    block = build_dmpnn(hidden_dim=8, layout="flat", impl="csr", dtype="bfloat16").network["mp"]
    assert isinstance(block, ChempropBlock) and block.impl == "csr" and block.dtype == torch.bfloat16  # row 9b
    assert isinstance(build_dmpnn(hidden_dim=8, remat=True).network["mp"], ChempropBlock)  # auto -> flat


def _cli(*args):
    proc = subprocess.run([sys.executable, "-m", "notorch_tpu_torch", *map(str, args), "--cpu"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return [json.loads(line) for line in proc.stdout.strip().splitlines()]


def test_train_and_serve_impl_csr_on_the_cpu(datasets, lipo_csv, tmp_path, monkeypatch):
    """The CLIs train and serve configs/dmpnn_regression.yaml with
    model.impl=csr; the checkpoint's predictions go through the packed
    reduce (every layer's and the final one, every batch) and agree with
    the JAX model on the same weights, served as the JAX run_predict serves
    it: unpacked, through the segment ops."""
    ckpt = tmp_path / "ckpt"
    lines = _cli("train", "configs/dmpnn_regression.yaml", f"data.csv={lipo_csv}", "model.impl=csr",
                 f"model.hidden_dim={D}", "model.depth=2", "trainer.epochs=2", "trainer.batch_size=32",
                 f"trainer.checkpoint_dir={ckpt}")
    assert [r["epoch"] for r in lines[:2]] == [0, 1] and np.isfinite(lines[2]["test"]["val/rmse"])
    meta = json.loads((ckpt / "predict_meta.json").read_text())
    assert meta["model"]["layout"] == "flat" and meta["model"]["impl"] == "csr"
    out = tmp_path / "preds.csv"
    assert _cli("predict", ckpt, lipo_csv, "-o", out) == [{"predictions_csv": str(out)}]
    served = np.array([float(x) for x in out.read_text().split()[1:]])

    calls = []
    real = chemprop.csr_segment_sum_packed
    monkeypatch.setattr(chemprop, "csr_segment_sum_packed", lambda *a, **k: calls.append(1) or real(*a, **k))
    again = run_predict(ckpt, lipo_csv, batch_size=64, device="cpu")["lipo"]
    assert len(calls) == 3 * 2  # (depth + 1) reduces x 2 batches
    np.testing.assert_allclose(again, served, rtol=1e-5, atol=1e-5)  # the CSV keeps 6 digits

    ds, jds = datasets
    transforms = {name: {"preds": {"module": jax_task_transforms.deserialize(tr["preds"]), "key": "ffn.preds"},
                         "targets": {"module": jax_task_transforms.deserialize(tr["targets"]),
                                     "key": f"targets.{name}"}}
                  for name, tr in meta["transforms"].items()}
    jmodel = jax_build_dmpnn(hidden_dim=D, depth=2, impl="csr", layout="flat", transforms=transforms)
    params = params_to_jax(Checkpointer(ckpt).restore())
    ref = jax_predict(jmodel, params, JaxDataLoader(jds, batch_size=64, layout="flat"), keys=["ffn.preds"])
    np.testing.assert_allclose(again, np.asarray(ref["ffn.preds"])[:N, 0], **TOL)


def test_train_and_serve_declarative_example_on_the_cpu(lipo_csv, tmp_path):
    """configs/declarative_example.yaml as shipped, at width 16 and one
    epoch: the CLIs train on the flat layout and serve the checkpoint."""
    ckpt = tmp_path / "ckpt"
    widths = [f"model.modules.{m}.args.{k}={D}" for m, k in
              (("embed", "hidden_dim"), ("mp", "hidden_dim"), ("readout", "input_dim"), ("ffn", "input_dim"),
               ("ffn", "hidden_dim"))]
    lines = _cli("train", "configs/declarative_example.yaml", f"data.csv={lipo_csv}", "trainer.epochs=1",
                 f"trainer.checkpoint_dir={ckpt}", *widths)
    assert lines[0]["epoch"] == 0 and np.isfinite(lines[0]["train/loss"]) and "test" in lines[1]
    meta = json.loads((ckpt / "predict_meta.json").read_text())
    assert meta["model"]["modules"]["readout"]["class"] == "Gated" and "layout" not in meta["model"]
    served = run_predict(ckpt, lipo_csv, batch_size=40, device="cpu")["lipo"]
    assert served.shape == (N,) and np.isfinite(served).all()
    again = run_predict(ckpt, lipo_csv, batch_size=64, device="cpu")["lipo"]
    np.testing.assert_allclose(again, served, **TOL)  # the batch's padding does not leak
