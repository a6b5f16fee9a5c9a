"""The plain dense D-MPNN block and the layouts it serves, against the JAX
package on the CPU.

- :class:`DenseChempropBlock` against JAX's for sum, mean and max, with and
  without ``bias``, with ``shared``, residual on and off, on the
  per-molecule and the bin-packed layouts, at dropout 0 and with the same
  injected masks (``tests/test_torch_dropout.py``'s ``masks``): edge and
  node hiddens and the gradients of every parameter and both feature
  inputs. The features are random floats, so no two nonzero messages of a
  node tie and max's gradient is one element's.
- ``resolve_layout`` and the block and readout types of ``build_dmpnn``
  against JAX's for every combination of dropout, reduce and layout.
- ``run`` of ``configs/dmpnn_regression.yaml`` at hidden 32 with
  ``model.dropout: 0.1`` and with ``model.reduce: max``, trained and served
  on the CPU; at dropout 0 with ``layout: dense``, the whole run against
  JAX's ``run`` from the same initial weights.

Tolerances: the block at rtol = atol = 1e-5 on values and 1e-5 of each
gradient's largest magnitude (f32 on both sides, sums in other orders over
depth 2); the whole run's per-epoch losses and metrics and the served
predictions at rtol = atol = 1e-4 (two epochs of Adam carry the blocks'
rounding into the weights).
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from notorch_tpu.cli import train as jax_train_cli
from notorch_tpu.data import dense as jax_dense
from notorch_tpu.model.model import Model as JaxModel
from notorch_tpu.models.dmpnn import build_dmpnn as jax_build_dmpnn
from notorch_tpu.models.dmpnn import resolve_layout as jax_resolve_layout
from notorch_tpu.nn.chemprop_dense import DenseChempropBlock as JaxDenseChempropBlock
from notorch_tpu.transforms import MolToGraph as JaxMolToGraph
from notorch_tpu.transforms import Pipeline as JaxPipeline
from notorch_tpu.transforms import SmiToMol as JaxSmiToMol
from notorch_tpu_torch.cli.predict import run_predict
from notorch_tpu_torch.cli.train import load_config, prepare, run
from notorch_tpu_torch.data import dense
from notorch_tpu_torch.model.convert import params_to_jax
from notorch_tpu_torch.models.dmpnn import build_dmpnn, resolve_layout
from notorch_tpu_torch.nn.chemprop_dense import DenseChempropBlock
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol
from tests.test_torch_dropout import check_graph_module, masks, t  # noqa: F401 (masks: a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "dmpnn_regression.yaml")
PIPE = Pipeline(SmiToMol(), MolToGraph())
JAX_PIPE = JaxPipeline(JaxSmiToMol(), JaxMolToGraph())
SMIS = ["CCO", "c1ccccc1C(=O)O", "CC(C)CC(N)C(=O)O", "O", "CCN(CC)CC", "NC(=O)c1ccccc1", "OCC(O)CO",
        "[Na+].[Cl-]"]
D = 16
RUN_TOL = dict(rtol=1e-4, atol=1e-4)


def graphs(layout):
    """The molecules in both packages with random float node and edge
    features: one molecule a 24-slot block, or packed into 32-slot bins."""
    g, jg = [PIPE(s) for s in SMIS], [JAX_PIPE(s) for s in SMIS]
    if layout == "packed":
        G = dense.pack_graphs_dense(g, 32, 64, np_out=True)
        jG = jax_dense.pack_graphs_dense(jg, 32, 64, bin_cap=G.src.shape[0], np_out=True)
    else:
        G, jG = dense.pad_graphs_dense(g, 24, 48, np_out=True), jax_dense.pad_graphs_dense(jg, 24, 48, np_out=True)
    rng = np.random.default_rng(0)
    B, V = G.node_mask.shape
    nf, ef = rng.standard_normal((B, V, D)).astype(np.float32), rng.standard_normal((B, G.src.shape[1], D))
    ef = ef.astype(np.float32)
    jGf = jax.tree.map(jnp.asarray, jG.update(node_feats=nf, edge_feats=ef))
    return jGf, G.to("cpu").update(node_feats=t(nf), edge_feats=t(ef)), rng


BLOCK_CASES = [dict(reduce=r) for r in ("sum", "mean", "max")] + [
    dict(reduce="max", bias=False), dict(reduce="mean", shared=True), dict(reduce="sum", residual=False),
    dict(reduce="max", shared=True, bias=False, residual=False)]


@pytest.mark.parametrize("layout", ["dense", "packed"])
@pytest.mark.parametrize("kw", BLOCK_CASES)
def test_plain_block_matches_jax(layout, kw):
    """Dropout 0: edge hiddens, node hiddens and every gradient."""
    jG, G, rng = graphs(layout)
    for field in ("edge_feats", "node_feats"):
        check_graph_module(JaxDenseChempropBlock(hidden_dim=D, depth=2, **kw),
                           DenseChempropBlock(hidden_dim=D, depth=2, **kw), jG, G, rng, field)


@pytest.mark.parametrize("layout", ["dense", "packed"])
@pytest.mark.parametrize("kw", [dict(reduce="sum"), dict(reduce="mean"), dict(reduce="max"),
                                dict(reduce="max", shared=True, bias=False)])
def test_plain_block_dropout_matches_jax(masks, layout, kw):  # noqa: F811
    """Edge dropout on each layer's update, before the residual add: the
    same masks in both packages."""
    jG, G, rng = graphs(layout)
    check_graph_module(JaxDenseChempropBlock(hidden_dim=D, depth=2, dropout=0.25, **kw),
                       DenseChempropBlock(hidden_dim=D, depth=2, dropout=0.25, **kw), jG, G, rng, "edge_feats")


# -- build_dmpnn's routing ------------------------------------------------------------

LAYOUTS = ["auto", "dense_packed", "dense_fused", "dense", "flat"]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_build_dmpnn_routes_as_jax(layout, reduce, dropout):
    """resolve_layout, and the block and readout classes build_dmpnn picks,
    are JAX's for every combination (the fused block refuses dropout and max
    in both packages, with a ValueError)."""
    kw = dict(layout=layout, reduce=reduce, dropout=dropout)
    assert resolve_layout(**kw) == jax_resolve_layout(**kw)
    try:
        jmodel = jax_build_dmpnn(hidden_dim=8, **kw)
    except ValueError as exc:
        with pytest.raises(ValueError, match="dropout" if dropout else "max"):
            build_dmpnn(hidden_dim=8, **kw)
        assert layout == "dense_fused", exc
        return
    model = build_dmpnn(hidden_dim=8, **kw)
    for name in ("mp", "readout"):
        assert type(model.network[name]).__name__ == type(jmodel.network.modules_[name]).__name__, name
    rates = [m.rate for m in model.network.modules() if type(m).__name__ == "Dropout"]
    assert rates and set(rates) == {dropout}


# -- run and serve --------------------------------------------------------------------


@pytest.fixture(scope="module")
def lipo_csv(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "lipo96.csv"
    with open(os.path.join(ROOT, "tests", "data", "lipo.csv")) as f:
        rows = list(csv.reader(f))[:97]
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return path


def regression_cfg(csv_path, ckpt, **model) -> dict:
    cfg = load_config(CONFIG)
    cfg["data"]["csv"] = str(csv_path)
    cfg["model"].update(hidden_dim=32, **model)
    cfg["trainer"].update(epochs=2, batch_size=16, checkpoint_dir=str(ckpt), compilation_cache="off", prefetch=0)
    return cfg


@pytest.mark.parametrize("model", [{"dropout": 0.1}, {"reduce": "max"}])
def test_run_trains_and_serves(lipo_csv, tmp_path, model):
    """The shipped regression config with edge dropout (auto -> the plain
    dense layout) or max message passing (dense_packed -> the plain block
    over packed bins) trains two epochs and serves its checkpoint."""
    cfg = regression_cfg(lipo_csv, tmp_path / "ckpt", **model)
    init = prepare(cfg, "cpu")
    expect = ("dense", "DenseMean") if "dropout" in model else ("dense_packed", "PackedMean")
    assert (init["layout"], type(init["model"].network["readout"]).__name__) == expect
    assert type(init["model"].network["mp"]).__name__ == "DenseChempropBlock"
    out = run(cfg, device="cpu")
    assert len(out["history"]) == 2 and all(np.isfinite(r["train/loss"]) for r in out["history"])
    served = run_predict(tmp_path / "ckpt", lipo_csv, batch_size=16, device="cpu")["lipo"]
    assert served.shape == (96,) and np.isfinite(served).all()
    again = run_predict(tmp_path / "ckpt", lipo_csv, batch_size=24, device="cpu")["lipo"]
    np.testing.assert_allclose(again, served, **RUN_TOL)  # eval mode: no dropout, padding does not leak


def test_dense_layout_run_matches_jax(lipo_csv, tmp_path, monkeypatch):
    """layout: dense at dropout 0, both packages from the port's initial
    weights (the JAX Model.init patched to take them): every epoch's train
    and val losses and metrics, and the test metrics."""
    cfg = regression_cfg(lipo_csv, tmp_path / "ours", layout="dense")
    initial = params_to_jax(prepare(cfg, "cpu")["model"].network.state_dict())
    ours = run(cfg, device="cpu")
    init_jax = JaxModel.init

    def from_port_weights(self, rng, batch):
        state = init_jax(self, rng, batch)
        params = jax.tree.map(jnp.asarray, initial)
        assert jax.tree.structure(params) == jax.tree.structure(state.params)
        return state.replace(params=params, opt_state=self.optimizer.init(params))

    monkeypatch.setattr(JaxModel, "init", from_port_weights)
    theirs = jax_train_cli.run(regression_cfg(lipo_csv, tmp_path / "theirs", layout="dense"))
    assert len(ours["history"]) == len(theirs["history"]) == 2
    for a, b in zip(ours["history"], theirs["history"]):
        for key in ("train/loss", "val/loss", "val/rmse", "val/mae"):
            np.testing.assert_allclose(a[key], float(b[key]), **RUN_TOL, err_msg=key)
    for key in ("val/rmse", "val/mae"):
        np.testing.assert_allclose(ours["test"][key], float(theirs["test"][key]), **RUN_TOL, err_msg=key)
