"""The multicomponent model and config against the JAX package on the CPU:

- ``build_multicomponent_dmpnn`` on JAX's weights (``params_from_jax``,
  ``batch_stats`` included) with separate encoders and per-component
  vocabularies, a shared encoder (one set of parameters), molecule-level
  extra features (Morgan fingerprints from a configurable ``MolToFP``
  transform), layer norm and batch norm: predictions, the loss and every
  gradient; with batch norm, three training steps over a short batch whose
  padded molecules count in the statistics, as in flax: losses, running
  statistics and parameters after the steps, then eval predictions;
- ``run`` of ``configs/multicomponent.yaml`` at hidden 16, depth 1, two
  epochs on the first 16 rows of ``tests/data/multi.csv`` with seeded
  ``y`` (the JAX package's ``test_multicomponent_cli_config`` setup) from
  the port's initial weights in both packages: every per-epoch loss within
  MULTI_RUN_RTOL, then each package's predict CLI; one port weight tensor
  scaled by 1.03 leaves the limit;
- the config with fingerprint features and batch norm through ``run`` and
  ``run_predict`` in the port: a run killed after an epoch and resumed ends
  with the uninterrupted run's bits, running statistics included, and
  serving uses them.

Tolerance: rtol = atol = 1e-4; gradients at 1e-4 times the tensor's largest
magnitude.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from notorch_tpu.cli import predict as jax_predict_cli
from notorch_tpu.cli import train as jax_train_cli
from notorch_tpu.data.batching import DataLoader as JaxDataLoader
from notorch_tpu.data.dataset import MolecularDataset as JaxDataset
from notorch_tpu.data.dataset import TargetSpec as JaxTargetSpec
from notorch_tpu.data.dataset import TransformManager as JaxTM
from notorch_tpu.model.model import Model as JaxModel
from notorch_tpu.models.multicomponent import build_multicomponent_dmpnn as jax_build
from notorch_tpu.training.loop import predict as jax_predict
from notorch_tpu.transforms import MolToFP as JaxMolToFP
from notorch_tpu.transforms import MolToGraph as JaxMolToGraph
from notorch_tpu.transforms import Pipeline as JaxPipeline
from notorch_tpu.transforms import SmiToMol as JaxSmiToMol
from notorch_tpu_torch.cli.predict import run_predict
from notorch_tpu_torch.cli.train import build_dataset, load_config, prepare, run
from notorch_tpu_torch.data.batching import DataLoader
from notorch_tpu_torch.model.convert import batch_stats_to_jax, params_from_jax, params_to_jax
from notorch_tpu_torch.model.model import Model
from notorch_tpu_torch.models.multicomponent import build_multicomponent_dmpnn
from notorch_tpu_torch.training.loop import predict, to_device
from notorch_tpu_torch.training.optim import OptimizerSpec
from tests.test_torch_glue import close_grad

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
CONFIG = os.path.join(ROOT, "configs", "multicomponent.yaml")
KEYS = ["inputs.G1", "inputs.G2"]
FP_BITS = 64
# the fingerprint transforms of a config: SMILES -> molecule -> Morgan bits
FP_TRANSFORMS = {"mol": {"transform": {"class": "SmiToMol"}, "in_key": "smiles1", "out_key": "mol"},
                 "fp": {"transform": {"class": "MolToFP", "args": {"length": FP_BITS}}, "in_key": "mol",
                        "out_key": "X_f"}}
OPTIONS = {
    "separate": dict(num_node_types={"inputs.G2": 45}, num_edge_types={"inputs.G1": 14}),
    "shared": dict(shared_encoder=True, num_node_types={"inputs.G1": 42, "inputs.G2": 45}),
    "extra_features": dict(extra_features_key="inputs.X_f", extra_features_dim=FP_BITS),
    "no_norm": dict(normalize_fingerprint=False, aggregation="sum"),
    "batch_norm": dict(norm="batch", extra_features_key="inputs.X_f", extra_features_dim=FP_BITS),
}
# port-CPU against JAX-CPU, the per-epoch losses of the config's run below
# drift 5.6e-7 relative (4 steps: the epoch means and Adam's updates summed
# in another order); the limit is about 3x that. With the port's first
# block weight scaled by 1.03 they drift 7.0e-3
MULTI_RUN_RTOL = 2e-6


def multi_csv(directory, n: int = 16) -> str:
    """The first ``n`` rows of tests/data/multi.csv with ``y`` drawn from
    ``default_rng(0)``, as the JAX package's CLI test writes them."""
    with open(os.path.join(ROOT, "tests", "data", "multi.csv")) as f:
        rows = list(csv.DictReader(f))[:n]
    y = np.random.default_rng(0).normal(size=len(rows))
    path = os.path.join(directory, "multi_y.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["smiles1", "smiles2", "y"])
        w.writerows([r["smiles1"], r["smiles2"], repr(float(v))] for r, v in zip(rows, y))
    return path


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """12 rows in both packages (batches of 8: the second is short), with
    the fingerprint features, the port's built from the config's transform
    specs."""
    path = multi_csv(tmp_path_factory.mktemp("multi"), 12)
    graphs = {"g1": {"in_key": "smiles1", "out_key": "G1"}, "g2": {"in_key": "smiles2", "out_key": "G2"}}
    ds = build_dataset({"csv": path, "transforms": {**graphs, **FP_TRANSFORMS},
                        "targets": {"y": {"columns": ["y"]}}})
    table = {k: [r[k] for r in ds.records] for k in ("smiles1", "smiles2")}
    table["y"] = [float(r["y"]) for r in ds.records]

    def pipe():
        return JaxPipeline(JaxSmiToMol(), JaxMolToGraph())

    jds = JaxDataset(table, {"g1": JaxTM(pipe(), "smiles1", "G1"), "g2": JaxTM(pipe(), "smiles2", "G2"),
                             "fp": JaxTM(JaxPipeline(JaxSmiToMol(), JaxMolToFP(length=FP_BITS)), "smiles1", "X_f")},
                     targets={"y": JaxTargetSpec(["y"])})
    batches = list(DataLoader(ds, batch_size=8, layout="flat"))
    jbatches = list(JaxDataLoader(jds, batch_size=8, layout="flat"))
    np.testing.assert_array_equal(batches[1]["inputs.X_f"], np.asarray(jbatches[1]["inputs.X_f"]))
    assert batches[1]["inputs.G1"].n_graphs == 8 and int(batches[1]["targets.y_mask"].sum()) == 4
    return ds, jds, batches, jbatches


def models(data, option):
    ds, jds, _, jbatches = data
    kw = dict(hidden_dim=16, depth=2, **OPTIONS[option])
    jmodel = jax_build(KEYS, transforms=jds.build_task_transform_configs(), optimizer=optax.adam(1e-2), **kw)
    model = build_multicomponent_dmpnn(KEYS, transforms=ds.build_task_transform_configs(),
                                       optimizer=OptimizerSpec("adam", 1e-2), **kw)
    state = jmodel.init(jax.random.PRNGKey(0), jbatches[0])
    params, stats = jax.device_get(state.params), jax.device_get(state.extra_vars.get("batch_stats"))
    model.network.load_state_dict(params_from_jax(params, stats))
    return jmodel, model, state


@pytest.mark.parametrize("option", list(OPTIONS))
def test_multicomponent_model_matches_jax(data, option):
    """Predictions of both batches, then one train step's loss and every
    gradient."""
    _, _, batches, jbatches = data
    jmodel, model, state = models(data, option)
    names = {k.split(".")[0] for k in model.network.state_dict()}
    if option == "shared":
        assert "embed_1" not in names and "mp_1" not in names and model.network.aliases == {
            "embed_1": "embed_0", "mp_1": "mp_0"}
        assert model.network["embed_0"].node.embedding.weight.shape[0] == 45
    if option == "separate":
        assert model.network["embed_1"].node.embedding.weight.shape[0] == 45
        assert model.network["embed_0"].edge.embedding.weight.shape[0] == 14
    assert params_to_jax(model.network.state_dict()).keys() == state.params.keys()
    ref = jax_predict(jmodel, state.params, jbatches, keys=["ffn.preds"], extra_vars=state.extra_vars)
    np.testing.assert_allclose(predict(model, batches, keys=["ffn.preds"])["ffn.preds"],
                               np.asarray(ref["ffn.preds"]), **TOL)

    mutable = list(state.extra_vars) or False

    def loss_fn(p):
        out = jmodel.network.apply({"params": p, **state.extra_vars}, dict(jbatches[1]), training=True,
                                   mutable=mutable)
        out = out[0] if mutable else out
        terms = jmodel._loss_terms(jmodel._apply_transforms(out, "targets"))
        return sum(jmodel.train_loss_weights[k] * v for k, v in terms.items())

    loss, grads = jax.value_and_grad(loss_fn)(state.params)
    grads = params_from_jax(jax.device_get(grads))
    logs = model.train_step(to_device(batches[1], "cpu"))
    np.testing.assert_allclose(float(logs["train/loss"]), float(loss), **TOL)
    for name, p in model.network.named_parameters():
        close_grad(p.grad, grads[name].numpy(), name)


def test_batch_norm_steps_and_serving_match_flax(data):
    """Three train steps (a full batch, the short one, the full one): each
    loss, then the running statistics and every parameter, then eval
    predictions through the running averages."""
    _, _, batches, jbatches = data
    jmodel, model, state = models(data, "batch_norm")
    for step, i in enumerate((0, 1, 0)):
        state, jlogs = jmodel.train_step(state, jbatches[i])
        logs = model.train_step(to_device(batches[i], "cpu"))
        np.testing.assert_allclose(float(logs["train/loss"]), float(jlogs["train/loss"]), **TOL, err_msg=str(step))
    ours = batch_stats_to_jax(model.network.state_dict())["modules__norm"]["BatchNorm_0"]
    theirs = jax.device_get(state.extra_vars["batch_stats"])["modules__norm"]["BatchNorm_0"]
    for key in ("mean", "var"):
        np.testing.assert_allclose(ours[key], theirs[key], **TOL, err_msg=key)
    params = params_from_jax(jax.device_get(state.params))
    for name, p in model.network.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), params[name].numpy(), **TOL, err_msg=name)
    ref = jax_predict(jmodel, state.params, jbatches, keys=["ffn.preds"], extra_vars=state.extra_vars)
    np.testing.assert_allclose(predict(model, batches, keys=["ffn.preds"])["ffn.preds"],
                               np.asarray(ref["ffn.preds"]), **TOL)


def multi_cfg(csv_path, ckpt, **trainer) -> dict:
    cfg = load_config(CONFIG)
    cfg["data"]["csv"] = str(csv_path)
    cfg["model"].update(hidden_dim=16, depth=1)
    cfg["trainer"].update(epochs=2, batch_size=8, checkpoint_dir=str(ckpt), compilation_cache="off", prefetch=0,
                          **trainer)
    return cfg


@pytest.fixture(scope="module")
def jax_multi_run(tmp_path_factory):
    """The config's run in the JAX package from the port's initial weights,
    and its checkpoint served."""
    directory = tmp_path_factory.mktemp("multi_run")
    csv_path = multi_csv(directory)
    initial = params_to_jax(prepare(multi_cfg(csv_path, directory / "x"), "cpu")["model"].network.state_dict())
    init_jax = JaxModel.init

    def from_port_weights(self, rng, batch):
        state = init_jax(self, rng, batch)
        params = jax.tree.map(jnp.asarray, initial)
        assert jax.tree.structure(params) == jax.tree.structure(state.params)
        return state.replace(params=params, opt_state=self.optimizer.init(params))

    JaxModel.init = from_port_weights
    try:
        out = jax_train_cli.run(multi_cfg(csv_path, directory / "theirs"))
    finally:
        JaxModel.init = init_jax
    return csv_path, out, jax_predict_cli.run_predict(directory / "theirs", csv_path)


def drift(ours: dict, theirs: dict) -> float:
    return max(abs(a[k] - float(b[k])) / abs(float(b[k]))
               for a, b in zip(ours["history"], theirs["history"]) for k in b if k.startswith(("train/", "val/")))


def test_multicomponent_config_runs_and_serves_as_in_jax(jax_multi_run, tmp_path):
    csv_path, theirs, jserved = jax_multi_run
    ours = run(multi_cfg(csv_path, tmp_path / "ours"), device="cpu")
    assert len(ours["history"]) == len(theirs["history"]) == 2
    print("multi drift", drift(ours, theirs))
    assert drift(ours, theirs) <= MULTI_RUN_RTOL
    served = run_predict(tmp_path / "ours", csv_path, device="cpu")
    assert list(served) == list(jserved) == ["y"]
    np.testing.assert_allclose(served["y"], jserved["y"], **TOL)


def test_multicomponent_run_gate_catches_a_scaled_weight(jax_multi_run, tmp_path, monkeypatch):
    csv_path, theirs, _ = jax_multi_run
    reset = Model.reset_parameters

    def scaled(self, generator=None):
        reset(self, generator)
        with torch.no_grad():
            self.network["mp_0"].weight.mul_(1.03)

    monkeypatch.setattr(Model, "reset_parameters", scaled)
    ours = run(multi_cfg(csv_path, tmp_path / "scaled"), device="cpu")
    print("multi scaled drift", drift(ours, theirs))
    assert drift(ours, theirs) > MULTI_RUN_RTOL


def test_fingerprint_batch_norm_config_resumes_and_serves(tmp_path):
    """The config with Morgan features from configurable transforms and
    batch norm: 2 epochs, and 1 epoch then resumed to 2, end with the same
    bits (the running statistics too); run_predict serves the checkpoint
    through the running averages, as the trained model predicts in eval."""
    csv_path = multi_csv(tmp_path)

    def cfg(ckpt, epochs, resume=False):
        c = multi_cfg(csv_path, ckpt, resume=resume)
        c["data"]["transforms"].update(FP_TRANSFORMS)
        c["model"].update(norm="batch", extra_features_key="inputs.X_f", extra_features_dim=FP_BITS)
        c["trainer"]["epochs"] = epochs
        return c

    whole = run(cfg(tmp_path / "whole", 2), device="cpu")
    run(cfg(tmp_path / "cut", 1), device="cpu")
    resumed = run(cfg(tmp_path / "cut", 2, resume=True), device="cpu")
    a = torch.load(sorted((tmp_path / "whole").glob("state_*.pt"))[-1], weights_only=True)
    b = torch.load(sorted((tmp_path / "cut").glob("state_*.pt"))[-1], weights_only=True)
    assert "norm.batch_norm.running_var" in a and not torch.equal(a["norm.batch_norm.running_var"],
                                                                  torch.ones(32 + FP_BITS))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert whole["history"][-1]["train/loss"] == resumed["history"][-1]["train/loss"]
    served = run_predict(tmp_path / "whole", csv_path, device="cpu")["y"]
    built = prepare(cfg(None, 2), "cpu")
    built["model"].network.load_state_dict(a)
    direct = predict(built["model"], DataLoader(built["ds"], batch_size=64, layout="flat"), keys=["ffn.preds"])
    np.testing.assert_allclose(served, direct["ffn.preds"][:16, 0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["multicomponent", "reaction_regression", "moe_regression", "pcqm4m_pretrain",
                                  "dmpnn_halo"])
def test_chip_smoke_slice_configs_are_the_shipped_ones(name, tmp_path):
    """chip_smoke.py writes the five configs out (the card's machine may
    lack a YAML parser): each is the file as shipped, and slice_config
    changes only the data file, the epochs and the checkpoint directory."""
    import chip_smoke

    shipped = load_config(os.path.join(ROOT, "configs", f"{name}.yaml"))
    assert chip_smoke.SLICE_CONFIGS[name] == shipped
    cfg = chip_smoke.slice_config(name, tmp_path / "data.csv", tmp_path / "ckpt")
    assert cfg["data"]["csv"] == str(tmp_path / "data.csv") and cfg["trainer"]["epochs"] == chip_smoke.TRAIN_EPOCHS
    assert cfg["trainer"]["checkpoint_dir"] == str(tmp_path / "ckpt")
    for section in ("model", "optimizer"):
        assert cfg[section] == shipped[section]
    assert {k: v for k, v in cfg["data"].items() if k != "csv"} == {k: v for k, v in shipped["data"].items()
                                                                      if k != "csv"}
    if name == "multicomponent":
        path = chip_smoke.multicomponent_csv(tmp_path, 40)
        rows = list(csv.DictReader(open(path)))
        assert len(rows) == 40 and rows[0].keys() == {"smiles1", "smiles2", "y"}
        assert rows[39]["smiles2"] == list(csv.DictReader(open(os.path.join(ROOT, "tests", "data", "multi.csv"))))[
            39]["smiles2"]
