"""The multitask classification config through both packages' CLIs on
the CPU: ``run`` of ``configs/dmpnn_multitask_classification.yaml`` (hidden
32, depth 2, 1 epoch) on a 64-molecule CSV with its 12 structural labels,
the scaffold split, from the port's initial weights in both packages (the
JAX ``Model.init`` patched to take them): the epoch's losses and
``val/y_auroc``/``val/y_auprc``; then each package's predict CLI on its own
checkpoint, the two CSVs alike at rtol = atol = 1e-4. And ``chip_smoke.py``'s
copy of the config and labels against the shipped ones.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from notorch_tpu.cli import predict as jax_predict_cli
from notorch_tpu.cli import train as jax_train_cli
from notorch_tpu.data.splits import scaffold_split as jax_scaffold_split
from notorch_tpu.model.model import Model as JaxModel
from notorch_tpu_torch.cli.predict import run_predict
from notorch_tpu_torch.cli.train import load_config, prepare, run
from notorch_tpu_torch.model.convert import params_to_jax
from tests.test_multitask_classification import _structural_labels
from tests.test_torch_task_models import lipo_smiles

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
CONFIG = os.path.join(ROOT, "configs", "dmpnn_multitask_classification.yaml")


@pytest.fixture(scope="module")
def classification_csv(tmp_path_factory):
    """64 lipo molecules with the 12 structural labels, a fifth missing."""
    smis = lipo_smiles(64)
    y = _structural_labels(smis, np.random.default_rng(0))
    path = tmp_path_factory.mktemp("data") / "tox21_like.csv"
    cols = load_config(CONFIG)["data"]["targets"]["y"]["columns"]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["smiles", *cols])
        for smi, row in zip(smis, y):
            w.writerow([smi, *("" if np.isnan(v) else int(v) for v in row)])
    return path


def classification_cfg(csv_path, ckpt) -> dict:
    cfg = load_config(CONFIG)
    cfg["data"]["csv"] = str(csv_path)
    cfg["model"].update(hidden_dim=32, depth=2)
    cfg["trainer"].update(epochs=1, checkpoint_dir=str(ckpt), compilation_cache="off", prefetch=0)
    return cfg


def test_classification_config_runs_and_serves_as_in_jax(classification_csv, tmp_path, monkeypatch):
    """The shipped config, cut to hidden 32, depth 2 and 1 epoch: the
    scaffold split, the epoch's train and val losses and the host AUROC and
    AUPRC of both packages from the same initial weights; then each
    package's predict CLI on its own checkpoint gives the same CSV."""
    cfg = classification_cfg(classification_csv, tmp_path / "ours")
    init = prepare(cfg, "cpu")
    folds = jax_scaffold_split(lipo_smiles(64), (0.8, 0.1, 0.1), seed=0)
    for part, fold in zip(("train", "val", "test"), folds):
        np.testing.assert_array_equal(init[part].indices, fold)
    initial = params_to_jax(init["model"].network.state_dict())
    ours = run(cfg, device="cpu")

    init_jax = JaxModel.init

    def from_port_weights(self, rng, batch):
        state = init_jax(self, rng, batch)
        params = jax.tree.map(jnp.asarray, initial)
        assert jax.tree.structure(params) == jax.tree.structure(state.params)
        return state.replace(params=params, opt_state=self.optimizer.init(params))

    monkeypatch.setattr(JaxModel, "init", from_port_weights)
    theirs = jax_train_cli.run(classification_cfg(classification_csv, tmp_path / "theirs"))
    (a,), (b,) = ours["history"], theirs["history"]
    for key in ("train/loss", "train/classification", "val/loss", "val/classification", "val/y_auroc",
                "val/y_auprc"):
        np.testing.assert_allclose(a[key], float(b[key]), **TOL, err_msg=key)
    for key in ("val/y_auroc", "val/y_auprc"):
        np.testing.assert_allclose(ours["test"][key], float(theirs["test"][key]), **TOL, err_msg=key)

    served = run_predict(tmp_path / "ours", classification_csv, out=tmp_path / "ours.csv", device="cpu")
    jax_predict_cli.run_predict(tmp_path / "theirs", classification_csv, out=tmp_path / "theirs.csv")
    rows = [list(csv.reader(open(tmp_path / f"{side}.csv"))) for side in ("ours", "theirs")]
    assert rows[0][0] == rows[1][0] == list(served)
    got, ref = (np.array(r[1:], dtype=np.float64) for r in rows)
    assert got.shape == (64, 12) and 0.0 <= got.min() and got.max() <= 1.0
    np.testing.assert_allclose(got, ref, **TOL)


def test_chip_smoke_classification_config_is_the_shipped_one(smis):
    """chip_smoke.py writes the config out (the card's machine may lack a
    YAML parser): its model, optimizer, split, columns, batch and seed are
    configs/dmpnn_multitask_classification.yaml's, and its labels are
    tests/test_multitask_classification.py's."""
    import chip_smoke

    shipped = load_config(CONFIG)
    written = chip_smoke.classification_config("data.csv", None)
    assert written["model"] == shipped["model"] and written["optimizer"] == shipped["optimizer"]
    assert written["data"]["split"] == shipped["data"]["split"]
    assert written["data"]["targets"] == shipped["data"]["targets"]
    assert {k: written["trainer"][k] for k in ("batch_size", "seed")} == {
        k: shipped["trainer"][k] for k in ("batch_size", "seed")}
    ours = chip_smoke.structural_labels(smis, np.random.default_rng(0))
    np.testing.assert_array_equal(ours, _structural_labels(smis, np.random.default_rng(0)))
