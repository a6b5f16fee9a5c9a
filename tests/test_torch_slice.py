"""The serving slice end to end: the JAX D-MPNN regression model and the
port, on shared weights, give the same predictions in data units — through
``predict`` and through ``python -m notorch_tpu_torch predict --cpu``.
Tolerance rtol=atol=1e-4: f32 with a different summation order (the JAX
side runs its Pallas kernel in interpret mode on the CPU)."""

import csv
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from notorch_tpu.cli.train import _save_predict_meta as jax_save_predict_meta
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
from notorch_tpu_torch.cli.predict import run_predict
from notorch_tpu_torch.cli.train import build_dataset, build_model, load_config, save_predict_meta
from notorch_tpu_torch.data.batching import DataLoader
from notorch_tpu_torch.model.convert import params_from_jax, params_to_jax
from notorch_tpu_torch.models.dmpnn import build_dmpnn
from notorch_tpu_torch.tasks import transforms as task_transforms
from notorch_tpu_torch.training.checkpoint import Checkpointer
from notorch_tpu_torch.training.loop import predict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BATCH, D, DEPTH = 128, 64, 32, 3
MODEL_CFG = {"kind": "dmpnn", "hidden_dim": D, "depth": DEPTH, "aggregation": "mean",
             "ffn_layers": 1, "layout": "dense_packed"}
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def lipo_csv(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "lipo_head.csv"
    with open(os.path.join(ROOT, "tests", "data", "lipo.csv")) as f:
        rows = list(csv.reader(f))[: N + 1]
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return path


@pytest.fixture(scope="module")
def jax_side(lipo_csv):
    """JAX model initialised on a lipo batch, and its predictions."""
    port_table = build_dataset({"csv": str(lipo_csv)}).records
    table = {"smiles": [r["smiles"] for r in port_table], "lipo": [float(r["lipo"]) for r in port_table]}
    ds = JaxDataset(table, {"graph": JaxTM(JaxPipeline(JaxSmiToMol(), JaxMolToGraph()), "smiles", "G")},
                    targets={"y": JaxTargetSpec(["lipo"])})
    transforms = ds.build_task_transform_configs()
    model = jax_build_dmpnn(hidden_dim=D, depth=DEPTH, transforms=transforms)
    loader = JaxDataLoader(ds, batch_size=BATCH, layout="dense_packed")
    state = model.init(jax.random.PRNGKey(0), next(iter(loader)))
    preds = jax_predict(model, state.params, loader, keys=["ffn.preds"])["ffn.preds"]
    return {"ds": ds, "transforms": transforms, "params": jax.device_get(state.params),
            "preds": np.asarray(preds)}


def _port_dataset(lipo_csv):
    return build_dataset({"csv": str(lipo_csv), "targets": {"y": {"columns": ["lipo"]}}})


def test_predictions_match_jax(jax_side, lipo_csv):
    ds = _port_dataset(lipo_csv)
    model = build_dmpnn(hidden_dim=D, depth=DEPTH, transforms=ds.build_task_transform_configs())
    model.network.load_state_dict(params_from_jax(jax_side["params"]))
    preds = predict(model, DataLoader(ds, batch_size=BATCH), keys=["ffn.preds"])["ffn.preds"]
    assert preds.shape == jax_side["preds"].shape == (N, 1)
    np.testing.assert_allclose(preds, jax_side["preds"], **TOL)


def test_params_round_trip(jax_side):
    tree = jax_side["params"]
    back = params_to_jax(params_from_jax(tree))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(leaf), flat_back[path])
    model = build_dmpnn(hidden_dim=D, depth=DEPTH)
    model.network.load_state_dict(params_from_jax(tree))  # strict: every key, every shape


def test_predict_cli_on_port_checkpoint(jax_side, lipo_csv, tmp_path):
    ds = _port_dataset(lipo_csv)
    transforms = ds.build_task_transform_configs()
    model = build_dmpnn(hidden_dim=D, depth=DEPTH, transforms=transforms)
    model.network.load_state_dict(params_from_jax(jax_side["params"]))
    ckpt = tmp_path / "ckpt"
    Checkpointer(ckpt).save(model.network.state_dict(), step=7)
    cfg = {"model": MODEL_CFG, "data": {"smiles_col": "smiles"}}
    save_predict_meta(ckpt, cfg, transforms, ds, "ffn.preds")

    # the meta is byte for byte what the JAX trainer writes for the same run
    jax_dir = tmp_path / "jax_meta"
    jax_save_predict_meta(jax_dir, cfg, jax_side["transforms"], jax_side["ds"], "ffn.preds")
    assert (ckpt / "predict_meta.json").read_text() == (jax_dir / "predict_meta.json").read_text()

    out_csv = tmp_path / "preds.csv"
    proc = subprocess.run(
        [sys.executable, "-m", "notorch_tpu_torch", "predict", str(ckpt), str(lipo_csv),
         "-o", str(out_csv), "--cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"predictions_csv": str(out_csv)}
    lines = out_csv.read_text().strip().split("\n")
    assert lines[0] == "lipo" and len(lines) == N + 1
    got = np.array([float(x) for x in lines[1:]])
    np.testing.assert_allclose(got, jax_side["preds"][:, 0], **TOL)

    res = run_predict(ckpt, lipo_csv, batch_size=BATCH, device="cpu")
    np.testing.assert_allclose(res["lipo"], jax_side["preds"][:, 0], **TOL)


def test_checkpointer_round_trip(tmp_path):
    ckpt = Checkpointer(tmp_path / "c")
    with pytest.raises(FileNotFoundError, match="orbax"):
        ckpt.restore()
    sd = build_dmpnn(hidden_dim=8, depth=1, generator=torch.Generator().manual_seed(0)).network.state_dict()
    ckpt.save(sd, 3)
    ckpt.save({k: v + 1 for k, v in sd.items()}, 10)
    assert ckpt.all_steps() == [3, 10] and ckpt.latest_step() == 10
    back = ckpt.restore(step=3)
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    assert torch.equal(ckpt.restore()["mp.weight"], sd["mp.weight"] + 1)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(step=4)


def test_task_transform_records_match_jax():
    values = np.array([[1.0], [2.5], [np.nan], [4.0]], np.float32)
    ours, ref = task_transforms.build("regression", values), jax_task_transforms.build("regression", values)
    for side in ("preds", "targets"):
        rec = task_transforms.serialize(ours[side])
        assert rec == jax_task_transforms.serialize(ref[side])
        x = np.array([[0.3], [-1.2]], np.float32)
        np.testing.assert_allclose(
            task_transforms.deserialize(rec)(torch.from_numpy(x)).numpy(),
            np.asarray(ref[side](x)), rtol=1e-6,
        )
    mve = jax_task_transforms.serialize(jax_task_transforms.MVE((0.0,), (1.0,)))
    assert task_transforms.deserialize(mve) == task_transforms.MVE((0.0,), (1.0,))
    with pytest.raises(ValueError, match="unknown task transform"):
        task_transforms.deserialize({"kind": "Tanh"})
    with pytest.raises(ValueError, match="invalid task type"):
        task_transforms.build("ranking", values)


def test_config_builds_the_served_model():
    """configs/dmpnn_regression.yaml read by the port gives the model the
    chip smoke run serves: hidden 256, depth 3, one FFN layer."""
    cfg = load_config(os.path.join(ROOT, "configs", "dmpnn_regression.yaml"))
    model = build_model(cfg["model"], None, generator=torch.Generator().manual_seed(0))
    sd = model.network.state_dict()
    assert sd["mp.weight"].shape == (3, 256, 256)
    assert sd["ffn.dense_0.weight"].shape == (256, 256) and sd["ffn.dense_1.weight"].shape == (1, 256)
    assert type(model.network["readout"]).__name__ == "PackedMean"


def test_unported_model_options_raise():
    """Edge dropout, refused until the plain dense slice, now builds: auto
    resolves to the plain ``dense`` layout, and the flat block takes it as
    well; unknown options still raise."""
    model = build_dmpnn(hidden_dim=8, dropout=0.1)
    assert type(model.network["mp"]).__name__ == "DenseChempropBlock"
    assert type(model.network["readout"]).__name__ == "DenseMean"
    assert model.network["mp"].dropout.rate == 0.1 and model.network["ffn"].dropout.rate == 0.1
    model = build_dmpnn(hidden_dim=8, layout="flat", dropout=0.1)  # edge dropout in the flat block
    assert type(model.network["mp"]).__name__ == "ChempropBlock" and model.network["mp"].dropout.rate == 0.1
    with pytest.raises(ValueError, match="unknown task"):
        build_dmpnn(hidden_dim=8, task="ranking")
    with pytest.raises(ValueError, match="aggregation"):
        build_dmpnn(hidden_dim=8, aggregation="median")
