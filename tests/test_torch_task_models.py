"""The task types through the port's models and CLI, against the JAX
package on the CPU:

- ``build_dmpnn`` on ``dense_packed`` for all six task types with the JAX
  model's weights (``params_from_jax``): predictions through the task's
  preds transform, the loss, and every gradient;
- ``build_gat`` and ``build_spatial_model`` with ``task="classification"``
  and ``"multiclass"``: one forward (predictions and loss).

``tests/test_torch_task_run.py`` runs the classification config through
both packages' CLIs.

The JAX side runs its Pallas kernels in interpret mode; the port its plain
versions. Tolerance rtol = atol = 1e-4 (f32, another summation order);
gradients at atol 1e-4 times the tensor's largest magnitude.
"""

import csv
import os

import jax
import numpy as np
import pytest
import torch

from notorch_tpu.data.batching import DataLoader as JaxDataLoader
from notorch_tpu.data.dataset import MolecularDataset as JaxDataset
from notorch_tpu.data.dataset import TargetSpec as JaxTargetSpec
from notorch_tpu.data.dataset import TransformManager as JaxTM
from notorch_tpu.models.dmpnn import build_dmpnn as jax_build_dmpnn
from notorch_tpu.models.gat import build_gat as jax_build_gat
from notorch_tpu.models.spatial import build_spatial_model as jax_build_spatial_model
from notorch_tpu.training.loop import predict as jax_predict
from notorch_tpu.transforms import MolToGraph as JaxMolToGraph
from notorch_tpu.transforms import Pipeline as JaxPipeline
from notorch_tpu.transforms import SmiToMol as JaxSmiToMol
from notorch_tpu_torch.data.batching import DataLoader
from notorch_tpu_torch.data.dataset import MolecularDataset, TargetSpec, TransformManager
from notorch_tpu_torch.model.convert import params_from_jax
from notorch_tpu_torch.data.point_cloud import cloud_batches, coordination_targets, make_clouds
from notorch_tpu_torch.models.dmpnn import build_dmpnn
from notorch_tpu_torch.models.gat import build_gat
from notorch_tpu_torch.models.spatial import build_spatial_model
from notorch_tpu_torch.training.loop import predict, to_device
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol
from tests.test_torch_spatial import jax_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
N, BATCH, D, T, CLASSES = 48, 16, 32, 2, 3
TASKS = ["regression", "classification", "multiclass", "mve", "evidential", "dirichlet"]


def lipo_smiles(n: int) -> list[str]:
    with open(os.path.join(ROOT, "tests", "data", "lipo.csv")) as f:
        return [row["smiles"] for row in csv.DictReader(f)][:n]


def task_targets(task: str, n: int, rng) -> np.ndarray:
    """[n, T] targets of ``task``, a fifth of them missing (NaN)."""
    if task == "classification":
        y = (rng.random((n, T)) > 0.5).astype(np.float32)
    elif task in ("multiclass", "dirichlet"):
        y = rng.integers(0, CLASSES, (n, T)).astype(np.float32)
    else:
        y = (2.0 + 1.5 * rng.standard_normal((n, T))).astype(np.float32)
    y[rng.random((n, T)) < 0.2] = np.nan
    return y


def datasets(task: str):
    smis = lipo_smiles(N)
    y = task_targets(task, N, np.random.default_rng(TASKS.index(task)))
    table = {"smiles": smis, **{f"t{i}": [float(v) for v in y[:, i]] for i in range(T)}}
    cols = [f"t{i}" for i in range(T)]
    ds = MolecularDataset(table, {"graph": TransformManager(Pipeline(SmiToMol(), MolToGraph()), "smiles", "G")},
                          targets={"y": TargetSpec(cols, task=task)})
    jds = JaxDataset(table, {"graph": JaxTM(JaxPipeline(JaxSmiToMol(), JaxMolToGraph()), "smiles", "G")},
                     targets={"y": JaxTargetSpec(cols, task=task)})
    return ds, jds


def jax_loss_and_grads(jmodel, params, jbatch):
    def loss_fn(p):
        out = jmodel.network.apply({"params": p}, dict(jbatch), training=True)
        terms = jmodel._loss_terms(jmodel._apply_transforms(out, "targets"))
        return sum(jmodel.train_loss_weights[k] * v for k, v in terms.items())

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), params_from_jax(jax.device_get(grads))


def check_step(model, jmodel, params, batch, jbatch):
    """One train step of the port from ``params``: its loss and every
    gradient against JAX's."""
    loss, ref = jax_loss_and_grads(jmodel, params, jbatch)
    logs = model.train_step(to_device(batch, "cpu"))
    np.testing.assert_allclose(float(logs["train/loss"]), loss, **TOL)
    for name, p in model.network.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), ref[name].numpy(), rtol=1e-4,
                                   atol=1e-4 * float(ref[name].abs().max()), err_msg=name)


@pytest.mark.parametrize("task", TASKS)
def test_build_dmpnn_matches_jax_for_every_task_type(task):
    """dense_packed, the fused block: the head's shape, the loss's name,
    the predictions in data units (or probabilities), the loss and every
    gradient."""
    ds, jds = datasets(task)
    kw = dict(num_tasks=T, task=task, num_classes=CLASSES, hidden_dim=D, depth=2, layout="dense_packed")
    jmodel = jax_build_dmpnn(transforms=jds.build_task_transform_configs(), **kw)
    model = build_dmpnn(transforms=ds.build_task_transform_configs(), **kw)
    jbatches = list(JaxDataLoader(jds, batch_size=BATCH, layout="dense_packed"))
    batches = list(DataLoader(ds, batch_size=BATCH, layout="dense_packed"))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jbatches[0]).params)
    model.network.load_state_dict(params_from_jax(params))
    assert list(model.losses) == list(jmodel.losses) == [task if task != "regression" else "mse"]
    assert list(model.metrics) == list(jmodel.metrics)
    assert type(model.network["mp"]).__name__ == "FusedDenseChempropBlock"

    preds = predict(model, batches, keys=["ffn.preds"])["ffn.preds"]
    ref = np.asarray(jax_predict(jmodel, params, jbatches, keys=["ffn.preds"])["ffn.preds"])
    assert preds.shape == ref.shape and preds.shape[1] == T
    np.testing.assert_allclose(preds, ref, **TOL)
    if task in ("classification", "multiclass", "dirichlet"):
        assert preds.min() >= 0.0 and preds.max() <= 1.0
    check_step(model, jmodel, params, batches[0], jbatches[0])


@pytest.mark.parametrize("task", ["classification", "multiclass"])
def test_gat_and_spatial_recipes_take_the_task(task):
    """One forward of build_gat and build_spatial_model on JAX's weights:
    the predictions and the loss."""
    ds, jds = datasets(task)
    kw = dict(num_tasks=T, task=task, num_classes=CLASSES, hidden_dim=16, depth=2, num_heads=2)
    jmodel = jax_build_gat(transforms=jds.build_task_transform_configs(), **kw)
    model = build_gat(transforms=ds.build_task_transform_configs(), **kw)
    loader = dict(layout="dense_packed", bin_edges=256, bin_nodes=128)
    jbatches = list(JaxDataLoader(jds, batch_size=BATCH, **loader))
    batches = list(DataLoader(ds, batch_size=BATCH, **loader))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jbatches[0]).params)
    model.network.load_state_dict(params_from_jax(params))
    np.testing.assert_allclose(predict(model, batches, keys=["ffn.preds"])["ffn.preds"],
                               np.asarray(jax_predict(jmodel, params, jbatches, keys=["ffn.preds"])["ffn.preds"]),
                               **TOL)
    logs, _ = model.eval_step(to_device(batches[0], "cpu"))
    jlogs, _ = jmodel.eval_step(params, jbatches[0])
    np.testing.assert_allclose(float(logs[f"val/{task}"]), float(jlogs[f"val/{task}"]), **TOL)

    clouds = make_clouds(32, seed=0)
    y = coordination_targets(clouds)
    y = (y > np.median(y)).astype(np.float32)  # two classes, for both task types
    cloud = cloud_batches(clouds, y, batch_size=BATCH)
    skw = dict(backbone="gvp", task=task, hidden_dim=16, depth=1, neighbor_window=24)
    jspatial = jax_build_spatial_model(**skw)
    spatial = build_spatial_model(**skw)
    jcloud = [jax_batch(b) for b in cloud]
    params = jax.device_get(jspatial.init(jax.random.PRNGKey(0), jcloud[0]).params)
    spatial.network.load_state_dict(params_from_jax(params))
    out = spatial.network(to_device(cloud[0], "cpu"))["ffn.preds"]
    ref = jspatial.network.apply({"params": params}, dict(jcloud[0]))["ffn.preds"]
    assert out.shape == ((BATCH, 1) if task == "classification" else (BATCH, 1, 2))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    logs, _ = spatial.eval_step(to_device(cloud[0], "cpu"))
    jlogs, _ = jspatial.eval_step(params, jcloud[0])
    np.testing.assert_allclose(float(logs["val/loss"]), float(jlogs["val/loss"]), **TOL)
