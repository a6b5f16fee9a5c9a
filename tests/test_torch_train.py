"""The training slice against the JAX package, on shared weights: one train
step (loss and every parameter gradient), three Adam/Noam steps, the
schedule, the split and the shuffled batch order, ``evaluate``, the
gradient clip, and the trained weights served through the JAX ``predict``.

The JAX side runs its Pallas stash kernels in interpret mode on the CPU;
the port runs its plain versions. Tolerances: rtol = atol = 1e-4 for losses,
metrics and predictions (f32, another summation order); rtol = 2e-3 and
atol = 1e-5 for gradients (test_pallas_kernels.py's gradient rtol; the
weight gradients sum over every edge lane of the batch).
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from notorch_tpu.cli.train import build_optimizer as jax_build_optimizer
from notorch_tpu.data.batching import DataLoader as JaxDataLoader
from notorch_tpu.data.batching import Subset as JaxSubset
from notorch_tpu.data.batching import random_split as jax_random_split
from notorch_tpu.data.dataset import MolecularDataset as JaxDataset
from notorch_tpu.data.dataset import TargetSpec as JaxTargetSpec
from notorch_tpu.data.dataset import TransformManager as JaxTM
from notorch_tpu.models.dmpnn import build_dmpnn as jax_build_dmpnn
from notorch_tpu.tasks import losses as jax_losses
from notorch_tpu.training.loop import evaluate as jax_evaluate
from notorch_tpu.training.loop import predict as jax_predict
from notorch_tpu.training.schedulers import noam_like_schedule as jax_noam
from notorch_tpu.transforms import MolToGraph as JaxMolToGraph
from notorch_tpu.transforms import Pipeline as JaxPipeline
from notorch_tpu.transforms import SmiToMol as JaxSmiToMol
from notorch_tpu_torch.cli.train import build_dataset, build_optimizer
from notorch_tpu_torch.data.batching import DataLoader, Subset, random_split
from notorch_tpu_torch.model.convert import params_from_jax, params_to_jax
from notorch_tpu_torch.models.dmpnn import build_dmpnn
from notorch_tpu_torch.tasks import losses
from notorch_tpu_torch.training.loop import evaluate, predict, to_device
from notorch_tpu_torch.training.optim import OptimizerSpec, clip_by_global_norm_
from notorch_tpu_torch.training.schedulers import noam_like_schedule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BATCH, D, DEPTH = 128, 64, 32, 3
NOAM = {"warmup_steps": 100, "cooldown_steps": 1500, "init_lr": 1e-4, "max_lr": 1e-3, "final_lr": 1e-4}
OPT_CFG = {"name": "adam", "schedule": {"noam": NOAM}}
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=2e-3, atol=1e-5)


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


@pytest.fixture(scope="module")
def pair(datasets):
    """The JAX model and its initial params, and a port model carrying the
    same weights, both with Adam and the Noam schedule of the config."""
    ds, jds = datasets
    jmodel = jax_build_dmpnn(hidden_dim=D, depth=DEPTH, transforms=jds.build_task_transform_configs(),
                             optimizer=jax_build_optimizer(OPT_CFG))
    jbatches = list(JaxDataLoader(jds, batch_size=BATCH, layout="dense_packed"))
    state = jmodel.init(jax.random.PRNGKey(0), jbatches[0])
    return {"jmodel": jmodel, "state": state, "jbatches": jbatches,
            "batches": list(DataLoader(ds, batch_size=BATCH))}


def _port_model(pair, datasets):
    model = build_dmpnn(hidden_dim=D, depth=DEPTH, transforms=datasets[0].build_task_transform_configs(),
                        optimizer=build_optimizer(OPT_CFG))
    model.network.load_state_dict(params_from_jax(jax.device_get(pair["state"].params)))
    return model


def test_train_step_matches_jax_loss_and_gradients(pair, datasets):
    jmodel, state, jbatch = pair["jmodel"], pair["state"], pair["jbatches"][0]

    def loss_fn(params):
        out = jmodel.network.apply({"params": params}, dict(jbatch), training=True,
                                   rngs={"dropout": jax.random.PRNGKey(1)})
        terms = jmodel._loss_terms(jmodel._apply_transforms(out, "targets"))
        return sum(jmodel.train_loss_weights[k] * v for k, v in terms.items()), terms

    (loss, terms), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    model = _port_model(pair, datasets)
    logs = model.train_step(to_device(pair["batches"][0], "cpu"))
    np.testing.assert_allclose(float(logs["train/mse"]), float(terms["mse"]), **TOL)
    np.testing.assert_allclose(float(logs["train/loss"]), float(loss), **TOL)
    ref = params_from_jax(jax.device_get(grads))
    got = {name: p.grad for name, p in model.network.named_parameters()}
    assert sorted(got) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(), err_msg=name, **GRAD_TOL)
    assert model.step == 1


def test_three_adam_noam_steps_match_jax_and_serve_through_jax_predict(pair, datasets):
    """Adam moves each weight by about the rate whatever its gradient's
    size, so a gradient at round-off level may flip the sign of an update:
    after ``steps`` updates the parameters agree within 2 * lr * steps."""
    jmodel = pair["jmodel"]
    state = jax.tree.map(jnp.copy, pair["state"])  # the train step donates its state
    model = _port_model(pair, datasets)
    order = [0, 1, 0]
    for i in order:
        state, jlogs = jmodel.train_step(state, pair["jbatches"][i])
        logs = model.train_step(to_device(pair["batches"][i], "cpu"))
        np.testing.assert_allclose(float(logs["train/loss"]), float(jlogs["train/loss"]), rtol=1e-3)
    lr = max(noam_like_schedule(**NOAM)(s) for s in range(len(order)))
    ref = params_from_jax(jax.device_get(state.params))
    for name, p in model.network.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=0,
                                   atol=2 * lr * len(order), err_msg=name)
    assert model.step == int(state.step) == len(order)

    # the port's trained weights, carried back, serve through the JAX predict
    ds, jds = datasets
    jax_preds = jax_predict(jmodel, params_to_jax(model.network.state_dict()),
                            JaxDataLoader(jds, batch_size=BATCH, layout="dense_packed"),
                            keys=["ffn.preds"])["ffn.preds"]
    preds = predict(model, DataLoader(ds, batch_size=BATCH), keys=["ffn.preds"])["ffn.preds"]
    np.testing.assert_allclose(preds, np.asarray(jax_preds), **TOL)


def test_evaluate_matches_jax(pair, datasets):
    """A batch size of 48 leaves a ragged last batch of 32: the means are
    weighted by mask counts in both packages."""
    ds, jds = datasets
    model = _port_model(pair, datasets)
    ref = jax_evaluate(pair["jmodel"], pair["state"].params,
                       JaxDataLoader(jds, batch_size=48, layout="dense_packed"))
    got = evaluate(model, DataLoader(ds, batch_size=48))
    assert sorted(got) == sorted(ref) == ["val/loss", "val/mae", "val/mse", "val/rmse"]
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **TOL)


def test_noam_schedule_matches_jax_and_drives_every_update():
    steps = np.arange(2001)
    ref = np.asarray(jax_noam(**NOAM)(jnp.asarray(steps)))
    schedule = noam_like_schedule(**NOAM)
    np.testing.assert_allclose([schedule(int(s)) for s in steps], ref, rtol=1e-6)
    # optax reads the schedule at the update count before it increments:
    # the first update uses schedule(0)
    w = torch.nn.Parameter(torch.zeros(3))
    opt, sched = OptimizerSpec("adam", schedule).build([w])
    for step in range(5):
        assert opt.param_groups[0]["lr"] == schedule(step)
        w.grad = torch.ones(3)
        opt.step()
        sched.step()


def test_adam_and_adamw_updates_match_optax():
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((4, 5)).astype(np.float32)
    gs = [rng.standard_normal((4, 5)).astype(np.float32) for _ in range(4)]
    for name, tx in (("adam", optax.adam(1e-2)), ("adamw", optax.adamw(1e-2))):
        params, opt_state = jnp.asarray(p0), None
        opt_state = tx.init(params)
        w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt, _ = OptimizerSpec(name, 1e-2).build([w])
        for g in gs:
            updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
            params = optax.apply_updates(params, updates)
            w.grad = torch.from_numpy(g)
            opt.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params), rtol=1e-5, atol=1e-6)
    tx = optax.sgd(1e-2)
    params, opt_state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, _ = build_optimizer({"name": "sgd", "lr": 1e-2}).build([w])
    for g in gs:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        w.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(params), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="decay_steps"):
        build_optimizer({"name": "adam", "schedule": {"cosine": {"init_value": 1e-3, "decay_steps": 0}}})


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_matches_optax_clip_by_global_norm(max_norm):
    """Scaled by max_norm / norm only when norm >= max_norm, with no +1e-6
    in the denominator (torch.nn.utils.clip_grad_norm_ adds one)."""
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 2))]
    ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    clip_by_global_norm_(params, max_norm)
    for p, r in zip(params, ref):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)


def test_split_and_shuffled_batch_order_match_jax(datasets):
    ds, jds = datasets
    for seed in (0, 3):
        for a, b in zip(random_split(4200, (0.8, 0.1, 0.1), seed), jax_random_split(4200, (0.8, 0.1, 0.1), seed)):
            np.testing.assert_array_equal(a, b)
    idx = random_split(len(ds), (0.8, 0.1, 0.1), 0)
    train, jtrain = Subset(ds, idx[0]), JaxSubset(jds, idx[0])
    loader = DataLoader(train, batch_size=16, shuffle=True, seed=3)
    jloader = JaxDataLoader(jtrain, batch_size=16, shuffle=True, seed=3, layout="dense_packed")
    assert len(loader) == len(jloader) == 7
    for epoch in (None, 0, 1, 5):  # None: the stateful order before set_epoch
        if epoch is not None:
            loader.set_epoch(epoch)
            jloader.set_epoch(epoch)
        assert list(loader.sampler) == list(jloader.sampler)
        for b, jb in zip(loader, jloader):
            np.testing.assert_array_equal(b["targets.y"], np.asarray(jb["targets.y"]))
            np.testing.assert_array_equal(b["inputs.G"].src, np.asarray(jb["inputs.G"].src))
    dropped = DataLoader(train, batch_size=16, drop_last=True)
    assert len(dropped) == len(list(dropped)) == len(train) // 16
    np.testing.assert_array_equal(
        train.build_task_transform_configs()["y"]["targets"]["module"].loc,
        jtrain.build_task_transform_configs()["y"]["targets"]["module"].loc,
    )


def test_masked_reduce_matches_jax_weighted_mean():
    """The weighted mean the JAX package pins, not the reference's
    count-normalized form."""
    rng = np.random.default_rng(2)
    loss = rng.random((6, 2)).astype(np.float32)
    mask = rng.random((6, 2)) > 0.3
    sw = rng.random(6).astype(np.float32)
    for m, w in ((None, None), (mask, None), (None, sw), (mask, sw)):
        ref = jax_losses.masked_reduce(jnp.asarray(loss), None if m is None else jnp.asarray(m),
                                       None if w is None else jnp.asarray(w))
        got = losses.masked_reduce(torch.from_numpy(loss), None if m is None else torch.from_numpy(m),
                                   None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
