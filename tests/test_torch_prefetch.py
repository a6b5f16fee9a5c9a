"""The port's input pipeline and grouped training on the CPU, against the
JAX package: ``PrefetchLoader`` yields the loader's batches in order, its
groups are JAX's ``PrefetchLoader(to_device=False, stack=4)``'s on the
same data and seed, a producer's error is raised in the consumer and an
early ``close()`` ends its thread; ``fit(steps_per_dispatch=4)``, with and
without the prefetcher, ends with the same bits in every parameter and
Adam state as ``steps_per_dispatch=1``, and its epoch records and
``log_every`` records match JAX's ``fit(steps_per_dispatch=4)`` at
test_torch_fit.py's tolerances (rtol = atol = 1e-4, the JAX side in
interpret mode); a resume cursor inside a group and a group handed to
``evaluate`` raise as in JAX. The card's staging (one pinned transfer a
group, each step's arrays 256-byte aligned) is checked on the card by
test_torch_gpu.py's ``test_cuda_prefetch_groups_are_aligned_views``."""

import csv
import os
import threading

import jax
import numpy as np
import pytest
import torch

from notorch_tpu.cli.train import build_optimizer as jax_build_optimizer
from notorch_tpu.data.batching import DataLoader as JaxDataLoader
from notorch_tpu.data.batching import PrefetchLoader as JaxPrefetchLoader
from notorch_tpu.data.batching import StackedBatch as JaxStackedBatch
from notorch_tpu.data.dataset import MolecularDataset as JaxDataset
from notorch_tpu.data.dataset import TargetSpec as JaxTargetSpec
from notorch_tpu.data.dataset import TransformManager as JaxTM
from notorch_tpu.models.dmpnn import build_dmpnn as jax_build_dmpnn
from notorch_tpu.training.loop import fit as jax_fit
from notorch_tpu.transforms import MolToGraph as JaxMolToGraph
from notorch_tpu.transforms import Pipeline as JaxPipeline
from notorch_tpu.transforms import SmiToMol as JaxSmiToMol
from notorch_tpu_torch.cli.train import build_dataset, build_optimizer
from notorch_tpu_torch.data.batching import (
    DataLoader,
    PrefetchLoader,
    StackedBatch,
    shape_signature,
    stack_trees,
    unstack_tree,
)
from notorch_tpu_torch.model.convert import params_from_jax
from notorch_tpu_torch.models.dmpnn import build_dmpnn
from notorch_tpu_torch.training.checkpoint import Checkpointer
from notorch_tpu_torch.training.loop import evaluate, fit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BATCH, D, DEPTH, K = 96, 8, 16, 2, 4
OPT_CFG = {"name": "adam", "lr": 1e-3}
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "lipo_head.csv"
    with open(os.path.join(ROOT, "tests", "data", "lipo.csv")) as f:
        rows = list(csv.reader(f))[: N + 1]
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    ds = build_dataset({"csv": str(path), "targets": {"y": {"columns": ["lipo"]}}})
    table = {"smiles": [r["smiles"] for r in ds.records], "lipo": [float(r["lipo"]) for r in ds.records]}
    jds = JaxDataset(table, {"graph": JaxTM(JaxPipeline(JaxSmiToMol(), JaxMolToGraph()), "smiles", "G")},
                     targets={"y": JaxTargetSpec(["lipo"])})
    return ds, jds


def _loader(ds, **kw):
    return DataLoader(ds, batch_size=BATCH, shuffle=True, seed=3, **kw)


def _model(ds, params=None):
    model = build_dmpnn(hidden_dim=D, depth=DEPTH, transforms=ds.build_task_transform_configs(),
                        optimizer=build_optimizer(OPT_CFG), generator=torch.Generator().manual_seed(0))
    if params is not None:
        model.network.load_state_dict(params_from_jax(params))
    return model


def _arrays(batch):
    out = {}
    for k, v in batch.items():
        if hasattr(v, "_ARRAYS"):
            out.update({f"{k}.{f}": getattr(v, f) for f in v._ARRAYS if getattr(v, f) is not None})
        else:
            out[k] = v
    return {k: np.asarray(v) for k, v in out.items()}


def _same_state(a, b):
    assert a.step == b.step
    sa, sb = a.network.state_dict(), b.network.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert sorted(oa) == sorted(ob)
    assert all(torch.equal(oa[i][k], ob[i][k]) for i in oa for k in oa[i])


@pytest.mark.parametrize("to_device", [False, True])
def test_prefetch_yields_the_loaders_batches_in_order(datasets, to_device):
    ds = datasets[0]
    plain = list(_loader(ds))
    got = list(PrefetchLoader(_loader(ds), buffer_size=2, to_device=to_device, device="cpu"))
    assert len(got) == len(plain) == len(PrefetchLoader(_loader(ds)))
    for a, b in zip(got, plain):
        assert shape_signature(a) == shape_signature(b) or to_device
        x, y = _arrays(a), _arrays(b)
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    # attributes are the loader's
    wrapped = PrefetchLoader(_loader(ds), device="cpu")
    assert wrapped.batch_size == BATCH and wrapped.dataset is ds and callable(wrapped.set_epoch)


def test_groups_equal_jax_prefetch_groups(datasets):
    ds, jds = datasets
    ours = [b.n if isinstance(b, StackedBatch) else 1
            for b in PrefetchLoader(_loader(ds), to_device=False, stack=K)]
    theirs = [b.n if isinstance(b, JaxStackedBatch) else 1
              for b in JaxPrefetchLoader(JaxDataLoader(jds, batch_size=BATCH, shuffle=True, seed=3,
                                                       layout="dense_packed"), to_device=False, stack=K)]
    assert ours == theirs and K in ours and sum(ours) == N // BATCH
    # a group's steps are the loader's batches, in order
    plain = list(_loader(ds))
    at = 0
    for item in PrefetchLoader(_loader(ds), to_device=False, stack=K):
        steps = [unstack_tree(item.tree, i) for i in range(item.n)] if isinstance(item, StackedBatch) else [item]
        for step in steps:
            x, y = _arrays(step), _arrays(plain[at])
            assert all(np.array_equal(x[k], y[k]) for k in y)
            at += 1
    assert at == len(plain)


class _Failing:
    def __init__(self, loader, after):
        self.loader, self.after = loader, after

    def __iter__(self):
        for i, b in enumerate(self.loader):
            if i == self.after:
                raise KeyError("bad row")
            yield b


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "prefetch"]


def test_producer_error_is_raised_and_close_ends_the_thread(datasets):
    ds = datasets[0]
    seen = []
    with pytest.raises(KeyError, match="bad row"):
        for b in PrefetchLoader(_Failing(_loader(ds), 3), device="cpu"):
            seen.append(b)
    assert len(seen) == 3
    before = len(_prefetch_threads())
    it = iter(PrefetchLoader(_loader(ds), buffer_size=1, device="cpu"))
    next(it)
    assert len(_prefetch_threads()) == before + 1  # the producer waits on a full queue
    it.close()
    assert len(_prefetch_threads()) == before
    for _ in PrefetchLoader(_loader(ds), buffer_size=1, device="cpu"):
        break
    assert len(_prefetch_threads()) == before


def test_stack_and_unstack_round_trip(datasets):
    batches = list(_loader(datasets[0]))[:3]
    same = [b for b in batches if shape_signature(b) == shape_signature(batches[0])]
    tree = stack_trees(same)
    for i, b in enumerate(same):
        x, y = _arrays(unstack_tree(tree, i)), _arrays(b)
        assert all(np.array_equal(x[k], y[k]) for k in y)


@pytest.fixture(scope="module")
def jax_run(datasets):
    """JAX's fit(steps_per_dispatch=4) for 2 epochs with log_every=3, from
    its seeded init."""
    jds = datasets[1]
    jmodel = jax_build_dmpnn(hidden_dim=D, depth=DEPTH, transforms=jds.build_task_transform_configs(),
                             optimizer=jax_build_optimizer(OPT_CFG))
    loader = JaxDataLoader(jds, batch_size=BATCH, shuffle=True, seed=3, layout="dense_packed")
    state = jmodel.init(jax.random.PRNGKey(0), next(iter(loader)))
    params = jax.device_get(state.params)  # fit donates the state's buffers
    logs = []
    out = jax_fit(jmodel, state, loader, epochs=2, steps_per_dispatch=K, log_every=3, log_fn=logs.append)
    return params, out.history, logs


@pytest.mark.parametrize("prefetch", [False, True])
def test_fit_in_groups_gives_the_same_bits_and_jax_records(datasets, jax_run, prefetch):
    ds = datasets[0]
    params, jax_history, jax_logs = jax_run
    single = _model(ds, params)
    fit(single, _loader(ds), epochs=2)
    grouped = _model(ds, params)
    logs = []
    if prefetch:
        loader, spd = PrefetchLoader(_loader(ds), device="cpu", stack=K), 1
    else:
        loader, spd = _loader(ds), K
    history = fit(grouped, loader, epochs=2, steps_per_dispatch=spd, log_every=3, log_fn=logs.append).history
    _same_state(grouped, single)
    assert len(history) == len(jax_history) == 2
    for ours, theirs in zip(history, jax_history):
        assert sorted(k for k in ours if k != "time") == sorted(k for k in theirs if k != "time")
        for k in theirs:
            if k != "time":
                np.testing.assert_allclose(ours[k], theirs[k], err_msg=k, **TOL)
    epoch_records = [r for r in logs if "step" not in r]
    step_records = [r for r in logs if "step" in r]
    assert len(epoch_records) == 2
    theirs = [r for r in jax_logs if "step" in r]
    assert [(r["epoch"], r["step"]) for r in step_records] == [(r["epoch"], r["step"]) for r in theirs]
    for ours_r, theirs_r in zip(step_records, theirs):
        assert sorted(ours_r) == sorted(theirs_r)
        for k in theirs_r:
            np.testing.assert_allclose(ours_r[k], theirs_r[k], err_msg=k, **TOL)


def test_cursor_inside_a_group_and_a_group_in_evaluate_raise(datasets, tmp_path):
    ds = datasets[0]
    model = _model(ds)
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(model.network.state_dict(), step=0, train_state=model.train_state_dict(),
              extra={"epoch": 0, "batches_done": 2})
    with pytest.raises(RuntimeError, match="does not align"):
        fit(model, PrefetchLoader(_loader(ds), device="cpu", stack=K), epochs=1, checkpointer=ckpt, resume=True)
    with pytest.raises(TypeError, match="single batches"):
        evaluate(model, PrefetchLoader(_loader(ds), device="cpu", stack=K))
