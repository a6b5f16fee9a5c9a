"""The port's training loop and checkpoints on the CPU: a killed-and-resumed
run ends bit for bit where an uninterrupted one does (the port of
test_checkpoint.py::test_preemption_resume_trajectory_equality, on the
bin-packed layout the port trains, without dropout); retention, best-K and
early stopping across a resume, each with the JAX package's faults named
where the port departs from them; and ``python -m notorch_tpu_torch train
--cpu`` writing a checkpoint that ``predict --cpu`` serves."""

import csv
import json
import os
import subprocess
import sys

import pytest
import torch

from notorch_tpu_torch.cli.train import build_dataset
from notorch_tpu_torch.data.batching import DataLoader
from notorch_tpu_torch.models.dmpnn import build_dmpnn
from notorch_tpu_torch.training.checkpoint import Checkpointer
from notorch_tpu_torch.training.loop import fit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Preempt(BaseException):
    pass


class _KillerLoader:
    """Raises (a simulated preemption) after yielding ``kill_after`` batches."""

    def __init__(self, loader, kill_after: int):
        self.loader = loader
        self.kill_after = kill_after
        self._yielded = 0

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        for b in self.loader:
            if self._yielded >= self.kill_after:
                raise _Preempt()
            self._yielded += 1
            yield b


@pytest.fixture(scope="module")
def lipo48(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "lipo48.csv"
    with open(os.path.join(ROOT, "tests", "data", "lipo.csv")) as f:
        rows = list(csv.reader(f))[:49]
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return path


@pytest.fixture(scope="module")
def pieces(lipo48):
    ds = build_dataset({"csv": str(lipo48), "targets": {"y": {"columns": ["lipo"]}}})
    transforms = ds.build_task_transform_configs()

    def loader():
        return DataLoader(ds, batch_size=8, shuffle=True, seed=3)

    def model(seed=0):
        return build_dmpnn(hidden_dim=16, depth=2, transforms=transforms,
                           generator=torch.Generator().manual_seed(seed))

    return loader, model


def _assert_same_training_state(a, b):
    assert a.step == b.step
    sa, sb = a.network.state_dict(), b.network.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert sorted(oa) == sorted(ob)
    for i in oa:
        assert all(torch.equal(oa[i][k], ob[i][k]) for k in oa[i])


def test_preemption_resume_trajectory_equality(pieces, tmp_path):
    """Kill a shuffled run mid-epoch 1; resume from the latest mid-epoch
    save in a fresh model; parameters and optimizer state equal an
    uninterrupted run's exactly."""
    make_loader, make_model = pieces
    ref = make_model()
    fit(ref, make_loader(), epochs=3)

    ckpt = Checkpointer(tmp_path / "ckpt", max_to_keep=3)
    with pytest.raises(_Preempt):
        fit(make_model(), _KillerLoader(make_loader(), kill_after=6 + 3), epochs=3,
            checkpointer=ckpt, checkpoint_every=1)
    assert ckpt.latest_step() == 9
    assert ckpt.restore_extra() == {"epoch": 1, "batches_done": 3}

    resumed = make_model(seed=7)  # a fresh process's init, overwritten by the restore
    res = fit(resumed, make_loader(), epochs=3, checkpointer=ckpt, resume=True, checkpoint_every=1)
    assert [r["epoch"] for r in res.history] == [1, 2]
    _assert_same_training_state(resumed, ref)

    # resume on a finished run trains nothing more
    again = make_model(seed=8)
    assert fit(again, make_loader(), epochs=3, checkpointer=ckpt, resume=True).history == []
    _assert_same_training_state(again, ref)


def test_early_stopping_state_survives_resume(pieces, tmp_path):
    """The JAX loop drops the early-stopping state on resume
    (notorch_tpu/training/loop.py:100), so a resumed run there trains more
    epochs than the uninterrupted one. The port keeps it in the loop cursor.
    Monitoring ``epoch`` (which never improves after the first) stops every
    run at the end of epoch 2 with patience 2."""
    make_loader, make_model = pieces
    es = {"monitor": "epoch", "mode": "min", "patience": 2}
    ref = make_model()
    out = fit(ref, make_loader(), epochs=6, early_stopping=es)
    assert out.stopped_early and [r["epoch"] for r in out.history] == [0, 1, 2]

    ckpt = Checkpointer(tmp_path / "ckpt")
    with pytest.raises(_Preempt):
        fit(make_model(), _KillerLoader(make_loader(), kill_after=6 * 2 + 2), epochs=6,
            checkpointer=ckpt, checkpoint_every=1, early_stopping=es)
    assert ckpt.restore_extra()["early_stopping"] == {"best": 0.0, "wait": 1}
    resumed = make_model(seed=7)
    res = fit(resumed, make_loader(), epochs=6, checkpointer=ckpt, resume=True,
              checkpoint_every=1, early_stopping=es)
    assert res.stopped_early and [r["epoch"] for r in res.history] == [2]
    _assert_same_training_state(resumed, ref)


def test_resume_cursor_overrun_raises(pieces, tmp_path):
    make_loader, make_model = pieces
    model = make_model()
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(model.network.state_dict(), step=0, train_state=model.train_state_dict(),
              extra={"epoch": 0, "batches_done": 99})
    with pytest.raises(RuntimeError, match="exceeds"):
        fit(model, make_loader(), epochs=1, checkpointer=ckpt, resume=True)
    with pytest.raises(RuntimeError, match="steps_per_dispatch"):
        fit(model, make_loader(), epochs=1, checkpointer=ckpt, resume=True, steps_per_dispatch=4)


def _sd(value: float) -> dict:
    return {"w": torch.full((2,), value)}


def test_checkpointer_retention_and_same_step_replace(tmp_path):
    ckpt = Checkpointer(tmp_path / "c", max_to_keep=2)
    for step in (1, 2, 3, 4):
        ckpt.save(_sd(step), step, train_state={"step": step}, extra={"epoch": step})
    assert ckpt.all_steps() == [3, 4]
    assert sorted(p.name for p in (tmp_path / "c").iterdir()) == [
        "loop_3.json", "loop_4.json", "state_3.pt", "state_4.pt", "train_3.pt", "train_4.pt"]
    # a save at an existing step replaces it whole: state, cursor and all
    ckpt.save(_sd(40.0), 4, metrics={"val/rmse": 1.0})
    assert torch.equal(ckpt.restore()["w"], _sd(40.0)["w"])
    assert ckpt.restore_extra() is None and ckpt.restore_train() is None
    assert ckpt.metrics(4) == {"val/rmse": 1.0}


def test_checkpointer_best_by_keeps_the_resume_point(tmp_path):
    """With best_by, the JAX Checkpointer (notorch_tpu/training/
    checkpoint.py:106) scores a save without the metric as the worst and
    deletes it at once, losing a mid-epoch preemption save. The port keeps
    the latest step whatever its metrics and drops older saves that lack
    the metric."""
    ckpt = Checkpointer(tmp_path / "c", max_to_keep=2, best_by="val/rmse", best_mode="min")
    for step, rmse in ((1, 0.5), (2, 0.3), (3, 0.4)):
        ckpt.save(_sd(step), step, metrics={"val/rmse": rmse, "epoch": step})
    assert ckpt.all_steps() == [2, 3] and ckpt.best_step() == 2
    ckpt.save(_sd(4), 4, extra={"epoch": 3, "batches_done": 2})  # cursor only
    assert ckpt.all_steps() == [2, 3, 4] and ckpt.latest_step() == 4 and ckpt.best_step() == 2
    ckpt.save(_sd(5), 5, metrics={"val/rmse": 0.6})
    assert ckpt.all_steps() == [2, 3, 5] and ckpt.best_step() == 2
    high = Checkpointer(tmp_path / "h", max_to_keep=1, best_by="val/acc", best_mode="max")
    for step, acc in ((1, 0.5), (2, 0.9), (3, 0.7)):
        high.save(_sd(step), step, metrics={"val/acc": acc})
    assert high.all_steps() == [2, 3] and high.best_step() == 2
    with pytest.raises(ValueError, match="best_mode"):
        Checkpointer(tmp_path / "x", best_mode="median")


def test_best_step_is_none_without_the_metric(tmp_path):
    """The JAX best_step() (notorch_tpu/training/checkpoint.py:79) returns a
    step even when no save records the metric, and the train CLI then
    restores an arbitrary checkpoint; the port returns None."""
    ckpt = Checkpointer(tmp_path / "c", best_by="val/rmse")
    ckpt.save(_sd(1), 1, metrics={"train/loss": 1.0})
    ckpt.save(_sd(2), 2, metrics={"train/loss": 0.5})
    assert ckpt.best_step() is None
    assert Checkpointer(tmp_path / "c").best_step() is None  # best-tracking off


def test_train_cli_writes_a_checkpoint_predict_serves(tmp_path):
    data = tmp_path / "lipo128.csv"
    with open(os.path.join(ROOT, "tests", "data", "lipo.csv")) as f:
        rows = list(csv.reader(f))[:129]
    with open(data, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    ckpt, preds = tmp_path / "ckpt", tmp_path / "test_preds.csv"
    proc = subprocess.run(
        [sys.executable, "-m", "notorch_tpu_torch", "train", "configs/dmpnn_regression.yaml",
         f"data.csv={data}", "model.hidden_dim=32", "trainer.epochs=2", "trainer.batch_size=32",
         f"trainer.checkpoint_dir={ckpt}", "trainer.best_by=val/rmse",
         f"trainer.predictions_csv={preds}", "--cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    assert [r["epoch"] for r in lines[:2]] == [0, 1] and "val/rmse" in lines[0]
    assert "test" in lines[2]
    assert Checkpointer(ckpt).all_steps() == [4, 8]  # 102 training molecules at batch 32
    meta = json.loads((ckpt / "predict_meta.json").read_text())
    assert meta["model"]["hidden_dim"] == 32 and meta["model"]["layout"] == "dense_packed"
    assert len(preds.read_text().strip().split("\n")) == 1 + 14  # the test split: 128 - 102 - 12

    out = tmp_path / "served.csv"
    proc = subprocess.run(
        [sys.executable, "-m", "notorch_tpu_torch", "predict", str(ckpt), str(data), "-o", str(out), "--cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    served = out.read_text().strip().split("\n")
    assert served[0] == "lipo" and len(served) == 129
    assert all(abs(float(v)) < 100 for v in served[1:])
