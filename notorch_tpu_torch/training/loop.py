"""The training loop: fit / evaluate / predict.

Port of ``notorch_tpu.training.loop``. ``fit`` runs the model's train step
over the loader, with the JAX loop's epoch records, ``checkpoint_every``
saves with the loop cursor, preemption-safe ``resume``, epoch-end saves
and early stopping. ``evaluate`` takes count-weighted batch means exactly
as the JAX version does, so ``val/rmse`` means the same number in both
packages. Log values stay device scalars until a ``log_every`` boundary or
the epoch's end.

``host_metrics`` (AUROC, AUPRC, F1) are computed on the host over the
whole evaluation pass and logged as ``val/<name>``, as there.
``steps_per_dispatch=K`` groups K same-shape batches and runs each group
through ``Model.train_steps`` (the JAX loop's ``lax.scan`` over stacked
batches): one transfer a group, the same math as step by step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Mapping

import numpy as np
import torch

from notorch_tpu_torch.data.batching import StackedBatch, group_batches, stacked_on, stage, to_device
from notorch_tpu_torch.model.model import Model


@dataclass
class FitResult:
    history: list[dict] = field(default_factory=list)
    stopped_early: bool = False


class _EarlyStopping:
    """Stops when ``monitor`` has not improved by more than ``min_delta``
    for ``patience`` epochs. Its state rides in the loop cursor, so a
    resumed run stops where the uninterrupted one does (the JAX loop drops
    it on resume)."""

    def __init__(self, cfg: Mapping):
        self.monitor = cfg["monitor"]
        self.patience = int(cfg.get("patience", 5))
        self.mode = cfg.get("mode", "min")
        self.delta = float(cfg.get("min_delta", 0.0))
        if self.mode not in ("min", "max"):
            raise ValueError(f"early_stopping mode must be min|max, got {self.mode!r}")
        self.best: float | None = None
        self.wait = 0

    def state(self) -> dict:
        return {"best": self.best, "wait": self.wait}

    def load(self, state: Mapping) -> None:
        self.best, self.wait = state["best"], int(state["wait"])

    def stop(self, record: Mapping) -> bool:
        if self.monitor not in record:
            raise KeyError(
                f"early_stopping monitor {self.monitor!r} not in the epoch record; "
                f"available: {sorted(record)} (a val/ metric requires val_loader)"
            )
        value = float(record[self.monitor])
        improved = self.best is None or (
            value < self.best - self.delta if self.mode == "min" else value > self.best + self.delta
        )
        if improved:
            self.best, self.wait = value, 0
        else:
            self.wait += 1
        return self.wait >= self.patience


def fit(
    model: Model,
    train_loader,
    val_loader=None,
    epochs: int = 1,
    log_every: int = 0,
    log_fn: Callable[[dict], None] | None = None,
    host_metrics: Mapping[str, Mapping] | None = None,
    checkpointer=None,
    resume: bool = False,
    checkpoint_every: int = 0,
    steps_per_dispatch: int = 1,
    early_stopping: Mapping | None = None,
) -> FitResult:
    """Run the train step over ``train_loader`` for ``epochs`` epochs.

    ``host_metrics``: ``{name: {"fn", "in_keys"}}``, computed on the host
    over each epoch's evaluation pass (see :func:`evaluate`).
    Each epoch calls ``train_loader.set_epoch(epoch)`` where it exists, so
    that the epoch's order is a pure function of (seed, epoch).
    ``checkpoint_every=K`` also saves every K batches with the loop cursor
    (epoch, batches trained); ``resume=True`` restores the latest save
    (parameters, optimizer, schedule, update count, cursor and
    early-stopping state), re-derives the interrupted epoch's order and
    skips the batches already trained, so a killed-and-resumed run ends
    with the same parameters and optimizer state, bit for bit, as an
    uninterrupted one on the same device. ``early_stopping={"monitor":
    "val/rmse", "patience": 5, "mode": "min", "min_delta": 0.0}`` stops when
    the monitored epoch value has not improved for ``patience`` epochs.

    ``steps_per_dispatch=K`` (> 1) groups K consecutive same-shape batches
    and runs each group as :meth:`Model.train_steps` (K train steps in
    sequence) on one stacked transfer, a group cut short by a change of
    shape or by the epoch's end at its own length. A group's logs are
    averaged over its steps and weighted by them in the epoch mean.
    :class:`~notorch_tpu_torch.data.batching.StackedBatch` items (from
    ``PrefetchLoader(stack=K)``) are run as they come. A resume cursor that falls inside such a group raises
    ``RuntimeError``. ``log_every=N`` calls ``log_fn`` with ``{"epoch",
    "step", **logs}`` (the last step's or group's logs) whenever the count
    of trained batches crosses a multiple of N.
    """
    device = model.device
    history = []
    stopper = _EarlyStopping(early_stopping) if early_stopping is not None else None
    start_epoch = skip_batches = 0
    if resume and checkpointer is not None and checkpointer.latest_step() is not None:
        model.network.load_state_dict(checkpointer.restore())
        train_state = checkpointer.restore_train()
        if train_state is not None:
            model.load_train_state_dict(train_state)
        extra = checkpointer.restore_extra()
        if extra:
            start_epoch = int(extra.get("epoch", 0))
            skip_batches = int(extra.get("batches_done", 0))
            if stopper is not None and extra.get("early_stopping") is not None:
                stopper.load(extra["early_stopping"])

    def save(metrics=None, **cursor):
        if stopper is not None:
            cursor["early_stopping"] = stopper.state()
        checkpointer.save(model.network.state_dict(), step=model.step,
                          train_state=model.train_state_dict(), metrics=metrics, extra=cursor)

    for epoch in range(start_epoch, epochs):
        set_epoch = getattr(train_loader, "set_epoch", None)
        if callable(set_epoch):
            set_epoch(epoch)
        t0 = time.perf_counter()
        train_logs: dict[str, torch.Tensor] = {}
        n_batches = since_save = 0
        # batches of this epoch already trained by the preempted run: skipped
        # below, but counted in the epoch cursor
        done_offset = skip_batches if epoch == start_epoch else 0
        to_skip = done_offset

        def run_group(group: list) -> dict:
            if len(group) == 1:
                return model.train_step(to_device(group[0], device))
            return model.train_steps(stage(group, device)[0])

        def handle_logs(logs: dict, weight: int) -> None:
            nonlocal n_batches, since_save
            n_batches += weight
            if log_every and (n_batches % log_every) < weight and log_fn:
                log_fn({"epoch": epoch, "step": model.step, **{k: float(v) for k, v in logs.items()}})
            for k, v in logs.items():
                train_logs[k] = train_logs.get(k, 0.0) + (v if weight == 1 else v * weight)
            since_save += weight
            if checkpointer is not None and checkpoint_every and since_save >= checkpoint_every:
                save(epoch=epoch, batches_done=done_offset + n_batches)
                since_save = 0

        def unskipped():
            # batches (or groups) the preempted run already trained are
            # skipped; a group that straddles the cursor cannot be
            nonlocal to_skip
            for item in train_loader:
                if to_skip > 0:
                    w = item.n if isinstance(item, StackedBatch) else 1
                    if w > to_skip:
                        raise RuntimeError(
                            f"resume cursor ({done_offset} batches) does not align with the loader's "
                            f"dispatch groups (next group has {w}); resume with the same loader "
                            "configuration and steps_per_dispatch as the interrupted run"
                        )
                    to_skip -= w
                    continue
                yield item

        for item in group_batches(unskipped(), steps_per_dispatch):
            if isinstance(item, StackedBatch):  # a group stacked and moved by PrefetchLoader(stack=K)
                handle_logs(model.train_steps(stacked_on(item.tree, device)), item.n)
            else:
                handle_logs(run_group(item), len(item))
        if to_skip > 0:
            raise RuntimeError(
                f"resume cursor ({done_offset} batches) exceeds this epoch's batch count "
                f"by {to_skip}; resume with the same dataset, batch_size and steps_per_dispatch "
                "as the interrupted run"
            )
        means = {k: float(v) / max(n_batches, 1) for k, v in train_logs.items()}
        record = {"epoch": epoch, "time": time.perf_counter() - t0, **means}
        if val_loader is not None:
            record.update(evaluate(model, val_loader, host_metrics))
        history.append(record)
        if log_fn:
            log_fn(record)
        stop = stopper is not None and stopper.stop(record)
        if checkpointer is not None:
            save(metrics=record, epoch=epoch + 1, batches_done=0)
        if stop:
            return FitResult(history=history, stopped_early=True)
    return FitResult(history=history)


def evaluate(model: Model, loader, host_metrics: Mapping[str, Mapping] | None = None) -> dict[str, float]:
    """Count-weighted average of the eval step's losses and metrics over
    batches: each batch's masked mean is weighted by its mask count, so a
    ragged final batch does not skew the average. Sums stay on the device
    until the end. ``host_metrics`` (``{name: {"fn", "in_keys"}}``) take the
    eval outputs of their ``in_keys`` over the whole pass, concatenated on
    the host as numpy (a proper AUROC, not a mean of per-batch ones), and
    give ``val/<name>``."""
    device = model.device
    sums: dict = {}
    weights: dict = {}
    n = 0
    accum: dict[str, list[torch.Tensor]] = {}
    needed = set()
    for cfg in (host_metrics or {}).values():
        ks = cfg["in_keys"]
        needed.update(ks.values() if isinstance(ks, Mapping) else ks)
    for batch in loader:
        if isinstance(batch, StackedBatch):
            raise TypeError(
                "evaluate() expects single batches; build the eval loader without PrefetchLoader(stack=K)"
            )
        logs, out = model.eval_step(to_device(batch, device))
        n += 1
        for k, v in logs.items():
            if k.startswith("_count/"):
                continue
            w = logs.get(f"_count/{k}", 1.0)
            sums[k] = sums.get(k, 0.0) + v * w
            weights[k] = weights.get(k, 0.0) + w
        for key in needed:
            accum.setdefault(key, []).append(out[key])
    results = {k: float(v) / max(float(weights.get(k, n)), 1e-9) for k, v in sums.items()}
    arrays = {k: np.concatenate([host_array(x) for x in v]) for k, v in accum.items()}
    for name, cfg in (host_metrics or {}).items():
        ks = cfg["in_keys"]
        if isinstance(ks, Mapping):
            results[f"val/{name}"] = float(cfg["fn"](**{kw: arrays[key] for kw, key in ks.items()}))
        else:
            results[f"val/{name}"] = float(cfg["fn"](*(arrays[key] for key in ks)))
    return results


def host_array(x: torch.Tensor) -> np.ndarray:
    """``x`` on the host as numpy; a bf16 tensor (a bf16 model's untransformed
    outputs) as float32, which holds its values exactly."""
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def predict(model: Model, loader, keys: list[str] | None = None) -> dict[str, np.ndarray]:
    """Inference pass applying the ``preds`` transforms: each batch goes to
    the model's device, outputs stay there until the end, and are
    concatenated on the host."""
    device = model.device
    accum: dict[str, list] = {}
    for batch in loader:
        out = model.predict_step(to_device(batch, device))
        for k, v in out.items():
            if keys is not None and k not in keys:
                continue
            if isinstance(v, torch.Tensor):
                accum.setdefault(k, []).append(v)
    return {k: np.concatenate([host_array(x) for x in v]) for k, v in accum.items()}
