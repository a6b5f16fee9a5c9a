"""Checkpoint save/restore in the port's own format, with retention.

A checkpoint directory holds, per saved step:

- ``state_<step>.pt``: the model's ``state_dict``, written with
  ``torch.save`` and read back with ``torch.load(..., weights_only=True)``;
  this file alone is what ``run_predict`` serves;
- ``train_<step>.pt``: the optimizer's and scheduler's ``state_dict`` and
  the update count, when the save carries them;
- ``loop_<step>.json``: the training loop's cursor (epoch, batches done,
  early-stopping state), when the save carries one;
- ``metrics_<step>.json``: the metrics the save was given (the epoch
  record at epoch ends).

Orbax checkpoints of the JAX package are not read; carry JAX weights
across with :func:`notorch_tpu_torch.model.convert.params_from_jax`.

Retention follows ``notorch_tpu.training.checkpoint.Checkpointer``: the
latest ``max_to_keep`` steps, or with ``best_by`` the ``max_to_keep`` best
by that metric; a save at a step that exists replaces it. Two faults of the
JAX version are not copied:

- with ``best_by``, a save that does not carry the metric (a mid-epoch
  preemption save) is scored worst there and deleted at once, so resume
  falls back to an older epoch end. Here the latest step is always kept,
  whatever its metrics, and older saves without the metric are dropped;
- ``best_step()`` there returns a step even when no save carries the
  metric. Here it returns ``None`` then.
"""

from __future__ import annotations

import json
import math
import os
import re
from pathlib import Path

import torch

_STATE = re.compile(r"state_(\d+)\.pt$")
_FILES = ("state_{}.pt", "train_{}.pt", "loop_{}.json", "metrics_{}.json")


def _atomic_write(path: Path, write) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    write(tmp)
    os.replace(tmp, path)  # a reader never sees a half-written file


class Checkpointer:
    def __init__(
        self,
        directory: str | Path,
        max_to_keep: int | None = 3,
        best_by: str | None = None,
        best_mode: str = "min",
    ):
        if best_mode not in ("min", "max"):
            raise ValueError(f"best_mode must be 'min' or 'max', got {best_mode!r}")
        self.directory = Path(directory).absolute()
        self.max_to_keep = max_to_keep
        self.best_by = best_by
        self.best_mode = best_mode

    def _path(self, kind: str, step: int, ext: str) -> Path:
        return self.directory / f"{kind}_{int(step)}.{ext}"

    def all_steps(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(m.group(1)) for p in self.directory.iterdir() if (m := _STATE.match(p.name)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(
        self,
        state_dict: dict[str, torch.Tensor],
        step: int,
        train_state: dict | None = None,
        metrics: dict | None = None,
        extra: dict | None = None,
    ) -> Path:
        """Write ``state_dict`` (moved to the CPU) as step ``step``, with the
        optional training state, metrics and loop cursor beside it; a
        previous save of the same step is replaced whole. Then apply the
        retention policy."""
        self.directory.mkdir(parents=True, exist_ok=True)
        for p in self._files(step):
            p.unlink()
        if train_state is not None:
            _atomic_write(self._path("train", step, "pt"), lambda p: torch.save(_to_cpu(train_state), p))
        if metrics is not None:
            scalars = {k: float(v) for k, v in metrics.items() if _is_scalar(v)}
            self._path("metrics", step, "json").write_text(json.dumps(scalars))
        if extra is not None:
            self._path("loop", step, "json").write_text(json.dumps(extra))
        # the model file last: its presence is what makes the step exist
        path = self._path("state", step, "pt")
        _atomic_write(path, lambda p: torch.save(_to_cpu(state_dict), p))
        self._retain()
        return path

    def _files(self, step: int) -> list[Path]:
        return [p for name in _FILES if (p := self.directory / name.format(int(step))).exists()]

    def metrics(self, step: int) -> dict | None:
        path = self._path("metrics", step, "json")
        return json.loads(path.read_text()) if path.exists() else None

    def _score(self, step: int) -> float | None:
        value = (self.metrics(step) or {}).get(self.best_by)
        return None if value is None or math.isnan(value) else value

    def _retain(self) -> None:
        steps = self.all_steps()
        if self.max_to_keep is None or not steps:
            return
        if self.best_by is None:
            keep = set(steps[-self.max_to_keep:])
        else:
            scored = [s for s in steps if self._score(s) is not None]
            scored.sort(key=lambda s: (self._score(s) if self.best_mode == "min" else -self._score(s), -s))
            keep = set(scored[: self.max_to_keep]) | {steps[-1]}
        for step in steps:
            if step not in keep:
                for p in self._files(step):
                    p.unlink(missing_ok=True)

    def best_step(self) -> int | None:
        """The kept step whose metrics optimize ``best_by``; ``None`` when
        best-tracking is off or no kept save carries the metric. Ties go to
        the later step."""
        if self.best_by is None:
            return None
        scored = [s for s in self.all_steps() if self._score(s) is not None]
        if not scored:
            return None
        pick = min if self.best_mode == "min" else max
        return pick(reversed(scored), key=self._score)

    def restore(self, step: int | None = None) -> dict[str, torch.Tensor]:
        """The model ``state_dict`` of ``step`` (default: the latest), on the CPU."""
        step = self._resolve(step)
        return torch.load(self._path("state", step, "pt"), map_location="cpu", weights_only=True)

    def restore_train(self, step: int | None = None) -> dict | None:
        """The optimizer/scheduler state and update count saved with
        ``step`` (default: the latest), or ``None``."""
        path = self._path("train", self._resolve(step), "pt")
        return torch.load(path, map_location="cpu", weights_only=True) if path.exists() else None

    def restore_extra(self, step: int | None = None) -> dict | None:
        """The loop cursor saved with ``step`` (default: the latest), or ``None``."""
        path = self._path("loop", self._resolve(step), "json")
        return json.loads(path.read_text()) if path.exists() else None

    def _resolve(self, step: int | None) -> int:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no port checkpoint (state_<step>.pt) in {self.directory}; orbax "
                    "checkpoints of notorch_tpu are not read by the port"
                )
        if not self._path("state", step, "pt").exists():
            raise FileNotFoundError(f"no checkpoint for step {step} in {self.directory}")
        return int(step)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _is_scalar(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False
