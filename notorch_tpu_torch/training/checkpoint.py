"""Checkpoint save/restore in the port's own format.

A checkpoint directory holds one ``state_<step>.pt`` per saved step: a
model ``state_dict`` written with ``torch.save`` and read back with
``torch.load(..., weights_only=True)``. Orbax checkpoints of the JAX package
are not read; carry JAX weights across with
:func:`notorch_tpu_torch.model.convert.params_from_jax`. Retention and the
training-loop sidecars come with the training slice.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch

_STATE = re.compile(r"state_(\d+)\.pt$")


class Checkpointer:
    def __init__(self, directory: str | Path):
        self.directory = Path(directory).absolute()

    def _path(self, step: int) -> Path:
        return self.directory / f"state_{int(step)}.pt"

    def all_steps(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(m.group(1)) for p in self.directory.iterdir() if (m := _STATE.match(p.name)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state_dict: dict[str, torch.Tensor], step: int) -> Path:
        """Write ``state_dict`` (moved to the CPU) as step ``step``."""
        self.directory.mkdir(parents=True, exist_ok=True)
        path = self._path(step)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
        os.replace(tmp, path)  # a reader never sees a half-written file
        return path

    def restore(self, step: int | None = None) -> dict[str, torch.Tensor]:
        """The ``state_dict`` of ``step`` (default: the latest), on the CPU."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no port checkpoint (state_<step>.pt) in {self.directory}; orbax "
                    "checkpoints of notorch_tpu are not read by the port"
                )
        path = self._path(step)
        if not path.exists():
            raise FileNotFoundError(f"no checkpoint for step {step} in {self.directory}")
        return torch.load(path, map_location="cpu", weights_only=True)
