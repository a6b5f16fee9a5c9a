"""Tracing and profiling utilities.

Port of ``notorch_tpu.training.profiling``: :func:`trace` records a
``torch.profiler`` trace (the host's ops and, on the card, its kernels)
into a Chrome trace file, :func:`annotate` names a span in it (and an NVTX
range on the card), and :class:`StepTimer` times steps on the host's clock
with a real device sync every ``sync_every`` steps (a sync every step would
serialize the host's launches with the card's work); its
``steps_per_sec`` and ``summary`` feed the edges/s metric.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections.abc import Mapping
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch


def leaves(x: Any) -> list:
    """The tensors and numpy arrays of a nested structure (mappings, lists,
    tuples, dataclasses such as the batch graphs, modules' parameters), in
    order."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return [x]
    if isinstance(x, torch.nn.Module):
        return list(x.parameters())
    if isinstance(x, Mapping):
        return [leaf for v in x.values() for leaf in leaves(v)]
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in leaves(v)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [leaf for f in dataclasses.fields(x) for leaf in leaves(getattr(x, f.name))]
    return []


def device_sync(x: Any) -> float:
    """Wait for everything ``x`` depends on: ``torch.cuda.synchronize`` on
    the device of its first tensor where that is a card. Returns the JAX
    version's scalar, the float32 sum of the first array leaf (0.0 where
    there is none)."""
    found = leaves(x)
    if not found:
        return 0.0
    first = found[0]
    if isinstance(first, np.ndarray):
        return float(first.astype(np.float32).sum())
    if first.is_cuda:
        torch.cuda.synchronize(first.device)
    return float(first.detach().float().sum())


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Record a ``torch.profiler`` trace of the block (CPU activity, and
    CUDA where a card is present) and write it as a Chrome trace,
    ``trace.<pid>.<ms>.json`` in ``log_dir`` (view it in Perfetto or
    ``chrome://tracing``). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / f"trace.{os.getpid()}.{int(time.time() * 1e3)}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named span in the profiler's timeline (``record_function``), and
    an NVTX range of the same name where a card is present."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                torch.cuda.nvtx.range_pop()
        else:
            yield


@dataclass
class StepTimer:
    """Rolling wall-clock step timing with true device syncs every
    ``sync_every`` steps (syncing every step would serialize dispatch)."""

    sync_every: int = 10
    _t0: float = field(default=0.0)
    _steps: int = 0
    _times: list = field(default_factory=list)
    _pending: Any = None

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def step(self, result: Any = None) -> None:
        self._steps += 1
        self._pending = result
        if self._steps % self.sync_every == 0:
            device_sync(self._pending)
            now = time.perf_counter()
            self._times.append((self.sync_every, now - self._t0))
            self._t0 = now

    def steps_per_sec(self) -> float:
        if not self._times:
            return float("nan")
        n = sum(c for c, _ in self._times)
        t = sum(t for _, t in self._times)
        return n / t if t > 0 else float("nan")

    def summary(self, edges_per_step: int | None = None, depth: int = 1) -> dict:
        sps = self.steps_per_sec()
        out = {"steps_per_sec": sps}
        if edges_per_step:
            out["edges_per_sec"] = sps * edges_per_step * depth
        return out
