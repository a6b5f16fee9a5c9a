"""Data parallelism for the dense layouts.

Port of ``notorch_tpu.parallel.dense_dp``. A dense batch leads every array
with its molecule (or bin) axis, and every op of the model is independent
per molecule until the loss, so each rank runs its contiguous chunk of the
batch and only the gradients cross ranks.

- :class:`DenseSpmdTrainer` is the JAX ``shard_map`` trainer: each rank
  runs its chunk of a ``pack_graphs_dense(n_shards=k)`` batch (chunk-local
  molecule ids, the shard marker reset by :func:`_mark_shards_local`), the
  fused block's kernels (TPU kernel rows 2-3 on the card) on its own bins,
  and the mean of the gradients and of the logs over ``data``. It refuses
  BatchNorm state, as there.
- :class:`DenseDataParallel` gives what GSPMD gives the JAX package: the
  step of the whole global batch. Each rank's masked-mean loss terms are
  weighted by its share of the global count before the gradients are
  summed, and BatchNorm takes its training statistics over the whole batch
  (summed over the data group inside the forward).

At world size 1 both are ``Model.train_step``, bit for bit.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from notorch_tpu_torch.data.dense import DenseBatchedGraph
from notorch_tpu_torch.model.model import Model
from notorch_tpu_torch.parallel.collectives import psum
from notorch_tpu_torch.parallel.spmd import SpmdTrainer

__all__ = ["DenseDataParallel", "DenseSpmdTrainer"]


def _mark_shards_local(batch: Mapping[str, Any]) -> dict:
    """A rank holds ONE chunk of a ``pack_graphs_dense(n_shards=k)`` batch: a
    whole single-shard batch with chunk-local molecule ids. Reset the shard
    marker so the packed readouts (which refuse multi-shard batches) take
    it."""
    return {k: v.update(n_shards=1) if isinstance(v, DenseBatchedGraph) and v.n_shards != 1 else v
            for k, v in batch.items()}


def _chunk(x, rank: int, n: int):
    """Rank ``rank``'s contiguous ``1/n`` of ``x``'s leading axis, a fresh
    contiguous copy (numpy or a tensor where it lies)."""
    if x.shape[0] % n:
        raise ValueError(f"a leading axis of {x.shape[0]} does not split over {n} data ranks")
    per = x.shape[0] // n
    part = x[rank * per : (rank + 1) * per]
    if isinstance(x, torch.Tensor):
        return part.clone(memory_format=torch.contiguous_format)
    return np.array(part, copy=True, order="C")


class DenseSpmdTrainer(SpmdTrainer):
    """Dense-layout data parallelism over ``data_axis``: each rank its chunk
    of every array's leading axis (:meth:`local_batch`), the gradients and
    logs averaged over the axis. A model with BatchNorm statistics raises
    ``ValueError``, as the JAX trainer (use :class:`DenseDataParallel`)."""

    def __init__(self, model: Model, mesh, data_axis: str = "data"):
        super().__init__(model, mesh, data_axis=data_axis)

    def local_batch(self, batch: Mapping[str, Any]) -> dict:
        """This rank's chunk of every array of ``batch`` (the graph's fields,
        the targets and masks), the shard marker reset."""
        rank, n = self.index[0], self.sizes[0]
        out = {}
        for k, v in batch.items():
            if isinstance(v, DenseBatchedGraph):
                v = v.update(**{f: None if getattr(v, f) is None else _chunk(getattr(v, f), rank, n)
                                for f in v._ARRAYS})
            elif isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim:
                v = _chunk(v, rank, n)
            out[k] = v
        return _mark_shards_local(out)

    def train_step(self, batch: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        if any(b.is_floating_point() for b in self.network.buffers()):
            raise ValueError(
                "DenseSpmdTrainer does not thread mutable collections (e.g. BatchNorm batch_stats); use the "
                "jnp dense layout with DenseDataParallel for those models"
            )
        return super().train_step(batch)


class DenseDataParallel(DenseSpmdTrainer):
    """The step of the whole global batch, computed in chunks over
    ``axis``'s ranks: each loss and metric term weighted by this rank's
    share of the term's global count (the denominators of the masked
    means), the gradients and logs summed, BatchNorm's training statistics
    over the global batch."""

    data_mean = False
    batch_stats = True
    train_step = SpmdTrainer.train_step

    def __init__(self, model: Model, mesh, axis: str = "data"):
        super().__init__(model, mesh, data_axis=axis)

    def _weigh(self, terms: dict, out: dict) -> dict:
        if self.sizes[0] == 1:
            return terms
        counts = self.model._term_counts(out)
        local = torch.stack([torch.as_tensor(counts[k], dtype=torch.float32, device=self.device).reshape(())
                             for k in terms])
        share = local / psum(local, self.data_axis)
        return {k: v * share[i] for i, (k, v) in enumerate(terms.items())}
