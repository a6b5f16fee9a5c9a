"""Sharded data loading and the sharded epoch loop.

Port of ``notorch_tpu.parallel.loader``. :class:`ShardedDataLoader` builds
JAX's stacked ``[n_data, n_edge_shards, ...]`` batches straight from a
dataset: the global batch cut into per-data-shard molecule lists, padded to
SHARED caps (one shape over the mesh) and edge-sharded. :func:`spmd_fit`
trains a sharded trainer with the port's ``fit``, each rank on its own
entry of every batch, so ``checkpointer=``, ``resume=True`` and
``checkpoint_every`` work sharded: global rank 0 writes a checkpoint (the
unsharded model's ``state_dict``; expert slices are gathered), every rank
waits for it, and every rank restores from it.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch.distributed as dist

from notorch_tpu_torch.data.batching import bucket_ladder, round_up_ladder
from notorch_tpu_torch.data.samplers import SeededSampler, SequentialSampler
from notorch_tpu_torch.parallel.distributed import process_info
from notorch_tpu_torch.parallel.partition import build_spmd_batch

__all__ = ["ShardedDataLoader", "RankZeroCheckpointer", "spmd_fit"]


class ShardedDataLoader:
    """SPMD-stacked batches over a
    :class:`~notorch_tpu_torch.data.dataset.MolecularDataset`: ``n_data``
    data shards x ``n_edge_shards`` edge shards, a global batch of ``n_data
    * per_shard_graphs`` molecules, the shuffle a pure function of (seed,
    epoch) after :meth:`set_epoch`, as the single-device ``DataLoader``."""

    def __init__(self, dataset, n_data: int, per_shard_graphs: int, n_edge_shards: int = 1, shuffle: bool = False,
                 seed: int = 0, node_quantum: int = 128, edge_quantum: int = 256, target_name: str | None = None):
        self.dataset = dataset
        self.n_data, self.per, self.n_edge_shards = n_data, per_shard_graphs, n_edge_shards
        self.global_batch = n_data * per_shard_graphs
        self.sampler = SeededSampler(len(dataset), seed) if shuffle else SequentialSampler(len(dataset))
        self.node_ladder = bucket_ladder(node_quantum, 1 << 22)
        self.edge_ladder = bucket_ladder(edge_quantum, 1 << 23)
        names = list(dataset.targets)
        self.target_name = target_name or (names[0] if names else None)
        self._cache: dict[int, object] = {}

    def _graph(self, idx: int):
        hit = self._cache.get(idx)
        if hit is None:
            mgr = next(iter(self.dataset.transforms.values()))
            hit = self._cache[idx] = self.dataset[idx][mgr.out_key]
        return hit

    def set_epoch(self, epoch: int) -> None:
        set_epoch = getattr(self.sampler, "set_epoch", None)
        if callable(set_epoch):
            set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.sampler) // self.global_batch

    def __iter__(self) -> Iterator:
        indices = list(iter(self.sampler))
        for start in range(0, len(indices) - self.global_batch + 1, self.global_batch):
            chunk = indices[start : start + self.global_batch]
            groups_idx = [chunk[i * self.per : (i + 1) * self.per] for i in range(self.n_data)]
            groups = [[self._graph(i) for i in g] for g in groups_idx]
            # shared caps over the data shards: one shape
            max_v = max(sum(g.num_nodes for g in grp) for grp in groups) + 1
            max_e = max(sum(g.num_edges for g in grp) for grp in groups)
            node_cap = round_up_ladder(max_v, self.node_ladder)
            edge_cap = round_up_ladder(max_e, self.edge_ladder)
            q = 2 * self.n_edge_shards  # the edge cap splits into even shards
            edge_cap = -(-edge_cap // q) * q
            targets = None
            if self.target_name is not None:
                arr = self.dataset._target_arrays[self.target_name]
                targets = {self.target_name: np.stack([arr[np.asarray(g)] for g in groups_idx])}
            yield build_spmd_batch(groups, targets, node_cap=node_cap, edge_cap=edge_cap, graph_cap=self.per,
                                   n_edge_shards=self.n_edge_shards)


class RankZeroCheckpointer:
    """A :class:`~notorch_tpu_torch.training.checkpoint.Checkpointer` that
    global rank 0 alone writes, every rank waiting at a barrier after each
    save; every rank reads."""

    def __init__(self, checkpointer):
        self.inner = checkpointer

    def save(self, *args, **kwargs):
        path = self.inner.save(*args, **kwargs) if process_info()[0] == 0 else None
        if dist.is_initialized():
            dist.barrier()
        return path

    def __getattr__(self, name):
        return getattr(self.inner, name)


class _LocalEntries:
    """A loader of stacked batches, yielding the trainer's entry of each."""

    def __init__(self, loader, trainer):
        self.loader, self.trainer = loader, trainer

    def set_epoch(self, epoch: int) -> None:
        set_epoch = getattr(self.loader, "set_epoch", None)
        if callable(set_epoch):
            set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            yield self.trainer.local_batch(batch)


def spmd_fit(trainer, loader, epochs: int = 1, log_fn=None, val_loader=None, checkpointer=None, **fit_kwargs):
    """Epochs of a sharded trainer (:class:`~notorch_tpu_torch.parallel.spmd.
    SpmdTrainer` or a dense one) over a loader of stacked batches
    (:class:`ShardedDataLoader`, or any), through
    :func:`~notorch_tpu_torch.training.loop.fit`, each rank on its entry;
    ``checkpointer`` behind a :class:`RankZeroCheckpointer`. Returns the
    ``FitResult``."""
    from notorch_tpu_torch.training.loop import fit

    if checkpointer is not None and not isinstance(checkpointer, RankZeroCheckpointer):
        checkpointer = RankZeroCheckpointer(checkpointer)
    val = None if val_loader is None else _LocalEntries(val_loader, trainer)
    return fit(trainer, _LocalEntries(loader, trainer), val, epochs=epochs, log_fn=log_fn,
               checkpointer=checkpointer, **fit_kwargs)
