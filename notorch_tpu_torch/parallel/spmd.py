"""SPMD training: data-parallel and graph-partitioned steps, one process a rank.

Port of ``notorch_tpu.parallel.spmd``. The JAX package runs its step under
``shard_map`` over a ``data`` x ``graph`` mesh; here every rank runs the
same step on its own entry of the stacked batch, with the mesh's axis names
bound to its process groups (:func:`~notorch_tpu_torch.parallel.collectives.
bind_axes`), so that a module's ``psum_axis`` sums over the graph group
inside the forward.

Gradient exactness, as in JAX: with graph partitioning, what follows the
message passing (readout, head, loss) is replicated over the graph axis.
The loss is gated to graph rank 0, and the ``psum`` in the forward sums the
cotangent of every rank in its backward, so a sum of the gradients over the
graph axis equals the unsharded gradient: each rank's partial path gets the
whole cotangent, and the replicated tail's gradient is nonzero on rank 0
alone. Over the data axis the gradients, the logs and BatchNorm's running
statistics are averaged; for an expert-sharded model, whose JAX step is
GSPMD's, the routers' and BatchNorm's statistics are the global batch's. A
parameter that a module shards over an axis
(the expert stacks of :func:`~notorch_tpu_torch.parallel.expert.
shard_expert_params`) is not summed over that axis: each rank owns its
slice's gradient.

At world size 1 every collective is the identity and the step is
``Model.train_step``'s, bit for bit.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from notorch_tpu_torch.model.model import EPS, Model
from notorch_tpu_torch.parallel.collectives import axis_index, axis_size, bind_axes, group_of
from notorch_tpu_torch.parallel.partition import local_entry
from notorch_tpu_torch.training.optim import clip_by_global_norm_

__all__ = ["SpmdTrainer"]

# the attribute a sharded parameter carries: the mesh axis it is split over
SHARDED_AXIS = "_spmd_sharded_axis"


def _all_reduce_flat(tensors: list[torch.Tensor], axis: str, mean: bool) -> None:
    """Sum (or average) ``tensors`` in place over ``axis``'s ranks, in one
    collective; nothing at an axis of one rank."""
    import torch.distributed as dist

    size = axis_size(axis)
    if size == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group_of(axis))
    if mean:
        flat = flat / size
    offset = 0
    for t in tensors:
        t.copy_(flat[offset : offset + t.numel()].view_as(t))
        offset += t.numel()


def _gather_slices(value: torch.Tensor, param, axis: str) -> torch.Tensor:
    """The whole stack of a state tensor that is sharded like ``param``: the
    slices of ``axis``'s ranks, in rank order."""
    import torch.distributed as dist

    size = axis_size(axis)
    if size == 1:
        return value
    parts = [torch.empty_like(value) for _ in range(size)]
    dist.all_gather(parts, value.contiguous(), group=group_of(axis))
    return torch.cat(parts)


def _own_slice(value: torch.Tensor, param, axis: str) -> torch.Tensor:
    """This rank's slice (a fresh copy) of a whole stack sharded like
    ``param``."""
    n = param.shape[0]
    start = axis_index(axis) * n
    return value[start : start + n].clone()


def fold_generators(model: Model, rank: int) -> None:
    """Give data rank ``rank`` > 0 a mask stream of its own: every noise
    generator of the model reseeded from its next draw plus ``rank`` (JAX's
    ``fold_in`` of the dropout key by the data index). Rank 0 keeps its
    stream, so a world of one keeps the plain model's."""
    if rank == 0:
        return
    for g in model.generators().values():
        g.manual_seed(int(torch.randint(0, 2**62, (), generator=g)) + rank)


class SpmdTrainer:
    """A :class:`~notorch_tpu_torch.model.model.Model` trained over a mesh
    (a ``DeviceMesh`` from :func:`~notorch_tpu_torch.parallel.mesh.
    make_mesh`) with ``data_axis`` and, for graph partitioning,
    ``graph_axis`` (the model's modules built with that axis as their
    ``psum_axis``/``graph_axis``).

    Batches come from the builders of :mod:`~notorch_tpu_torch.parallel.
    partition`, every leaf ``[n_data, n_graph, ...]`` (``n_graph`` 1 without
    a graph axis); each rank trains on its entry, :meth:`local_batch`. The
    trainer has the surface of a ``Model`` that ``fit``, ``evaluate`` and a
    ``Checkpointer`` use (``network``, ``device``, ``step``,
    ``train_state_dict``, ``train_step``, ``train_steps``, ``eval_step``),
    so :func:`~notorch_tpu_torch.parallel.loader.spmd_fit` trains it."""

    # the data axis averages the ranks' gradients and logs; a trainer of the
    # global batch's step (DenseDataParallel) sums count-weighted terms;
    # batch_stats takes the statistics over the batch (BatchNorm's, the MoE
    # routers') over the data group (DenseDataParallel, an expert-sharded
    # model)
    data_mean = True
    batch_stats = False

    def __init__(self, model: Model, mesh, data_axis: str = "data", graph_axis: str | None = None):
        self.model, self.mesh = model, mesh
        self.data_axis, self.graph_axis = data_axis, graph_axis
        with bind_axes(mesh):
            self.index = (axis_index(data_axis), axis_index(graph_axis) if graph_axis else 0)
            self.sizes = (axis_size(data_axis), axis_size(graph_axis) if graph_axis else 1)

    # -- the Model surface ------------------------------------------------
    @property
    def network(self):
        return self.model.network

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def step(self) -> int:
        return self.model.step

    @step.setter
    def step(self, value: int) -> None:
        self.model.step = value

    def generators(self) -> dict:
        return self.model.generators()

    def train_state_dict(self) -> dict:
        """The model's training state, the optimizer state of every sharded
        parameter gathered over its axis (every rank takes part), so that
        it is the unsharded model's, as the parameters' ``state_dict`` is."""
        state = self.model.train_state_dict()
        return {**state, "optimizer": self._map_sharded_state(state["optimizer"], _gather_slices)}

    def load_train_state_dict(self, state: Mapping) -> None:
        """Restore a saved training state (rank 0's, unsharded): each sharded
        parameter's optimizer state cut to this rank's slice, then the noise
        streams folded by the data rank again, as :meth:`init` does."""
        self.model.load_train_state_dict({**state, "optimizer": self._map_sharded_state(state["optimizer"],
                                                                                          _own_slice)})
        fold_generators(self.model, self.index[0])

    def _map_sharded_state(self, opt: Mapping, fn) -> dict:
        """A copy of ``opt`` (an optimizer ``state_dict``) with ``fn(value,
        param, axis)`` applied to every tensor with an axis in the state of
        each parameter that a module shards over a mesh axis."""
        state = dict(opt["state"])
        with bind_axes(self.mesh):
            for group, saved in zip(self.model.optimizer.param_groups, opt["param_groups"]):
                for p, idx in zip(group["params"], saved["params"]):
                    axis = getattr(p, SHARDED_AXIS, None)
                    if axis is not None and idx in state:
                        state[idx] = {k: fn(v, p, axis) if isinstance(v, torch.Tensor) and v.dim() else v
                                      for k, v in state[idx].items()}
        return {**opt, "state": state}

    # -- setup ------------------------------------------------------------
    def init(self, generator: torch.Generator | None = None) -> "SpmdTrainer":
        """Make the parameters and buffers the same on every rank: drawn
        from ``generator`` where given (every rank the same draws), then
        rank 0's broadcast to all; then fold the noise streams by the data
        rank. Returns the trainer."""
        import torch.distributed as dist

        from notorch_tpu_torch.parallel.collectives import broadcast_

        if generator is not None:
            self.model.reset_parameters(generator)
        tensors = [*self.network.parameters(), *self.network.buffers()]
        broadcast_([t for t in tensors if getattr(t, SHARDED_AXIS, None) is None])
        sharded = [t for t in tensors if getattr(t, SHARDED_AXIS, None) is not None]
        if sharded:  # a slice is the same along the data axis only
            with bind_axes(self.mesh):
                group = group_of(self.data_axis)
            broadcast_(sharded, src=dist.get_global_rank(group, 0), group=group)
            # an expert-sharded model is the JAX package's GSPMD step: the
            # statistics over the batch (the routers', BatchNorm's) are the
            # global batch's
            self.batch_stats = True
        fold_generators(self.model, self.index[0])
        return self

    def local_batch(self, stacked: Mapping[str, Any]) -> dict:
        """This rank's entry ``[data_index, graph_index]`` of a stacked batch,
        every array a fresh contiguous copy where it lies (numpy or a
        tensor)."""
        return local_entry(dict(stacked), self.index)

    @property
    def _batch_axis(self) -> str | None:
        """The axis that statistics over the batch are taken over, where the
        step is the global batch's."""
        return self.data_axis if self.batch_stats else None

    def _weigh(self, terms: dict, out: dict) -> dict:
        """The loss and metric terms as this rank contributes them: on graph
        rank 0 alone, where there is a graph axis (the replicated tail
        counts once)."""
        if self.graph_axis is None:
            return terms
        gate = 1.0 if self.index[1] == 0 else 0.0
        return {k: v * gate for k, v in terms.items()}

    def _reduce_logs(self, logs: dict) -> dict:
        vals = [v.detach().reshape(1).to(torch.float32).clone() for v in logs.values()]
        _all_reduce_flat(vals, self.data_axis, mean=self.data_mean)
        if self.graph_axis is not None:
            _all_reduce_flat(vals, self.graph_axis, mean=False)
        return {k: v.reshape(()) for k, v in zip(logs, vals)}

    def _reduce_grads(self) -> None:
        params = [p for p in self.network.parameters() if p.requires_grad]
        if max(self.sizes) > 1:  # every rank hands every gradient to the collective
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        params = [p for p in params if p.grad is not None]
        _all_reduce_flat([p.grad for p in params], self.data_axis, mean=self.data_mean)
        if self.graph_axis is not None:
            _all_reduce_flat([p.grad for p in params if getattr(p, SHARDED_AXIS, None) != self.graph_axis],
                             self.graph_axis, mean=False)

    def _average_statistics(self) -> None:
        """BatchNorm's running averages: each data rank saw another
        sub-batch, so they are averaged over the data axis (statistics of
        the global batch are the same on every rank already)."""
        if self.batch_stats:
            return
        stats = [b for b in self.network.buffers() if b.is_floating_point()]
        with torch.no_grad():
            _all_reduce_flat(stats, self.data_axis, mean=True)

    # -- steps ------------------------------------------------------------
    def train_step(self, batch: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        """One optimizer update on this rank's entry ``batch`` (already on
        the device): the sharded forward and backward, the gradients
        averaged over ``data`` and summed over ``graph``, the clip, the
        optimizer and the schedule. Returns ``train/<name>`` and
        ``train/loss`` reduced as the gradients (device scalars)."""
        m = self.model
        m.network.train()
        m.optimizer.zero_grad(set_to_none=True)
        with bind_axes(self.mesh, batch_axis=self._batch_axis):
            out = m._apply_transforms(m.network(batch), "targets")
            terms = self._weigh(m._terms(m.losses, out), out)
            total = sum(m.loss_weights.get(name, EPS) * v for name, v in terms.items())
            total.backward()
            self._reduce_grads()
            logs = self._reduce_logs({**{f"train/{k}": v for k, v in terms.items()}, "train/loss": total})
            self._average_statistics()
        if m.optimizer_spec.clip_norm:
            clip_by_global_norm_(m.network.parameters(), float(m.optimizer_spec.clip_norm))
        m.optimizer.step()
        if m.scheduler is not None:
            m.scheduler.step()
        m.step += 1
        return logs

    # K sharded steps on K of this rank's entries stacked on a leading axis,
    # the logs averaged: Model's loop over this class's train_step
    train_steps = Model.train_steps

    def eval_step(self, batch: Mapping[str, Any]) -> tuple[dict, dict]:
        """The losses and metrics of this rank's entry in eval mode, weighed
        (:meth:`_weigh`) and reduced as the training logs: ``(logs,
        outputs)`` with ``val/<name>`` keys, as ``Model.eval_step``."""
        m = self.model
        m.network.eval()
        with torch.no_grad(), bind_axes(self.mesh, batch_axis=self._batch_axis):
            out = m._apply_transforms(m.network(batch), "targets")
            terms = self._weigh({**m._terms(m.losses, out), **m._terms(m.metrics, out)}, out)
            logs = self._reduce_logs({f"val/{k}": v for k, v in terms.items()})
        return logs, out
