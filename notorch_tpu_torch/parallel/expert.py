"""Expert parallelism for :class:`~notorch_tpu_torch.nn.moe.MixtureOfExperts`.

Port of ``notorch_tpu.parallel.expert``. The JAX package places the stacked
expert axis on an ``expert`` mesh axis and lets GSPMD partition the batched
expert products. Here each rank keeps the slice of every ``experts.*``
stack that its coordinate on the ``expert`` axis owns (a contiguous run of
experts), computes those experts alone and sums the router-weighted
combine over the expert group inside the forward
(:func:`~notorch_tpu_torch.parallel.collectives.psum`). The routers stay
replicated; tokens may ride a ``data`` axis beside it. A leaf whose leading
axis does not divide by the axis size stays whole, as in JAX.

Train it with :class:`~notorch_tpu_torch.parallel.spmd.SpmdTrainer`
``(model, mesh, data_axis="data", graph_axis="expert")``: the loss counted
once (on expert rank 0), the replicated parameters' gradients summed over
the expert group, each rank's expert slice keeping its own, the routers'
importance and load summed over the data group (the global batch's, as
GSPMD's). A ``state_dict`` of a sharded module gathers the slices, and the
trainer's ``train_state_dict`` the optimizer state of the slices, so a
checkpoint equals the unsharded model's; loading such a whole one keeps
this rank's slice.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from notorch_tpu_torch.nn.moe import MixtureOfExperts
from notorch_tpu_torch.parallel.spmd import SHARDED_AXIS

__all__ = ["expert_partition_specs", "shard_expert_params"]


def _network(module) -> nn.Module:
    return module.network if hasattr(module, "network") and isinstance(module.network, nn.Module) else module


def _experts(module: nn.Module, expert_collection: str):
    """``(path, moe)`` of every MixtureOfExperts below ``module`` whose
    expert stacks sit under ``expert_collection``."""
    return [(name, m) for name, m in module.named_modules()
            if isinstance(m, MixtureOfExperts) and isinstance(getattr(m, expert_collection, None), nn.Module)]


def expert_partition_specs(module, mesh, axis: str = "expert", expert_collection: str = "experts") -> dict:
    """The placement of every parameter of ``module`` (a ``Model`` or an
    ``nn.Module``), by its ``state_dict`` key: ``(axis, None, ...)`` for a
    leaf of an expert stack whose leading axis divides by the axis size
    (split over ``axis``), ``()`` for a replicated one (JAX's
    ``PartitionSpec``s)."""
    net = _network(module)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    stacked = {f"{path}.{expert_collection}.{k}" if path else f"{expert_collection}.{k}"
               for path, moe in _experts(net, expert_collection)
               for k, _ in getattr(moe, expert_collection).named_parameters()}
    return {name: (axis,) + (None,) * (p.dim() - 1) if name in stacked and p.dim() >= 1 and p.shape[0] % n == 0
            else () for name, p in net.named_parameters()}


def shard_expert_params(module, mesh, axis: str = "expert", expert_collection: str = "experts"):
    """Keep, in place, this rank's slice of every expert stack of ``module``
    (a ``Model`` or an ``nn.Module``, its parameters already the same on
    every rank) on ``axis`` of ``mesh``; the optimizer's references stay
    valid (the parameters are the same objects). Returns ``module``."""
    net = _network(module)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    rank, group = mesh.get_local_rank(axis), mesh.get_group(axis)
    for _, moe in _experts(net, expert_collection):
        stacks = getattr(moe, expert_collection)
        if moe.num_experts % n or any(p.shape[0] != moe.num_experts for p in stacks.parameters()):
            continue  # stays whole, as a leaf that does not divide in JAX
        per = moe.num_experts // n
        start, stop = rank * per, (rank + 1) * per
        for p in stacks.parameters():
            p.data = p.data[start:stop].clone()
            setattr(p, SHARDED_AXIS, axis)
        moe.expert_axis, moe.expert_range = axis, (start, stop)
        _gather_on_save(moe, stacks, expert_collection, group, n, start, stop)
    return module


def _gather_on_save(moe: nn.Module, stacks: nn.Module, collection: str, group, n: int, start: int, stop: int):
    """A ``state_dict`` of ``moe`` holds the whole stacks (gathered over
    ``group``; every rank takes part), and ``load_state_dict`` keeps this
    rank's ``[start, stop)`` of whole ones."""
    names = [k for k, _ in stacks.named_parameters()]

    def gather(module, state_dict, prefix, local_metadata):
        for k in names:
            key = f"{prefix}{collection}.{k}"
            part = state_dict[key].detach().contiguous()
            parts = [torch.empty_like(part) for _ in range(n)]
            dist.all_gather(parts, part, group=group)
            state_dict[key] = torch.cat(parts)
        return state_dict

    def slice_whole(state_dict, prefix, *args):
        for k in names:
            key = f"{prefix}{collection}.{k}"
            if key in state_dict and state_dict[key].shape[0] == moe.num_experts:
                state_dict[key] = state_dict[key][start:stop]

    moe._register_state_dict_hook(gather)
    moe._register_load_state_dict_pre_hook(slice_whole)
