"""Collectives over named mesh axes, differentiable as JAX's are.

Inside ``shard_map`` the JAX package names a mesh axis (``"graph"``,
``"data"``) and XLA finds its devices. Here a trainer binds the axis names
of its ``DeviceMesh`` to the mesh's per-axis process groups for the length
of its step (:func:`bind_axes`), and a module with ``psum_axis="graph"``
resolves the name to that group when it runs. A name that no trainer has
bound raises ``NameError``, as an unbound axis name does in JAX.

The differentiable collectives are this module's own
``torch.autograd.Function``s, so that their backward is the same on every
version of torch:

- :func:`psum`: an all-reduce SUM whose backward is an all-reduce SUM of the
  cotangent (JAX's ``psum`` under ``shard_map(check_vma=False)``);
- :func:`all_to_all`: chunk ``j`` of the leading axis to rank ``j``, chunk
  ``i`` of the result from rank ``i``; its backward is the same exchange;
- :func:`all_gather`: the ranks' tensors stacked on a new leading axis; its
  backward sums the cotangent over the ranks and keeps this rank's slice;
- :func:`pmax`: an all-reduce MAX of a value that takes no gradient (JAX's
  ``pmax`` has no differentiation rule; :func:`pmax_nondiff` raises in the
  backward, where JAX raises).

On a group of one rank every collective is the identity, so a sharded step
at world size 1 keeps the plain step's bits.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.distributed as dist

__all__ = ["bind_axes", "group_of", "axis_size", "axis_index", "batch_stats_axis", "psum", "all_to_all",
           "all_gather", "pmax", "pmax_nondiff", "broadcast_"]

# axis name -> (process group, its size, this rank's index in it)
_AXES: dict[str, tuple] = {}
# the axis over which BatchNorm statistics are taken (DenseDataParallel)
_BATCH_AXIS: list[str | None] = [None]


@contextmanager
def bind_axes(mesh, batch_axis: str | None = None):
    """Bind every named dimension of ``mesh`` (a ``DeviceMesh``) to its
    process group while the block runs; ``batch_axis`` also makes BatchNorm
    take its training statistics over that axis's ranks."""
    saved, saved_batch = dict(_AXES), _BATCH_AXIS[0]
    for name in mesh.mesh_dim_names:
        _AXES[name] = (mesh.get_group(name), mesh.size(mesh.mesh_dim_names.index(name)),
                       mesh.get_local_rank(name))
    _BATCH_AXIS[0] = batch_axis
    try:
        yield
    finally:
        _AXES.clear()
        _AXES.update(saved)
        _BATCH_AXIS[0] = saved_batch


def _bound(axis: str) -> tuple:
    try:
        return _AXES[axis]
    except KeyError:
        raise NameError(
            f"Found an unbound axis name: {axis}. A module with a mesh axis runs inside a sharded trainer's "
            f"step (SpmdTrainer, DenseDataParallel); bound now: {sorted(_AXES)}"
        ) from None


def group_of(axis: str):
    return _bound(axis)[0]


def axis_size(axis: str) -> int:
    return _bound(axis)[1]


def axis_index(axis: str) -> int:
    """This rank's coordinate along ``axis`` (JAX's ``lax.axis_index``)."""
    return _bound(axis)[2]


def batch_stats_axis() -> str | None:
    """The axis BatchNorm takes its statistics over, where one is bound and
    has more than one rank; else None (the local batch)."""
    axis = _BATCH_AXIS[0]
    return axis if axis is not None and axis_size(axis) > 1 else None


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index):
        ctx.group, ctx.index = group, index
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group)[ctx.index], None, None


class _PMaxNoGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group, dist.ReduceOp.MAX)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError("pmax has no differentiation rule (as in JAX): a sharded max reduce trains only "
                                  "through all_gather")


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis``; its gradient is the psum of
    the cotangent."""
    group, size, _ = _bound(axis)
    return x if size == 1 else _AllReduceSum.apply(x, group)


def all_to_all(x: torch.Tensor, axis: str) -> torch.Tensor:
    """JAX's ``all_to_all(x, axis, 0, 0)`` on ``x [n, ...]`` (``n`` the
    axis size); the same exchange in the backward."""
    group, size, _ = _bound(axis)
    if x.shape[0] != size:
        raise ValueError(f"all_to_all over {axis!r} ({size} ranks) needs a leading axis of {size}, got {x.shape}")
    return x if size == 1 else _AllToAll.apply(x, group)


def all_gather(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``[n, *x.shape]``: every rank's ``x`` in rank order (JAX's
    ``all_gather``)."""
    group, size, index = _bound(axis)
    return x[None] if size == 1 else _AllGather.apply(x, group, index)


def pmax(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Max over the ranks of ``axis`` of a value that takes no gradient
    (JAX's ``pmax(stop_gradient(x))``)."""
    group, size, _ = _bound(axis)
    return x.detach() if size == 1 else _all_reduce(x, group, dist.ReduceOp.MAX)


def pmax_nondiff(x: torch.Tensor, axis: str) -> torch.Tensor:
    """JAX's ``pmax``: the max over the ranks, whose backward raises."""
    group, size, _ = _bound(axis)
    return x if size == 1 else _PMaxNoGrad.apply(x, group)


def broadcast_(tensors, src: int = 0, group=None) -> None:
    """Overwrite ``tensors`` in place with the global rank ``src``'s values
    (a no-op outside a process group or at world size 1)."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return
    with torch.no_grad():
        for t in tensors:
            buf = t.detach().contiguous().clone()
            dist.broadcast(buf, src=src, group=group)
            t.copy_(buf)
