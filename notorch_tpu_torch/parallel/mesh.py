"""Device mesh construction.

Port of ``notorch_tpu.parallel.mesh``: a ``DeviceMesh`` over the world's
processes (one rank a device) with named dimensions, where the JAX package
builds a ``jax.sharding.Mesh`` over devices.
"""

from __future__ import annotations

import math

import torch.distributed as dist

__all__ = ["make_mesh"]


def make_mesh(axes: dict[str, int] | None = None, device_type: str | None = None):
    """A ``DeviceMesh`` from ``{axis_name: size}``, in dict order (the last
    axis varies fastest over the ranks, as the last axis of a JAX mesh over
    its devices).

    Default: every rank on one ``"data"`` axis. The sizes must multiply to
    the world size, else ``ValueError`` (JAX's, checked before any process
    group is touched); outside a process group the world is one process and
    :func:`~notorch_tpu_torch.parallel.distributed.initialize` starts one on
    ``device_type`` (``"cuda"``, the default, or ``"cpu"``). Inside one,
    ``device_type`` defaults to the group's: ``cuda`` under NCCL, ``cpu``
    under gloo."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if axes is None:
        axes = {"data": world}
    if math.prod(axes.values()) != world:
        raise ValueError(f"mesh {dict(axes)} does not match {world} devices (the world's processes)")
    if not dist.is_initialized():
        from notorch_tpu_torch.parallel.distributed import initialize

        initialize(device=device_type)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(axes.values()), mesh_dim_names=tuple(axes))
