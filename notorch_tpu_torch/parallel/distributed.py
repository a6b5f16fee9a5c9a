"""Process-group initialisation and the host-local data split.

Port of ``notorch_tpu.parallel.distributed``. Where the JAX package calls
``jax.distributed.initialize``, the port starts a ``torch.distributed``
process group: NCCL for the card, gloo for ``device="cpu"``, one process
per rank. Under ``torchrun`` (``python -m torch.distributed.run``) or any
launcher that sets ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``/
``MASTER_PORT``, every argument comes from the environment (``env://``);
``coordinator_address`` (``tcp://host:port`` or ``file:///path``) and
``store`` name the rendezvous explicitly. A single process with nothing of
that set is a world of one, rendezvousing on an in-process store.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from notorch_tpu_torch.utils import resolve_device

__all__ = ["initialize", "process_info", "host_local_slice", "launched"]


def launched() -> bool:
    """Whether a launcher set this process's rank (``torchrun`` does)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device | None = None,
    store=None,
) -> None:
    """Start the default process group once (a second call does nothing).

    ``device=None`` is the card (NCCL; raises where there is none), ``"cpu"``
    gloo. Rank and world size come from ``process_id``/``num_processes``,
    else ``RANK``/``WORLD_SIZE``. On the card each rank takes the card of
    its ``LOCAL_RANK`` (its rank where that is unset)."""
    if dist.is_initialized():
        return
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
    world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", 1))
    kwargs = {"rank": rank, "world_size": world}
    if store is not None:
        kwargs["store"] = store
    elif coordinator_address is not None:
        kwargs["init_method"] = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    elif "MASTER_ADDR" in os.environ:
        kwargs["init_method"] = "env://"
    elif world == 1:
        kwargs["store"] = dist.HashStore()
    else:
        raise ValueError(
            f"a world of {world} processes needs a rendezvous: run under torchrun, or pass "
            "coordinator_address (tcp://host:port, file:///path) or store"
        )
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, **kwargs)


def process_info() -> tuple[int, int]:
    """``(process_index, process_count)``: ``(0, 1)`` outside a process
    group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def host_local_slice(n_items: int) -> slice:
    """This process's contiguous share of a global per-step work list (the
    JAX package's arithmetic: the first ``n_items % count`` processes take
    one more)."""
    pid, pcount = process_info()
    per = n_items // pcount
    extra = n_items % pcount
    start = pid * per + min(pid, extra)
    return slice(start, start + per + (1 if pid < extra else 0))
