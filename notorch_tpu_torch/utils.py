"""Small shared utilities."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. ``None`` means ``cuda``; asking for a card where there is none
    raises rather than running on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--cpu on the command "
            "line) to run the plain CPU path"
        )
    return device


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(dtype) -> torch.dtype:
    """The dtype a module computes in, from its ``dtype`` argument as the
    JAX modules take it (``None`` is float32; a name or a torch dtype):
    float32 or bfloat16. The parameters stay float32 either way, as flax's
    ``param_dtype``; anything else raises ``ValueError``."""
    if dtype is None:
        return torch.float32
    name = str(dtype).removeprefix("torch.")
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"dtype must be one of {sorted(COMPUTE_DTYPES)}, got {dtype!r}")
    return COMPUTE_DTYPES[name]

