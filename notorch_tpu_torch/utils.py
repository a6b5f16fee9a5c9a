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


def require_f32(dtype, what: str) -> None:
    """Refuse a dtype other than float32 (``None`` is the default, float32):
    the port runs ``what`` in float32 only."""
    if dtype is not None and str(dtype).removeprefix("torch.") != "float32":
        raise NotImplementedError(f"dtype={dtype!r}: the port's {what} runs in float32")
