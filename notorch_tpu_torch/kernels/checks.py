"""The checks every kernel wrapper makes before it launches: which device
takes the kernel, and the dtype, shape, device, contiguity and alignment
of the tensors it is handed."""

from __future__ import annotations

import torch


def on_card(t: torch.Tensor) -> bool:
    """CPU tensors take the plain version; CUDA tensors the kernel; any
    other device is refused."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


def check_tensors(expect: dict, device: torch.device, anchor: str = "edge_hiddens") -> None:
    """``expect`` maps a name to ``(tensor, dtype, shape)``; every tensor must
    have them, lie on ``device`` (that of the tensor named ``anchor``) and be
    contiguous."""
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, {anchor} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_aligned(**tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(
                f"the CUDA kernels read {name} in 16-byte vectors; its storage must "
                "start 16-byte aligned (pass a fresh tensor, not an offset view)"
            )
