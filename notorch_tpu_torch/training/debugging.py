"""Numerical debugging helpers.

Port of ``notorch_tpu.training.debugging``: :func:`debug_nans` (JAX's
``jax_debug_nans``: raise on the first NaN made), :func:`assert_finite`
and :func:`grad_norm`.
"""

from __future__ import annotations

import contextlib
from collections.abc import Mapping

import numpy as np
import torch

from notorch_tpu_torch.training.profiling import leaves


def _has_nan(x) -> bool:
    return any(bool(torch.isnan(t).any()) for t in leaves(x)
               if isinstance(t, torch.Tensor) and t.is_floating_point())


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise on the first NaN made inside a forward or a backward: a forward
    hook on every module raises ``FloatingPointError`` naming the module
    whose output holds a NaN, and autograd's anomaly detection raises
    ``RuntimeError`` naming the backward function that returned one. Each
    check reads the values to the host, so this is a debugging mode, not a
    training one. The previous anomaly-detection state is restored on
    exit; ``enable=False`` turns both off inside the block."""
    prev = torch.is_anomaly_enabled()
    prev_check = torch.is_anomaly_check_nan_enabled()
    handle = None
    if enable:

        def hook(module, args, output):
            if _has_nan(output):
                raise FloatingPointError(f"NaN in the output of {type(module).__name__}")

        handle = torch.nn.modules.module.register_module_forward_hook(hook)
    torch.autograd.set_detect_anomaly(enable, check_nan=True)
    try:
        yield
    finally:
        if handle is not None:
            handle.remove()
        torch.autograd.set_detect_anomaly(prev, check_nan=prev_check)


def _named(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``(path, leaf)`` of a module (parameter and buffer names) or of a
    nested mapping/sequence (JAX's ``keystr`` paths: ``['a'][0]``)."""
    if isinstance(tree, torch.nn.Module):
        return [*tree.named_parameters(), *tree.named_buffers()]
    if isinstance(tree, Mapping):
        return [item for k, v in tree.items() for item in _named(v, f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree) for item in _named(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def assert_finite(tree, name: str = "tree") -> None:
    """Host-side check that every floating array of ``tree`` (a module's
    parameters and buffers, or a nested structure of tensors and arrays) is
    finite; raises ``FloatingPointError`` naming the bad entries."""
    bad = []
    for path, leaf in _named(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            if not bool(torch.isfinite(leaf.detach()).all()):
                bad.append(path)
        elif isinstance(leaf, np.ndarray) and np.issubdtype(leaf.dtype, np.floating):
            if not np.isfinite(leaf).all():
                bad.append(path)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")


def grad_norm(grads) -> float:
    """Global L2 norm, in float32, of a module's gradients (``p.grad`` of
    its parameters) or of a nested structure of gradient tensors."""
    if isinstance(grads, torch.nn.Module):
        grads = [p.grad for p in grads.parameters() if p.grad is not None]
    sums = [torch.sum(g.detach().to(torch.float32) ** 2) for g in leaves(grads)
            if isinstance(g, torch.Tensor)]
    return float(torch.sqrt(sum(sums))) if sums else 0.0
