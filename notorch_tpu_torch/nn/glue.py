"""Tensor-plumbing modules, so that wiring itself can be written in model
configs.

Port of ``notorch_tpu.nn.glue``: ``Add``, ``Mul``, ``Cat``, ``Split``,
``MatMul``, ``Einsum``, ``Identity``, ``Residual`` and ``BatchNorm``, tiny
named modules for the key-space DAG.

``BatchNorm`` has flax's semantics, not ``nn.BatchNorm1d``'s: in training
it normalises by the batch's mean and its biased variance over every
leading axis (``E[x^2] - E[x]^2``, floored at 0, as flax's fast variance),
and moves the running averages as ``ra = momentum * ra + (1 - momentum) *
batch`` with ``momentum = 0.9`` (torch's ``momentum`` is the other weight);
in eval it normalises by the running averages. They are the buffers
``running_mean`` and ``running_var`` of its inner module (named
``batch_norm`` as the JAX module's inner ``BatchNorm_0``), so the
``state_dict``, a checkpoint and a resumed run carry them as the JAX
package's ``batch_stats`` collection. Under
:class:`~notorch_tpu_torch.parallel.dense_dp.DenseDataParallel` the
training statistics are the global batch's: the ranks' sums and counts are
summed over the data group inside the forward, as GSPMD computes them.
"""

from __future__ import annotations

from collections.abc import Sequence
from itertools import accumulate

import torch
from torch import nn

from notorch_tpu_torch.parallel.collectives import batch_stats_axis, psum

__all__ = ["Add", "Mul", "Cat", "Split", "MatMul", "Einsum", "Identity", "BatchNorm", "Residual"]


class Add(nn.Module):
    def forward(self, *inputs):
        out = inputs[0]
        for x in inputs[1:]:
            out = out + x
        return out


class Mul(nn.Module):
    def forward(self, *inputs):
        out = inputs[0]
        for x in inputs[1:]:
            out = out * x
        return out


class Cat(nn.Module):
    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, *inputs):
        return torch.cat(inputs, dim=self.axis)


class Split(nn.Module):
    def __init__(self, sizes: Sequence[int] = (), axis: int = -1):
        super().__init__()
        self.sizes, self.axis = list(sizes), axis

    def forward(self, x):
        # cut at the cumulative sizes but the last, as the JAX module does
        return torch.tensor_split(x, list(accumulate(self.sizes[:-1])), dim=self.axis)


class MatMul(nn.Module):
    def forward(self, a, b):
        return a @ b


class Einsum(nn.Module):
    def __init__(self, equation: str = "ij,jk->ik"):
        super().__init__()
        self.equation = equation

    def forward(self, *operands):
        return torch.einsum(self.equation, *operands)


class Identity(nn.Module):
    def forward(self, x):
        return x


class _FlaxBatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over the last axis: ``weight`` (flax's
    ``scale``), ``bias`` and the running averages."""

    def __init__(self, features: int, momentum: float, epsilon: float):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            rows = x.reshape(-1, x.shape[-1])
            axis = batch_stats_axis()
            if axis is None:
                mean = rows.mean(dim=0)
                var = ((rows * rows).mean(dim=0) - mean * mean).clamp_min(0.0)
            else:  # the global batch's, over the data group
                n = psum(rows.new_full((), float(rows.shape[0])), axis)
                mean = psum(rows.sum(dim=0), axis) / n
                var = (psum((rows * rows).sum(dim=0), axis) / n - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + self.epsilon) * self.weight + self.bias


class BatchNorm(nn.Module):
    """Feature normalisation for concat-readout heads (flax semantics; see
    the module docstring). ``features`` is the normalised width, which flax
    infers and the port is told."""

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.batch_norm = _FlaxBatchNorm(features, momentum, epsilon)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.batch_norm.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.batch_norm(x)


class Residual(nn.Module):
    """``x + module(x, ...)``."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        if hasattr(self.module, "reset_parameters"):
            self.module.reset_parameters(generator)

    def forward(self, *inputs):
        return inputs[0] + self.module(*inputs)
