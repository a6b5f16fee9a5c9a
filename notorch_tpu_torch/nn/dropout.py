"""Dropout with flax's semantics and masks that are the same on every device.

:class:`Dropout` is ``flax.linen.Dropout`` as the JAX package uses it: at
rate 0 or out of training mode the identity, at rate 1 zeros, otherwise
``where(mask, x / keep, 0)`` with ``keep = 1 - rate`` (a division, as flax
computes it, not a multiplication by ``1 / keep``), each element kept with
probability ``keep``.

Masks come from the module's own ``torch.Generator`` (seeded from the
parameter generator in ``reset_parameters``), so a model's training state
carries them (:meth:`~notorch_tpu_torch.model.model.Model.generators`) and a
resumed run draws the masks an uninterrupted one would. A call draws one
62-bit seed from that generator on the host and forms the mask on the
tensor's own device with integer tensor ops: element ``i`` is kept where
``hash(seed, i) < keep * 2**32``, ``hash`` a counter hash over 32-bit words
(:func:`keep_mask`). Integer ops give the same bits on the CPU and on the
card, so a card run and a CPU run from one seed drop the same elements, and
no mask crosses the bus. A module at rate 0 has no generator and draws
nothing, not even from the parameter generator, so adding it to a model
leaves the model's weights as they were.

:class:`Dropout` is the single dropout of the port: the MLP head, the flat
and plain dense D-MPNN blocks, the attention blocks and, through
:class:`~notorch_tpu_torch.nn.spatial.gvp.DualRankDropout`, the GVP layers.
"""

from __future__ import annotations

from collections.abc import Sequence
from math import prod

import torch
from torch import nn

_WORD = 0xFFFFFFFF
# odd multipliers below 2**31: a 32-bit word times one stays below 2**63, so
# the int64 products never overflow on any device
_MIX = (0x7FEB352D, 0x2C1B3C6D, 0x297A2D39, 0x3B9AC9F9)


def _mix32(x: torch.Tensor, m1: int, m2: int) -> torch.Tensor:
    """A bijective mix of the 32-bit words in ``x`` (int64 holding values
    below ``2**32``), in place."""
    x ^= x >> 16
    x.mul_(m1).bitwise_and_(_WORD)
    x ^= x >> 15
    x.mul_(m2).bitwise_and_(_WORD)
    x ^= x >> 16
    return x


def keep_mask(seed: int, shape: Sequence[int], keep: float, device) -> torch.Tensor:
    """The boolean mask of ``shape`` that keeps element ``i`` (in row-major
    order) where ``hash(seed, i) < keep * 2**32``: two rounds of
    :func:`_mix32`, the low word of ``seed`` folded in before the first and
    the high word before the second. Same bits on every device."""
    n = prod(shape)
    if n >= 2**32:
        raise ValueError(f"a dropout mask holds fewer than 2**32 elements, got {n}")
    x = torch.arange(n, dtype=torch.int64, device=device)
    x ^= seed & _WORD
    x = _mix32(x, _MIX[0], _MIX[1])
    x ^= (seed >> 32) & _WORD
    x = _mix32(x, _MIX[2], _MIX[3])
    return (x < int(keep * 2**32)).reshape(tuple(shape))


class Dropout(nn.Module):
    """flax's ``Dropout(rate)`` on the module's training flag (see the module
    docstring). :meth:`mask` draws the keep mask of a shape."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"dropout rate must be in [0, 1], got {rate}")
        self.rate = float(rate)
        self.generator = torch.Generator() if self.rate > 0.0 else None

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Seed the mask stream from ``generator`` (nothing at rate 0)."""
        if self.generator is not None:
            self.generator.manual_seed(int(torch.randint(0, 2**62, (), generator=generator)))

    def mask(self, shape: Sequence[int], device) -> torch.Tensor:
        """The keep mask of ``shape`` on ``device``: one seed drawn from the
        module's generator, the mask formed on ``device``."""
        seed = int(torch.randint(0, 2**62, (), generator=self.generator))
        return keep_mask(seed, shape, 1.0 - self.rate, device)

    def apply_mask(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``where(mask, x / keep, 0)``, ``mask`` broadcast to ``x``. The
        divisor is a 0-dim tensor on ``x``'s device, so the card divides as
        the CPU does (a host scalar would become a multiplication by its
        reciprocal there)."""
        keep = torch.full((), 1.0 - self.rate, dtype=x.dtype, device=x.device)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))

    def active(self) -> bool:
        """Whether a call draws a mask: training mode and a rate in (0, 1)."""
        return self.training and 0.0 < self.rate < 1.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        return self.apply_mask(x, self.mask(x.shape, x.device))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
