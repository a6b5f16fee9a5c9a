"""Gaussian radial basis expansion of interatomic distances.

Port of ``notorch_tpu.nn.rbf.RBFEmbedding``: ``num_bases`` Gaussians with
centres evenly spaced over ``[start, cutoff]`` and width
``(cutoff - start) / num_bases``. No parameters.
"""

from __future__ import annotations

import torch
from torch import nn


class RBFEmbedding(nn.Module):
    def __init__(self, start: float = 0.0, cutoff: float = 5.0, num_bases: int = 16):
        super().__init__()
        self.start, self.cutoff, self.num_bases = start, cutoff, num_bases

    def forward(self, dists: torch.Tensor) -> torch.Tensor:
        """``[...]`` distances -> ``[..., num_bases]`` Gaussian features."""
        centers = torch.linspace(self.start, self.cutoff, self.num_bases, dtype=dists.dtype, device=dists.device)
        width = (self.cutoff - self.start) / self.num_bases
        diff = dists[..., None] - centers
        return torch.exp(-0.5 * (diff / width) ** 2)
