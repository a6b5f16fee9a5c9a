"""Pointwise modules for point clouds.

Port of ``notorch_tpu.nn.spatial.pointwise``: :class:`PointwiseEmbed`
(the sum of the node type ids' embeddings in ``dtype``, its table named
``node`` as there) and :class:`Pointwise` (lift a feature module onto
``P.node_feats``).
"""

from __future__ import annotations

import torch
from torch import nn

from notorch_tpu_torch.conf import DEFAULT_HIDDEN_DIM
from notorch_tpu_torch.data.point_cloud import BatchedPointCloud
from notorch_tpu_torch.nn.embed import EmbeddingBagSum
from notorch_tpu_torch.transforms.vocab import DEFAULT_NUM_ATOM_TYPES


class PointwiseEmbed(nn.Module):
    def __init__(self, num_types: int = DEFAULT_NUM_ATOM_TYPES, hidden_dim: int = DEFAULT_HIDDEN_DIM, dtype=None):
        super().__init__()
        self.node = EmbeddingBagSum(num_types, hidden_dim, dtype)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.node.reset_parameters(generator)

    def forward(self, P: BatchedPointCloud) -> BatchedPointCloud:
        return P.update(node_feats=self.node(P.node_feats))


class Pointwise(nn.Module):
    """Apply ``module`` to ``P.node_feats`` and return the updated cloud."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        if hasattr(self.module, "reset_parameters"):
            self.module.reset_parameters(generator)

    def forward(self, P: BatchedPointCloud) -> BatchedPointCloud:
        return P.update(node_feats=self.module(P.node_feats))
