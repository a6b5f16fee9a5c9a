"""Dual-rank (scalar, vector) feature containers for GVP-family models.

Port of ``notorch_tpu.data.gvp``: :class:`DualRankFeatures` (scalars
``[*b, ds]`` and vectors ``[*b, 3, dv]`` whose batch shapes must agree) and
:class:`GVPPointCloud` (a batched point cloud whose node features are
dual-rank). Dataclasses of tensors, moved with ``.to(device)``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

from notorch_tpu_torch.data.point_cloud import BatchedPointCloud


@dataclass
class DualRankFeatures:
    scalar: Any  # [*b, ds]
    vector: Any  # [*b, 3, dv]

    def __post_init__(self):
        s, v = self.scalar, self.vector
        if hasattr(s, "shape") and hasattr(v, "shape") and tuple(s.shape[:-1]) != tuple(v.shape[:-2]):
            raise ValueError(f"batch shapes disagree: scalar {tuple(s.shape[:-1])} vs vector {tuple(v.shape[:-2])}")

    @property
    def batch_shape(self) -> tuple:
        return tuple(self.scalar.shape[:-1])

    def astuple(self) -> tuple[Any, Any]:
        return self.scalar, self.vector

    def to(self, device) -> "DualRankFeatures":
        return DualRankFeatures(self.scalar.to(device), self.vector.to(device))


@dataclass
class GVPPointCloud:
    """A batched point cloud carrying dual-rank node features."""

    features: DualRankFeatures
    cloud: BatchedPointCloud

    def update(self, **kwargs) -> "GVPPointCloud":
        return dataclasses.replace(self, **kwargs)

    def to(self, device) -> "GVPPointCloud":
        return GVPPointCloud(self.features.to(device), self.cloud.to(device))
