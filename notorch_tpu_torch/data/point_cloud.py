"""Point-cloud data model: 3D molecular systems.

Port of ``notorch_tpu.data.point_cloud``: :class:`PointCloud` (node type
ids and coordinates) and its batched form, a padded static-shape batch
like :class:`~notorch_tpu_torch.data.graph.BatchedGraph`. The neighbour
topology is not stored: it is recomputed each forward pass under a fixed
max-degree budget (:mod:`notorch_tpu_torch.nn.spatial.neighbors`).

Also here, for the spatial models' runs on synthetic data: the JAX
package's synthetic clouds (``scripts/bench_spatial.py`` ``make_clouds``:
10-25 atoms per cloud in a cube of side ``(8 n)^(1/3)`` angstrom, types
0-8), their geometric target (the mean coordination number within 2
angstrom, as ``tests/test_spatial.py`` trains on) and the batches a
``fit``/``predict`` loop takes.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

__all__ = ["PointCloud", "BatchedPointCloud", "pad_point_clouds", "make_clouds", "coordination_targets",
           "cloud_batches"]


@dataclass
class PointCloud:
    node_types: np.ndarray  # [N, t] int32
    coords: np.ndarray  # [N, 3] float32

    @property
    def num_nodes(self) -> int:
        return len(self.node_types)


@dataclass
class BatchedPointCloud:
    """A padded batch of clouds. Fields are numpy arrays as
    :func:`pad_point_clouds` gives them, or tensors after :meth:`to`;
    ``node_feats`` starts as type ids and becomes float hiddens as the
    model runs (:meth:`update`)."""

    node_feats: Any  # [N_cap, t] ints or [N_cap, d] floats
    coords: Any  # [N_cap, 3]
    batch_index: Any  # [N_cap] i32, padding -> n_graphs
    node_mask: Any  # [N_cap] bool
    num_graphs_real: Any  # [] i32
    n_graphs: int = 1

    _ARRAYS = ("node_feats", "coords", "batch_index", "node_mask", "num_graphs_real")

    @property
    def num_nodes(self) -> int:
        return self.node_feats.shape[0]

    def __len__(self) -> int:
        return self.n_graphs

    def update(self, **kwargs) -> "BatchedPointCloud":
        return dataclasses.replace(self, **kwargs)

    def to(self, device) -> "BatchedPointCloud":
        """Every array field on ``device`` (numpy fields become tensors)."""

        def move(x):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(np.ascontiguousarray(x))
            return x.to(device)

        return self.update(**{k: move(getattr(self, k)) for k in self._ARRAYS})


def pad_point_clouds(clouds: Iterable[PointCloud], node_cap: int, graph_cap: int | None = None) -> BatchedPointCloud:
    """Lay the clouds' atoms out contiguously in ``node_cap`` slots (numpy
    fields): padding coordinates at 1e9, so no padding point falls inside
    any radius, and padding ``batch_index = graph_cap``."""
    clouds = list(clouds)
    n = len(clouds)
    graph_cap = graph_cap if graph_cap is not None else n
    total = sum(c.num_nodes for c in clouds)
    if total > node_cap:
        raise ValueError(f"{total} points exceed node_cap={node_cap}")
    t = clouds[0].node_types.shape[1] if clouds else 1
    node_types = np.zeros((node_cap, t), dtype=np.int32)
    coords = np.full((node_cap, 3), 1e9, dtype=np.float32)
    batch_index = np.full(node_cap, graph_cap, dtype=np.int32)
    mask = np.zeros(node_cap, dtype=bool)
    off = 0
    for i, c in enumerate(clouds):
        size = c.num_nodes
        node_types[off: off + size] = c.node_types
        coords[off: off + size] = c.coords
        batch_index[off: off + size] = i
        mask[off: off + size] = True
        off += size
    return BatchedPointCloud(node_feats=node_types, coords=coords, batch_index=batch_index, node_mask=mask,
                             num_graphs_real=np.asarray(n, dtype=np.int32), n_graphs=graph_cap)


def make_clouds(n_clouds: int, seed: int = 0, max_atoms: int = 25) -> list[PointCloud]:
    """Synthetic clouds at about a molecule's density, drawn as the JAX
    package's ``scripts/bench_spatial.py`` ``make_clouds`` draws them: per
    cloud ``n`` in ``[10, max_atoms]``, coordinates uniform in a cube of
    side ``(8 n)^(1/3)``, then types ``[n, 1]`` in 0-8."""
    rng = np.random.default_rng(seed)
    clouds = []
    for _ in range(n_clouds):
        n = int(rng.integers(10, max_atoms + 1))
        coords = rng.uniform(0, (n * 8.0) ** (1.0 / 3.0), size=(n, 3)).astype(np.float32)
        types = rng.integers(0, 9, size=(n, 1)).astype(np.int32)
        clouds.append(PointCloud(types, coords))
    return clouds


def coordination_targets(clouds: list[PointCloud]) -> np.ndarray:
    """``[n_clouds, 1]`` float32: each cloud's mean number of other atoms
    within 2 angstrom."""
    ys = []
    for c in clouds:
        d = np.linalg.norm(c.coords[:, None] - c.coords[None, :], axis=-1)
        ys.append(((d < 2.0).sum(1) - 1).mean())
    return np.asarray(ys, dtype=np.float32)[:, None]


def cloud_batches(clouds: list[PointCloud], targets: np.ndarray | None = None, batch_size: int = 64) -> list[dict]:
    """Consecutive batches of ``batch_size`` clouds (the last may hold
    fewer), each padded by :func:`pad_point_clouds` to the least multiple
    of 64 node slots that holds it (what ``GvpConv(impl="fused")`` takes)
    and to ``batch_size`` graph slots: ``{"inputs.P"}`` and, with
    ``targets``, ``targets.y`` and its mask (padding graph slots masked)."""
    batches = []
    for start in range(0, len(clouds), batch_size):
        part = clouds[start: start + batch_size]
        atoms = sum(c.num_nodes for c in part)
        cap = max(64, -(-atoms // 64) * 64)
        batch = {"inputs.P": pad_point_clouds(part, cap, graph_cap=batch_size)}
        if targets is not None:
            y = np.zeros((batch_size, targets.shape[1]), dtype=np.float32)
            y[: len(part)] = targets[start: start + batch_size]
            mask = np.zeros(y.shape, dtype=bool)
            mask[: len(part)] = True
            batch["targets.y"], batch["targets.y_mask"] = y, mask
        batches.append(batch)
    return batches
