"""SchNet: continuous-filter convolutions over 3D point clouds.

Port of ``notorch_tpu.nn.spatial.schnet``:
:class:`ContinuousFilterConvolution` -> :class:`InteractionLayer` ->
:class:`SchnetBlock`. The neighbourhoods are the static-K radius lists of
:func:`~notorch_tpu_torch.nn.spatial.neighbors.radius_neighbors`, built
once a block (coordinates do not change through the stack), and the sum
over a neighbourhood is a masked dense reduction over the K axis.

The neighbour gather goes through :func:`~notorch_tpu_torch.nn.ops.take`:
on the card its backward is the row-pointer segment sum (TPU kernel row 8)
over the stable sort of the neighbour ids, each node's terms added in
ascending order, so a run repeats bit for bit (``x[idx]``'s backward adds
by float atomics).

Parameters keep the JAX names: ``interaction_{i}`` holding ``in_proj``,
``cfconv`` (``filter_0``, ``filter_1``), ``out_proj_0`` and ``out_proj_1``.

``dtype`` (float32 or bfloat16) is every dense layer's compute dtype, as
flax's ``Dense(dtype=...)`` (:class:`~notorch_tpu_torch.nn.init.Dense`:
f32 parameters, the product rounded); the RBF expansion stays f32 and is
rounded by the filter's first layer, as in JAX. At bf16 the neighbour
gather's backward is the ordered bf16 sum (TPU kernel row 8b on the card),
as XLA's bf16 scatter-add.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from notorch_tpu_torch.conf import DEFAULT_HIDDEN_DIM
from notorch_tpu_torch.data.point_cloud import BatchedPointCloud
from notorch_tpu_torch.nn.init import dense, reset_module_
from notorch_tpu_torch.nn.ops import take
from notorch_tpu_torch.nn.rbf import RBFEmbedding
from notorch_tpu_torch.nn.spatial.neighbors import radius_neighbors


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x) - log 2`` as JAX's ``logaddexp(x, 0) - log(2)``
    (``F.softplus`` switches to ``x`` above its threshold of 20, which
    rounds differently). Below f32 it takes ``lax.logaddexp``'s steps,
    ``max(x, 0) + log1p(exp(-|x|))``, each rounded to the dtype as XLA rounds
    them (``torch.logaddexp`` rounds once)."""
    zero = x.new_zeros(())
    if x.dtype == torch.float32:
        return torch.logaddexp(x, zero) - math.log(2.0)
    out = torch.maximum(x, zero) + torch.log1p(torch.exp(-(x - zero).abs()))
    return torch.where(torch.isnan(x), x, out) - math.log(2.0)


class ContinuousFilterConvolution(nn.Module):
    """``sum_j W(r_ij) * h_j`` over each node's neighbourhood: the filter
    ``W`` is two dense layers (``filter_0``, ``filter_1``, each followed by
    ``act``) over the RBF expansion of the neighbour distances.
    ``neighbor_window`` is the banded neighbour search, valid when every
    cloud has at most ``window + 1`` atoms."""

    def __init__(self, hidden_dim: int = DEFAULT_HIDDEN_DIM, radius: float = 5.0, max_neighbors: int = 32,
                 num_bases: int = 16, act: Callable = shifted_softplus, dtype=None,
                 neighbor_window: int | None = None):
        super().__init__()
        self.radius, self.max_neighbors, self.neighbor_window = radius, max_neighbors, neighbor_window
        self.act = act
        self.rbf = RBFEmbedding(0.0, radius, num_bases)
        self.filter_0 = dense(num_bases, hidden_dim, dtype=dtype)
        self.filter_1 = dense(hidden_dim, hidden_dim, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        reset_module_(self, generator)

    def forward(self, node_feats: torch.Tensor, P: BatchedPointCloud, neighbors: tuple | None = None) -> torch.Tensor:
        """``node_feats [N, d]`` -> ``[N, d]``; ``neighbors`` is a
        precomputed ``(nbrs, mask, dists)`` (the block builds one for all
        its layers)."""
        if neighbors is None:
            neighbors = radius_neighbors(P.coords, P.batch_index, self.radius, self.max_neighbors,
                                         window=self.neighbor_window)
        nbrs, mask, dists = neighbors
        W = self.act(self.filter_1(self.act(self.filter_0(self.rbf(dists)))))  # [N, K, d]
        neighbor_feats = take(node_feats, nbrs)  # [N, K, d]
        return (W * neighbor_feats * mask[..., None].to(node_feats.dtype)).sum(dim=1)


class InteractionLayer(nn.Module):
    """atom-wise ``in_proj`` -> CFConv -> ``out_proj_0`` -> act ->
    ``out_proj_1``, over ``hidden_dim``-wide node features (the block's
    residual keeps them so)."""

    def __init__(self, hidden_dim: int = DEFAULT_HIDDEN_DIM, radius: float = 5.0, max_neighbors: int = 32,
                 num_bases: int = 16, act: Callable = shifted_softplus, dtype=None,
                 neighbor_window: int | None = None):
        super().__init__()
        self.act = act
        self.in_proj = dense(hidden_dim, hidden_dim, dtype=dtype)
        self.cfconv = ContinuousFilterConvolution(hidden_dim, radius, max_neighbors, num_bases, act, dtype,
                                                  neighbor_window=neighbor_window)
        self.out_proj_0 = dense(hidden_dim, hidden_dim, dtype=dtype)
        self.out_proj_1 = dense(hidden_dim, hidden_dim, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        reset_module_(self, generator)

    def forward(self, node_feats: torch.Tensor, P: BatchedPointCloud, neighbors: tuple | None = None) -> torch.Tensor:
        h = self.cfconv(self.in_proj(node_feats), P, neighbors=neighbors)
        return self.out_proj_1(self.act(self.out_proj_0(h)))


class SchnetBlock(nn.Module):
    """``depth`` residual interaction layers over a point cloud whose node
    features are ``hidden_dim`` wide, with one neighbour search for all of
    them."""

    def __init__(self, hidden_dim: int = DEFAULT_HIDDEN_DIM, depth: int = 3, radius: float = 5.0,
                 max_neighbors: int = 32, num_bases: int = 16, act: Callable = shifted_softplus, dtype=None,
                 neighbor_window: int | None = None):
        super().__init__()
        self.depth, self.radius, self.max_neighbors = depth, radius, max_neighbors
        self.neighbor_window = neighbor_window
        for i in range(depth):
            self.add_module(f"interaction_{i}", InteractionLayer(hidden_dim, radius, max_neighbors, num_bases, act,
                                                                 dtype, neighbor_window=neighbor_window))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        reset_module_(self, generator)

    def forward(self, P: BatchedPointCloud) -> BatchedPointCloud:
        node_feats = P.node_feats
        neighbors = radius_neighbors(P.coords, P.batch_index, self.radius, self.max_neighbors,
                                     window=self.neighbor_window)
        for i in range(self.depth):
            node_feats = node_feats + getattr(self, f"interaction_{i}")(node_feats, P, neighbors=neighbors)
        return P.update(node_feats=node_feats)
