"""Geometric Vector Perceptrons (GVP) and the GVP graph stack.

Port of ``notorch_tpu.nn.spatial.gvp``. Dual-rank features are a
``(scalars [N, ds], vectors [N, 3, dv])`` tuple.

- :class:`GVP`, :class:`GatedGVP`: rotation-equivariant (scalar, vector)
  transforms;
- :class:`DualRankLayerNorm`, :class:`DualRankDropout` (rate 0 only),
  :class:`DualRankAggregation`;
- :class:`GvpConv`: static-K radius neighbourhoods -> RBF and unit-vector
  edge features -> three GatedGVP message layers -> masked neighbourhood
  mean -> residual and LayerNorm. ``impl="fused"`` runs the message stack
  and the mean through :class:`~notorch_tpu_torch.kernels.gvp_conv.
  FusedGvpConvFn` (the kernels of ``csrc/gvp_conv.cu`` on the card);
  ``"auto"`` means ``"jnp"``, plain tensor ops, as in the JAX package;
- :class:`GvpGNNLayer`, :class:`GvpGNNBlock`: conv and update stacks, with
  one neighbour build for the whole depth.

flax infers a layer's input widths at its first call; the port is told
them. :class:`GvpGNNBlock` takes ``input_dim`` for ``in_proj`` (default
``scalar_dim``) and :class:`GVP`/:class:`GatedGVP` their input widths.
Parameters keep the JAX names (``W_h``, ``W_mu``, ``W_m``, ``W_g``,
``scalar_ln``, ``message_i``, ``update_i``, ``layer_i``, ``in_proj``); the
fused and plain impls share one tree.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from notorch_tpu_torch.data.point_cloud import BatchedPointCloud
from notorch_tpu_torch.kernels.gvp_conv import fused_gvp_conv, split_gvp_weights
from notorch_tpu_torch.nn.init import dense, reset_dense_
from notorch_tpu_torch.nn.ops import segment_mean, segment_sum
from notorch_tpu_torch.nn.rbf import RBFEmbedding
from notorch_tpu_torch.nn.spatial.neighbors import radius_neighbors
from notorch_tpu_torch.utils import require_f32

EPS = 1e-8
IMPLS = ("auto", "fused", "jnp")


def _norm(v: torch.Tensor, axis: int = -2, keepdims: bool = False) -> torch.Tensor:
    return torch.sqrt((v**2).sum(dim=axis, keepdim=keepdims) + EPS)


def _reset_all(module: nn.Module, generator: torch.Generator | None) -> None:
    """flax's defaults for every dense layer (lecun-normal kernel, zero
    bias) and LayerNorm (unit scale, zero bias) below ``module``."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            reset_dense_(m, generator)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


def _no_bias_dense(in_features: int, out_features: int) -> nn.Linear:
    return nn.Linear(in_features, out_features, bias=False, device="meta").to_empty(device="cpu")


class GVP(nn.Module):
    """Plain geometric vector perceptron: the scalars' update sees the
    hidden vectors' norms (ReLU); the vectors are mixed channel-wise and
    gated by ``vector_act`` of their new norms. The hidden vector width is
    ``max(in_vector, out_vector)``, the JAX default."""

    def __init__(self, in_scalar: int, in_vector: int, out_scalar: int, out_vector: int,
                 vector_act: Callable | None = torch.sigmoid):
        super().__init__()
        h = max(in_vector, out_vector)
        self.W_h = _no_bias_dense(in_vector, h)
        self.W_mu = _no_bias_dense(h, out_vector)
        self.W_m = dense(in_scalar + h, out_scalar)
        self.vector_act = vector_act

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        _reset_all(self, generator)

    def forward(self, sv: tuple[torch.Tensor, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        s, v = sv  # [*, ds], [*, 3, dv]
        v_h = self.W_h(v)
        v_mu = self.W_mu(v_h)
        s_out = torch.relu(self.W_m(torch.cat([s, _norm(v_h)], dim=-1)))
        if self.vector_act is not None:
            v_mu = v_mu * self.vector_act(_norm(v_mu, keepdims=True))
        return s_out, v_mu


class GatedGVP(nn.Module):
    """Gated GVP: the vector gate comes from the scalar path's
    pre-activation (``W_g``)."""

    def __init__(self, in_scalar: int, in_vector: int, out_scalar: int, out_vector: int,
                 vector_act: Callable | None = torch.sigmoid):
        super().__init__()
        h = max(in_vector, out_vector)
        self.W_h = _no_bias_dense(in_vector, h)
        self.W_mu = _no_bias_dense(h, out_vector)
        self.W_m = dense(in_scalar + h, out_scalar)
        self.W_g = dense(out_scalar, out_vector)
        self.vector_act = vector_act

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        _reset_all(self, generator)

    def forward(self, sv: tuple[torch.Tensor, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        s, v = sv
        v_h = self.W_h(v)
        v_mu = self.W_mu(v_h)
        s_mid = self.W_m(torch.cat([s, _norm(v_h)], dim=-1))
        gate = self.W_g(s_mid)
        if self.vector_act is not None:
            gate = self.vector_act(gate)
        return torch.relu(s_mid), v_mu * gate[..., None, :]

    def kernel_params(self) -> dict:
        """The flax-shaped tree (kernels ``[in, out]``) the fused kernels'
        :func:`~notorch_tpu_torch.kernels.gvp_conv.split_gvp_weights` takes;
        views of this layer's parameters, so gradients reach them."""
        return {"W_h": {"kernel": self.W_h.weight.t()}, "W_mu": {"kernel": self.W_mu.weight.t()},
                "W_m": {"kernel": self.W_m.weight.t(), "bias": self.W_m.bias},
                "W_g": {"kernel": self.W_g.weight.t(), "bias": self.W_g.bias}}


class DualRankLayerNorm(nn.Module):
    """LayerNorm of the scalars (flax's epsilon 1e-6), RMS normalisation of
    the vectors' norms (rotation-safe)."""

    def __init__(self, scalar_dim: int):
        super().__init__()
        self.scalar_ln = nn.LayerNorm(scalar_dim, eps=1e-6)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        _reset_all(self, generator)

    def forward(self, sv):
        s, v = sv
        norms2 = (v**2).sum(dim=-2, keepdim=True)  # [*, 1, dv]
        rms = torch.sqrt(norms2.mean(dim=-1, keepdim=True) + EPS)
        return self.scalar_ln(s), v / rms


class DualRankDropout(nn.Module):
    """Rotation-safe dropout at rate 0 (the identity)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        if rate > 0.0:
            raise NotImplementedError(
                f"dropout rate {rate}: dual-rank dropout above 0 comes with the non-default numerics "
                "slice of the port (ROADMAP.md queue A item 5)"
            )
        self.rate = rate

    def forward(self, sv):
        return sv


class DualRankAggregation(nn.Module):
    """Per-cloud segment mean (or sum) of scalars and vectors over
    ``batch_index``."""

    def __init__(self, reduce: str = "mean"):
        super().__init__()
        self.reduce = reduce

    def forward(self, sv, P: BatchedPointCloud):
        fn = segment_mean if self.reduce == "mean" else segment_sum
        s, v = sv
        n = P.n_graphs + 1
        return fn(s, P.batch_index, n)[: P.n_graphs], fn(v, P.batch_index, n)[: P.n_graphs]


def nbr_take(x: torch.Tensor, nbrs: torch.Tensor) -> torch.Tensor:
    """The neighbour gather ``x[nbrs]`` (``[N, ...]`` x ``[N, K]`` ->
    ``[N, K, ...]``) of the JAX ``_nbr_take``; its backward is autograd's
    scatter-add, the exact VJP that the JAX one-hot contraction computes.
    ``index_select``, not ``x[idx]``: on the CPU the latter's backward adds
    by float atomics across threads, so its bits change from run to run;
    ``index_select``'s adds each row's terms in ascending order."""
    return x.index_select(0, nbrs.reshape(-1).long()).reshape(*nbrs.shape, *x.shape[1:])


class GvpConv(nn.Module):
    """GVP message passing over static-K radius neighbourhoods.

    ``impl``: ``"fused"`` runs the message stack (the gather, three GatedGVP
    layers and the masked mean) through :class:`~notorch_tpu_torch.kernels.
    gvp_conv.FusedGvpConvFn`; it needs ``neighbor_window`` set, dropout 0,
    three message GVPs, float32 and a node count divisible by 64, and rounds
    the window up to a multiple of 8 for the kernels' band. ``"auto"``
    means ``"jnp"``: plain tensor ops."""

    def __init__(self, scalar_dim: int, vector_dim: int, radius: float = 5.0, max_neighbors: int = 16,
                 num_bases: int = 16, num_message_gvps: int = 3, dropout: float = 0.0, dtype=None,
                 neighbor_window: int | None = None, impl: str = "auto"):
        super().__init__()
        require_f32(dtype, "GVP stack")
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.scalar_dim, self.vector_dim = scalar_dim, vector_dim
        self.radius, self.max_neighbors, self.num_bases = radius, max_neighbors, num_bases
        self.num_message_gvps, self.dropout_rate = num_message_gvps, dropout
        self.neighbor_window, self.impl = neighbor_window, impl
        ds, dv = scalar_dim, vector_dim
        self.rbf = RBFEmbedding(0.0, radius, num_bases)
        for i in range(num_message_gvps):
            last = i == num_message_gvps - 1
            in_s, in_v = (2 * ds + num_bases, 2 * dv + 1) if i == 0 else (ds, dv)
            self.add_module(f"message_{i}", GatedGVP(in_s, in_v, ds, dv, vector_act=None if last else torch.sigmoid))
        self.dropout = DualRankDropout(dropout)
        self.ln = DualRankLayerNorm(ds)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        _reset_all(self, generator)

    def _use_fused(self, N: int) -> bool:
        if self.impl != "fused":
            return False
        ok = (self.neighbor_window is not None and self.dropout_rate == 0.0 and self.num_message_gvps == 3
              and N % 64 == 0)
        if not ok:
            raise ValueError(
                "impl='fused' needs neighbor_window set, dropout=0, num_message_gvps=3, f32, and a node count "
                "divisible by 64"
            )
        return True

    def forward(self, sv, P: BatchedPointCloud, neighbors: tuple | None = None):
        s, v = sv  # [N, ds], [N, 3, dv]
        N = s.shape[0]
        fused = self._use_fused(N)
        window = self.neighbor_window
        if fused and window % 8 != 0:
            window = -(-window // 8) * 8  # the kernels' band is a multiple of 8
        if neighbors is not None:
            nbrs, mask, dists = neighbors
        else:
            nbrs, mask, dists = radius_neighbors(P.coords, P.batch_index, self.radius, self.max_neighbors,
                                                 window=window)
        rbf = self.rbf(dists)  # [N, K, nb]
        disp = P.coords[nbrs.long()] - P.coords[:, None, :]
        unit = disp / _norm(disp, axis=-1, keepdims=True)  # [N, K, 3]

        if fused:
            ds, dv, nb = self.scalar_dim, self.vector_dim, self.num_bases
            tree = {f"message_{i}": getattr(self, f"message_{i}").kernel_params() for i in range(3)}
            K = nbrs.shape[-1]
            agg_s, avx, avy, avz = fused_gvp_conv(
                s, v[:, 0, :], v[:, 1, :], v[:, 2, :], nbrs, mask, rbf.reshape(N * K, nb),
                unit[..., 0].reshape(N * K, 1), unit[..., 1].reshape(N * K, 1), unit[..., 2].reshape(N * K, 1),
                split_gvp_weights(tree, ds, dv, nb), int(window), 64, False)
            return self.ln((s + agg_s, v + torch.stack([avx, avy, avz], dim=1)))

        s_j, v_j = nbr_take(s, nbrs), nbr_take(v, nbrs)  # [N, K, ds], [N, K, 3, dv]
        s_in = torch.cat([s[:, None].expand_as(s_j), s_j, rbf], dim=-1)
        v_in = torch.cat([v[:, None].expand_as(v_j), v_j, unit[..., None]], dim=-1)
        msg = (s_in, v_in)
        for i in range(self.num_message_gvps):
            msg = getattr(self, f"message_{i}")(msg)
        ms, mv = self.dropout(msg)
        fmask = mask[..., None].to(ms.dtype)
        denom = torch.clamp_min(mask.sum(dim=1), 1)[:, None].to(ms.dtype)
        agg_s = (ms * fmask).sum(dim=1) / denom
        agg_v = (mv * fmask[..., None, :]).sum(dim=1) / denom[..., None]
        return self.ln((s + agg_s, v + agg_v))


class GvpGNNLayer(nn.Module):
    """conv, then ``num_update_gvps`` pointwise GatedGVPs with a residual
    and LayerNorm."""

    def __init__(self, scalar_dim: int, vector_dim: int, radius: float = 5.0, max_neighbors: int = 16,
                 num_update_gvps: int = 2, dropout: float = 0.0, dtype=None, neighbor_window: int | None = None,
                 impl: str = "auto"):
        super().__init__()
        self.conv = GvpConv(scalar_dim, vector_dim, radius, max_neighbors, dropout=dropout, dtype=dtype,
                            neighbor_window=neighbor_window, impl=impl)
        self.num_update_gvps = num_update_gvps
        for i in range(num_update_gvps):
            self.add_module(f"update_{i}", GatedGVP(scalar_dim, vector_dim, scalar_dim, vector_dim))
        self.dropout = DualRankDropout(dropout)
        self.ln = DualRankLayerNorm(scalar_dim)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        _reset_all(self, generator)

    def forward(self, sv, P: BatchedPointCloud, neighbors: tuple | None = None):
        s, v = self.conv(sv, P, neighbors=neighbors)
        upd = (s, v)
        for i in range(self.num_update_gvps):
            upd = getattr(self, f"update_{i}")(upd)
        us, uv = self.dropout(upd)
        return self.ln((s + us, v + uv))


class GvpGNNBlock(nn.Module):
    """``depth`` GVP layers over a point cloud: ``in_proj`` (from
    ``input_dim``, default ``scalar_dim``) makes the scalars, the vectors
    start at zero, and one neighbour build serves every layer (coordinates
    do not change through the stack)."""

    def __init__(self, scalar_dim: int = 128, vector_dim: int = 16, depth: int = 3, radius: float = 5.0,
                 max_neighbors: int = 16, dropout: float = 0.0, dtype=None, neighbor_window: int | None = None,
                 impl: str = "auto", input_dim: int | None = None):
        super().__init__()
        self.scalar_dim, self.vector_dim, self.depth = scalar_dim, vector_dim, depth
        self.radius, self.max_neighbors, self.neighbor_window = radius, max_neighbors, neighbor_window
        self.in_proj = dense(input_dim or scalar_dim, scalar_dim)
        for i in range(depth):
            self.add_module(f"layer_{i}", GvpGNNLayer(scalar_dim, vector_dim, radius, max_neighbors, dropout=dropout,
                                                      dtype=dtype, neighbor_window=neighbor_window, impl=impl))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        _reset_all(self, generator)

    def forward(self, P: BatchedPointCloud) -> BatchedPointCloud:
        s = self.in_proj(P.node_feats)
        v = s.new_zeros(s.shape[:-1] + (3, self.vector_dim))
        neighbors = radius_neighbors(P.coords, P.batch_index, self.radius, self.max_neighbors,
                                     window=self.neighbor_window)
        sv = (s, v)
        for i in range(self.depth):
            sv = getattr(self, f"layer_{i}")(sv, P, neighbors=neighbors)
        return P.update(node_feats=sv[0])
