"""Edge-restricted self-attention over the dense per-molecule and bin-packed
layouts.

Port of ``notorch_tpu.nn.attention_dense``:

- :class:`EdgeBiasScatterFn` and :class:`MaskedSoftmaxFn`, the JAX custom
  VJPs (the factored bias-scatter backward and the textbook masked-softmax
  backward) as ``autograd.Function``s in plain tensor ops;
- :class:`DenseGraphSelfAttention` (``impl`` jnp, fused or auto; the fused
  core is :class:`~notorch_tpu_torch.kernels.dense_attention.
  FusedDenseAttentionFn`, whose backward is the hand-written kernel and whose
  forward is the kernel with ``fwd_impl="pallas"``), :class:`DenseGATBlock`
  and :class:`DenseGATv2Layer`.

The parameters are ``nn.Linear`` layers under the JAX names (``W_q``,
``W_k``, ``W_v``, ``W_o``, ``W_bias``; ``W_src``, ``W_dst``, ``W_e`` and the
per-head score ``a`` ``[dh -> 1]``; ``in_proj``, ``attn_<i>``,
``ffn_<i>_<j>``), which :mod:`notorch_tpu_torch.model.convert` maps to and
from the JAX tree. flax infers a layer's input width at its first call;
here it is given: ``hidden_dim`` for the layers' inputs, ``edge_dim``
(default ``hidden_dim``) for the edge features, and the blocks'
``input_dim`` (default ``hidden_dim``) for ``in_proj``, which is also the
width of the edge features they pass on. The blocks' ``dropout`` is one
:class:`~notorch_tpu_torch.nn.dropout.Dropout` applied twice a layer, to
the attention output and to the feed-forward output, as in the JAX blocks.
``dtype`` (float32 or bfloat16) is every layer's compute dtype, as in the
JAX modules: each dense layer is flax's ``Dense(dtype=...)``
(:class:`~notorch_tpu_torch.nn.init.Dense`, f32 parameters), the one-hot
operators, scores and softmax follow the data's dtype, and the fused core
takes bf16 q, k, v and bias (TPU kernel rows 12b and 13b); ``interpret`` is
accepted for the JAX signature (see
:mod:`notorch_tpu_torch.kernels.dense_attention`).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from notorch_tpu_torch.conf import DEFAULT_HIDDEN_DIM
from notorch_tpu_torch.data.dense import DenseBatchedGraph
from notorch_tpu_torch.kernels.dense_attention import FWD_IMPLS, fused_dense_attention
from notorch_tpu_torch.nn.dropout import Dropout
from notorch_tpu_torch.nn.init import dense, reset_dense_
from notorch_tpu_torch.nn.ops import scalar
from notorch_tpu_torch.utils import compute_dtype

ATTENTIONS = ("sdp", "gatv2")
IMPLS = ("jnp", "fused", "auto")
BIAS_IMPLS = ("auto", "two_step", "factored_vjp", "einsum3")


class EdgeBiasScatterFn(torch.autograd.Function):
    """``bias[b,h,i,j] = sum_e S[b,i,e] eb[b,e,h] Gm[b,e,j]`` with the
    factored backward of the JAX custom VJP: ``T = S^T g`` per head, then
    ``g_eb[b,e,h] = sum_j T[b,h,e,j] Gm[b,e,j]``. ``S`` and ``Gm`` (one-hots)
    get no gradient."""

    @staticmethod
    def forward(ctx, S, eb, Gm):
        ctx.save_for_backward(S, Gm)
        SB = S[:, :, :, None] * eb[:, None, :, :]  # [B, V, E, H]
        return torch.einsum("bieh,bej->bhij", SB, Gm)

    @staticmethod
    def backward(ctx, g):
        S, Gm = ctx.saved_tensors
        T = torch.einsum("bie,bhij->bhej", S, g)
        return None, torch.einsum("bhej,bej->beh", T, Gm), None


class MaskedSoftmaxFn(torch.autograd.Function):
    """Row-masked softmax over the last axis (masked lanes and all-masked
    rows give zero weights) with the textbook backward ``g_s = alpha * (g -
    sum(alpha * g))``. The mask gets no gradient."""

    @staticmethod
    def forward(ctx, scores, mask):
        neg = torch.where(mask, scores, float("-inf"))
        mx = neg.amax(-1, keepdim=True)
        ex = torch.where(mask, torch.exp(neg - torch.where(torch.isfinite(mx), mx, 0.0)), 0.0)
        alpha = ex / ex.sum(-1, keepdim=True).clamp_min(1e-12)
        ctx.save_for_backward(alpha)
        return alpha

    @staticmethod
    def backward(ctx, g):
        (alpha,) = ctx.saved_tensors
        tmp = alpha * g
        return tmp - alpha * tmp.sum(-1, keepdim=True), None


class LinearLayers(nn.Module):
    """A layer made of ``nn.Linear`` children only, drawn as flax draws
    ``Dense`` layers."""

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for layer in self.children():
            reset_dense_(layer, generator)


def _node_mask(G: DenseBatchedGraph, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``S [B, V, E]``, ``Gm [B, E, V]`` in ``dtype`` and the node-node mask
    ``[B, 1, V, V]``."""
    S = G.scatter_matrix(dtype)
    Gm = G.gather_matrix(dtype)
    return S, Gm, (torch.bmm(S, Gm) > 0)[:, None]


def leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """``jax.nn.leaky_relu``: ``where(x >= 0, x, slope * x)``, the slope in
    ``x``'s dtype as JAX's weakly typed scalar is."""
    return torch.where(x >= 0, x, scalar(negative_slope, x) * x)


class DenseGraphSelfAttention(LinearLayers):
    """Edge-restricted multi-head self-attention on the dense layout.

    ``impl="fused"`` runs the core (mask and bias build, masked softmax,
    combine) through :func:`~notorch_tpu_torch.kernels.dense_attention.
    fused_dense_attention`: its backward is the hand-written recompute
    kernel, its forward the kernel for ``fwd_impl="pallas"`` and the plain
    tensor ops for ``"jnp"``. ``impl="jnp"`` is the einsum path, with the
    edge bias scattered by ``bias_impl`` (``auto`` is ``factored_vjp``, as
    in the JAX package); ``"auto"`` picks fused at float32 and jnp below,
    as the JAX module does. The q/k/v/o projections are dense layers in
    ``dtype`` either way."""

    def __init__(
        self,
        hidden_dim: int = DEFAULT_HIDDEN_DIM,
        num_heads: int = 4,
        edge_bias: bool = True,
        bias_impl: str = "auto",
        impl: str = "jnp",
        bins_per_tile: int = 8,
        interpret: bool = False,
        fwd_impl: str = "jnp",
        dtype=None,
        edge_dim: int | None = None,
    ):
        if hidden_dim % num_heads != 0:
            raise ValueError(f"hidden_dim {hidden_dim} not divisible by num_heads {num_heads}")
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        if bias_impl not in BIAS_IMPLS:
            raise ValueError(f"bias_impl must be one of {BIAS_IMPLS}, got {bias_impl!r}")
        if fwd_impl not in FWD_IMPLS:
            raise ValueError(f"fwd_impl must be one of {FWD_IMPLS}, got {fwd_impl!r}")
        super().__init__()
        d = hidden_dim
        self.dtype = compute_dtype(dtype)
        self.hidden_dim, self.num_heads, self.edge_bias = d, num_heads, edge_bias
        self.bias_impl, self.fwd_impl = bias_impl, fwd_impl
        self.impl = impl if impl != "auto" else "fused" if self.dtype == torch.float32 else "jnp"
        self.bins_per_tile, self.interpret = bins_per_tile, interpret
        self.W_q, self.W_k, self.W_v, self.W_o = (dense(d, d, dtype=dtype) for _ in range(4))
        if edge_bias:
            self.W_bias = dense(edge_dim or d, num_heads, dtype=dtype)

    def forward(self, G: DenseBatchedGraph) -> DenseBatchedGraph:
        H = self.num_heads
        x = G.node_feats
        B, V, d = x.shape
        q, k, v = self.W_q(x), self.W_k(x), self.W_v(x)
        bias = self.edge_bias and G.edge_feats.dim() == 3
        if self.impl == "fused":
            eb = self.W_bias(G.edge_feats).transpose(1, 2).contiguous() if bias else None
            out = fused_dense_attention(q, k, v, eb, G.src, G.dst, G.edge_mask, H, self.bins_per_tile,
                                        self.interpret, None, self.fwd_impl)
            return G.update(node_feats=self.W_o(out))
        dh = d // H
        S, Gm, mask = _node_mask(G, q.dtype)
        q, k, v = (t.reshape(B, V, H, dh) for t in (q, k, v))
        scores = torch.einsum("bihd,bjhd->bhij", q, k) / scalar(math.sqrt(dh), q)
        if bias:
            eb = self.W_bias(G.edge_feats)  # [B, E, H]
            if self.bias_impl == "two_step":
                scores = scores + torch.einsum("bieh,bej->bhij", S[:, :, :, None] * eb[:, None], Gm)
            elif self.bias_impl == "einsum3":
                scores = scores + torch.einsum("bie,beh,bej->bhij", S, eb, Gm)
            else:  # auto, factored_vjp
                scores = scores + EdgeBiasScatterFn.apply(S, eb, Gm)
        alpha = MaskedSoftmaxFn.apply(scores, mask)
        out = torch.einsum("bhij,bjhd->bihd", alpha, v).reshape(B, V, d)
        return G.update(node_feats=self.W_o(out))


class DenseGATv2Layer(LinearLayers):
    """GATv2 on the dense layout: the per-edge score ``a . LeakyReLU(u[src]
    + w[dst] + W_e e)`` per head, computed in edge space with one-hot
    gathers, scattered into ``[B, H, V, V]`` by :class:`EdgeBiasScatterFn`
    and softmaxed over each node's in-edges; the values are ``u``. Same
    parameters as the flat :class:`~notorch_tpu_torch.nn.attention.
    GATv2Layer`."""

    def __init__(
        self,
        hidden_dim: int = DEFAULT_HIDDEN_DIM,
        num_heads: int = 4,
        negative_slope: float = 0.2,
        use_edge_feats: bool = True,
        dtype=None,
        edge_dim: int | None = None,
    ):
        if hidden_dim % num_heads != 0:
            raise ValueError(f"hidden_dim {hidden_dim} not divisible by num_heads {num_heads}")
        super().__init__()
        d = hidden_dim
        self.hidden_dim, self.num_heads = d, num_heads
        self.negative_slope, self.use_edge_feats = negative_slope, use_edge_feats
        self.W_src, self.W_dst = dense(d, d, dtype=dtype), dense(d, d, dtype=dtype)
        if use_edge_feats:
            self.W_e = dense(edge_dim or d, d, dtype=dtype)
        self.a = dense(d // num_heads, 1, dtype=dtype)

    def forward(self, G: DenseBatchedGraph) -> DenseBatchedGraph:
        H = self.num_heads
        x = G.node_feats
        B, V, d = x.shape
        u, w = self.W_src(x), self.W_dst(x)
        S, Gm, mask = _node_mask(G, u.dtype)
        Dst = (G.dst.long()[:, :, None] == torch.arange(V, device=x.device)[None, None, :]).to(u.dtype)
        z = torch.bmm(Gm, u) + torch.bmm(Dst, w)
        if self.use_edge_feats and G.edge_feats.dim() == 3:
            z = z + self.W_e(G.edge_feats)
        z = leaky_relu(z.reshape(B, -1, H, d // H), self.negative_slope)
        scores = EdgeBiasScatterFn.apply(S, self.a(z).squeeze(-1), Gm)  # [B, E, H] scattered
        alpha = MaskedSoftmaxFn.apply(scores, mask)
        out = torch.einsum("bhij,bjhd->bihd", alpha, u.reshape(B, V, H, d // H))
        return G.update(node_feats=out.reshape(B, V, d))


class AttentionStack(nn.Module):
    """``in_proj`` (``input_dim -> hidden_dim``), then ``depth`` times: the
    layer ``make_layer(i)`` + residual and a ReLU feed-forward of width
    ``ffn_mult * hidden_dim`` + residual, ``dropout`` on the layer's output
    and on the feed-forward's. The body of the dense and the flat GAT blocks,
    whose parameters it names as the JAX blocks do; its dense layers compute
    in ``dtype``."""

    def __init__(self, hidden_dim: int, depth: int, ffn_mult: int, residual: bool, input_dim: int,
                 make_layer, dropout: float = 0.0, dtype=None):
        super().__init__()
        d = hidden_dim
        self.depth, self.residual = depth, residual
        self.in_proj = dense(input_dim, d, dtype=dtype)
        for i in range(depth):
            self.add_module(f"attn_{i}", make_layer(i))
            self.add_module(f"ffn_{i}_0", dense(d, ffn_mult * d, dtype=dtype))
            self.add_module(f"ffn_{i}_1", dense(ffn_mult * d, d, dtype=dtype))
        self.dropout = Dropout(dropout)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        reset_dense_(self.in_proj, generator)
        for i in range(self.depth):
            getattr(self, f"attn_{i}").reset_parameters(generator)
            reset_dense_(getattr(self, f"ffn_{i}_0"), generator)
            reset_dense_(getattr(self, f"ffn_{i}_1"), generator)
        self.dropout.reset_parameters(generator)

    def forward(self, G):
        h = self.in_proj(G.node_feats)
        for i in range(self.depth):
            out = self.dropout(getattr(self, f"attn_{i}")(G.update(node_feats=h)).node_feats)
            h = h + out if self.residual else out
            ff = self.dropout(getattr(self, f"ffn_{i}_1")(torch.relu(getattr(self, f"ffn_{i}_0")(h))))
            h = h + ff if self.residual else ff
        return G.update(node_feats=h)


class DenseGATBlock(AttentionStack):
    """Depth-stacked dense graph transformer (:class:`AttentionStack`) whose
    layers are :class:`DenseGraphSelfAttention` for ``attention="sdp"``,
    with the block's ``edge_bias``, ``bias_impl``, ``impl``,
    ``bins_per_tile``, ``interpret`` and ``fwd_impl``, or
    :class:`DenseGATv2Layer` for ``"gatv2"``. Same parameters as the flat
    :class:`~notorch_tpu_torch.nn.attention.GATBlock`."""

    def __init__(
        self,
        hidden_dim: int = DEFAULT_HIDDEN_DIM,
        depth: int = 3,
        num_heads: int = 4,
        attention: str = "sdp",
        dropout: float = 0.0,
        ffn_mult: int = 2,
        residual: bool = True,
        edge_bias: bool = True,
        bias_impl: str = "auto",
        impl: str = "jnp",
        bins_per_tile: int = 8,
        interpret: bool = False,
        fwd_impl: str = "jnp",
        dtype=None,
        input_dim: int | None = None,
    ):
        if attention not in ATTENTIONS:
            raise ValueError(f"unknown attention {attention!r}")
        width = input_dim or hidden_dim

        def make_layer(i):
            if attention == "gatv2":
                return DenseGATv2Layer(hidden_dim=hidden_dim, num_heads=num_heads, dtype=dtype, edge_dim=width)
            return DenseGraphSelfAttention(
                hidden_dim=hidden_dim, num_heads=num_heads, edge_bias=edge_bias, bias_impl=bias_impl,
                impl=impl, bins_per_tile=bins_per_tile, interpret=interpret, fwd_impl=fwd_impl,
                dtype=dtype, edge_dim=width,
            )

        super().__init__(hidden_dim, depth, ffn_mult, residual, width, make_layer, dropout, dtype)
