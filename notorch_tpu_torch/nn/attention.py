"""Graph attention layers over the flat batched graph.

Port of ``notorch_tpu.nn.attention``: :class:`GATv2Layer` (per-edge score
``a . LeakyReLU(W_src h_src + W_dst h_dst + W_e e)`` per head, softmaxed
over each destination's in-edges), :class:`GraphSelfAttention` (dot-product
scores restricted to edges, plus a per-edge bias) and :class:`GATBlock`,
their depth stack with residuals and a ReLU feed-forward. Both layers
reduce through the port's padding-safe ``segment_softmax`` and
``segment_sum``. Parameters, input widths and ``dtype`` as in
:mod:`notorch_tpu_torch.nn.attention_dense`, whose blocks share these
parameter names, so that weights move between the layouts; at bf16 the
gathers and sums are the ordered bf16 ones of :mod:`notorch_tpu_torch.nn.ops`.
"""

from __future__ import annotations

import math

from notorch_tpu_torch.conf import DEFAULT_HIDDEN_DIM
from notorch_tpu_torch.data.graph import BatchedGraph
from notorch_tpu_torch.nn.attention_dense import ATTENTIONS, AttentionStack, LinearLayers, leaky_relu
from notorch_tpu_torch.nn.init import dense
from notorch_tpu_torch.nn.ops import scalar, segment_softmax, segment_sum, take


class GATv2Layer(LinearLayers):
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
        self.num_heads, self.negative_slope, self.use_edge_feats = num_heads, negative_slope, use_edge_feats
        self.W_src, self.W_dst = dense(d, d, dtype=dtype), dense(d, d, dtype=dtype)
        if use_edge_feats:
            self.W_e = dense(edge_dim or d, d, dtype=dtype)
        self.a = dense(d // num_heads, 1, dtype=dtype)

    def forward(self, G: BatchedGraph) -> BatchedGraph:
        H = self.num_heads
        h_src, h_dst = self.W_src(G.node_feats), self.W_dst(G.node_feats)
        d = h_src.shape[-1]
        z = take(h_src, G.src) + take(h_dst, G.dst)
        if self.use_edge_feats and G.edge_feats.dim() == 2:
            z = z + self.W_e(G.edge_feats)
        z = leaky_relu(z.reshape(-1, H, d // H), self.negative_slope)
        scores = self.a(z).squeeze(-1)  # [E, H]
        alpha = segment_softmax(scores, G.dst, G.num_nodes, mask=G.edge_mask)
        # the values gathered a second time, as the JAX layer gathers them:
        # each gather's gradient is summed on its own
        out = segment_sum(alpha[..., None] * take(h_src, G.src).reshape(-1, H, d // H), G.dst, G.num_nodes)
        return G.update(node_feats=out.reshape(-1, d))


class GraphSelfAttention(LinearLayers):
    """Edge-restricted multi-head self-attention with an additive per-edge
    bias (``W_bias``, used when the edge features are floats)."""

    def __init__(self, hidden_dim: int = DEFAULT_HIDDEN_DIM, num_heads: int = 4, dtype=None,
                 edge_dim: int | None = None):
        if hidden_dim % num_heads != 0:
            raise ValueError(f"hidden_dim {hidden_dim} not divisible by num_heads {num_heads}")
        super().__init__()
        d = hidden_dim
        self.num_heads = num_heads
        self.W_q, self.W_k, self.W_v = (dense(d, d, dtype=dtype) for _ in range(3))
        self.W_bias = dense(edge_dim or d, num_heads, dtype=dtype)
        self.W_o = dense(d, d, dtype=dtype)

    def forward(self, G: BatchedGraph) -> BatchedGraph:
        H = self.num_heads
        x = G.node_feats
        d = x.shape[-1]
        q, k, v = (layer(x).reshape(-1, H, d // H) for layer in (self.W_q, self.W_k, self.W_v))
        scores = (take(q, G.dst) * take(k, G.src)).sum(-1) / scalar(math.sqrt(d // H), q)  # [E, H]
        if G.edge_feats.dim() == 2:
            scores = scores + self.W_bias(G.edge_feats)
        alpha = segment_softmax(scores, G.dst, G.num_nodes, mask=G.edge_mask)
        out = segment_sum(alpha[..., None] * take(v, G.src), G.dst, G.num_nodes)
        return G.update(node_feats=self.W_o(out.reshape(-1, d)))


class GATBlock(AttentionStack):
    """Depth-stacked flat attention encoder (:class:`~notorch_tpu_torch.nn.
    attention_dense.AttentionStack`) whose layers are :class:`GATv2Layer`
    for ``attention="gatv2"`` or :class:`GraphSelfAttention` for ``"sdp"``.
    ``input_dim`` (default ``hidden_dim``) is the width of the node and edge
    features it is given."""

    def __init__(
        self,
        hidden_dim: int = DEFAULT_HIDDEN_DIM,
        depth: int = 3,
        num_heads: int = 4,
        attention: str = "gatv2",
        dropout: float = 0.0,
        ffn_mult: int = 2,
        residual: bool = True,
        dtype=None,
        input_dim: int | None = None,
    ):
        if attention not in ATTENTIONS:
            raise ValueError(f"unknown attention {attention!r}")
        width = input_dim or hidden_dim
        layer = GATv2Layer if attention == "gatv2" else GraphSelfAttention
        super().__init__(hidden_dim, depth, ffn_mult, residual, width,
                         lambda i: layer(hidden_dim=hidden_dim, num_heads=num_heads, dtype=dtype, edge_dim=width),
                         dropout, dtype)
