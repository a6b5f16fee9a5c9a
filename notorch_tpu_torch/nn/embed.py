"""Graph type-index embedding.

``EmbeddingBagSum`` is ``nn.EmbeddingBag(mode="sum")`` over multi-family
type indices: one lookup of an ``nn.Embedding``'s table summed over the
family axis, as ``notorch_tpu.nn.embed.EmbeddingBagSum`` takes and sums.
:class:`GraphEmbedding` embeds a flat batch's node and edge type ids. At
``dtype=bfloat16`` the table stays float32 and is cast to bf16 before the
lookup, as flax's ``Embed(dtype=...)`` casts it, so the rows and their sum
are bf16.
"""

from __future__ import annotations

import torch
from torch import nn

from notorch_tpu_torch.conf import DEFAULT_HIDDEN_DIM
from notorch_tpu_torch.data.graph import BatchedGraph
from notorch_tpu_torch.nn.init import embed_normal_
from notorch_tpu_torch.nn.ops import take
from notorch_tpu_torch.transforms.vocab import DEFAULT_NUM_ATOM_TYPES, DEFAULT_NUM_BOND_TYPES
from notorch_tpu_torch.utils import compute_dtype


class EmbeddingBagSum(nn.Module):
    """``[..., t]`` type ids -> ``[..., features]``: the sum of the ``t``
    rows they name, in ``dtype``. The table is ``embedding.weight`` ``[n,
    features]``, float32."""

    def __init__(self, num_embeddings: int, features: int, dtype=None):
        super().__init__()
        self.embedding = nn.Embedding(num_embeddings, features, _weight=torch.empty(num_embeddings, features))
        self.dtype = compute_dtype(dtype)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        embed_normal_(self.embedding.weight, generator)

    def forward(self, type_ids: torch.Tensor) -> torch.Tensor:
        # the table's rows through take: nn.Embedding's backward on the card
        # gave the table's gradient other bits on two calls at a lipo batch
        # (scripts/repeat_probe.py)
        return take(self.embedding.weight.to(self.dtype), type_ids).sum(dim=-2)


class GraphEmbedding(nn.Module):
    """Embed a flat batch's node and edge type indices into float hiddens
    (``node``/``edge`` tables, as the JAX ``GraphEmbedding``'s)."""

    def __init__(
        self,
        num_node_types: int = DEFAULT_NUM_ATOM_TYPES,
        num_edge_types: int = DEFAULT_NUM_BOND_TYPES,
        hidden_dim: int = DEFAULT_HIDDEN_DIM,
        dtype=None,
    ):
        super().__init__()
        self.node = EmbeddingBagSum(num_node_types, hidden_dim, dtype)
        self.edge = EmbeddingBagSum(num_edge_types, hidden_dim, dtype)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.node.reset_parameters(generator)
        self.edge.reset_parameters(generator)

    def forward(self, G: BatchedGraph) -> BatchedGraph:
        return G.update(node_feats=self.node(G.node_feats), edge_feats=self.edge(G.edge_feats))
