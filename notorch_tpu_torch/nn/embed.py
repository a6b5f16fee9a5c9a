"""Graph type-index embedding.

``EmbeddingBagSum`` is ``nn.EmbeddingBag(mode="sum")`` over multi-family
type indices: one ``nn.Embedding`` lookup summed over the family axis, as
``notorch_tpu.nn.embed.EmbeddingBagSum`` takes and sums.
"""

from __future__ import annotations

import torch
from torch import nn

from notorch_tpu_torch.nn.init import embed_normal_


class EmbeddingBagSum(nn.Module):
    """``[..., t]`` type ids -> ``[..., features]``: the sum of the ``t``
    rows they name. The table is ``embedding.weight`` ``[n, features]``."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Embedding(num_embeddings, features, _weight=torch.empty(num_embeddings, features))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        embed_normal_(self.embedding.weight, generator)

    def forward(self, type_ids: torch.Tensor) -> torch.Tensor:
        return self.embedding(type_ids.long()).sum(dim=-2)
