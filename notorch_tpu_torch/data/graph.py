"""Host-side graph data model.

Only the ragged host :class:`Graph` is ported so far. The flat padded device
batch (``BatchedGraph``, ``pad_graphs`` and the CSR helpers of
``notorch_tpu.data.graph``) comes with the flat-layout slice; the dense
layouts live in :mod:`notorch_tpu_torch.data.dense`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Graph"]


@dataclass
class Graph:
    """A single (host-side, ragged) graph of integer type-index features.

    ``rev[e]`` is the index of the reverse directed edge of ``e`` — the
    D-MPNN essential. With interleaved (u,v),(v,u) edge construction this is
    the pairwise swap permutation [1,0,3,2,...].
    """

    node_types: np.ndarray  # [V, t_v] int32
    edge_types: np.ndarray  # [E, t_e] int32
    src: np.ndarray  # [E] int32
    dst: np.ndarray  # [E] int32
    rev: np.ndarray  # [E] int32

    @property
    def num_nodes(self) -> int:
        return len(self.node_types)

    @property
    def num_edges(self) -> int:
        return len(self.edge_types)

    def __repr__(self) -> str:
        return (
            f"Graph(V={self.num_nodes}, E={self.num_edges}, "
            f"node_types=[{self.num_nodes}, {self.node_types.shape[1]}], "
            f"edge_types=[{self.num_edges}, {self.edge_types.shape[1]}])"
        )
