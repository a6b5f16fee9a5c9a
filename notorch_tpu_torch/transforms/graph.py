"""Molecule -> Graph transform.

Builds the directed-edge graph the D-MPNN consumes: every bond contributes the
two directed edges (u, v), (v, u) interleaved, so the reverse-edge map is the
pairwise swap [1, 0, 3, 2, ...]. Capability parity: reference
``notorch/transforms/graph.py:17-45``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar

import numpy as np

from notorch_tpu_torch.chem.mol import Molecule
from notorch_tpu_torch.data.graph import BatchedGraph, Graph, pad_graphs
from notorch_tpu_torch.transforms.atom import AtomTransform, MultiTypeAtomTransform
from notorch_tpu_torch.transforms.bond import BondTransform, MultiTypeBondTransform


@dataclass
class MolToGraph:
    _in_key_: ClassVar[str] = "mol"
    _out_key_: ClassVar[str] = "G"

    atom_transform: AtomTransform = field(default_factory=MultiTypeAtomTransform)
    bond_transform: BondTransform = field(default_factory=MultiTypeBondTransform)

    @property
    def num_node_types(self) -> int:
        return len(self.atom_transform)

    @property
    def num_edge_types(self) -> int:
        return len(self.bond_transform)

    def __call__(self, mol: Molecule) -> Graph:
        V = self.atom_transform(mol.GetAtoms())
        bond_feats = self.bond_transform(mol.GetBonds())
        E = np.repeat(bond_feats, 2, axis=0)  # directed edges, both ways

        n_edges = 2 * mol.GetNumBonds()
        src = np.empty(n_edges, dtype=np.int32)
        dst = np.empty(n_edges, dtype=np.int32)
        for i, b in enumerate(mol.GetBonds()):
            u, v = b.GetBeginAtomIdx(), b.GetEndAtomIdx()
            src[2 * i], dst[2 * i] = u, v
            src[2 * i + 1], dst[2 * i + 1] = v, u
        rev = np.arange(n_edges, dtype=np.int32).reshape(-1, 2)[:, ::-1].ravel()

        return Graph(
            node_types=V.astype(np.int32),
            edge_types=E.astype(np.int32),
            src=src,
            dst=dst,
            rev=rev,
        )

    @staticmethod
    def collate(graphs: list[Graph], node_cap: int | None = None, edge_cap: int | None = None) -> BatchedGraph:
        """Pad-collate into the flat layout. Without caps, pads to the exact
        batch totals (+1 node sink slot) — bucketing callers pass explicit caps."""
        total_v = sum(g.num_nodes for g in graphs) + 1
        total_e = max(sum(g.num_edges for g in graphs), 1)
        return pad_graphs(
            graphs,
            node_cap=node_cap if node_cap is not None else total_v,
            edge_cap=edge_cap if edge_cap is not None else total_e,
        )
