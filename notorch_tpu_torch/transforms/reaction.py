"""Condensed Graph of Reaction (CGR) featurization.

Port of ``notorch_tpu.transforms.reaction``: the six ``RxnMode``s, the
atom-map correspondence of reactant and product atoms, and the union graph
over both sides, in the type-index embedding scheme:

- each side contributes a block of type ids (side-block offsets with an
  "absent" slot), so REAC_PROD concatenates [reactant ids | product ids];
- the DIFF modes keep one side's ids and add a binary "changed" family per
  feature family;
- the BALANCE modes copy the present side's features to the missing side
  for unbalanced atoms and bonds instead of marking them absent.

Reactions are parsed by :func:`~notorch_tpu_torch.chem.smiles.
parse_reaction_smiles`; a batch collates as ``MolToGraph``'s.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import ClassVar

import numpy as np

from notorch_tpu_torch.chem.smiles import parse_reaction_smiles
from notorch_tpu_torch.data.graph import Graph
from notorch_tpu_torch.transforms.atom import MultiTypeAtomTransform
from notorch_tpu_torch.transforms.bond import MultiTypeBondTransform
from notorch_tpu_torch.transforms.graph import MolToGraph


class RxnMode(Enum):
    REAC_PROD = "REAC_PROD"
    REAC_DIFF = "REAC_DIFF"
    PROD_DIFF = "PROD_DIFF"
    REAC_PROD_BALANCE = "REAC_PROD_BALANCE"
    REAC_DIFF_BALANCE = "REAC_DIFF_BALANCE"
    PROD_DIFF_BALANCE = "PROD_DIFF_BALANCE"

    @property
    def balanced(self) -> bool:
        return self.name.endswith("BALANCE")

    @property
    def diff(self) -> bool:
        return "DIFF" in self.name

    @property
    def keep_side(self) -> str:
        return "prod" if self.name.startswith("PROD") else "reac"


@dataclass
class RxnToGraph:
    _in_key_: ClassVar[str] = "rxn"
    _out_key_: ClassVar[str] = "G"

    mode: RxnMode = RxnMode.REAC_DIFF
    atom_transform: MultiTypeAtomTransform = field(default_factory=MultiTypeAtomTransform)
    bond_transform: MultiTypeBondTransform = field(default_factory=MultiTypeBondTransform)

    def __post_init__(self):
        if isinstance(self.mode, str):
            self.mode = RxnMode[self.mode.upper()]
        # side blocks: [side ids | absent] per side (or one side + changed flags)
        self._atom_block = len(self.atom_transform) + 1  # +1 absent slot
        self._bond_block = len(self.bond_transform) + 1
        self._n_atom_fam = self.atom_transform.num_types
        self._n_bond_fam = self.bond_transform.num_types

    @property
    def num_node_types(self) -> int:
        if self.mode.diff:
            return self._atom_block + 2 * self._n_atom_fam  # side + changed flags
        return 2 * self._atom_block

    @property
    def num_edge_types(self) -> int:
        if self.mode.diff:
            return self._bond_block + 2 * self._n_bond_fam
        return 2 * self._bond_block

    def __call__(self, rxn) -> Graph:
        if isinstance(rxn, str):
            reac, prod = parse_reaction_smiles(rxn)
        else:
            reac, prod = rxn

        # atom-map correspondence of the two sides
        map_r = {a.atom_map: a.idx for a in reac.atoms if a.atom_map}
        map_p = {a.atom_map: a.idx for a in prod.atoms if a.atom_map}

        # node universe: all reactant atoms, then product-only atoms
        nodes: list[tuple[int | None, int | None]] = []  # (reac idx, prod idx)
        prod_seen = set()
        for a in reac.atoms:
            p_idx = map_p.get(a.atom_map) if a.atom_map else None
            if p_idx is not None:
                prod_seen.add(p_idx)
            nodes.append((a.idx, p_idx))
        for a in prod.atoms:
            if a.idx not in prod_seen:
                nodes.append((None, a.idx))

        r_feats = self.atom_transform(reac.atoms) if reac.atoms else np.zeros((0, 1), np.int32)
        p_feats = self.atom_transform(prod.atoms) if prod.atoms else np.zeros((0, 1), np.int32)
        node_types = np.stack([self._atom_row(ri, pi, r_feats, p_feats) for ri, pi in nodes])

        # bond universe: union of both sides' bonds over the node universe
        r_pos = {ri: n for n, (ri, _) in enumerate(nodes) if ri is not None}
        p_pos = {pi: n for n, (_, pi) in enumerate(nodes) if pi is not None}
        r_bonds = {}
        for b in reac.bonds:
            u, v = r_pos[b.begin], r_pos[b.end]
            r_bonds[frozenset((u, v))] = b
        p_bonds = {}
        for b in prod.bonds:
            u, v = p_pos[b.begin], p_pos[b.end]
            p_bonds[frozenset((u, v))] = b
        all_keys = list(dict.fromkeys(list(r_bonds) + list(p_bonds)))

        rb_feats = (
            self.bond_transform(reac.bonds) if reac.bonds else np.zeros((0, 1), np.int32)
        )
        pb_feats = (
            self.bond_transform(prod.bonds) if prod.bonds else np.zeros((0, 1), np.int32)
        )
        rb_index = {frozenset((r_pos[b.begin], r_pos[b.end])): i for i, b in enumerate(reac.bonds)}
        pb_index = {frozenset((p_pos[b.begin], p_pos[b.end])): i for i, b in enumerate(prod.bonds)}

        edge_rows = []
        src, dst = [], []
        for key in all_keys:
            u, v = sorted(key)
            row = self._bond_row(rb_index.get(key), pb_index.get(key), rb_feats, pb_feats)
            edge_rows.extend([row, row])
            src.extend([u, v])
            dst.extend([v, u])

        n_edges = len(edge_rows)
        edge_types = (
            np.stack(edge_rows) if edge_rows else np.zeros((0, self._edge_width()), np.int32)
        )
        rev = np.arange(n_edges, dtype=np.int32).reshape(-1, 2)[:, ::-1].ravel()
        return Graph(
            node_types=node_types.astype(np.int32),
            edge_types=edge_types.astype(np.int32),
            src=np.asarray(src, dtype=np.int32),
            dst=np.asarray(dst, dtype=np.int32),
            rev=rev,
        )

    # -- feature rows ------------------------------------------------------
    def _edge_width(self) -> int:
        if self.mode.diff:
            return 2 * self._n_bond_fam
        return 2 * self._n_bond_fam

    def _atom_row(self, ri, pi, r_feats, p_feats) -> np.ndarray:
        absent_r = np.full(self._n_atom_fam, self._atom_block - 1, np.int64)
        r = r_feats[ri] if ri is not None else None
        p = p_feats[pi] if pi is not None else None
        if self.mode.balanced:
            r = r if r is not None else p
            p = p if p is not None else r
        if self.mode.diff:
            keep = (r if self.mode.keep_side == "reac" else p)
            keep = keep if keep is not None else absent_r
            changed = np.array(
                [
                    0 if (r is None or p is None) else int(r[f] != p[f])
                    for f in range(self._n_atom_fam)
                ]
            )
            # changed flags live in their own 2-wide families after the block
            flag_ids = self._atom_block + 2 * np.arange(self._n_atom_fam) + changed
            return np.concatenate([keep, flag_ids])
        r = r if r is not None else absent_r
        p = p if p is not None else absent_r
        return np.concatenate([r, p + self._atom_block])

    def _bond_row(self, ri, pi, rb_feats, pb_feats) -> np.ndarray:
        absent = np.full(self._n_bond_fam, self._bond_block - 1, np.int64)
        r = rb_feats[ri] if ri is not None else None
        p = pb_feats[pi] if pi is not None else None
        if self.mode.balanced:
            r = r if r is not None else p
            p = p if p is not None else r
        if self.mode.diff:
            keep = (r if self.mode.keep_side == "reac" else p)
            keep = keep if keep is not None else absent
            changed = np.array(
                [
                    1 if (r is None) != (p is None)
                    else (0 if r is None else int(r[f] != p[f]))
                    for f in range(self._n_bond_fam)
                ]
            )
            flag_ids = self._bond_block + 2 * np.arange(self._n_bond_fam) + changed
            return np.concatenate([keep, flag_ids])
        r = r if r is not None else absent
        p = p if p is not None else absent
        return np.concatenate([r, p + self._bond_block])

    @staticmethod
    def collate(graphs, node_cap=None, edge_cap=None):
        return MolToGraph.collate(graphs, node_cap, edge_cap)
