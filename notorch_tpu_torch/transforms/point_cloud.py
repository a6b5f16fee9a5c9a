"""Molecule (with 3D coordinates) -> PointCloud transform.

Port of ``notorch_tpu.transforms.point_cloud``: SDF mol blocks carry a
conformer (``Molecule.coords``, :class:`~notorch_tpu_torch.data.databases.
SDFDatabase`); :class:`MolToPointCloud` featurizes the atoms with the
standard type-index scheme and pairs them with the coordinates for the
spatial models. Its collate pads a batch to a static node cap.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar

import numpy as np

from notorch_tpu_torch.chem.mol import Molecule
from notorch_tpu_torch.data.point_cloud import BatchedPointCloud, PointCloud, pad_point_clouds
from notorch_tpu_torch.transforms.atom import AtomTransform, MultiTypeAtomTransform


@dataclass
class MolToPointCloud:
    _in_key_: ClassVar[str] = "mol"
    _out_key_: ClassVar[str] = "P"

    atom_transform: AtomTransform = field(default_factory=MultiTypeAtomTransform)

    @property
    def num_node_types(self) -> int:
        return len(self.atom_transform)

    def __call__(self, mol: Molecule) -> PointCloud:
        coords = getattr(mol, "coords", None)
        if coords is None:
            raise ValueError(
                "molecule has no 3D coordinates; point clouds need conformers (e.g. from an SDF database)"
            )
        return PointCloud(
            node_types=self.atom_transform(mol.GetAtoms()).astype(np.int32),
            coords=np.asarray(coords, dtype=np.float32),
        )

    @staticmethod
    def collate(clouds: list[PointCloud], node_cap: int | None = None) -> BatchedPointCloud:
        """The clouds padded to ``node_cap`` node slots (default: their atoms
        rounded up to a multiple of 64), one graph slot a cloud."""
        total = sum(c.num_nodes for c in clouds)
        cap = node_cap if node_cap is not None else -(-total // 64) * 64
        return pad_point_clouds(clouds, cap)
