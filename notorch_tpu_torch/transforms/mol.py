"""Molecule -> Morgan fingerprint transform.

Port of ``notorch_tpu.transforms.mol``: ``MolToFP`` maps a molecule to its
folded Morgan fingerprint (:func:`~notorch_tpu_torch.chem.fingerprint.
morgan_fingerprint`) and collates a batch into a float32 ``[B, length]``
array.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import numpy as np

from notorch_tpu_torch.chem.fingerprint import morgan_fingerprint
from notorch_tpu_torch.chem.mol import Molecule


@dataclass
class MolToFP:
    _in_key_: ClassVar[str] = "mol"
    _out_key_: ClassVar[str] = "fp"

    radius: int = 2
    length: int = 2048
    count: bool = False

    def __call__(self, mol: Molecule) -> np.ndarray:
        return morgan_fingerprint(mol, self.radius, self.length, self.count)

    def collate(self, fps: list[np.ndarray]) -> np.ndarray:
        return np.stack(fps).astype(np.float32)


def morgan(radius: int = 2, length: int = 2048, count: bool = False) -> MolToFP:
    return MolToFP(radius, length, count)
