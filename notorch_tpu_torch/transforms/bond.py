"""Bond featurization: integer type ids with family offsets.

Capability parity: reference ``notorch/transforms/bond.py:23-87``.
"""

from __future__ import annotations

from collections.abc import Collection, Iterable
from typing import Protocol

import numpy as np

from notorch_tpu_torch.chem.mol import Bond
from notorch_tpu_torch.transforms.inverse_index import InverseIndexWithUnknown, build
from notorch_tpu_torch.transforms.vocab import BOND_STEREOS, BOND_TYPES


class BondTransform(Protocol):
    def __len__(self) -> int: ...

    def __call__(self, bonds: Iterable[Bond]) -> np.ndarray: ...


class BondTypeOnlyTransform:
    def __init__(self, bond_types: Collection = BOND_TYPES):
        self.bond_type_map = InverseIndexWithUnknown(bond_types)

    def __len__(self) -> int:
        return len(self.bond_type_map)

    def __call__(self, bonds: Iterable[Bond]) -> np.ndarray:
        return np.array([[self.bond_type_map[b.GetBondType()]] for b in bonds], dtype=np.int32)


class MultiTypeBondTransform:
    def __init__(
        self,
        bond_types: Collection | None = BOND_TYPES,
        stereos: Collection | None = BOND_STEREOS,
    ):
        self.maps = [
            (build(bond_types), lambda b: b.GetBondType()),
            (build(stereos), lambda b: b.GetStereo()),
        ]
        self.maps = [(m, f) for m, f in self.maps if m is not None]

        sizes = np.array([len(m) for m, _ in self.maps])
        self._num_types = int(sizes.sum())
        self.sizes = sizes
        self.offset = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)

    def __len__(self) -> int:
        return self._num_types

    @property
    def num_types(self) -> int:
        return len(self.maps)

    def __call__(self, bonds: Iterable[Bond]) -> np.ndarray:
        rows = [[m[f(b)] for m, f in self.maps] for b in bonds]
        arr = np.asarray(rows, dtype=np.int32).reshape(-1, len(self.maps))
        return arr + self.offset[None, :]
