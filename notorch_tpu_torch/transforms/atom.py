"""Atom featurization: per-atom vectors of integer type ids.

Each feature family (element, hybridization, chirality, degree, formal charge,
num Hs, aromaticity) maps to an id, offset into a single shared embedding
table via the cumulative-size offset scheme — so the embedding layer is one
take + sum, not one-hot concat. Capability parity: reference
``notorch/transforms/atom.py:30-137``.
"""

from __future__ import annotations

from collections.abc import Iterable, Sequence
from typing import Protocol

import numpy as np

from notorch_tpu_torch.chem.mol import Atom
from notorch_tpu_torch.transforms.inverse_index import InverseIndexWithUnknown, build
from notorch_tpu_torch.transforms.vocab import (
    CHIRAL_TAGS,
    DEGREES,
    ELEMENTS,
    FORMAL_CHARGES,
    HYBRIDIZATIONS,
    NUM_HS,
)


class AtomTransform(Protocol):
    def __len__(self) -> int: ...

    def __call__(self, atoms: Iterable[Atom]) -> np.ndarray: ...


class ElementOnlyAtomTransform:
    def __init__(self, elements: Sequence[str] = ELEMENTS):
        self.element_map = InverseIndexWithUnknown(elements)

    def __len__(self) -> int:
        return len(self.element_map)

    @property
    def num_types(self) -> int:
        return 1

    def __call__(self, atoms: Iterable[Atom]) -> np.ndarray:
        return np.array([[self.element_map[a.GetSymbol()]] for a in atoms], dtype=np.int32)


class MultiTypeAtomTransform:
    def __init__(
        self,
        elements: Sequence[str] | None = ELEMENTS,
        hybridizations: Sequence | None = HYBRIDIZATIONS,
        chiral_tags: Sequence | None = CHIRAL_TAGS,
        degrees: Sequence[int] | None = DEGREES,
        formal_charges: Sequence[int] | None = FORMAL_CHARGES,
        num_hs: Sequence[int] | None = NUM_HS,
        include_aromaticity: bool = True,
    ):
        aromaticity = [True, False] if include_aromaticity else None

        self.maps = [
            (build(elements), lambda a: a.GetSymbol()),
            (build(hybridizations), lambda a: a.GetHybridization()),
            (build(chiral_tags), lambda a: a.GetChiralTag()),
            (build(degrees), lambda a: a.GetTotalDegree()),
            (build(formal_charges), lambda a: a.GetFormalCharge()),
            (build(num_hs), lambda a: a.GetTotalNumHs()),
            (build(aromaticity, unknown_pad=False), lambda a: a.GetIsAromatic()),
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

    def __call__(self, atoms: Iterable[Atom]) -> np.ndarray:
        rows = [[m[f(a)] for m, f in self.maps] for a in atoms]
        arr = np.asarray(rows, dtype=np.int32).reshape(-1, len(self.maps))
        return arr + self.offset[None, :]
