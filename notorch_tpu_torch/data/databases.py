"""Feature databases: keyed lookups into on-disk feature stores.

Port of ``notorch_tpu.data.databases``: the :class:`Database` mapping with
a ``collate`` for batching looked-up values, the NPZ/NPY and HDF5 stores
(eager, and the lazy :class:`HDF5DatabaseOnDisk` read inside a ``with``
block), and :class:`SDFDatabase`, whose V2000 mol blocks become
:class:`~notorch_tpu_torch.chem.mol.Molecule` objects carrying their
conformer as ``coords``. All host-side numpy; ``h5py`` is imported only by
the HDF5 classes.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from collections.abc import Mapping
from pathlib import Path

import numpy as np

from notorch_tpu_torch.chem.mol import Atom, Bond, BondType, Molecule


class ClosedDatabaseError(RuntimeError):
    """Raised when reading from a lazy database outside its context."""


class Database(ABC, Mapping):
    """A mapping with a ``collate`` for batching looked-up values."""

    @abstractmethod
    def __getitem__(self, key): ...

    @abstractmethod
    def __len__(self): ...

    def __iter__(self):
        return iter(range(len(self)))

    def collate(self, values: list) -> np.ndarray:
        return np.stack([np.asarray(v) for v in values]).astype(np.float32)


class NPZDatabase(Database):
    """Feature matrix from one array of an ``.npz`` archive, int-indexed."""

    def __init__(self, path: str | Path, key: str, mmap: bool = False):
        self.path = Path(path)
        self.key = key
        with np.load(self.path, mmap_mode="r" if mmap else None) as npz:
            self.X = npz[key]

    def __getitem__(self, idx: int) -> np.ndarray:
        return self.X[idx]

    def __len__(self) -> int:
        return len(self.X)


class NPYDatabase(Database):
    """Feature matrix from an ``.npy`` file, optionally memory-mapped."""

    def __init__(self, path: str | Path, mmap: bool = False):
        self.path = Path(path)
        self.X = np.load(self.path, mmap_mode="r" if mmap else None)

    def __getitem__(self, idx: int) -> np.ndarray:
        return np.asarray(self.X[idx])

    def __len__(self) -> int:
        return len(self.X)


class HDF5Database(Database):
    """An HDF5 dataset, loaded whole at construction."""

    def __init__(self, path: str | Path, dataset: str):
        import h5py

        self.path = Path(path)
        with h5py.File(self.path, "r") as f:
            self.X = f[dataset][:]

    def __getitem__(self, idx: int) -> np.ndarray:
        return self.X[idx]

    def __len__(self) -> int:
        return len(self.X)


class HDF5DatabaseOnDisk(Database):
    """Lazy HDF5 access: rows are read from the file while it is open in a
    ``with`` block; outside one a read raises :class:`ClosedDatabaseError`."""

    def __init__(self, path: str | Path, dataset: str):
        self.path = Path(path)
        self.dataset = dataset
        self._file = None

    def __enter__(self):
        import h5py

        self._file = h5py.File(self.path, "r")
        return self

    def __exit__(self, *exc):
        self._file.close()
        self._file = None

    def __getitem__(self, idx: int) -> np.ndarray:
        if self._file is None:
            raise ClosedDatabaseError(f"database {self.path} is not open")
        return self._file[self.dataset][idx]

    def __len__(self) -> int:
        if self._file is None:
            import h5py

            with h5py.File(self.path, "r") as f:
                return len(f[self.dataset])
        return len(self._file[self.dataset])


class SDFDatabase(Database):
    """Molecules from an SDF (MDL mol-block) file, each with its conformer
    as ``coords`` (:func:`_parse_molblock`). Collates to a list."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        text = self.path.read_text()
        self.mols = [_parse_molblock(b) for b in text.split("$$$$") if b.strip()]

    def __getitem__(self, idx: int) -> Molecule:
        return self.mols[idx]

    def __len__(self) -> int:
        return len(self.mols)

    def collate(self, values: list) -> list:
        return list(values)


# V2000 bond orders; any other order reads as a single bond
_BOND_ORDERS = {1: BondType.SINGLE, 2: BondType.DOUBLE, 3: BondType.TRIPLE, 4: BondType.AROMATIC}


def _parse_molblock(block: str) -> Molecule:
    """A V2000 mol block as a finalized Molecule with ``coords [n, 3]``
    float32: the counts line, then one line an atom (x, y, z, symbol) and
    one a bond (1-based atoms in fixed columns 1-3 and 4-6, the order in
    7-9; an aromatic bond marks both its atoms aromatic)."""
    lines = block.strip("\n").split("\n")
    counts = lines[3]
    n_atoms, n_bonds = int(counts[:3]), int(counts[3:6])
    mol = Molecule()
    coords = np.zeros((n_atoms, 3), dtype=np.float32)
    for i in range(n_atoms):
        parts = lines[4 + i].split()
        coords[i] = [float(parts[0]), float(parts[1]), float(parts[2])]
        mol.add_atom(Atom(symbol=parts[3]))
    mol.coords = coords
    for i in range(n_bonds):
        ln = lines[4 + n_atoms + i]
        a, b, order = int(ln[:3]) - 1, int(ln[3:6]) - 1, int(ln[6:9])
        bt = _BOND_ORDERS.get(order, BondType.SINGLE)
        if bt is BondType.AROMATIC:
            mol.atoms[a].aromatic = True
            mol.atoms[b].aromatic = True
        mol.add_bond(Bond(a, b, bt))
    return mol.finalize()
