"""SMILES -> Molecule transform.

Capability parity: reference ``notorch/transforms/chem.py`` (``SmiToMol`` with
keep-H semantics). This framework's parser keeps bracket Hs by construction;
``add_h`` materializes implicit hydrogens as explicit atoms.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

from notorch_tpu_torch.chem.mol import Atom, Bond, BondType, Molecule
from notorch_tpu_torch.chem.smiles import parse_smiles


def add_hs(mol: Molecule) -> Molecule:
    """Materialize implicit/bracket hydrogens as explicit atoms."""
    out = Molecule()
    for a in mol.atoms:
        out.add_atom(
            Atom(
                symbol=a.symbol,
                aromatic=a.aromatic,
                formal_charge=a.formal_charge,
                explicit_hs=0,
                isotope=a.isotope,
                atom_map=a.atom_map,
                chiral_tag=a.chiral_tag,
            )
        )
    for b in mol.bonds:
        out.add_bond(Bond(b.begin, b.end, b.bond_type, b.stereo, b.direction))
    for a in mol.atoms:
        for _ in range(a.GetTotalNumHs()):
            h = out.add_atom(Atom(symbol="H", explicit_hs=0))
            out.add_bond(Bond(a.idx, h, BondType.SINGLE))
    return out.finalize()


@dataclass
class SmiToMol:
    _in_key_: ClassVar[str] = "smi"
    _out_key_: ClassVar[str] = "mol"

    keep_h: bool = True
    add_h: bool = False

    def __call__(self, smi: str) -> Molecule:
        mol = parse_smiles(smi)
        return add_hs(mol) if self.add_h else mol

    collate = staticmethod(list)
