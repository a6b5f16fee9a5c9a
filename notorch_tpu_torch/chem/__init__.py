"""Host-side chemistry backend (RDKit-free, with RDKit-compatible accessors)."""

from notorch_tpu_torch.chem.mol import (
    Atom,
    Bond,
    BondStereo,
    BondType,
    ChiralTag,
    Hybridization,
    Molecule,
)
from notorch_tpu_torch.chem.smiles import (
    MolFromSmiles,
    SmilesParseError,
    parse_reaction_smiles,
    parse_smiles,
)

__all__ = [
    "Atom",
    "Bond",
    "BondStereo",
    "BondType",
    "ChiralTag",
    "Hybridization",
    "Molecule",
    "MolFromSmiles",
    "SmilesParseError",
    "parse_reaction_smiles",
    "parse_smiles",
]
