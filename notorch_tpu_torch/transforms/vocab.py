"""Canonical chemistry vocabularies for type-index featurization.

Capability parity: reference ``notorch/transforms/conf.py:4-44``, expressed in
terms of this framework's own chemistry enums instead of RDKit's.
"""

from notorch_tpu_torch.chem.mol import BondStereo, BondType, ChiralTag, Hybridization

# atom feature families
ELEMENTS = ["H", "C", "N", "O", "F", "P", "S", "Cl", "Br", "I"]
DEGREES = [0, 1, 2, 3]
HYBRIDIZATIONS = [
    Hybridization.S,
    Hybridization.SP,
    Hybridization.SP2,
    Hybridization.SP3,
    Hybridization.SP3D,
    Hybridization.SP3D2,
]
CHIRAL_TAGS = [
    ChiralTag.UNSPECIFIED,
    ChiralTag.TETRAHEDRAL_CW,
    ChiralTag.TETRAHEDRAL_CCW,
    ChiralTag.OTHER,
]
NUM_HS = [0, 1, 2, 3, 4]
FORMAL_CHARGES = [-1, -2, 1, 2, 0]

# bond feature families
BOND_TYPES = [BondType.SINGLE, BondType.DOUBLE, BondType.TRIPLE, BondType.AROMATIC]
BOND_STEREOS = [
    BondStereo.NONE,
    BondStereo.ANY,
    BondStereo.Z,
    BondStereo.E,
    BondStereo.CIS,
    BondStereo.TRANS,
    BondStereo.ATROPCW,
]

# each family gets a +1 <UNK> slot; aromaticity is a 2-way family with no <UNK>
DEFAULT_NUM_ATOM_TYPES = (
    len(ELEMENTS)
    + len(DEGREES)
    + len(HYBRIDIZATIONS)
    + len(CHIRAL_TAGS)
    + len(NUM_HS)
    + len(FORMAL_CHARGES)
    + 8
)
DEFAULT_NUM_BOND_TYPES = len(BOND_TYPES) + len(BOND_STEREOS) + 2
