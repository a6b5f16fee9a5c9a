"""Minimal host-side molecular data model.

The reference delegates all chemistry to RDKit (C++). This framework ships a
self-contained chemistry backend so featurization runs anywhere; when RDKit is
importable it can be used interchangeably through the same featurizer protocol
(the featurizers only need the small accessor surface defined here).

Capability parity: the accessor surface mirrors what the reference featurizers
consume from RDKit ``Atom``/``Bond``/``Mol`` (reference
``notorch/transforms/atom.py:95-111``, ``notorch/transforms/bond.py:63-70``,
``notorch/transforms/graph.py:32-43``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum


class Hybridization(Enum):
    S = "S"
    SP = "SP"
    SP2 = "SP2"
    SP3 = "SP3"
    SP3D = "SP3D"
    SP3D2 = "SP3D2"
    UNSPECIFIED = "UNSPECIFIED"


class ChiralTag(Enum):
    UNSPECIFIED = "UNSPECIFIED"
    TETRAHEDRAL_CW = "CW"
    TETRAHEDRAL_CCW = "CCW"
    OTHER = "OTHER"


class BondType(Enum):
    SINGLE = 1.0
    DOUBLE = 2.0
    TRIPLE = 3.0
    AROMATIC = 1.5


class BondStereo(Enum):
    NONE = "NONE"
    ANY = "ANY"
    Z = "Z"
    E = "E"
    CIS = "CIS"
    TRANS = "TRANS"
    ATROPCW = "ATROPCW"


# Default valences used for implicit-hydrogen assignment (organic subset).
# Multiple entries = allowed hypervalent states, lowest first.
DEFAULT_VALENCES: dict[str, tuple[int, ...]] = {
    "H": (1,),
    "B": (3,),
    "C": (4,),
    "N": (3,),
    "O": (2,),
    "F": (1,),
    "P": (3, 5),
    "S": (2, 4, 6),
    "Cl": (1,),
    "Br": (1,),
    "I": (1,),
}

# Organic subset: elements that may be written without brackets in SMILES.
ORGANIC_SUBSET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}

ATOMIC_NUMBERS: dict[str, int] = {
    s: i + 1
    for i, s in enumerate(
        "H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe Co Ni "
        "Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In Sn Sb Te I "
        "Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf Ta W Re Os Ir Pt "
        "Au Hg Tl Pb Bi Po At Rn".split()
    )
}


@dataclass
class Atom:
    """One atom. Fields are populated by the parser; derived fields
    (``num_implicit_hs``, ``hybridization``) by :meth:`Molecule.finalize`."""

    symbol: str
    aromatic: bool = False
    formal_charge: int = 0
    explicit_hs: int | None = None  # bracket H-count; None => derive implicit Hs
    isotope: int = 0
    atom_map: int = 0
    chiral_tag: ChiralTag = ChiralTag.UNSPECIFIED
    idx: int = -1
    # derived
    num_implicit_hs: int = 0
    hybridization: Hybridization = Hybridization.UNSPECIFIED
    _mol: "Molecule | None" = field(default=None, repr=False)

    # -- accessor surface mirroring what featurizers need -------------------
    def GetSymbol(self) -> str:
        return self.symbol

    def GetAtomicNum(self) -> int:
        return ATOMIC_NUMBERS.get(self.symbol, 0)

    def GetIsAromatic(self) -> bool:
        return self.aromatic

    def GetFormalCharge(self) -> int:
        return self.formal_charge

    def GetChiralTag(self) -> ChiralTag:
        return self.chiral_tag

    def GetHybridization(self) -> Hybridization:
        return self.hybridization

    def GetTotalNumHs(self) -> int:
        return (self.explicit_hs or 0) + self.num_implicit_hs

    def GetDegree(self) -> int:
        """Number of explicit (heavy-atom graph) neighbors."""
        assert self._mol is not None
        return len(self._mol.neighbors(self.idx))

    def GetTotalDegree(self) -> int:
        """Degree including (implicit and bracket) hydrogens."""
        return self.GetDegree() + self.GetTotalNumHs()

    def GetIdx(self) -> int:
        return self.idx

    def GetAtomMapNum(self) -> int:
        return self.atom_map


@dataclass
class Bond:
    begin: int
    end: int
    bond_type: BondType = BondType.SINGLE
    stereo: BondStereo = BondStereo.NONE
    direction: str = ""  # '/' or '\\' as written in SMILES, for stereo perception
    idx: int = -1
    in_ring: bool = False

    def GetBeginAtomIdx(self) -> int:
        return self.begin

    def GetEndAtomIdx(self) -> int:
        return self.end

    def GetBondType(self) -> BondType:
        return self.bond_type

    def GetStereo(self) -> BondStereo:
        return self.stereo

    def GetIsAromatic(self) -> bool:
        return self.bond_type is BondType.AROMATIC

    def order(self) -> float:
        return self.bond_type.value


class Molecule:
    """A molecular graph with RDKit-like accessors.

    Construction: parser appends atoms/bonds, then calls :meth:`finalize` which
    perceives rings, demotes non-ring "aromatic" bonds, assigns implicit
    hydrogens and hybridization, and perceives double-bond stereo.
    """

    def __init__(self) -> None:
        self.atoms: list[Atom] = []
        self.bonds: list[Bond] = []
        self._adj: dict[int, list[int]] = {}  # atom idx -> list of bond idxs

    # -- construction -------------------------------------------------------
    def add_atom(self, atom: Atom) -> int:
        atom.idx = len(self.atoms)
        atom._mol = self
        self.atoms.append(atom)
        self._adj[atom.idx] = []
        return atom.idx

    def add_bond(self, bond: Bond) -> int:
        bond.idx = len(self.bonds)
        self.bonds.append(bond)
        self._adj[bond.begin].append(bond.idx)
        self._adj[bond.end].append(bond.idx)
        return bond.idx

    # -- accessors -----------------------------------------------------------
    def GetAtoms(self) -> list[Atom]:
        return self.atoms

    def GetBonds(self) -> list[Bond]:
        return self.bonds

    def GetNumAtoms(self) -> int:
        return len(self.atoms)

    def GetNumBonds(self) -> int:
        return len(self.bonds)

    def GetAtomWithIdx(self, idx: int) -> Atom:
        return self.atoms[idx]

    def neighbors(self, idx: int) -> list[int]:
        out = []
        for b_idx in self._adj[idx]:
            b = self.bonds[b_idx]
            out.append(b.end if b.begin == idx else b.begin)
        return out

    def bonds_of(self, idx: int) -> list[Bond]:
        return [self.bonds[i] for i in self._adj[idx]]

    # -- perception ----------------------------------------------------------
    def _find_ring_bonds(self) -> set[int]:
        """Bond indices that lie on a cycle = all non-bridge edges (Tarjan)."""
        n = len(self.atoms)
        visited = [False] * n
        disc = [0] * n
        low = [0] * n
        bridges: set[int] = set()
        timer = [0]

        for root in range(n):
            if visited[root]:
                continue
            # iterative DFS to avoid recursion limits on large molecules
            stack: list[tuple[int, int, int]] = [(root, -1, 0)]  # (node, parent_bond, child_ptr)
            order: list[tuple[int, int]] = []
            visited[root] = True
            disc[root] = low[root] = timer[0]
            timer[0] += 1
            while stack:
                u, pb, ptr = stack.pop()
                adj = self._adj[u]
                advanced = False
                while ptr < len(adj):
                    b_idx = adj[ptr]
                    ptr += 1
                    if b_idx == pb:
                        continue
                    b = self.bonds[b_idx]
                    v = b.end if b.begin == u else b.begin
                    if not visited[v]:
                        visited[v] = True
                        disc[v] = low[v] = timer[0]
                        timer[0] += 1
                        stack.append((u, pb, ptr))
                        stack.append((v, b_idx, 0))
                        order.append((u, v))
                        advanced = True
                        break
                    else:
                        low[u] = min(low[u], disc[v])
                if not advanced and stack:
                    # u finished; propagate low-link to parent on stack
                    pu = stack[-1][0]
                    low[pu] = min(low[pu], low[u])
                    if low[u] > disc[pu]:
                        bridges.add(pb)
        return {b.idx for b in self.bonds if b.idx not in bridges}

    def finalize(self) -> "Molecule":
        ring_bonds = self._find_ring_bonds()
        for b in self.bonds:
            b.in_ring = b.idx in ring_bonds
            # an "aromatic" default bond between two lowercase atoms that is
            # not in a ring is actually a single bond (e.g. biphenyl junction)
            if b.bond_type is BondType.AROMATIC and not b.in_ring:
                b.bond_type = BondType.SINGLE

        self._assign_implicit_hs()
        self._assign_hybridization()
        self._perceive_double_bond_stereo()
        return self

    def _bond_order_sum(self, atom: Atom) -> int:
        """Integer bond-order sum used for valence accounting.

        Aromatic atoms use the Kekulé-equivalent convention: aromatic bonds
        count 1 and atoms that carry a double bond in any Kekulé structure
        (C/N/P/B) get +1; π-donor heteroatoms (O/S/Se/Te) do not.
        """
        if atom.aromatic:
            s = 0
            for b in self.bonds_of(atom.idx):
                s += 1 if b.bond_type is BondType.AROMATIC else int(b.order())
            if atom.symbol not in ("O", "S", "Se", "Te"):
                s += 1
            return s
        total = 0.0
        for b in self.bonds_of(atom.idx):
            total += b.order()
        return int(total + 0.999) if total != int(total) else int(total)

    def _assign_implicit_hs(self) -> None:
        for atom in self.atoms:
            if atom.explicit_hs is not None:
                atom.num_implicit_hs = 0
                continue
            valences = DEFAULT_VALENCES.get(atom.symbol)
            if valences is None:
                atom.num_implicit_hs = 0
                continue
            bos = self._bond_order_sum(atom)
            # charge adjusts the effective valence for common cases (N+: 4, O-: 1)
            chg = atom.formal_charge
            nh = 0
            for v in valences:
                eff = v + chg if atom.symbol in ("N", "P", "B") else v - abs(chg)
                if atom.symbol in ("O", "S") and chg > 0:
                    eff = v + chg
                if eff >= bos:
                    nh = eff - bos
                    break
            atom.num_implicit_hs = max(nh, 0)

    def _assign_hybridization(self) -> None:
        for atom in self.atoms:
            if atom.symbol == "H":
                atom.hybridization = Hybridization.S
                continue
            n_triple = sum(1 for b in self.bonds_of(atom.idx) if b.bond_type is BondType.TRIPLE)
            n_double = sum(1 for b in self.bonds_of(atom.idx) if b.bond_type is BondType.DOUBLE)
            if n_triple or n_double >= 2:
                atom.hybridization = Hybridization.SP
            elif n_double or atom.aromatic:
                atom.hybridization = Hybridization.SP2
            else:
                heavy = len(self._adj[atom.idx])
                total = heavy + atom.GetTotalNumHs()
                if total > 4:
                    atom.hybridization = (
                        Hybridization.SP3D if total == 5 else Hybridization.SP3D2
                    )
                else:
                    atom.hybridization = Hybridization.SP3
        return

    def _perceive_double_bond_stereo(self) -> None:
        """Assign CIS/TRANS stereo to double bonds flanked by directional bonds."""
        for b in self.bonds:
            if b.bond_type is not BondType.DOUBLE or b.in_ring:
                continue
            left = self._directional_neighbor(b.begin, b.idx)
            right = self._directional_neighbor(b.end, b.idx)
            if left is None or right is None:
                continue
            l_dir, _ = left
            r_dir, _ = right
            # directions are normalized "as seen from the stereo atom", so
            # F/C=C/F (trans, Daylight) arrives here as ('\\', '/'): opposite
            # normalized symbols = trans, same = cis
            b.stereo = BondStereo.CIS if l_dir == r_dir else BondStereo.TRANS

    def _directional_neighbor(self, atom_idx: int, skip_bond: int):
        for nb in self.bonds_of(atom_idx):
            if nb.idx == skip_bond or not nb.direction:
                continue
            # normalize direction to be "as seen from atom_idx"
            d = nb.direction
            if nb.end == atom_idx:
                d = "/" if d == "\\" else "\\"
            return d, nb
        return None
