"""A self-contained SMILES parser.

Replaces the reference's RDKit dependency (``notorch/transforms/chem.py:20-27``)
for environments without RDKit. Supports the full organic subset, bracket atoms
(isotope, chirality, H-count, charge, atom maps), branches, ring closures
(including ``%nn``), directional bonds, dots, and reaction SMILES
(``reactants>agents>products``).

Aromaticity is taken from lowercase notation (as written), with non-ring
"aromatic" bonds demoted to single bonds during perception.
"""

from __future__ import annotations

import re

from notorch_tpu_torch.chem.mol import (
    Atom,
    Bond,
    BondType,
    ChiralTag,
    Molecule,
    ORGANIC_SUBSET,
)

__all__ = ["MolFromSmiles", "parse_smiles", "parse_reaction_smiles", "SmilesParseError"]


class SmilesParseError(ValueError):
    pass


_BRACKET_RE = re.compile(
    r"^(?P<isotope>\d+)?"
    r"(?P<symbol>[A-Z][a-z]?|[cnobps]|se|as|te|si|\*)"
    r"(?P<chiral>@{1,2}(?:TH[12]|AL[12]|SP[1-3]|TB\d{1,2}|OH\d{1,2})?)?"
    r"(?P<hcount>H\d*)?"
    r"(?P<charge>\+{1,3}|-{1,3}|\+\d+|-\d+)?"
    r"(?::(?P<map>\d+))?$"
)

_BOND_CHARS = {
    "-": BondType.SINGLE,
    "=": BondType.DOUBLE,
    "#": BondType.TRIPLE,
    ":": BondType.AROMATIC,
    "/": BondType.SINGLE,
    "\\": BondType.SINGLE,
}

_TWO_LETTER_ORGANIC = ("Cl", "Br")


def _parse_bracket_atom(body: str) -> Atom:
    m = _BRACKET_RE.match(body)
    if m is None:
        raise SmilesParseError(f"invalid bracket atom: [{body}]")
    sym = m.group("symbol")
    aromatic = sym[0].islower() and sym != "*"
    symbol = sym if not aromatic else sym.capitalize()
    if sym == "*":
        symbol = "*"
    if symbol != "*":
        from notorch_tpu_torch.chem.mol import ATOMIC_NUMBERS

        if symbol not in ATOMIC_NUMBERS:
            raise SmilesParseError(f"unknown element {symbol!r} in [{body}]")

    chiral = ChiralTag.UNSPECIFIED
    if m.group("chiral"):
        c = m.group("chiral")
        if c == "@":
            chiral = ChiralTag.TETRAHEDRAL_CCW
        elif c == "@@":
            chiral = ChiralTag.TETRAHEDRAL_CW
        else:
            chiral = ChiralTag.OTHER

    hcount = 0
    if m.group("hcount"):
        h = m.group("hcount")[1:]
        hcount = int(h) if h else 1

    charge = 0
    if m.group("charge"):
        c = m.group("charge")
        if c in ("+", "++", "+++"):
            charge = len(c)
        elif c in ("-", "--", "---"):
            charge = -len(c)
        else:
            charge = int(c)

    return Atom(
        symbol=symbol,
        aromatic=aromatic,
        formal_charge=charge,
        explicit_hs=hcount,
        isotope=int(m.group("isotope") or 0),
        atom_map=int(m.group("map") or 0),
        chiral_tag=chiral,
    )


def parse_smiles(smi: str) -> Molecule:
    """Parse a SMILES string into a finalized :class:`Molecule`."""
    mol = Molecule()
    prev: int | None = None  # previous atom idx in the chain
    pending_bond: BondType | None = None
    pending_dir = ""
    branch_stack: list[int | None] = []
    # ring-closure number -> (atom idx, pending bond type, direction)
    ring_open: dict[int, tuple[int, BondType | None, str]] = {}

    i, n = 0, len(smi)
    while i < n:
        ch = smi[i]

        if ch == "[":
            j = smi.find("]", i)
            if j < 0:
                raise SmilesParseError(f"unclosed bracket in {smi!r}")
            atom = _parse_bracket_atom(smi[i + 1 : j])
            i = j + 1
            prev = _attach(mol, atom, prev, pending_bond, pending_dir)
            pending_bond, pending_dir = None, ""
        elif ch.isalpha() or ch == "*":
            if smi[i : i + 2] in _TWO_LETTER_ORGANIC:
                sym, i = smi[i : i + 2], i + 2
            else:
                sym, i = ch, i + 1
            aromatic = sym.islower()
            symbol = sym.capitalize() if aromatic else sym
            if symbol not in ORGANIC_SUBSET and symbol != "*":
                raise SmilesParseError(f"element {symbol!r} requires brackets in {smi!r}")
            atom = Atom(symbol=symbol, aromatic=aromatic)
            prev = _attach(mol, atom, prev, pending_bond, pending_dir)
            pending_bond, pending_dir = None, ""
        elif ch in _BOND_CHARS:
            pending_bond = _BOND_CHARS[ch]
            pending_dir = ch if ch in "/\\" else ""
            i += 1
        elif ch.isdigit() or ch == "%":
            if ch == "%":
                digits = smi[i + 1 : i + 3]
                if len(digits) != 2 or not digits.isdigit():
                    raise SmilesParseError(f"invalid %-ring closure at {i} in {smi!r}")
                num, i = int(digits), i + 3
            else:
                num, i = int(ch), i + 1
            if prev is None:
                raise SmilesParseError(f"ring closure before any atom in {smi!r}")
            if num in ring_open:
                other, opened_bond, opened_dir = ring_open.pop(num)
                bt = pending_bond or opened_bond or _default_bond(mol, other, prev)
                direction = pending_dir or opened_dir
                mol.add_bond(Bond(other, prev, bt, direction=direction))
            else:
                ring_open[num] = (prev, pending_bond, pending_dir)
            pending_bond, pending_dir = None, ""
        elif ch == "(":
            branch_stack.append(prev)
            i += 1
        elif ch == ")":
            if not branch_stack:
                raise SmilesParseError(f"unbalanced parentheses in {smi!r}")
            prev = branch_stack.pop()
            i += 1
        elif ch == ".":
            prev = None
            pending_bond, pending_dir = None, ""
            i += 1
        elif ch.isspace():
            break  # SMILES may be followed by a title
        else:
            raise SmilesParseError(f"unexpected character {ch!r} at {i} in {smi!r}")

    if ring_open:
        raise SmilesParseError(f"unclosed ring bond(s) {sorted(ring_open)} in {smi!r}")
    if branch_stack:
        raise SmilesParseError(f"unbalanced parentheses in {smi!r}")
    if pending_bond is not None:
        raise SmilesParseError(f"dangling bond at end of {smi!r}")

    return mol.finalize()


def _default_bond(mol: Molecule, a: int, b: int) -> BondType:
    if mol.atoms[a].aromatic and mol.atoms[b].aromatic:
        return BondType.AROMATIC
    return BondType.SINGLE


def _attach(
    mol: Molecule,
    atom: Atom,
    prev: int | None,
    pending_bond: BondType | None,
    pending_dir: str,
) -> int:
    idx = mol.add_atom(atom)
    if prev is not None:
        bt = pending_bond or _default_bond(mol, prev, idx)
        mol.add_bond(Bond(prev, idx, bt, direction=pending_dir))
    return idx


def MolFromSmiles(smi: str) -> Molecule | None:
    """RDKit-compatible entry: return ``None`` on parse failure."""
    try:
        return parse_smiles(smi)
    except SmilesParseError:
        return None


def parse_reaction_smiles(rxn: str) -> tuple[Molecule, Molecule]:
    """Parse a reaction SMILES ``reactants>agents>products`` into a
    (reactant, product) pair of (possibly multi-fragment) molecules.

    Capability parity: the reference's dead CGR featurizer consumed
    ``Rxn = tuple[Mol, Mol]`` (reference ``notorch/types.py:10``).
    """
    parts = rxn.split(">")
    if len(parts) == 2:
        reac_s, prod_s = parts
    elif len(parts) == 3:
        reac_s, _, prod_s = parts
    else:
        raise SmilesParseError(f"invalid reaction SMILES: {rxn!r}")
    return parse_smiles(reac_s), parse_smiles(prod_s)
