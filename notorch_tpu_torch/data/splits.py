"""Dataset splitting: Bemis-Murcko scaffold splits.

Port of ``notorch_tpu.data.splits`` on the port's own chemistry backend
(``notorch_tpu_torch.chem``, no RDKit): molecules sharing a Bemis-Murcko
scaffold (ring systems + linkers) land in the same fold, the MoleculeNet
protocol of the Tox21 config. Scaffold identity is an order-invariant
Weisfeiler-Lehman-style hash of the scaffold subgraph; it hashes tuples of
ints, which is the same in every process. The random split is
:func:`notorch_tpu_torch.data.batching.random_split`.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from notorch_tpu_torch.chem.mol import Molecule
from notorch_tpu_torch.chem.smiles import parse_smiles

__all__ = ["murcko_scaffold_atoms", "scaffold_key", "scaffold_split"]


def murcko_scaffold_atoms(mol: Molecule) -> set[int]:
    """Atom indices of the Bemis-Murcko scaffold: iteratively strip
    non-ring terminal atoms; what remains is rings + linkers."""
    ring_atoms = {a for b in mol.bonds if b.in_ring for a in (b.begin, b.end)}
    if not ring_atoms:
        return set()
    alive = set(range(mol.GetNumAtoms()))
    changed = True
    while changed:
        changed = False
        for i in list(alive):
            if i in ring_atoms:
                continue
            if len([j for j in mol.neighbors(i) if j in alive]) <= 1:
                alive.discard(i)
                changed = True
    return alive


def scaffold_key(mol_or_smiles) -> int:
    """Order-invariant hash of the molecule's Murcko scaffold subgraph.
    Molecules with no rings share the sentinel key 0 (MoleculeNet groups
    acyclic molecules together)."""
    mol = parse_smiles(mol_or_smiles) if isinstance(mol_or_smiles, str) else mol_or_smiles
    atoms = murcko_scaffold_atoms(mol)
    if not atoms:
        return 0

    # WL refinement restricted to the scaffold subgraph
    idx = sorted(atoms)
    pos = {a: i for i, a in enumerate(idx)}
    nbrs = [[] for _ in idx]
    for b in mol.bonds:
        if b.begin in atoms and b.end in atoms:
            k = int(b.order() * 2)
            nbrs[pos[b.begin]].append((k, pos[b.end]))
            nbrs[pos[b.end]].append((k, pos[b.begin]))
    inv = [
        hash((mol.atoms[a].GetAtomicNum(), mol.atoms[a].aromatic, len(nbrs[pos[a]]))) & 0xFFFFFFFF
        for a in idx
    ]
    for _ in range(4):
        inv = [hash((inv[i], tuple(sorted((k, inv[j]) for k, j in nbrs[i])))) & 0xFFFFFFFF
               for i in range(len(idx))]
    return hash(tuple(sorted(inv))) & 0x7FFFFFFFFFFFFFFF


def scaffold_split(
    smiles: list[str],
    fractions: tuple[float, ...] = (0.8, 0.1, 0.1),
    seed: int = 0,
    balanced: bool = False,
) -> tuple[np.ndarray, ...]:
    """Greedy scaffold split: group molecules by scaffold, order groups
    largest-first (ties in a seeded random order, or all shuffled when
    ``balanced``), fill folds in sequence. Molecules sharing a scaffold
    never cross folds. A SMILES that does not parse is its own group under
    ``hash(smi)``, as in the JAX package (a string's hash differs between
    processes unless ``PYTHONHASHSEED`` is set)."""
    groups: dict[int, list[int]] = defaultdict(list)
    for i, smi in enumerate(smiles):
        try:
            key = scaffold_key(smi)
        except Exception:
            key = hash(smi)
        groups[key].append(i)

    group_list = list(groups.values())
    rg = np.random.default_rng(seed)
    if balanced:
        rg.shuffle(group_list)
    else:
        order = sorted(range(len(group_list)), key=lambda g: (-len(group_list[g]), rg.random()))
        group_list = [group_list[g] for g in order]

    n = len(smiles)
    capacities = [f * n for f in fractions]
    folds: list[list[int]] = [[] for _ in fractions]
    for grp in group_list:
        # the fold with the most remaining capacity takes the group
        deficits = [cap - len(fold) for cap, fold in zip(capacities, folds)]
        folds[int(np.argmax(deficits))].extend(grp)
    return tuple(np.asarray(sorted(f)) for f in folds)
