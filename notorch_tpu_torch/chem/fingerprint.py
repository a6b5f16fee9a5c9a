"""Morgan (ECFP-style) circular fingerprints, self-contained.

Port of ``notorch_tpu.chem.fingerprint`` on the port's own ``Molecule``:
iterative neighbourhood hashing of atom invariants, folded into a
fixed-length bit or count vector. The hashes are Python's ``hash`` of
tuples of ints, which does not vary from one process to the next, so both
packages give the same arrays.
"""

from __future__ import annotations

import numpy as np

from notorch_tpu_torch.chem.mol import Molecule


def _initial_invariant(mol: Molecule, idx: int) -> int:
    a = mol.atoms[idx]
    key = (
        a.GetAtomicNum(),
        a.GetDegree(),
        a.GetTotalNumHs(),
        a.formal_charge,
        int(a.aromatic),
        int(any(b.in_ring for b in mol.bonds_of(idx))),
    )
    return hash(key) & 0xFFFFFFFF


def morgan_fingerprint(
    mol: Molecule,
    radius: int = 2,
    num_bits: int = 2048,
    count: bool = False,
) -> np.ndarray:
    """Compute a folded Morgan fingerprint.

    Parameters are ``MolToFP``'s (``radius``, ``length``,
    bit vs count mode).
    """
    n = mol.GetNumAtoms()
    invariants = [_initial_invariant(mol, i) for i in range(n)]
    # (bond order key, neighbor idx) pairs per atom, sorted for canonicalization
    nbrs: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for b in mol.bonds:
        k = int(b.order() * 2)
        nbrs[b.begin].append((k, b.end))
        nbrs[b.end].append((k, b.begin))

    features: set[int] = set(invariants)
    counts: dict[int, int] = {}
    for inv in invariants:
        counts[inv] = counts.get(inv, 0) + 1

    current = invariants
    for _ in range(radius):
        nxt = []
        for i in range(n):
            env = sorted((k, current[j]) for k, j in nbrs[i])
            code = hash((current[i], tuple(env))) & 0xFFFFFFFF
            nxt.append(code)
        for code in nxt:
            if code not in features or count:
                counts[code] = counts.get(code, 0) + 1
            features.add(code)
        current = nxt

    fp = np.zeros(num_bits, dtype=np.int32 if count else np.float32)
    if count:
        for code, c in counts.items():
            fp[code % num_bits] += c
    else:
        for code in features:
            fp[code % num_bits] = 1
    return fp
