"""The port's scaffold split against the JAX package's: the same scaffold
keys and the same fold indices on ``tests/data/smis.csv`` and
``tests/data/lipo.csv``, for three seeds, ``balanced`` on and off."""

import csv
import os

import numpy as np
import pytest

from notorch_tpu.data.splits import murcko_scaffold_atoms as jax_murcko_scaffold_atoms
from notorch_tpu.data.splits import scaffold_key as jax_scaffold_key
from notorch_tpu.data.splits import scaffold_split as jax_scaffold_split
from notorch_tpu.chem import parse_smiles as jax_parse_smiles
from notorch_tpu_torch.chem.smiles import parse_smiles
from notorch_tpu_torch.data.splits import murcko_scaffold_atoms, scaffold_key, scaffold_split

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def smiles_of(name: str) -> list[str]:
    with open(os.path.join(DATA, name)) as f:
        return [row["smiles"] for row in csv.DictReader(f)]


def test_scaffold_atoms_and_keys_match_jax(smis):
    for smi in smis:
        assert murcko_scaffold_atoms(parse_smiles(smi)) == jax_murcko_scaffold_atoms(jax_parse_smiles(smi))
        assert scaffold_key(smi) == jax_scaffold_key(smi)
    assert scaffold_key("CCO") == 0  # acyclic molecules share the sentinel key
    assert scaffold_key("c1ccccc1CC") == scaffold_key("CCc1ccccc1")  # atom order does not matter


@pytest.mark.parametrize("data", ["smis.csv", "lipo.csv"])
@pytest.mark.parametrize("balanced", [False, True], ids=["largest_first", "balanced"])
def test_scaffold_split_folds_match_jax(data, balanced):
    smiles = smiles_of(data)
    for seed in (0, 1, 2):
        ours = scaffold_split(smiles, (0.8, 0.1, 0.1), seed=seed, balanced=balanced)
        theirs = jax_scaffold_split(smiles, (0.8, 0.1, 0.1), seed=seed, balanced=balanced)
        assert len(ours) == len(theirs) == 3
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
        assert sorted(np.concatenate(ours).tolist()) == list(range(len(smiles)))
    # a scaffold never crosses folds
    fold_of = {int(i): f for f, idx in enumerate(ours) for i in idx}
    by_key: dict[int, set[int]] = {}
    for i, smi in enumerate(smiles):
        key = scaffold_key(smi)
        if key:
            by_key.setdefault(key, set()).add(fold_of[i])
    assert all(len(folds) == 1 for folds in by_key.values())
