"""The port's native (C++) featurizer against the port's Python pipeline
and the JAX package's Python pipeline: the same graphs, array for array,
on the fixture SMILES, the tricky cases of test_native.py and the first 256
lipo molecules (through ``featurize_batch`` and its status); garbage is
rejected; the library is built under a hash of its source and flags; the
CLI's default transform is the native one where a compiler exists. The
JAX package's own native build is not used."""

import os

import numpy as np
import pytest

from notorch_tpu.transforms import MolToGraph as JaxMolToGraph
from notorch_tpu.transforms import Pipeline as JaxPipeline
from notorch_tpu.transforms import SmiToMol as JaxSmiToMol
from notorch_tpu_torch import native
from notorch_tpu_torch.cli.train import build_dataset, smiles_pipeline
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol

PIPE = Pipeline(SmiToMol(), MolToGraph())
JAX_PIPE = JaxPipeline(JaxSmiToMol(), JaxMolToGraph())
TRICKY = ["c1ccccc1", "c1ccccc1-c1ccccc1", "F/C=C/F", "F/C=C\\F", "[NH4+]", "[O-]C(=O)C", "c1cc[nH]c1",
          "c1ccsc1", "C%10CCCCC%10", "[CH3:7][N+:2](C)(C)C", "O", "[Na+].[Cl-]", "C[C@H](N)C(=O)O",
          "C[C@@H](N)C(=O)O"]
FIELDS = ("node_types", "edge_types", "src", "dst", "rev")


def _same(a, b, smi):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == np.int32 and np.asarray(y).dtype == np.int32, (smi, f)
        np.testing.assert_array_equal(x, np.asarray(y), err_msg=f"{f} {smi}")


def test_native_builds_under_a_hash_and_is_available():
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent.name == "notorch_tpu_torch" and path.parent.parent.name == "build"
    assert path.name.startswith("libfeaturizer-")
    assert isinstance(smiles_pipeline(), native.NativeSmiToGraph)


@pytest.mark.parametrize("case", ["fixture", "tricky"])
def test_native_graphs_equal_both_python_pipelines(case, smis):
    cases = smis if case == "fixture" else TRICKY
    for smi in cases:
        cc = native.featurize_smiles(smi)
        assert cc is not None, smi
        _same(cc, PIPE(smi), smi)
        _same(cc, JAX_PIPE(smi), smi)
        _same(native.NativeSmiToGraph()(smi), cc, smi)


def test_native_batch_equals_python_on_lipo(lipo_rows):
    smis = [r[0] for r in lipo_rows][:256]
    graphs, status = native.featurize_batch(smis, n_threads=2)
    assert status.shape == (256,) and (status == 0).all()
    for smi, cc in zip(smis, graphs):
        _same(cc, PIPE(smi), smi)
        _same(cc, JAX_PIPE(smi), smi)


def test_native_rejects_garbage():
    for bad in ("C(", "C1CC", "Zz"):
        assert native.featurize_smiles(bad) is None
        with pytest.raises(ValueError, match="failed to parse"):
            native.NativeSmiToGraph()(bad)
    graphs, status = native.featurize_batch(["CCO", "C(", "c1ccccc1", "Zz"], n_threads=1)
    assert [s != 0 for s in status] == [False, True, False, True]
    assert graphs[1] is None and graphs[3] is None
    _same(graphs[2], PIPE("c1ccccc1"), "c1ccccc1")


@pytest.mark.parametrize("compiler", ["missing", "refusing"])
def test_no_compiler_is_unavailable_a_refusing_one_raises(monkeypatch, tmp_path, compiler):
    """No compiler: unavailable, and the CLI takes the Python pipeline. A
    compiler that refuses the source (here one that always fails, building
    into an empty directory): ``available()`` raises, nothing is left."""
    cxx = tmp_path / "cxx"
    if compiler == "refusing":
        cxx.write_text("#!/bin/sh\necho 'refused' >&2\nexit 1\n")
        cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native._load.cache_clear()
    try:
        if compiler == "missing":
            assert not native.available()
            with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
                native.featurize_smiles("CCO")
            assert isinstance(smiles_pipeline(), Pipeline)
        else:
            with pytest.raises(native.FeaturizerCompileError, match="refused"):
                native.available()
            assert list((tmp_path / "build").iterdir()) == []
    finally:
        native._load.cache_clear()


def test_cli_dataset_featurizes_natively_as_python_does(tmp_path, lipo_rows):
    path = tmp_path / "lipo.csv"
    path.write_text("smiles,lipo\n" + "".join(f"{s},{y}\n" for s, y in lipo_rows[:32]))
    ds = build_dataset({"csv": str(path), "targets": {"y": {"columns": ["lipo"]}}})
    assert isinstance(ds.transforms["graph"].transform, native.NativeSmiToGraph)
    for i, (smi, _) in enumerate(lipo_rows[:32]):
        _same(ds[i]["G"], PIPE(smi), smi)
    assert os.path.exists(native.library_path())
