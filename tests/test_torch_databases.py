"""Feature databases, SDF point clouds and the GVP data containers against
the JAX package: the NPZ/NPY/HDF5 stores (eager and lazy, with the
closed-database error), the exceptions module, ``_parse_molblock`` and
``SDFDatabase``, ``MolToPointCloud`` and its collate, ``DatabaseManager``
in the dataset and its loader, and the SDF -> dataset -> SchNet path with
its outputs against JAX's on the same file and weights.

Arrays that are copied compare exactly; model outputs at rtol = atol =
1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from notorch_tpu import exceptions as jax_exceptions
from notorch_tpu.data import databases as jax_db
from notorch_tpu.data import gvp as jax_gvp
from notorch_tpu.data.batching import DataLoader as JaxDataLoader
from notorch_tpu.data.dataset import DatabaseManager as JaxDatabaseManager
from notorch_tpu.data.dataset import MolecularDataset as JaxMolecularDataset
from notorch_tpu.data.dataset import TargetSpec as JaxTargetSpec
from notorch_tpu.data.dataset import TransformManager as JaxTransformManager
from notorch_tpu.models.spatial import build_spatial_model as jax_build_spatial_model
from notorch_tpu.training.loop import predict as jax_predict
from notorch_tpu.transforms import MolToGraph as JaxMolToGraph
from notorch_tpu.transforms import Pipeline as JaxPipeline
from notorch_tpu.transforms import SmiToMol as JaxSmiToMol
from notorch_tpu.transforms.point_cloud import MolToPointCloud as JaxMolToPointCloud
from notorch_tpu_torch import exceptions
from notorch_tpu_torch.data import databases as db
from notorch_tpu_torch.data.batching import DataLoader
from notorch_tpu_torch.data.dataset import DatabaseManager, MolecularDataset, TargetSpec, TransformManager
from notorch_tpu_torch.data.gvp import DualRankFeatures, GVPPointCloud
from notorch_tpu_torch.data.point_cloud import BatchedPointCloud, make_clouds, pad_point_clouds
from notorch_tpu_torch.model.convert import params_from_jax
from notorch_tpu_torch.models.spatial import build_spatial_model
from notorch_tpu_torch.training.loop import fit, predict, to_device
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol
from notorch_tpu_torch.transforms.point_cloud import MolToPointCloud
from notorch_tpu_torch.transforms.vocab import DEFAULT_NUM_ATOM_TYPES

from .test_databases import MOLBLOCK
from .test_torch_spatial import jax_batch

TOL = dict(rtol=1e-4, atol=1e-4)
# an aromatic ring (bond order 4) with its conformer, beside MOLBLOCK's chains
BENZENE = "\n  benzene\n  program\n\n  6  6  0  0  0  0  0  0  0  0999 V2000\n" + "".join(
    f"{1.39 * np.cos(k * np.pi / 3):10.4f}{1.39 * np.sin(k * np.pi / 3):10.4f}{0.0:10.4f} C   0  0  0  0  0\n"
    for k in range(6)) + "".join(f"{k + 1:3d}{(k + 1) % 6 + 1:3d}  4  0\n" for k in range(6)) + "M  END\n$$$$\n"


def mol_record(mol) -> dict:
    """What a parsed molecule carries: atoms (symbol, aromatic flag,
    hydrogens, hybridization), bonds (ends, type) and coordinates."""
    return {"atoms": [(a.GetSymbol(), a.GetIsAromatic(), a.GetTotalNumHs(), a.GetHybridization().name)
                      for a in mol.GetAtoms()],
            "bonds": [(b.GetBeginAtomIdx(), b.GetEndAtomIdx(), b.GetBondType().name) for b in mol.GetBonds()],
            "coords": np.asarray(mol.coords).tolist()}


@pytest.mark.parametrize("mmap", [False, True])
def test_npz_and_npy_databases_equal_jax(tmp_path, mmap):
    X = np.random.default_rng(0).standard_normal((10, 4)).astype(np.float32)
    np.savez(tmp_path / "f.npz", feats=X)
    np.save(tmp_path / "f.npy", X)
    pairs = [(db.NPZDatabase(tmp_path / "f.npz", key="feats", mmap=mmap),
              jax_db.NPZDatabase(tmp_path / "f.npz", key="feats", mmap=mmap)),
             (db.NPYDatabase(tmp_path / "f.npy", mmap=mmap), jax_db.NPYDatabase(tmp_path / "f.npy", mmap=mmap))]
    for ours, ref in pairs:
        assert len(ours) == len(ref) == 10 and list(ours) == list(ref)
        np.testing.assert_array_equal(ours[3], ref[3])
        batch = ours.collate([ours[0], ours[5]])
        np.testing.assert_array_equal(batch, ref.collate([ref[0], ref[5]]))
        assert batch.shape == (2, 4) and batch.dtype == np.float32


def test_hdf5_databases_equal_jax(tmp_path):
    """The eager store, and the lazy one read only inside its context, both
    sides raising the closed-database error (one class, re-exported by
    exceptions) outside it."""
    h5py = pytest.importorskip("h5py")
    X = np.random.default_rng(1).standard_normal((6, 3)).astype(np.float32)
    with h5py.File(tmp_path / "f.h5", "w") as f:
        f.create_dataset("X", data=X)
    ours, ref = db.HDF5Database(tmp_path / "f.h5", dataset="X"), jax_db.HDF5Database(tmp_path / "f.h5", dataset="X")
    assert len(ours) == len(ref) == 6
    np.testing.assert_array_equal(ours[2], ref[2])
    for lazy in (db.HDF5DatabaseOnDisk(tmp_path / "f.h5", dataset="X"),
                 jax_db.HDF5DatabaseOnDisk(tmp_path / "f.h5", dataset="X")):
        assert len(lazy) == 6
        with pytest.raises(RuntimeError, match="is not open"):
            lazy[0]
        with lazy:
            np.testing.assert_array_equal(lazy[4], X[4])
            assert len(lazy) == 6
        with pytest.raises(exceptions.ClosedDatabaseError if isinstance(lazy, db.Database)
                           else jax_db.ClosedDatabaseError):
            lazy[0]
    assert exceptions.ClosedDatabaseError is db.ClosedDatabaseError


def test_exceptions_equal_jax():
    for ours, ref in ((exceptions.InvalidShapeError("x", (3, 4), [(3, 5), (2,)]),
                       jax_exceptions.InvalidShapeError("x", (3, 4), [(3, 5), (2,)])),
                      (exceptions.InvalidChoiceError("relu6", {"relu", "gelu"}),
                       jax_exceptions.InvalidChoiceError("relu6", {"relu", "gelu"}))):
        assert isinstance(ours, ValueError) and str(ours) == str(ref)
    assert exceptions.pretty_shape((2, 3, 4)) == jax_exceptions.pretty_shape((2, 3, 4)) == "2 x 3 x 4"
    assert exceptions.__all__ == jax_exceptions.__all__


def test_parse_molblock_and_sdf_database_equal_jax(tmp_path):
    """Atoms, hydrogens, hybridization, bonds, aromatic flags and
    coordinates of each mol block, read alone and from an SDF file."""
    for block in [*MOLBLOCK.split("$$$$")[:2], BENZENE.split("$$$$")[0]]:
        ours, ref = db._parse_molblock(block), jax_db._parse_molblock(block)
        assert mol_record(ours) == mol_record(ref)
        assert ours.coords.dtype == np.float32
    benzene = db._parse_molblock(BENZENE.split("$$$$")[0])
    assert all(a.GetIsAromatic() for a in benzene.GetAtoms())
    (tmp_path / "mols.sdf").write_text(MOLBLOCK + BENZENE)
    ours, ref = db.SDFDatabase(tmp_path / "mols.sdf"), jax_db.SDFDatabase(tmp_path / "mols.sdf")
    assert len(ours) == len(ref) == 3
    assert [mol_record(m) for m in ours.collate([ours[i] for i in ours])] == [mol_record(m) for m in ref.mols]
    assert ours[0].coords.shape == (3, 3)


def test_mol_to_point_cloud_and_collate_equal_jax(tmp_path):
    """Node types and coordinates of each molecule; the collate's default
    cap (atoms rounded up to 64) and a given one; a molecule without
    coordinates is refused."""
    (tmp_path / "mols.sdf").write_text(MOLBLOCK + BENZENE)
    mols, jmols = db.SDFDatabase(tmp_path / "mols.sdf"), jax_db.SDFDatabase(tmp_path / "mols.sdf")
    t, jt = MolToPointCloud(), JaxMolToPointCloud()
    assert t.num_node_types == jt.num_node_types == DEFAULT_NUM_ATOM_TYPES
    clouds, jclouds = [t(m) for m in mols.mols], [jt(m) for m in jmols.mols]
    for c, jc in zip(clouds, jclouds):
        np.testing.assert_array_equal(c.node_types, jc.node_types)
        np.testing.assert_array_equal(c.coords, jc.coords)
    for cap in (None, 128):
        P, jP = MolToPointCloud.collate(clouds, node_cap=cap), JaxMolToPointCloud.collate(jclouds, node_cap=cap)
        assert isinstance(P, BatchedPointCloud) and P.num_nodes == (cap or 64) and P.n_graphs == jP.n_graphs == 3
        for f in BatchedPointCloud._ARRAYS:
            np.testing.assert_array_equal(getattr(P, f), np.asarray(getattr(jP, f)), err_msg=f)
    with pytest.raises(ValueError, match="no 3D coordinates"):
        t(SmiToMol()("CCO"))


def test_database_manager_in_dataset_and_loader_equal_jax(tmp_path):
    """A feature database beside a graph transform: looked up before the
    transforms run (a transform may read what it wrote), collated as its
    database collates, padded to the loader's batch slots, as in JAX."""
    X = np.random.default_rng(2).standard_normal((5, 8)).astype(np.float32)
    np.save(tmp_path / "extra.npy", X)
    table = {"smiles": ["CCO", "CCN", "CCC", "CCF", "CO"], "y": [1.0, 2.0, 3.0, 4.0, 5.0]}
    ds = MolecularDataset(table, transforms={"g": TransformManager(Pipeline(SmiToMol(), MolToGraph()), "smiles")},
                          databases={"extra": DatabaseManager(db.NPYDatabase(tmp_path / "extra.npy"), out_key="X_f")},
                          targets={"y": TargetSpec(columns=["y"])})
    jds = JaxMolecularDataset(
        table, transforms={"g": JaxTransformManager(JaxPipeline(JaxSmiToMol(), JaxMolToGraph()), in_key="smiles")},
        databases={"extra": JaxDatabaseManager(jax_db.NPYDatabase(tmp_path / "extra.npy"), out_key="X_f")},
        targets={"y": JaxTargetSpec(columns=["y"])})
    assert list(ds[0]) == list(jds[0])
    for batch, jbatch in zip(DataLoader(ds, batch_size=4), JaxDataLoader(jds, batch_size=4)):
        assert set(batch) == set(jbatch)
        for key in ("inputs.X_f", "targets.y", "targets.y_mask"):
            np.testing.assert_array_equal(batch[key], np.asarray(jbatch[key]), err_msg=key)
    assert batch["inputs.X_f"].shape == (4, 8) and not batch["inputs.X_f"][1:].any()
    # a transform reads the database's value: the molecule from the SDF file
    (tmp_path / "mols.sdf").write_text(MOLBLOCK)
    sdf = MolecularDataset({"idx": [1, 0]}, transforms={"p": TransformManager(MolToPointCloud(), in_key="mol")},
                           databases={"mols": DatabaseManager(db.SDFDatabase(tmp_path / "mols.sdf"), "idx", "mol")})
    assert sdf[0]["P"].num_nodes == 2 and sdf[1]["P"].num_nodes == 3


def test_dual_rank_features_and_gvp_point_cloud_equal_jax():
    """The batch-shape check and its message, astuple, update and .to."""
    s, v = torch.zeros(4, 5, 6), torch.zeros(4, 5, 3, 2)
    feats = DualRankFeatures(s, v)
    ref = jax_gvp.DualRankFeatures(jnp.zeros((4, 5, 6)), jnp.zeros((4, 5, 3, 2)))
    assert feats.batch_shape == tuple(ref.batch_shape) == (4, 5)
    assert feats.astuple()[0] is s and feats.astuple()[1] is v
    for bad in ((torch.zeros(4, 6), torch.zeros(5, 3, 2)), (jnp.zeros((4, 6)), jnp.zeros((5, 3, 2)))):
        cls = DualRankFeatures if isinstance(bad[0], torch.Tensor) else jax_gvp.DualRankFeatures
        with pytest.raises(ValueError, match=r"batch shapes disagree: scalar \(4,\) vs vector \(5,\)"):
            cls(*bad)
    cloud = pad_point_clouds(make_clouds(2, seed=0), 64)
    P = GVPPointCloud(feats, cloud).to("cpu")
    assert isinstance(P.cloud.coords, torch.Tensor) and P.features.scalar.device.type == "cpu"
    assert P.update(features=DualRankFeatures(s[:1], v[:1])).features.batch_shape == (1, 5)


def test_sdf_to_schnet_equals_jax(tmp_path):
    """The spatial data path of tests/test_spatial.py on an SDF file of 48
    conformers (chip_smoke.py's writer, synthetic clouds with element
    symbols): SDFDatabase -> DatabaseManager -> MolToPointCloud -> the
    dataset's collate -> SchNet, outputs and predictions against JAX's on
    the same file and weights; then one epoch of fit."""
    sdf = tmp_path / "clouds.sdf"
    clouds = make_clouds(48, seed=3)
    table = chip_smoke.clouds_sdf(sdf, clouds)

    def dataset(pkg):
        dbm, dsm, tm, ts, t = ((JaxDatabaseManager, JaxMolecularDataset, JaxTransformManager, JaxTargetSpec,
                                JaxMolToPointCloud) if pkg == "jax" else
                               (DatabaseManager, MolecularDataset, TransformManager, TargetSpec, MolToPointCloud))
        store = (jax_db if pkg == "jax" else db).SDFDatabase(sdf)
        return dsm(table, transforms={"p": tm(t(), in_key="mol")},
                   databases={"mols": dbm(store, out_key="mol")},
                   targets={"y": ts(columns=["y"])})

    batches = list(DataLoader(dataset("port"), batch_size=16))
    jbatches = list(JaxDataLoader(dataset("jax"), batch_size=16))
    assert len(batches) == 3 and sorted(batches[0]) == ["inputs.P", "inputs.mol", "targets.y", "targets.y_mask"]
    for batch, jbatch in zip(batches, jbatches):
        P, jP = batch["inputs.P"], jbatch["inputs.P"]
        for f in BatchedPointCloud._ARRAYS:
            np.testing.assert_array_equal(getattr(P, f), np.asarray(getattr(jP, f)), err_msg=f)
        np.testing.assert_array_equal(batch["targets.y"], np.asarray(jbatch["targets.y"]))
    # the file holds the clouds' coordinates to 4 decimals
    np.testing.assert_allclose(batches[0]["inputs.P"].coords[batches[0]["inputs.P"].node_mask],
                               np.concatenate([c.coords for c in clouds[:16]]), rtol=0, atol=5.1e-5)
    kw = dict(hidden_dim=16, depth=2, aggregation="sum")
    jmodel = jax_build_spatial_model(**kw)
    model = build_spatial_model(**kw, generator=torch.Generator().manual_seed(0))
    jb = [jax_batch({k: v for k, v in b.items() if k != "inputs.mol"}) for b in batches]
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jb[0]).params)
    model.network.load_state_dict(params_from_jax(params))
    out = model.network(to_device(batches[0], "cpu"))
    ref = jmodel.network.apply({"params": params}, jb[0])
    np.testing.assert_allclose(out["backbone.P"].node_feats.detach().numpy(),
                               np.asarray(ref["backbone.P"].node_feats), **TOL)
    preds = predict(model, batches, keys=["ffn.preds"])["ffn.preds"]
    np.testing.assert_allclose(preds, np.asarray(jax_predict(jmodel, params, jb, keys=["ffn.preds"])["ffn.preds"]),
                               **TOL)
    history = fit(model, DataLoader(dataset("port"), batch_size=16), epochs=1).history
    assert np.isfinite(history[0]["train/loss"])
