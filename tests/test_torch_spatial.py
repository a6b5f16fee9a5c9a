"""The spatial slice against the JAX package: point-cloud data, the radius
neighbour search, the RBF features, the pointwise embedding, the spatial
readouts, the GVP layers, the registry's spatial names, and the GVP model
both ways it is built (the ``kind: spatial`` recipe, which runs no kernel,
and the declarative config whose ``GvpGNNBlock(impl: fused)`` runs TPU
kernel rows 14-15), trained, checkpointed and served on the CPU.

Inputs are made from numpy seeds and both packages run on the same weights
(``params_from_jax``). Tolerances: outputs, losses and predictions at
rtol = atol = 1e-4; gradients at rtol = 1e-4 and atol 1e-4 times the
tensor's largest magnitude; neighbour indices and masks bit for bit and
distances within 1e-6. The JAX side of the declarative model runs its jnp
conv (``tests/test_spatial.py`` holds it equal to the fused one), which
shares the fused conv's parameter tree.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from notorch_tpu.cli import registry as jax_registry
from notorch_tpu.cli.train import build_model as jax_build_model
from notorch_tpu.data.point_cloud import PointCloud as JaxPointCloud
from notorch_tpu.data.point_cloud import pad_point_clouds as jax_pad_point_clouds
from notorch_tpu.models.spatial import build_spatial_model as jax_build_spatial_model
from notorch_tpu.nn.rbf import RBFEmbedding as JaxRBF
from notorch_tpu.nn.spatial import agg as jax_agg
from notorch_tpu.nn.spatial import gvp as jax_gvp
from notorch_tpu.nn.spatial.neighbors import radius_neighbors as jax_radius_neighbors
from notorch_tpu.nn.spatial.pointwise import PointwiseEmbed as JaxPointwiseEmbed
from notorch_tpu.training.loop import predict as jax_predict
from notorch_tpu_torch.cli import registry
from notorch_tpu_torch.cli.predict import run_predict
from notorch_tpu_torch.cli.train import build_model, run
from notorch_tpu_torch.data.point_cloud import cloud_batches, coordination_targets, make_clouds, pad_point_clouds
from notorch_tpu_torch.model.convert import params_from_jax, params_to_jax
from notorch_tpu_torch.models.spatial import SPATIAL_AGGREGATIONS, build_spatial_model
from notorch_tpu_torch.nn.rbf import RBFEmbedding
from notorch_tpu_torch.nn.spatial import agg
from notorch_tpu_torch.nn.spatial.gvp import GVP, DualRankAggregation, DualRankLayerNorm, GatedGVP
from notorch_tpu_torch.nn.spatial.neighbors import radius_neighbors
from notorch_tpu_torch.nn.spatial.pointwise import Pointwise, PointwiseEmbed
from notorch_tpu_torch.training.checkpoint import Checkpointer
from notorch_tpu_torch.training.loop import fit, predict, to_device
from notorch_tpu_torch.training.optim import OptimizerSpec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
D, BATCH = 32, 16
KEYS = {"preds": "ffn.preds", "targets": "targets.y", "mask": "targets.y_mask"}
# the tier-1 command runs six pytest workers on eight cores: at torch's
# default of a thread a core their threads outnumber the cores many times
# over, and this file's full-width GVP run took ten times its time alone.
# Its tests, and those of the other full-width drift files, which import
# few_torch_threads, run at TEST_THREADS (the GVP and attention gates drift
# alike at 1 and 8 threads)
TEST_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(TEST_THREADS)
    yield
    torch.set_num_threads(threads)


def declarative_gvp_cfg(d=D, dv=8, depth=2, impl="fused", readout="SpatialSum"):
    """The declarative GVP model on the kernel path (README.md), at scalar
    width ``d`` and vector width ``dv``: PointwiseEmbed ->
    GvpGNNBlock(impl) -> ``readout`` (SpatialSum) -> MLP."""
    return {"modules": {
        "embed": {"class": "PointwiseEmbed", "args": {"hidden_dim": d}, "in_keys": ["inputs.P"], "out_keys": ["P"]},
        "backbone": {"class": "GvpGNNBlock",
                     "args": {"scalar_dim": d, "vector_dim": dv, "depth": depth, "radius": 5.0,
                              "max_neighbors": 16, "neighbor_window": 24, "impl": impl},
                     "in_keys": ["embed.P"], "out_keys": ["P"]},
        "readout": {"class": readout, "in_keys": ["backbone.P"], "out_keys": ["H"]},
        "ffn": {"class": "MLP", "args": {"input_dim": d, "output_size": 1, "hidden_dim": d, "num_layers": 1},
                "in_keys": ["readout.H"], "out_keys": ["preds"]},
    }, "losses": {"loss": {"class": "MSE", "in_keys": dict(KEYS)}}}


def jax_batch(batch):
    P = batch["inputs.P"]
    jP = jax_pad_point_clouds([], 1).replace(
        node_feats=jnp.asarray(P.node_feats), coords=jnp.asarray(P.coords), batch_index=jnp.asarray(P.batch_index),
        node_mask=jnp.asarray(P.node_mask), num_graphs_real=jnp.asarray(P.num_graphs_real), n_graphs=P.n_graphs)
    return {"inputs.P": jP, **{k: jnp.asarray(v) for k, v in batch.items() if k != "inputs.P"}}


@pytest.fixture(scope="module")
def batches():
    clouds = make_clouds(48, seed=0)
    return cloud_batches(clouds, coordination_targets(clouds), batch_size=BATCH)


# -- data ---------------------------------------------------------------------------------------


def test_point_clouds_equal_jax():
    """make_clouds draws the JAX bench's clouds (scripts/bench_spatial.py
    make_clouds, the same seed), and pad_point_clouds lays them out as the
    JAX function does, field for field."""
    spec = importlib.util.spec_from_file_location("bench_spatial", os.path.join(ROOT, "scripts", "bench_spatial.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    ref, n_atoms = bench.make_clouds(12, seed=3)
    clouds = make_clouds(12, seed=3)
    assert sum(c.num_nodes for c in clouds) == n_atoms and 10 <= min(c.num_nodes for c in clouds)
    P = pad_point_clouds(clouds, ref.num_nodes, graph_cap=12)
    for f in ("node_feats", "coords", "batch_index", "node_mask", "num_graphs_real"):
        a, r = getattr(P, f), np.asarray(getattr(ref, f))
        assert a.dtype == r.dtype and np.array_equal(a, r), f
    assert P.n_graphs == ref.n_graphs
    batches = cloud_batches(clouds, coordination_targets(clouds), batch_size=5)
    assert [b["inputs.P"].num_nodes % 64 for b in batches] == [0, 0, 0]
    assert batches[-1]["targets.y_mask"].sum() == 2 and batches[-1]["inputs.P"].n_graphs == 5


@pytest.mark.parametrize("K, window, loop", [(8, None, False), (16, 24, False), (8, 12, True), (4, 200, False)])
def test_radius_neighbors_equal_jax(K, window, loop):
    """Full and banded searches: indices and masks bit for bit (ties to the
    lower index, masked slots at 0), distances within 1e-6; the padding
    points (all at 1e9, one graph id) included."""
    clouds = make_clouds(9, seed=7, max_atoms=13 if window == 12 else 25)
    P = pad_point_clouds(clouds, 192)
    ours = radius_neighbors(torch.from_numpy(P.coords), torch.from_numpy(P.batch_index), 5.0, K, loop=loop,
                            window=window)
    ref = jax_radius_neighbors(jnp.asarray(P.coords), jnp.asarray(P.batch_index), 5.0, K, loop=loop, window=window)
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(ours[2].numpy(), np.asarray(ref[2]), rtol=1e-6, atol=1e-6)
    assert ours[0].dtype == torch.int32 and ours[1].dtype == torch.bool


def test_rbf_and_pointwise_embed_equal_jax():
    rng = np.random.default_rng(0)
    d = rng.uniform(0, 5, (40, 8)).astype(np.float32)
    ref = JaxRBF(0.0, 5.0, 16).apply({}, jnp.asarray(d))
    np.testing.assert_allclose(RBFEmbedding(0.0, 5.0, 16)(torch.from_numpy(d)).numpy(), np.asarray(ref), **TOL)
    P = pad_point_clouds(make_clouds(4, seed=1), 128)
    jP = jax_pad_point_clouds([JaxPointCloud(np.asarray(P.node_feats[:0]), P.coords[:0])], 1)
    jP = jP.replace(node_feats=jnp.asarray(P.node_feats))
    jmod = JaxPointwiseEmbed(num_types=12, hidden_dim=D)
    params = jmod.init(jax.random.PRNGKey(0), jP)["params"]
    ref = jmod.apply({"params": params}, jP).node_feats
    for mod in (PointwiseEmbed(num_types=12, hidden_dim=D), Pointwise(PointwiseEmbed(12, D).node)):
        sd = {k.split(".", 1)[1]: v for k, v in params_from_jax({"modules__e": jax.device_get(params)}).items()}
        if isinstance(mod, Pointwise):
            sd = {k.replace("node.", "module.", 1): v for k, v in sd.items()}
        mod.load_state_dict(sd)
        np.testing.assert_allclose(mod(P.to("cpu")).node_feats.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("name", ["sum", "mean", "max", "gated", "sdp"])
def test_spatial_readouts_equal_jax(name):
    rng = np.random.default_rng(1)
    P = pad_point_clouds(make_clouds(5, seed=2), 128, graph_cap=6)
    feats = rng.standard_normal((128, 8)).astype(np.float32)
    jP = jax_pad_point_clouds([JaxPointCloud(np.zeros((1, 1), np.int32), np.zeros((1, 3), np.float32))], 1)
    jP = jP.replace(node_feats=jnp.asarray(feats), coords=jnp.asarray(P.coords), batch_index=jnp.asarray(P.batch_index),
                    node_mask=jnp.asarray(P.node_mask), n_graphs=6)
    TP = P.update(node_feats=feats).to("cpu")
    args, targs = (jP,), (TP,)
    if name == "sdp":
        Q = rng.standard_normal((6, 8)).astype(np.float32)
        jmod, mod = jax_agg.SDPAttention(key_dim=8), agg.SDPAttention(key_dim=8)
        args, targs = (jP, jnp.asarray(Q)), (TP, torch.from_numpy(Q))
    elif name == "gated":
        jmod, mod = jax_agg.Gated(input_dim=8), agg.Gated(input_dim=8)
    else:
        jmod, mod = {"sum": jax_agg.Sum, "mean": jax_agg.Mean, "max": jax_agg.Max}[name](), SPATIAL_AGGREGATIONS[name]()
    variables = jmod.init(jax.random.PRNGKey(0), *args)
    if "params" in variables:
        mod.load_state_dict({k.split(".", 1)[1]: v for k, v in
                             params_from_jax({"modules__r": jax.device_get(variables["params"])}).items()})
    ref = jmod.apply(variables, *args)
    out = mod(*targs)
    assert out.shape == (6, 8)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


def test_gvp_layers_and_layer_norm_equal_jax():
    """GVP, GatedGVP (sigmoid and raw gates) and DualRankLayerNorm on shared
    weights; DualRankAggregation by cloud."""
    rng = np.random.default_rng(2)
    s = rng.standard_normal((30, 12)).astype(np.float32)
    v = rng.standard_normal((30, 3, 6)).astype(np.float32)
    cases = [(jax_gvp.GVP(out_scalar=10, out_vector=4), GVP(12, 6, 10, 4)),
             (jax_gvp.GatedGVP(out_scalar=10, out_vector=4), GatedGVP(12, 6, 10, 4)),
             (jax_gvp.GatedGVP(out_scalar=10, out_vector=4, vector_act=None), GatedGVP(12, 6, 10, 4, vector_act=None)),
             (jax_gvp.DualRankLayerNorm(), DualRankLayerNorm(12))]
    for jmod, mod in cases:
        variables = jmod.init(jax.random.PRNGKey(0), (jnp.asarray(s), jnp.asarray(v)))
        params = jax.device_get(variables["params"])
        if isinstance(mod, DualRankLayerNorm):  # a non-trivial scale and bias
            params = {"scalar_ln": {"scale": rng.standard_normal(12).astype(np.float32),
                                    "bias": rng.standard_normal(12).astype(np.float32)}}
        mod.load_state_dict({k.split(".", 1)[1]: t for k, t in params_from_jax({"modules__m": params}).items()})
        ref = jmod.apply({"params": params}, (jnp.asarray(s), jnp.asarray(v)))
        out = mod((torch.from_numpy(s), torch.from_numpy(v)))
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    P = pad_point_clouds(make_clouds(2, seed=4), 64, graph_cap=3)
    sv = (torch.from_numpy(rng.standard_normal((64, 5)).astype(np.float32)),
          torch.from_numpy(rng.standard_normal((64, 3, 2)).astype(np.float32)))
    ms, mv = DualRankAggregation()(sv, P.to("cpu"))
    real = P.batch_index == 0
    np.testing.assert_allclose(ms[0].numpy(), sv[0].numpy()[real].mean(0), **TOL)
    np.testing.assert_allclose(mv[0].numpy(), sv[1].numpy()[real].mean(0), **TOL)


def spatial_names_build_and_equal_jax() -> None:
    """SchnetBlock, GatedEquivariantBlock and MolToPointCloud, each built by
    name through both registries: the blocks' outputs on shared weights and
    the transform's point cloud of an SDF mol block agree."""
    clouds = make_clouds(3, seed=2)
    P = pad_point_clouds(clouds, 128)
    feats = np.random.default_rng(3).standard_normal((128, 16)).astype(np.float32)
    jP = jax_pad_point_clouds([JaxPointCloud(c.node_types, c.coords) for c in clouds], 128)
    jP = jP.replace(node_feats=jnp.asarray(feats))
    sv = (np.random.default_rng(4).standard_normal((10, 6)).astype(np.float32),
          np.random.default_rng(5).standard_normal((10, 3, 4)).astype(np.float32))
    cases = (({"class": "SchnetBlock", "args": {"hidden_dim": 16, "depth": 1, "max_neighbors": 8}},
              (jP,), (P.to("cpu").update(node_feats=torch.from_numpy(feats)),), lambda out: out.node_feats),
             ({"class": "GatedEquivariantBlock", "args": {"scalar_dim": 6, "vector_dim": 4}},
              ((jnp.asarray(sv[0]), jnp.asarray(sv[1])),), ((torch.from_numpy(sv[0]), torch.from_numpy(sv[1])),),
              lambda out: torch.cat([out[0].flatten(), out[1].flatten()]) if isinstance(out[0], torch.Tensor)
              else jnp.concatenate([out[0].ravel(), out[1].ravel()])))
    for spec, jargs, args, value in cases:
        jmod, mod = jax_registry.build(spec), registry.build(spec)
        variables = jmod.init(jax.random.PRNGKey(0), *jargs)
        mod.load_state_dict({k.split(".", 1)[1]: t for k, t in
                             params_from_jax({"modules__m": jax.device_get(variables["params"])}).items()})
        np.testing.assert_allclose(value(mod(*args)).detach().numpy(), np.asarray(value(jmod.apply(variables, *jargs))),
                                   **TOL)
    from notorch_tpu.data.databases import _parse_molblock as jax_parse_molblock
    from notorch_tpu_torch.data.databases import _parse_molblock

    from .test_databases import MOLBLOCK

    block = MOLBLOCK.split("$$$$")[0]
    ours, ref = registry.build("MolToPointCloud")(_parse_molblock(block)), jax_registry.build("MolToPointCloud")(
        jax_parse_molblock(block))
    np.testing.assert_array_equal(ours.node_types, ref.node_types)
    np.testing.assert_array_equal(ours.coords, ref.coords)


def test_registry_builds_the_spatial_names():
    for name in ("GvpGNNBlock", "PointwiseEmbed", "Pointwise", "RBFEmbedding", "SpatialSum", "SpatialMean",
                 "SpatialMax", "SpatialGated", "SchnetBlock", "GatedEquivariantBlock", "MolToPointCloud"):
        assert registry.resolve(name) is not None
    spatial_names_build_and_equal_jax()
    block = registry.build({"class": "GvpGNNBlock", "args": {"scalar_dim": 16, "vector_dim": 4, "depth": 1,
                                                               "input_dim": 8}})
    assert block.in_proj.in_features == 8


def test_spatial_refusals(tmp_path):
    """The default backbone, schnet, builds in both packages with the same
    parameter tree; the CLIs refuse every spatial model (no point clouds
    from SMILES), as the JAX CLIs do."""
    import optax

    cfg = {"kind": "spatial", "hidden_dim": 16}
    ours, ref = build_model(cfg, None), jax_build_model(cfg, None, optax.adam(1e-3))
    assert type(ours.network["backbone"]).__name__ == "SchnetBlock"
    clouds = make_clouds(4, seed=0)
    batch = jax_batch(cloud_batches(clouds, coordination_targets(clouds), batch_size=4)[0])
    params = jax.device_get(ref.init(jax.random.PRNGKey(0), batch).params)
    assert sorted(params["modules__backbone"]) == ["interaction_0", "interaction_1", "interaction_2"]
    ours.network.load_state_dict(params_from_jax(params))  # strict: the same tree
    assert jax.tree.structure(params_to_jax(ours.network.state_dict())) == jax.tree.structure(params)
    with pytest.raises(ValueError, match="no point clouds"):
        run({"data": {"csv": "x.csv"}, "model": {"kind": "spatial"}}, device="cpu")
    with pytest.raises(ValueError, match="unknown spatial backbone"):
        build_spatial_model(backbone="painn")
    with pytest.raises(ValueError, match="aggregation"):
        build_spatial_model(backbone="gvp", aggregation="median")
    with pytest.raises(ValueError, match="no point clouds"):
        run({"data": {"csv": "x.csv"}, "model": {"kind": "spatial", "backbone": "gvp"}}, device="cpu")
    with pytest.raises(ValueError, match="no point clouds"):
        run({"data": {"csv": "x.csv"}, "model": declarative_gvp_cfg()}, device="cpu")
    (tmp_path / "predict_meta.json").write_text('{"model": {"kind": "spatial", "backbone": "gvp"}, '
                                               '"pred_key": "ffn.preds", "transforms": {}}')
    with pytest.raises(ValueError, match="no point clouds"):
        run_predict(tmp_path, tmp_path / "in.csv", device="cpu")


# -- the model ----------------------------------------------------------------------------------


def models(kind):
    """(JAX model, port model) of the recipe or the declarative config, on
    Adam at 1e-3; the JAX declarative model with the jnp conv."""
    if kind == "recipe":
        kw = dict(backbone="gvp", hidden_dim=D, depth=2, neighbor_window=24)
        return jax_build_spatial_model(**kw), build_spatial_model(**kw, generator=torch.Generator().manual_seed(0))
    import optax

    jmodel = jax_build_model(declarative_gvp_cfg(impl="jnp"), None, optax.adam(1e-3))
    model = build_model(declarative_gvp_cfg(), None, generator=torch.Generator().manual_seed(0),
                        optimizer=OptimizerSpec("adam", 1e-3))
    return jmodel, model


@pytest.mark.parametrize("kind", ["recipe", "declarative"])
def test_gvp_model_train_step_and_predictions_equal_jax(batches, kind):
    """One train step from JAX's initial weights: the loss JAX's
    Model.train_step logs and every parameter gradient; then predictions
    over all batches and the weights' round trip through params_to_jax."""
    jmodel, model = models(kind)
    assert model.network["backbone"].layer_0.conv.impl == ("fused" if kind == "declarative" else "auto")
    jbatches = [jax_batch(b) for b in batches]
    state = jmodel.init(jax.random.PRNGKey(0), jbatches[0])
    params = jax.device_get(state.params)
    sd = params_from_jax(params)
    model.network.load_state_dict(sd)
    back = params_to_jax(model.network.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)

    def loss_fn(p):
        out = jmodel.network.apply({"params": p}, dict(jbatches[0]), training=True)
        terms = jmodel._loss_terms(jmodel._apply_transforms(out, "targets"))
        return sum(jmodel.train_loss_weights[k] * v for k, v in terms.items())

    grads = params_from_jax(jax.device_get(jax.jit(jax.grad(loss_fn))(params)))
    _, jlogs = jmodel.train_step(state, jbatches[0])
    logs = model.train_step(to_device(batches[0], "cpu"))
    np.testing.assert_allclose(float(logs["train/loss"]), float(jlogs["train/loss"]), **TOL)
    for name, p in model.network.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad  # a path that reaches no output: JAX's zeros
        np.testing.assert_allclose(got.numpy(), grads[name].numpy(), rtol=1e-4,
                                   atol=1e-4 * float(grads[name].abs().max()), err_msg=name)
    model.network.load_state_dict(sd)
    preds = predict(model, batches, keys=["ffn.preds"])["ffn.preds"]
    ref = jax_predict(jmodel, params, jbatches, keys=["ffn.preds"])["ffn.preds"]
    assert preds.shape == (len(batches) * BATCH, 1)
    np.testing.assert_allclose(preds, np.asarray(ref), **TOL)


@pytest.mark.parametrize("kind", ["recipe", "declarative"])
def test_gvp_model_fits_and_serves_from_a_checkpoint(batches, tmp_path, kind):
    """fit on the coordination-number target: the loss falls over 4 epochs;
    the checkpoint that fit wrote, restored into a fresh model, gives the
    trained model's predictions."""
    _, model = models(kind)
    ckpt = Checkpointer(tmp_path / "ckpt")
    result = fit(model, batches, epochs=4, checkpointer=ckpt)
    losses = [h["train/loss"] for h in result.history]
    assert losses[-1] < 0.5 * losses[0], losses
    served = models(kind)[1]
    served.network.load_state_dict(ckpt.restore())
    np.testing.assert_allclose(predict(served, batches, keys=["ffn.preds"])["ffn.preds"],
                               predict(model, batches, keys=["ffn.preds"])["ffn.preds"], **TOL)


# chip_smoke.py's GVP run: Adam at GVP_LR, the SpatialMean readout. The same
# run drifts port-CPU against JAX-CPU by 2.09e-5 at 8 threads and 2.12e-5 at
# one (three fresh processes each, the per-epoch losses); with the sum
# readout at 1e-3 it drifted 1.18e-1, at 1e-4 3.7e-3 and at 3e-5 1.7e-3, and
# with the mean readout at 1e-3 4.5e-3 and at 1e-4 2.0e-4. GVP_RUN_RTOL is
# over 3x the drift and under what a wrong weight makes: one weight tensor of
# the port's side scaled by 1.03 (in_proj, the embedding, a message layer's
# W_m) drifted by 1.7e-2, 1.2e-2 and 4.4e-3
GVP_LR = 3e-5
GVP_RUN_RTOL = 1e-3


def gvp_run_drift(lr: float, readout: str, scaled: str | None = None) -> tuple[float, list, list]:
    """chip_smoke.py's declarative GVP run (scalar 256, vector 32, depth 3,
    512 clouds, 2 epochs of 8 steps and a validation batch) with ``readout``
    and Adam at ``lr``, on the CPU in both packages from JAX's initial
    weights, the JAX conv the jnp path; ``scaled`` names a weight tensor of
    the port's side to scale by 1.03 (a fault the gate must catch). Checks
    that the first step's loss agrees within 1e-4 and returns the largest
    relative difference of the per-epoch losses and both histories."""
    import optax

    from notorch_tpu.training.loop import fit as jax_fit

    train_clouds, val_clouds = make_clouds(512, seed=0), make_clouds(64, seed=1)
    train = cloud_batches(train_clouds, coordination_targets(train_clouds))
    val = cloud_batches(val_clouds, coordination_targets(val_clouds))
    cfg = dict(d=256, dv=32, depth=3, readout=readout)
    jmodel = jax_build_model(declarative_gvp_cfg(**cfg, impl="jnp"), None, optax.adam(lr))
    state = jmodel.init(jax.random.PRNGKey(0), jax_batch(train[0]))
    weights = params_from_jax(jax.device_get(state.params))
    model = build_model(declarative_gvp_cfg(**cfg), None, optimizer=OptimizerSpec("adam", lr))
    model.network.load_state_dict(weights)
    first = model.train_step(to_device(train[0], "cpu"))["train/loss"]
    _, jlogs = jmodel.train_step(jmodel.init(jax.random.PRNGKey(0), jax_batch(train[0])), jax_batch(train[0]))
    np.testing.assert_allclose(float(first), float(jlogs["train/loss"]), rtol=1e-4)
    if scaled is not None:
        weights[scaled] = weights[scaled] * 1.03
    model = build_model(declarative_gvp_cfg(**cfg), None, optimizer=OptimizerSpec("adam", lr))
    model.network.load_state_dict(weights)
    ours = fit(model, train, val, epochs=2).history
    theirs = jax_fit(jmodel, state, [jax_batch(b) for b in train], [jax_batch(b) for b in val], epochs=2).history
    drift = max(abs(a[k] - float(b[k])) / abs(float(b[k])) for a, b in zip(ours, theirs) for k in ("train/loss", "val/loss"))
    return drift, ours, theirs


@pytest.mark.long
def test_gvp_full_width_run_drifts_apart_in_both_packages():
    """The GVP run of gvp_run_drift on chip_smoke.py's recipe (the
    SpatialMean readout, Adam at GVP_LR): two exact float32 implementations
    that round differently drift apart by no more than GVP_RUN_RTOL. At this
    rate Adam's steps, about the rate whatever a gradient's size, keep the
    rounding differences small (with the sum readout, a loss near 600 and
    Adam at 1e-3 they grew into 1.2e-1, though each step agreed in lockstep:
    tests/test_torch_gvp_drift.py). chip_smoke.py holds the card's run
    against the CPU's at that limit and every step in lockstep."""
    drift, ours, _ = gvp_run_drift(GVP_LR, "SpatialMean")
    assert ours[-1]["train/loss"] < ours[0]["train/loss"], ours
    assert drift <= GVP_RUN_RTOL, drift


if __name__ == "__main__":
    # the drift of one recipe, as GVP_RUN_RTOL was chosen; from the repo root:
    # python -m tests.test_torch_spatial LR READOUT [WEIGHT_TO_SCALE] [--threads N]
    import argparse
    import json
    import time

    parser = argparse.ArgumentParser(description="port-CPU against JAX-CPU drift of the full-width GVP run")
    parser.add_argument("lr", type=float)
    parser.add_argument("readout", help="SpatialSum or SpatialMean")
    parser.add_argument("scaled", nargs="?", help="a weight tensor of the port's side to scale by 1.03")
    parser.add_argument("--threads", type=int, help="torch's CPU threads (JAX's follow XLA_FLAGS)")
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    if args.threads:
        torch.set_num_threads(args.threads)
    t0 = time.perf_counter()
    drift, ours, theirs = gvp_run_drift(args.lr, args.readout, args.scaled)
    print(json.dumps({"lr": args.lr, "readout": args.readout, "scaled": args.scaled,
                      "threads": torch.get_num_threads(), "drift": drift,
                      "port": [{k: float(h[k]) for k in ("train/loss", "val/loss")} for h in ours],
                      "jax": [{k: float(h[k]) for k in ("train/loss", "val/loss")} for h in theirs],
                      "seconds": time.perf_counter() - t0}))
