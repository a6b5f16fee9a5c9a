"""The parallel package on ``torch.distributed``, against the JAX package's
on the same mesh and against the port's single-process step.

One gloo world of 4 ranks serves the whole module: ``tests/
torch_parallel_worker.py`` runs as a script in 4 processes (the repo root
on their ``PYTHONPATH``, rendezvous on a ``file://`` store in a temporary
directory, one torch thread each; they never import JAX) from the JAX
models' initial weights, which this module carries over and writes first.
The JAX side runs on the conftest's virtual devices (``jax.devices()[:4]``).
The legs mirror the JAX package's ``dryrun_multichip``:

- the molecule-partition and replicate-partition ``SpmdTrainer`` on a data
  2 x graph 2 mesh;
- ``train_steps`` of 3 stacked entries against 3 single steps (data 4);
- ``DenseDataParallel`` (the plain dense layout) and ``DenseSpmdTrainer``
  (the fused layout, its plain route on the CPU) over data 4;
- the halo block (node hiddens, the loss and its gradient) and the halo
  model (an SGD step) at 2 and 4 graph shards;
- expert parallelism, data 2 x expert 2 (an Adam step on the MSE and the
  router's aux loss; the gathered ``state_dict``; ``spmd_fit`` with a
  checkpoint of the gathered optimizer state, resume and the rest of the
  run);
- ``spmd_fit`` with a sharded checkpoint, resume and the rest of the run,
  against the run without the interruption (bit for bit).

Tolerances are the JAX tests' own (``tests/test_parallel.py``, ``tests/
test_halo.py``): losses at 1e-5, parameters after a step at rtol 2e-5 and
atol 1e-7; the halo block's hiddens at 2e-5, its gradient at rtol 5e-4 and
atol 1e-4; the halo model's parameters at rtol 1e-4, atol 1e-6.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from notorch_tpu.data.dense import pack_graphs_dense as jax_pack_graphs_dense
from notorch_tpu.data.dense import pad_graphs_dense as jax_pad_graphs_dense
from notorch_tpu.data.graph import pad_graphs as jax_pad_graphs
from notorch_tpu.models.dmpnn import build_dmpnn as jax_build_dmpnn
from notorch_tpu.nn.mlp import MLP as JaxMLP
from notorch_tpu.nn.moe import MixtureOfExperts as JaxMixtureOfExperts
from notorch_tpu.parallel import partition as jax_partition
from notorch_tpu.parallel.dense_dp import DenseDataParallel as JaxDenseDataParallel
from notorch_tpu.parallel.dense_dp import DenseSpmdTrainer as JaxDenseSpmdTrainer
from notorch_tpu.parallel.halo import halo_mpnn_block as jax_halo_mpnn_block
from notorch_tpu.parallel.halo import partition_edges_halo as jax_partition_edges_halo
from notorch_tpu.parallel.mesh import make_mesh as jax_make_mesh
from notorch_tpu.parallel.spmd import SpmdTrainer as JaxSpmdTrainer
from notorch_tpu.transforms import MolToGraph as JaxMolToGraph
from notorch_tpu.transforms import Pipeline as JaxPipeline
from notorch_tpu.transforms import SmiToMol as JaxSmiToMol
from notorch_tpu_torch.data.graph import pad_graphs
from notorch_tpu_torch.model.convert import params_from_jax
from notorch_tpu_torch.models.dmpnn import build_dmpnn

from . import torch_parallel_worker as W
from .test_torch_gat import ROOT, lipo_head

WORLD = 4
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 2e-5, 1e-7
HALO_RTOL, HALO_GRAD_RTOL, HALO_GRAD_ATOL = 2e-5, 5e-4, 1e-4
HALO_PARAM_RTOL, HALO_PARAM_ATOL = 1e-4, 1e-6
WORKER_TIMEOUT = 300


def jax_graphs():
    pipe = JaxPipeline(JaxSmiToMol(), JaxMolToGraph())
    return [pipe(s) for s in W.SMIS]


def jax_dmpnn(**kw):
    return jax_build_dmpnn(hidden_dim=W.D, depth=W.DEPTH, optimizer=optax.sgd(W.LR), **kw)


def jax_mesh(axes: dict):
    return jax_make_mesh(axes, devices=jax.devices()[:WORLD])


def spmd_batches(jgs) -> dict:
    """The stacked batch of each SpmdTrainer leg, from the JAX builders
    (whose arrays the port's equal, tests/test_torch_partition.py)."""
    y = {"y": W.targets(2)}
    out = {
        "molecule": jax_partition.build_molecule_spmd_batch(W.groups(jgs, 2), y, W.NODE_CAP, W.EDGE_CAP, W.PER,
                                                            n_graph_shards=2),
        "replicate": jax_partition.build_spmd_batch(W.groups(jgs, 2), y, W.NODE_CAP, W.EDGE_CAP, W.PER,
                                                    n_edge_shards=2),
        "train_steps": [jax_partition.build_spmd_batch(W.groups(jgs, 4, 2), {"y": W.targets(4, 2, seed=k)},
                                                       W.NODE_CAP, W.EDGE_CAP, 2) for k in range(3)],
    }
    for n in (2, 4):
        node_cap = -(-48 // (8 * n)) * 8 * n
        out[f"halo_model_{n}"] = jax_partition.build_halo_spmd_batch(
            W.groups(jgs, 4 // n), {"y": W.targets(4 // n, seed=2)}, node_cap, W.EDGE_CAP, W.PER, n_shards=n)
    return out


def dense_batch(jgs, packed_shards: int = 0) -> dict:
    G = (jax_pack_graphs_dense(jgs, 32, 64, n_shards=packed_shards) if packed_shards
         else jax_pad_graphs_dense(jgs, 32, 64, graph_cap=8))
    return {"inputs.G": G, "targets.y": W.targets(1, 8)[0], "targets.y_mask": np.ones((8, 1), bool)}


def jax_moe():
    return JaxMixtureOfExperts(expert_fn=lambda: JaxMLP(input_dim=W.MOE_WIDTH, output_size=W.MOE_WIDTH,
                                                          hidden_dim=16),
                               num_experts=W.MOE_EXPERTS, router_kind="dense")


def initial_weights(jgs, batches) -> dict:
    """Each leg's JAX model and initial parameters (numpy)."""
    legs = {}
    flat_example = {"inputs.G": jax_pad_graphs(W.groups(jgs, 1)[0], 64, 96, graph_cap=W.PER),
                    "targets.y": W.targets(1)[0], "targets.y_mask": np.ones((W.PER, 1), bool)}
    for leg, kw in (("molecule", dict(graph_axis="graph", partition="molecule")),
                    ("replicate", dict(graph_axis="graph", partition="replicate")),
                    ("train_steps", dict(layout="flat")), ("dense_dp", dict(layout="dense")),
                    ("dense_spmd", dict(layout="dense_fused")), ("dense_packed", dict(layout="dense_packed")),
                    ("checkpoint", dict(layout="flat")),
                    *((f"halo_model_{n}", dict(graph_axis="graph", partition="halo")) for n in (2, 4))):
        jmodel = jax_dmpnn(**kw)
        if kw.get("partition") == "halo":  # its collectives need the mesh: the trainer inits it
            n = int(leg[-1])
            trainer = JaxSpmdTrainer(jmodel, jax_mesh({"data": 4 // n, "graph": n}), "data", "graph")
            params = trainer.init(jax.random.PRNGKey(0), batches[leg]).params
        else:  # the graph-axis models share the flat model's tree
            ex = dense_batch(jgs, int(leg == "dense_packed")) if leg.startswith("dense") else flat_example
            init_model = jax_dmpnn(layout="flat") if "graph_axis" in kw else jmodel
            params = jax.jit(lambda key: init_model.network.init(key, dict(ex), training=False))(
                jax.random.PRNGKey(0))["params"]
        legs[leg] = (jmodel, jax.device_get(params))
    bn = W.batch_norm_model()
    bn.reset_parameters(torch.Generator().manual_seed(0))
    legs["dense_bn"] = (None, bn.network.state_dict())
    x, _ = W.moe_data()
    legs["expert"] = (jax_moe(), jax.device_get(jax_moe().init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]))
    return legs


def port_weights(leg: str, params) -> dict:
    if leg == "dense_bn":  # the port's own initial weights
        return params
    if leg == "expert":
        return params_from_jax({"modules__moe": params})
    return params_from_jax(params)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jgs = jax_graphs()
    batches = spmd_batches(jgs)
    legs = initial_weights(jgs, batches)
    work = tmp_path_factory.mktemp("parallel_world")
    for leg, (_, params) in legs.items():
        torch.save(port_weights(leg, params), work / f"{leg}.pt")
    csv_path = lipo_head(work / "lipo_head.csv", W.CKPT_ROWS)
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=ROOT, WORLD_SIZE=str(WORLD), OMP_NUM_THREADS="1")
    worker = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(work), str(work), str(csv_path)], cwd=ROOT,
                              env={**env, "RANK": str(r)}, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    outs = []
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{err[-4000:]}"
    results = dict(np.load(work / "results.npz"))
    return {"jgs": jgs, "batches": batches, "legs": legs, "results": results}


def result_tree(results: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in results.items() if k.startswith(prefix + "/")}


def assert_params(got: dict, ref: dict, rtol=PARAM_RTOL, atol=PARAM_ATOL, what=""):
    assert sorted(got) == sorted(ref), what
    for name in ref:
        np.testing.assert_allclose(got[name], np.asarray(ref[name]), rtol=rtol, atol=atol, err_msg=f"{what} {name}")


def jax_spmd_step(jmodel, params, batch, axes: dict, graph_axis):
    trainer = JaxSpmdTrainer(jmodel, jax_mesh(axes), "data", graph_axis)
    state = trainer.init(jax.random.PRNGKey(0), batch)
    state = state.replace(params=params, opt_state=jmodel.optimizer.init(params))
    state, logs = trainer.train_step(state, batch)
    return float(logs["train/loss"]), params_from_jax(jax.device_get(state.params))


def port_single_sgd(sd: dict, groups: list, y: np.ndarray) -> tuple[float, dict]:
    """The unsharded step: the flat model's loss and gradients on each data
    group's padded batch, averaged, and one SGD update."""
    model = build_dmpnn(hidden_dim=W.D, depth=W.DEPTH, layout="flat")
    model.network.load_state_dict(sd)
    losses, grads = [], {}
    for gi, grp in enumerate(groups):
        model.network.zero_grad()
        batch = {"inputs.G": pad_graphs(grp, 128, 256, graph_cap=W.PER), "targets.y": torch.from_numpy(y[gi]),
                 "targets.y_mask": torch.ones(W.PER, 1, dtype=torch.bool)}
        loss = sum(model._terms(model.losses, model.network(batch)).values())
        loss.backward()
        losses.append(float(loss.detach()))
        for name, p in model.network.named_parameters():
            grads[name] = grads.get(name, 0) + p.grad / len(groups)
    return float(np.mean(losses)), {n: (sd[n] - W.LR * g).numpy() for n, g in grads.items()}


@pytest.mark.parametrize("leg", ["molecule", "replicate"])
def test_partitioned_step_matches_jax_and_the_single_process_step(world, leg):
    jmodel, params = world["legs"][leg]
    got = world["results"]
    ref_loss, ref_params = jax_spmd_step(jmodel, params, world["batches"][leg], {"data": 2, "graph": 2}, "graph")
    np.testing.assert_allclose(got[f"{leg}/loss"], ref_loss, rtol=LOSS_RTOL)
    assert_params(result_tree(got, f"{leg}/params"), ref_params, what="jax")
    loss, single = port_single_sgd(port_weights(leg, params), W.groups(W.graphs(), 2), W.targets(2))
    np.testing.assert_allclose(got[f"{leg}/loss"], loss, rtol=LOSS_RTOL)
    assert_params(result_tree(got, f"{leg}/params"), single, what="single process")


def test_train_steps_equal_k_single_steps(world):
    got = world["results"]
    single, stacked = result_tree(got, "train_steps/single"), result_tree(got, "train_steps/stacked")
    for name in single:
        np.testing.assert_array_equal(stacked[name], single[name], err_msg=name)
    jmodel, params = world["legs"]["train_steps"]
    trainer = JaxSpmdTrainer(jmodel, jax_mesh({"data": 4}), "data")
    batches = world["batches"]["train_steps"]
    state = trainer.init(jax.random.PRNGKey(0), batches[0])
    state = state.replace(params=params, opt_state=jmodel.optimizer.init(params))
    state, logs = trainer.train_steps(state, jax.tree.map(lambda *xs: np.stack(xs), *batches))
    np.testing.assert_allclose(got["train_steps/loss"], float(logs["train/loss"]), rtol=LOSS_RTOL)
    assert_params(stacked, params_from_jax(jax.device_get(state.params)), what="jax")


@pytest.mark.parametrize("leg", ["dense_dp", "dense_spmd", "dense_packed"])
def test_dense_data_parallel_matches_jax_and_the_single_process_step(world, leg):
    """The dense trainers over data 4, one SGD step: DenseDataParallel on
    the per-molecule dense layout, DenseSpmdTrainer on the fused one and on
    a pack_graphs_dense(n_shards=4) batch of the packed layout (a rank a
    chunk of bins), against JAX's on the same mesh and the port's unsharded
    step (on the packing of one shard for dense_packed)."""
    jmodel, params = world["legs"][leg]
    batch = dense_batch(world["jgs"], 4 * (leg == "dense_packed"))
    cls = JaxDenseDataParallel if leg == "dense_dp" else JaxDenseSpmdTrainer
    trainer = cls(jmodel, jax_mesh({"data": 4}))
    state = trainer.init(jax.random.PRNGKey(0), batch)
    state = state.replace(params=params, opt_state=jmodel.optimizer.init(params))
    state, logs = trainer.train_step(state, batch)
    got = world["results"]
    np.testing.assert_allclose(got[f"{leg}/loss"], float(logs["train/loss"]), rtol=LOSS_RTOL)
    assert_params(result_tree(got, f"{leg}/params"), params_from_jax(jax.device_get(state.params)), what="jax")
    # the port's unsharded step on the whole batch
    from notorch_tpu_torch.data.dense import pad_graphs_dense
    from notorch_tpu_torch.training.loop import to_device
    from notorch_tpu_torch.training.optim import OptimizerSpec

    from notorch_tpu_torch.data.dense import pack_graphs_dense

    layout = {"dense_dp": "dense", "dense_spmd": "dense_fused", "dense_packed": "dense_packed"}[leg]
    model = build_dmpnn(hidden_dim=W.D, depth=W.DEPTH, layout=layout, optimizer=OptimizerSpec("sgd", W.LR))
    model.network.load_state_dict(port_weights(leg, params))
    G = pack_graphs_dense(W.graphs(), 32, 64) if leg == "dense_packed" else pad_graphs_dense(W.graphs(), 32, 64,
                                                                                                graph_cap=8)
    ours = {"inputs.G": G, "targets.y": W.targets(1, 8)[0], "targets.y_mask": np.ones((8, 1), bool)}
    logs = model.train_step(to_device(ours, "cpu"))
    np.testing.assert_allclose(got[f"{leg}/loss"], float(logs["train/loss"]), rtol=LOSS_RTOL)
    assert_params(result_tree(got, f"{leg}/params"), flat_params(model), what="single process")
    eval_logs, _ = model.eval_step(to_device(ours, "cpu"))
    np.testing.assert_allclose(got[f"{leg}/eval_mse"], float(eval_logs["val/mse"]), rtol=LOSS_RTOL)


def test_dense_data_parallel_batch_norm_takes_the_global_batch(world):
    """BatchNorm under DenseDataParallel (data 4) normalises by the global
    batch's statistics, as GSPMD computes them: the loss, every parameter
    and the running averages after an SGD step equal the unsharded step's
    on the whole batch. DenseSpmdTrainer refuses the model with JAX's
    ValueError."""
    from notorch_tpu_torch.data.dense import pad_graphs_dense
    from notorch_tpu_torch.training.loop import to_device

    got = world["results"]
    model = W.batch_norm_model()
    model.network.load_state_dict(world["legs"]["dense_bn"][1])
    batch = {"inputs.G": pad_graphs_dense(W.graphs(), 32, 64, graph_cap=8), "targets.y": W.targets(1, 8)[0],
             "targets.y_mask": np.ones((8, 1), bool)}
    logs = model.train_step(to_device(batch, "cpu"))
    np.testing.assert_allclose(got["dense_bn/loss"], float(logs["train/loss"]), rtol=LOSS_RTOL)
    state = {k: v.numpy() for k, v in model.network.state_dict().items()}
    assert_params(result_tree(got, "dense_bn/state"), state, what="single process")
    assert "does not thread mutable collections" in str(got["dense_bn/refusal"])


def flat_params(model) -> dict:
    return {k: v.detach().numpy() for k, v in model.network.named_parameters()}


def halo_oracle(bg, node_embed, edge_embed, w, b):
    """The unsharded D-MPNN recurrence of the JAX halo tests, and the loss of
    the halo block leg."""
    src, dst, rev = (jnp.asarray(x) for x in (bg.src, bg.dst, bg.rev))
    mask = jnp.asarray(np.asarray(bg.node_mask), jnp.float32)

    def loss(w):
        h = jnp.asarray(node_embed)[src] + jnp.asarray(edge_embed)
        for layer in range(W.HALO_DEPTH):
            m = jax.nn.relu(h)
            m_v = jax.ops.segment_sum(m, dst, num_segments=bg.num_nodes)
            h = h + (m_v[src] - m[rev]) @ w[layer] + jnp.asarray(b)[layer]
        node_h = jax.ops.segment_sum(h, dst, num_segments=bg.num_nodes)
        return jnp.sum((node_h * mask[:, None]) ** 2), node_h

    (val, node_h), grad = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(w))
    return float(val), np.asarray(node_h), np.asarray(grad)


@pytest.mark.parametrize("n", [2, 4])
def test_halo_block_matches_jax(world, n):
    """Forward (every real node's hiddens) and the gradient of the weights
    through the two exchanges a layer, against the unsharded recurrence and
    the JAX block under shard_map on n devices."""
    got = world["results"]
    bg, node_embed, edge_embed, w, b = W.halo_inputs(n)
    val, node_h, grad = halo_oracle(bg, node_embed, edge_embed, w, b)
    mask = np.asarray(bg.node_mask)
    np.testing.assert_allclose(got[f"halo_block_{n}/node_h"][mask], node_h[mask], rtol=HALO_RTOL, atol=HALO_RTOL)
    np.testing.assert_allclose(got[f"halo_block_{n}/loss"], val, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[f"halo_block_{n}/grad"], grad, rtol=HALO_GRAD_RTOL, atol=HALO_GRAD_ATOL)

    jbg = jax_pad_graphs([W.halo_graph(n)], 8 * n, 32 * n, graph_cap=1, np_out=True)
    shards = jax_partition_edges_halo(jbg, n)
    stacked = jax_partition.stack_pytrees(shards)
    ne = node_embed.reshape(n, shards[0].v_loc, W.HALO_D)
    ee = np.stack([np.where(np.asarray(s.edge_ids)[:, None] >= 0, edge_embed[np.maximum(np.asarray(s.edge_ids), 0)],
                            0.0) for s in shards]).astype(np.float32)

    def local_loss(w, shard, ne, ee):
        shard, ne, ee = jax.tree.map(lambda x: x.reshape(x.shape[1:]), (shard, ne, ee))
        node_h, _ = jax_halo_mpnn_block(ne, ee, shard, w, jnp.asarray(b), "graph")
        return jax.lax.psum(jnp.sum((node_h * shard.node_mask[:, None]) ** 2), "graph")

    fn = shard_map(local_loss, mesh=jax_make_mesh({"graph": n}, devices=jax.devices()[:n]),
                   in_specs=(P(), P("graph"), P("graph"), P("graph")), out_specs=P(), check_vma=False)
    jval, jgrad = jax.jit(jax.value_and_grad(lambda w: fn(w, stacked, ne, ee)))(jnp.asarray(w))
    np.testing.assert_allclose(got[f"halo_block_{n}/loss"], float(jval), rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[f"halo_block_{n}/grad"], np.asarray(jgrad), rtol=HALO_GRAD_RTOL,
                               atol=HALO_GRAD_ATOL)


@pytest.mark.parametrize("n", [2, 4])
def test_halo_model_matches_jax_and_the_flat_step(world, n):
    """The halo model's SGD step (embed, the halo block, the psum'd mean
    readout, the head) on a data (4 / n) x graph n mesh, against JAX's
    SpmdTrainer on the same mesh and the flat model's unsharded step on the
    same weights (the halo block's stacked [in, out] weights are the flat
    block's)."""
    leg = f"halo_model_{n}"
    jmodel, params = world["legs"][leg]
    got = world["results"]
    ref_loss, ref_params = jax_spmd_step(jmodel, params, world["batches"][leg], {"data": 4 // n, "graph": n}, "graph")
    np.testing.assert_allclose(got[f"{leg}/loss"], ref_loss, rtol=LOSS_RTOL)
    assert_params(result_tree(got, f"{leg}/params"), ref_params, HALO_PARAM_RTOL, HALO_PARAM_ATOL, "jax")
    sd = port_weights(leg, params)
    flat_sd = {k: v for k, v in sd.items() if not k.startswith("mp.")}
    flat_sd.update({"mp.weight": sd["mp.weights"], "mp.bias": sd["mp.biases"]})
    loss, single = port_single_sgd(flat_sd, W.groups(W.graphs(), 4 // n), W.targets(4 // n, seed=2))
    np.testing.assert_allclose(got[f"{leg}/loss"], loss, rtol=LOSS_RTOL)
    single = {k.replace("mp.weight", "mp.weights").replace("mp.bias", "mp.biases"): v for k, v in single.items()}
    assert_params(result_tree(got, f"{leg}/params"), single, HALO_PARAM_RTOL, HALO_PARAM_ATOL, "single process")


def test_expert_parallel_step_matches_jax(world):
    """data 2 x expert 2, 2 of the 4 experts a rank: an Adam step on the
    MSE of the router-weighted combine plus the router's aux loss (the
    dryrun's loss; the importance is the global batch's) equals the
    unsharded JAX step (what GSPMD computes), and the state_dict gathers the
    whole expert stacks."""
    moe, params = world["legs"]["expert"]
    x, y = W.moe_data()
    opt = optax.adam(W.MOE_LR)

    def loss_fn(p):
        out, aux = moe.apply({"params": p}, jnp.asarray(x))
        return ((out - jnp.asarray(y)) ** 2).mean() + W.MOE_AUX_WEIGHT * aux

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = opt.update(grads, opt.init(params), params)
    after = port_weights("expert", jax.device_get(optax.apply_updates(params, updates)))
    got = world["results"]
    np.testing.assert_allclose(got["expert/loss"], float(loss), rtol=LOSS_RTOL)
    assert_params(result_tree(got, "expert/params"), after, rtol=1e-4, atol=1e-6, what="jax")
    assert {v.shape[0] for k, v in result_tree(got, "expert/params").items() if ".experts." in k} == {W.MOE_EXPERTS}
    specs = {k: str(v) for k, v in result_tree(got, "expert/specs").items()}
    assert specs and all((v.startswith("expert/None") or v == "expert") if ".experts." in k else v == ""
                         for k, v in specs.items()), specs


def test_expert_sharded_checkpoint_resume_equals_the_uninterrupted_run(world):
    """The data 2 x expert 2 MoE model under spmd_fit: the checkpoint holds
    the whole optimizer state (each expert stack's Adam moments gathered over
    the expert group), equal to the port's unsharded run's on the same
    tokens, and a run resumed from it ends with the uninterrupted run's
    bits (each rank took its own slice of the moments back)."""
    from notorch_tpu_torch.training.loop import to_device

    got = world["results"]
    uninterrupted = result_tree(got, "expert_ckpt/uninterrupted")
    resumed = result_tree(got, "expert_ckpt/resumed")
    assert sorted(uninterrupted) == sorted(resumed)
    for name in uninterrupted:
        np.testing.assert_array_equal(resumed[name], uninterrupted[name], err_msg=name)
    model = W.moe_model()
    model.network.load_state_dict(port_weights("expert", world["legs"]["expert"][1]))
    for seed in range(2, 2 + W.MOE_BATCHES):
        x, y = W.moe_data(seed)
        model.train_step(to_device({"inputs.x": x, "targets.y": y}, "cpu"))
    ref = {f"{i}.{k}": v.numpy() for i, moments in model.optimizer.state_dict()["state"].items()
           for k, v in moments.items()}
    assert_params(result_tree(got, "expert_ckpt/saved_optimizer"), ref, rtol=1e-4, atol=1e-9,
                  what="single process optimizer state")


def test_sharded_checkpoint_resume_equals_the_uninterrupted_run(world):
    """Rank 0 wrote the checkpoints, every rank restored from them, and the
    resumed run's last epoch, parameters and the checkpoint it saved have
    the uninterrupted run's bits."""
    got = world["results"]
    uninterrupted, resumed = result_tree(got, "checkpoint/uninterrupted"), result_tree(got, "checkpoint/resumed")
    assert sorted(uninterrupted) == sorted(resumed)
    for name in uninterrupted:
        np.testing.assert_array_equal(resumed[name], uninterrupted[name], err_msg=name)
        np.testing.assert_array_equal(got[f"checkpoint/saved/{name}"], uninterrupted[name], err_msg=name)
    np.testing.assert_array_equal(got["checkpoint/resumed_losses"][-1], got["checkpoint/losses"][-1])
    assert got["checkpoint/steps"].max() == 2 * (W.CKPT_ROWS // (2 * W.CKPT_PER))
