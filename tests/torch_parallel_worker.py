"""One rank of the gloo world that ``tests/test_torch_parallel.py`` starts.

Run as a script, one process a rank, with the repo root on ``PYTHONPATH``:
``python tests/torch_parallel_worker.py STORE_DIR WORK_DIR CSV`` with ``RANK``
and ``WORLD_SIZE`` set; the ranks rendezvous on ``file://STORE_DIR/store``.
It imports the port alone (never JAX). Each leg of the JAX package's
``dryrun_multichip`` runs here from the initial weights the test wrote to
``WORK_DIR/<leg>.pt`` and the batches this script builds, and global
rank 0 writes every leg's results to ``WORK_DIR/results.npz``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from notorch_tpu_torch.cli.train import build_dataset
from notorch_tpu_torch.data.batching import stack_trees, to_device
from notorch_tpu_torch.data.dense import pack_graphs_dense, pad_graphs_dense
from notorch_tpu_torch.data.graph import Graph, pad_graphs
from notorch_tpu_torch.model.model import Model
from notorch_tpu_torch.models.dmpnn import build_dmpnn
from notorch_tpu_torch.nn.mlp import MLP
from notorch_tpu_torch.nn.moe import MixtureOfExperts
from notorch_tpu_torch.parallel import collectives, distributed
from notorch_tpu_torch.parallel.dense_dp import DenseDataParallel, DenseSpmdTrainer
from notorch_tpu_torch.parallel.expert import expert_partition_specs, shard_expert_params
from notorch_tpu_torch.parallel.halo import halo_mpnn_block, partition_edges_halo
from notorch_tpu_torch.parallel.loader import ShardedDataLoader, spmd_fit
from notorch_tpu_torch.parallel.mesh import make_mesh
from notorch_tpu_torch.parallel.partition import build_halo_spmd_batch, build_molecule_spmd_batch, build_spmd_batch
from notorch_tpu_torch.parallel.spmd import SpmdTrainer
from notorch_tpu_torch.tasks import losses as L
from notorch_tpu_torch.training.checkpoint import Checkpointer
from notorch_tpu_torch.training.optim import OptimizerSpec
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol
from notorch_tpu_torch.transforms.vocab import DEFAULT_NUM_ATOM_TYPES, DEFAULT_NUM_BOND_TYPES

SMIS = ["CCO", "c1ccccc1", "CC(=O)Nc1ccc(O)cc1", "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "c1ccc2c(c1)cccc2",
        "NC(=O)c1ccccc1", "OCC(O)CO", "ClCC(Cl)CCl"]
D, DEPTH, PER, LR = 16, 2, 4, 1e-2
NODE_CAP, EDGE_CAP = 64, 96
HALO_D, HALO_DEPTH = 16, 2
MOE_TOKENS, MOE_WIDTH, MOE_EXPERTS, MOE_LR = 8, 8, 4, 1e-2
MOE_AUX_WEIGHT, MOE_BATCHES = 0.01, 2
KEYS = {"preds": "ffn.preds", "targets": "targets.y", "mask": "targets.y_mask"}
CKPT_ROWS, CKPT_PER = 32, 4


def graphs() -> list[Graph]:
    pipe = Pipeline(SmiToMol(), MolToGraph())
    return [pipe(s) for s in SMIS]


def targets(n_data: int, per: int = PER, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n_data, per, 1)).astype(np.float32)


def groups(gs: list, n_data: int, per: int = PER) -> list[list]:
    return [[gs[(i * per + j) % len(gs)] for j in range(per)] for i in range(n_data)]


def halo_graph(n_shards: int) -> Graph:
    """The path graph with one chord of the JAX ``_dryrun_halo``, over ``8 *
    n_shards`` node slots (the last the padding sink)."""
    V = 8 * n_shards
    pairs = [(i, i + 1) for i in range(V - 2)] + [(0, V - 2)]
    src = np.asarray([e for u, v in pairs for e in (u, v)], np.int32)
    dst = np.asarray([e for u, v in pairs for e in (v, u)], np.int32)
    rev = np.arange(len(src), dtype=np.int32)
    rev[0::2] += 1
    rev[1::2] -= 1
    return Graph(node_types=np.zeros((V - 1, 1), np.int32), edge_types=np.zeros((len(src), 1), np.int32),
                 src=src, dst=dst, rev=rev)


def halo_inputs(n_shards: int):
    """(padded batch, node embeddings, edge embeddings, weights, biases) of
    the halo block leg, from seed 1 as the JAX leg draws them."""
    V = 8 * n_shards
    bg = pad_graphs([halo_graph(n_shards)], V, 4 * V, graph_cap=1, np_out=True)
    rng = np.random.default_rng(1)
    node_embed = rng.normal(size=(bg.num_nodes, HALO_D)).astype(np.float32)
    edge_embed = rng.normal(size=(bg.num_edges, HALO_D)).astype(np.float32)
    w = (rng.normal(size=(HALO_DEPTH, HALO_D, HALO_D)) * 0.2).astype(np.float32)
    return bg, node_embed, edge_embed, w, np.zeros((HALO_DEPTH, HALO_D), np.float32)


def moe_data(seed: int = 1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(MOE_TOKENS, MOE_WIDTH)).astype(np.float32)
    y = rng.normal(size=(MOE_TOKENS, MOE_WIDTH)).astype(np.float32)
    return x, y


def moe_model() -> Model:
    """The MoE model of the JAX ``dryrun_multichip`` expert leg: the MSE of
    the combine plus MOE_AUX_WEIGHT times the router's aux loss, Adam."""
    moe = MixtureOfExperts(expert_fn=lambda: MLP(input_dim=MOE_WIDTH, output_size=MOE_WIDTH, hidden_dim=16),
                           input_dim=MOE_WIDTH, num_experts=MOE_EXPERTS, router_kind="dense")
    return Model(modules={"moe": {"module": moe, "in_keys": ["inputs.x"], "out_keys": ["preds", "aux"]}},
                 losses={"mse": {"fn": L.MSE(), "in_keys": {"preds": "moe.preds", "targets": "targets.y"}},
                         "aux": {"fn": L.SelfSupervisedLoss(), "in_keys": ["moe.aux"], "weight": MOE_AUX_WEIGHT}},
                 optimizer=OptimizerSpec("adam", MOE_LR))


def moe_stacked(x: np.ndarray, y: np.ndarray) -> dict:
    """The stacked batch of a data 2 x expert 2 mesh: half the tokens a data
    rank, the same on both expert ranks."""
    return {"inputs.x": np.repeat(x.reshape(2, 1, -1, MOE_WIDTH), 2, axis=1),
            "targets.y": np.repeat(y.reshape(2, 1, -1, MOE_WIDTH), 2, axis=1)}


def batch_norm_model() -> Model:
    """The plain dense D-MPNN with BatchNorm between its mean readout and its
    head, SGD at LR."""
    from notorch_tpu_torch.cli.train import build_model

    cfg = {"modules": {
        "embed": {"class": "DenseGraphEmbedding", "args": {"num_node_types": DEFAULT_NUM_ATOM_TYPES,
                                                          "num_edge_types": DEFAULT_NUM_BOND_TYPES, "hidden_dim": D},
                  "in_keys": ["inputs.G"], "out_keys": ["G"]},
        "mp": {"class": "DenseChempropBlock", "args": {"hidden_dim": D, "depth": DEPTH}, "in_keys": ["embed.G"],
               "out_keys": ["G"]},
        "readout": {"class": "DenseMean", "in_keys": ["mp.G"], "out_keys": ["H"]},
        "norm": {"class": "BatchNorm", "args": {"features": D}, "in_keys": ["readout.H"], "out_keys": ["H"]},
        "ffn": {"class": "MLP", "args": {"input_dim": D, "output_size": 1, "hidden_dim": D},
                "in_keys": ["norm.H"], "out_keys": ["preds"]}},
        "losses": {"mse": {"class": "MSE", "in_keys": dict(KEYS)}}}
    return build_model(cfg, None, optimizer=OptimizerSpec("sgd", LR))


def dmpnn(**kw) -> Model:
    return build_dmpnn(hidden_dim=D, depth=DEPTH, optimizer=OptimizerSpec("sgd", LR), **kw)


def flat(tree) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


class Legs:
    def __init__(self, work: str):
        self.work, self.out = work, {}
        self.rank = dist.get_rank()
        self.gs = graphs()

    def put(self, leg: str, **values) -> None:
        for k, v in values.items():
            if isinstance(v, dict):
                for name, x in v.items():
                    self.out[f"{leg}/{k}/{name}"] = np.asarray(x)
            else:
                self.out[f"{leg}/{k}"] = np.asarray(v)

    def weights(self, leg: str) -> dict:
        return torch.load(os.path.join(self.work, f"{leg}.pt"), weights_only=True)

    def step(self, trainer, batch) -> float:
        return float(trainer.train_step(to_device(trainer.local_batch(batch), "cpu"))["train/loss"])

    # -- the legs -----------------------------------------------------------
    def partitioned(self, leg: str, partition: str) -> None:
        mesh = make_mesh({"data": 2, "graph": 2}, "cpu")
        model = dmpnn(graph_axis="graph", partition=partition)
        model.network.load_state_dict(self.weights(leg))
        trainer = SpmdTrainer(model, mesh, "data", "graph").init()
        y = {"y": targets(2)}
        if partition == "molecule":
            batch = build_molecule_spmd_batch(groups(self.gs, 2), y, NODE_CAP, EDGE_CAP, PER, n_graph_shards=2)
        else:
            batch = build_spmd_batch(groups(self.gs, 2), y, NODE_CAP, EDGE_CAP, PER, n_edge_shards=2)
        loss = self.step(trainer, batch)
        self.put(leg, loss=loss, params=flat(dict(model.network.named_parameters())))

    def train_steps(self) -> None:
        """K single steps against one ``train_steps`` of K stacked entries."""
        mesh = make_mesh({"data": 4}, "cpu")
        batches = [build_spmd_batch(groups(self.gs, 4, 2), {"y": targets(4, 2, seed=k)}, NODE_CAP, EDGE_CAP, 2)
                   for k in range(3)]
        params = []
        for stacked in (False, True):
            model = dmpnn(layout="flat")
            model.network.load_state_dict(self.weights("train_steps"))
            trainer = SpmdTrainer(model, mesh).init()
            if stacked:
                logs = trainer.train_steps(to_device(stack_trees([trainer.local_batch(b) for b in batches]), "cpu"))
                self.put("train_steps", loss=float(logs["train/loss"]))
            else:
                for b in batches:
                    self.step(trainer, b)
            assert trainer.step == 3
            params.append(flat(dict(model.network.named_parameters())))
        self.put("train_steps", single=params[0], stacked=params[1])

    def dense(self) -> None:
        """DenseDataParallel on the plain dense layout and DenseSpmdTrainer
        on the fused one (its plain route on the CPU), data 4."""
        mesh = make_mesh({"data": 4}, "cpu")
        batch = {"inputs.G": pad_graphs_dense(self.gs, 32, 64, graph_cap=8, np_out=True),
                 "targets.y": targets(1, 8)[0], "targets.y_mask": np.ones((8, 1), bool)}
        packed = {"inputs.G": pack_graphs_dense(self.gs, 32, 64, n_shards=4, np_out=True),
                  "targets.y": targets(1, 8)[0], "targets.y_mask": np.ones((8, 1), bool)}
        for leg, layout, cls in (("dense_dp", "dense", DenseDataParallel),
                                 ("dense_spmd", "dense_fused", DenseSpmdTrainer),
                                 ("dense_packed", "dense_packed", DenseSpmdTrainer)):
            model = dmpnn(layout=layout)
            model.network.load_state_dict(self.weights(leg))
            trainer = cls(model, mesh).init()
            leg_batch = packed if leg == "dense_packed" else batch
            loss = self.step(trainer, leg_batch)
            batch_eval = leg_batch
            logs, _ = trainer.eval_step(to_device(trainer.local_batch(batch_eval), "cpu"))
            self.put(leg, loss=loss, params=flat(dict(model.network.named_parameters())),
                     eval_mse=float(logs["val/mse"]))

    def dense_batch_norm(self) -> None:
        """DenseDataParallel with BatchNorm on the readout (data 4): its
        training statistics are the global batch's; DenseSpmdTrainer refuses
        the model."""
        mesh = make_mesh({"data": 4}, "cpu")
        batch = {"inputs.G": pad_graphs_dense(self.gs, 32, 64, graph_cap=8, np_out=True),
                 "targets.y": targets(1, 8)[0], "targets.y_mask": np.ones((8, 1), bool)}
        model = batch_norm_model()
        model.network.load_state_dict(self.weights("dense_bn"))
        trainer = DenseDataParallel(model, mesh).init()
        loss = self.step(trainer, batch)
        try:
            DenseSpmdTrainer(batch_norm_model(), mesh).init().train_step(batch)
            refusal = ""
        except ValueError as e:
            refusal = str(e)
        self.put("dense_bn", loss=loss, state=flat(model.network.state_dict()), refusal=refusal)

    def halo_block(self, n: int) -> None:
        """The halo block's node hiddens on each shard, its loss summed over
        the shards and the gradient of the weights (each rank's partial
        summed over the graph axis)."""
        mesh = make_mesh({"data": 4 // n, "graph": n}, "cpu")
        bg, node_embed, edge_embed, w, b = halo_inputs(n)
        shards = partition_edges_halo(bg, n)
        with collectives.bind_axes(mesh):
            g = collectives.axis_index("graph")
            shard = shards[g].to("cpu")
            ids = np.asarray(shards[g].edge_ids)
            ne = torch.from_numpy(node_embed.reshape(n, -1, HALO_D)[g].copy())
            ee = torch.from_numpy(np.where(ids[:, None] >= 0, edge_embed[np.maximum(ids, 0)], 0.0)
                                  .astype(np.float32))
            wt = torch.from_numpy(w).requires_grad_(True)
            node_h, _ = halo_mpnn_block(ne, ee, shard, wt, torch.from_numpy(b), "graph")
            local = ((node_h * shard.node_mask[:, None]) ** 2).sum()
            loss = collectives.psum(local, "graph")
            (loss * (1.0 if g == 0 else 0.0)).backward()
            grad = collectives.psum(wt.grad, "graph")
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, (g, node_h.detach().numpy()))
        node_h_all = np.concatenate([h for _, h in sorted(dict(parts).items())])
        self.put(f"halo_block_{n}", loss=float(loss), grad=grad.numpy(), node_h=node_h_all)

    def halo_model(self, n: int) -> None:
        leg = f"halo_model_{n}"
        n_data = 4 // n
        mesh = make_mesh({"data": n_data, "graph": n}, "cpu")
        model = dmpnn(graph_axis="graph", partition="halo")
        model.network.load_state_dict(self.weights(leg))
        trainer = SpmdTrainer(model, mesh, "data", "graph").init()
        node_cap = -(-48 // (8 * n)) * 8 * n
        batch = build_halo_spmd_batch(groups(self.gs, n_data), {"y": targets(n_data, seed=2)}, node_cap, EDGE_CAP,
                                      PER, n_shards=n)
        loss = self.step(trainer, batch)
        self.put(leg, loss=loss, params=flat(dict(model.network.named_parameters())))

    def expert(self) -> None:
        """data 2 x expert 2: each rank 2 of the 4 experts and half the
        tokens; an Adam step; the checkpoint's state_dict (the slices
        gathered) after it."""
        mesh = make_mesh({"data": 2, "expert": 2}, "cpu")
        model = moe_model()
        model.network.load_state_dict(self.weights("expert"))
        specs = expert_partition_specs(model, mesh)
        shard_expert_params(model, mesh)
        trainer = SpmdTrainer(model, mesh, "data", "expert").init()
        assert {p.shape[0] for p in model.network["moe"].experts.parameters()} == {MOE_EXPERTS // 2}
        loss = self.step(trainer, moe_stacked(*moe_data()))
        self.put("expert", loss=loss, params=flat(model.network.state_dict()),
                 specs={name: "/".join(str(a) for a in spec) for name, spec in specs.items()})

    def expert_checkpoint(self) -> None:
        """spmd_fit of the data 2 x expert 2 MoE model, MOE_BATCHES Adam steps
        an epoch: 2 epochs uninterrupted, then 1 epoch with a checkpoint and a
        resume to 2. The resumed run ends with the uninterrupted one's bits;
        the checkpoint after epoch 1 holds the whole optimizer state."""
        mesh = make_mesh({"data": 2, "expert": 2}, "cpu")
        batches = [moe_stacked(*moe_data(seed)) for seed in range(2, 2 + MOE_BATCHES)]
        ckpt_dir = os.path.join(self.work, "ckpt_expert")
        finals, saved = [], {}
        for epochs, resume in ((2, False), (1, False), (2, True)):
            model = moe_model()
            model.network.load_state_dict(self.weights("expert"))
            shard_expert_params(model, mesh)
            trainer = SpmdTrainer(model, mesh, "data", "expert").init()
            ckpt = Checkpointer(ckpt_dir) if epochs == 1 or resume else None
            spmd_fit(trainer, batches, epochs=epochs, checkpointer=ckpt, resume=resume)
            finals.append(flat(model.network.state_dict()))
            if epochs == 1 and not resume:
                state = Checkpointer(ckpt_dir).restore_train()["optimizer"]["state"]
                saved = {f"{i}.{k}": v for i, moments in state.items() for k, v in moments.items()}
        self.put("expert_ckpt", uninterrupted=finals[0], resumed=finals[2], saved_optimizer=saved)

    def checkpoint(self, csv_path: str) -> None:
        """spmd_fit of the replicate partition over ShardedDataLoader, 2
        epochs uninterrupted, then 1 epoch with a checkpoint and a resume to
        2; the resumed run ends with the uninterrupted one's bits."""
        mesh = make_mesh({"data": 2, "graph": 2}, "cpu")
        ds = build_dataset({"csv": csv_path, "targets": {"y": {"columns": ["lipo"]}}})
        transforms = ds.build_task_transform_configs()
        ckpt_dir = os.path.join(self.work, "ckpt")
        finals = []
        for epochs, resume in ((2, False), (1, False), (2, True)):
            model = build_dmpnn(hidden_dim=D, depth=DEPTH, graph_axis="graph", partition="replicate",
                                transforms=transforms, optimizer=OptimizerSpec("adam", 1e-3))
            model.network.load_state_dict(self.weights("checkpoint"))
            trainer = SpmdTrainer(model, mesh, "data", "graph").init()
            loader = ShardedDataLoader(ds, n_data=2, per_shard_graphs=CKPT_PER, n_edge_shards=2, shuffle=True,
                                       seed=3)
            ckpt = Checkpointer(ckpt_dir) if epochs == 1 or resume else None
            result = spmd_fit(trainer, loader, epochs=epochs, checkpointer=ckpt, resume=resume,
                              checkpoint_every=3)
            finals.append((flat(model.network.state_dict()), [r["train/loss"] for r in result.history]))
        written = sorted(os.listdir(ckpt_dir))
        self.put("checkpoint", uninterrupted=finals[0][0], resumed=finals[2][0],
                 losses=np.asarray(finals[0][1]), resumed_losses=np.asarray(finals[2][1]),
                 saved=Checkpointer(ckpt_dir).restore(), steps=np.asarray(Checkpointer(ckpt_dir).all_steps()),
                 n_files=len(written))


def main() -> None:
    store, work, csv_path = sys.argv[1:4]
    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    distributed.initialize(f"file://{store}/store", world, rank, device="cpu")
    legs = Legs(work)
    legs.partitioned("molecule", "molecule")
    legs.partitioned("replicate", "replicate")
    legs.train_steps()
    legs.dense()
    legs.dense_batch_norm()
    for n in (2, 4):
        legs.halo_block(n)
        legs.halo_model(n)
    legs.expert()
    legs.expert_checkpoint()
    legs.checkpoint(csv_path)
    if rank == 0:
        np.savez(os.path.join(work, "results.npz"), **legs.out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
