"""Self-supervised pretraining: masked atom-type prediction.

Port of ``notorch_tpu.models.pretrain``: mask a fraction of atoms' type-index
features (pointing them at each family's <UNK> slot), run message passing
on the flat layout, and predict each masked atom's element id from its node
hidden. :class:`MaskAtoms` is the JAX package's numpy code, so one seed
gives the same masks and labels in both packages. ``graph_axis`` with a
``partition`` trains on a data x graph mesh, as in the JAX package
(:func:`build_masked_atom_pretrainer`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar

import numpy as np
import torch
from torch import nn

from notorch_tpu_torch.conf import DEFAULT_HIDDEN_DIM
from notorch_tpu_torch.data.graph import BatchedGraph, Graph
from notorch_tpu_torch.model.model import Model
from notorch_tpu_torch.nn.chemprop import ChempropBlock
from notorch_tpu_torch.nn.embed import GraphEmbedding
from notorch_tpu_torch.nn.init import dense, reset_dense_
from notorch_tpu_torch.parallel.collectives import psum
from notorch_tpu_torch.tasks.losses import masked_reduce
from notorch_tpu_torch.training.optim import OptimizerSpec
from notorch_tpu_torch.transforms.atom import MultiTypeAtomTransform
from notorch_tpu_torch.transforms.graph import MolToGraph
from notorch_tpu_torch.transforms.vocab import DEFAULT_NUM_ATOM_TYPES, DEFAULT_NUM_BOND_TYPES, ELEMENTS


@dataclass
class MaskAtoms:
    """Transform: Graph -> Graph with masked atoms and per-node labels.

    Masked atoms have every feature family pointed at its <UNK> slot; labels
    are the original element ids (the primary identity family). Labels of
    unmasked atoms are -1.
    """

    _in_key_: ClassVar[str] = "G"
    _out_key_: ClassVar[str] = "G"

    mask_rate: float = 0.15
    seed: int = 0
    atom_transform: MultiTypeAtomTransform = field(default_factory=MultiTypeAtomTransform)

    def __post_init__(self):
        self._rg = np.random.default_rng(self.seed)
        # per-family <UNK> ids under the offset scheme
        sizes = self.atom_transform.sizes
        offsets = self.atom_transform.offset
        self._unk_row = np.array([o + s - 1 for o, s in zip(offsets, sizes)], dtype=np.int32)

    def __call__(self, g: Graph) -> Graph:
        V = g.num_nodes
        masked = self._rg.random(V) < self.mask_rate
        if not masked.any():
            masked[self._rg.integers(0, V)] = True
        node_types = g.node_types.copy()
        labels = np.full(V, -1, dtype=np.int32)
        labels[masked] = node_types[masked, 0]  # element family id (offset 0)
        node_types[masked] = self._unk_row
        out = Graph(node_types=node_types, edge_types=g.edge_types, src=g.src, dst=g.dst, rev=g.rev)
        out.node_labels = labels  # carried to collation
        return out

    @staticmethod
    def collate(graphs, node_cap=None, edge_cap=None) -> tuple[BatchedGraph, torch.Tensor]:
        """The flat batch of ``graphs`` and the labels of its node slots
        (-1 on padding), a CPU tensor."""
        bg = MolToGraph.collate(graphs, node_cap, edge_cap)
        labels = np.full(bg.num_nodes, -1, dtype=np.int32)
        off = 0
        for g in graphs:
            labels[off : off + g.num_nodes] = g.node_labels
            off += g.num_nodes
        return bg, torch.from_numpy(labels)


class NodeHead(nn.Module):
    """Per-node classification head over node hiddens: ``proj``, ReLU,
    ``out``. ``input_dim`` is the node hiddens' width (the block's), which
    flax infers; it defaults to ``hidden_dim``."""

    def __init__(self, num_classes: int, hidden_dim: int = DEFAULT_HIDDEN_DIM, input_dim: int | None = None):
        super().__init__()
        self.proj = dense(hidden_dim if input_dim is None else input_dim, hidden_dim)
        self.out = dense(hidden_dim, num_classes)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        reset_dense_(self.proj, generator)
        reset_dense_(self.out, generator)

    def forward(self, G: BatchedGraph) -> torch.Tensor:
        return self.out(torch.relu(self.proj(G.node_feats)))


@dataclass(frozen=True)
class MaskedNodeCrossEntropy:
    """Cross-entropy over masked node positions only (labels == -1 are
    ignored), the masked mean.

    ``psum_axis``: with molecule-partitioned (node-sharded) batches each
    shard sees a disjoint node subset, so the global masked mean is the
    ``psum`` of the local numerators over the ``psum`` of the local counts
    (floored at 1); the value is then the same on every graph shard, as a
    sharded trainer's count-once gate needs."""

    psum_axis: str | None = None

    def __call__(self, logits, labels, **kw):
        mask = labels >= 0
        safe = labels.clamp_min(0).long()
        nll = -torch.log_softmax(logits, dim=-1).gather(-1, safe[:, None]).squeeze(-1)
        if self.psum_axis is None:
            return masked_reduce(nll[:, None], mask[:, None])
        fmask = mask.to(logits.dtype)
        num = psum((nll * fmask).sum(), self.psum_axis)
        den = psum(fmask.sum(), self.psum_axis)
        return num / den.clamp_min(1.0)


def build_masked_atom_pretrainer(
    hidden_dim: int = DEFAULT_HIDDEN_DIM,
    depth: int = 3,
    num_elements: int = len(ELEMENTS) + 1,
    learning_rate: float = 1e-3,
    optimizer: OptimizerSpec | None = None,
    graph_axis: str | None = None,
    partition: str = "molecule",
    generator: torch.Generator | None = None,
) -> Model:
    """embed -> chemprop -> per-node head -> masked cross-entropy on the
    element identity, under the JAX package's module names (``embed``,
    ``mp``, ``head``) and loss name (``masked_ce``). ``graph_axis`` with
    ``partition`` selects the graph-partitioned scheme, as in the JAX
    package: ``"molecule"`` (shards hold whole molecules; only the loss's
    numerator and count cross shards, ``MaskedNodeCrossEntropy(psum_axis)``)
    or ``"replicate"`` (edge shards over replicated nodes; a ``psum`` of the
    E->V sums every layer, ``ChempropBlock(psum_axis)``).
    Parameters are drawn from ``generator``; the model is built on the CPU.
    ``optimizer`` defaults to Adam at ``learning_rate``."""
    if partition not in ("molecule", "replicate"):
        raise ValueError(f"unknown partition scheme {partition!r}")
    mp_axis = graph_axis if partition == "replicate" else None
    loss_axis = graph_axis if partition == "molecule" else None
    modules = {
        "embed": {"module": GraphEmbedding(DEFAULT_NUM_ATOM_TYPES, DEFAULT_NUM_BOND_TYPES, hidden_dim=hidden_dim),
                  "in_keys": ["inputs.G"], "out_keys": ["G"]},
        "mp": {"module": ChempropBlock(hidden_dim=hidden_dim, depth=depth, psum_axis=mp_axis),
               "in_keys": ["embed.G"], "out_keys": ["G"]},
        "head": {"module": NodeHead(num_classes=num_elements, hidden_dim=hidden_dim), "in_keys": ["mp.G"],
                 "out_keys": ["logits"]},
    }
    losses = {"masked_ce": {"fn": MaskedNodeCrossEntropy(psum_axis=loss_axis),
                            "in_keys": ["head.logits", "inputs.node_labels"], "weight": 1.0}}
    model = Model(modules=modules, losses=losses,
                  optimizer=optimizer if optimizer is not None else OptimizerSpec("adam", learning_rate))
    model.reset_parameters(generator)
    return model
