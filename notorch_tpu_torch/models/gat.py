"""The graph-attention property predictor (``model.kind: gat`` and
``graph_transformer``): embed -> depth-stacked attention -> readout -> FFN.

Port of ``notorch_tpu.models.gat``. ``layout="auto"`` resolves to the
bin-packed ``dense_packed`` layout for both stacks, whose bins the loaders
pin at 256 edge lanes and 128 node slots (:func:`gat_loader_kwargs`): there
the block is :class:`~notorch_tpu_torch.nn.attention_dense.DenseGATBlock`
with the einsum core (``impl="jnp"``, as the JAX recipe builds it, so no
kernel runs on this path in either package) and a ``Packed*`` readout; on
the per-molecule ``dense`` layout a ``Dense*`` readout; on ``flat`` the
flat :class:`~notorch_tpu_torch.nn.attention.GATBlock` and the readouts of
:mod:`notorch_tpu_torch.nn.agg`. Every task type, with the D-MPNN recipe's
head widths and losses. ``dropout`` goes to the block (twice a layer) and
the FFN, as in the JAX recipe; dtypes other than float32 raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from notorch_tpu_torch.conf import DEFAULT_HIDDEN_DIM
from notorch_tpu_torch.model.model import Model, fill_pred_transform_keys
from notorch_tpu_torch.models.dmpnn import (
    _HEAD_WIDTH,
    DENSE_READOUTS,
    FLAT_READOUTS,
    PACKED_READOUTS,
    head_size,
    readout,
    regression_metrics,
    task_losses,
)
from notorch_tpu_torch.nn.attention import GATBlock
from notorch_tpu_torch.nn.attention_dense import DenseGATBlock
from notorch_tpu_torch.nn.chemprop_dense import DenseGraphEmbedding
from notorch_tpu_torch.nn.embed import GraphEmbedding
from notorch_tpu_torch.nn.mlp import MLP
from notorch_tpu_torch.training.optim import OptimizerSpec
from notorch_tpu_torch.transforms.vocab import DEFAULT_NUM_ATOM_TYPES, DEFAULT_NUM_BOND_TYPES
from notorch_tpu_torch.utils import compute_dtype

KINDS = ("gat", "graph_transformer")


def resolve_gat_layout(layout: str = "auto", *, attention: str = "gatv2") -> str:
    """``auto`` -> ``dense_packed`` for both stacks, as in the JAX package;
    explicit layouts pass through."""
    return "dense_packed" if layout == "auto" else layout


def gat_loader_kwargs(layout: str) -> dict:
    """DataLoader kwargs of the attention stack's bins: 256 edge lanes and
    128 node slots on ``dense_packed``, nothing on the other layouts. One
    source for the train, eval and predict loaders."""
    if layout == "dense_packed":
        return {"bin_edges": 256, "bin_nodes": 128}
    return {}


def build_gat(
    num_tasks: int = 1,
    task: str = "regression",
    num_classes: int = 2,
    hidden_dim: int = DEFAULT_HIDDEN_DIM,
    depth: int = 3,
    num_heads: int = 4,
    attention: str = "gatv2",
    dropout: float = 0.0,
    aggregation: str = "mean",
    ffn_layers: int = 1,
    learning_rate: float = 1e-4,
    optimizer: OptimizerSpec | None = None,
    transforms: dict | None = None,
    target_key: str = "targets.y",
    num_node_types: int | None = None,
    num_edge_types: int | None = None,
    metrics: dict | None = None,
    dtype=None,
    layout: str = "auto",
    generator: torch.Generator | None = None,
) -> Model:
    """Embed -> attention block -> readout -> FFN, with the JAX recipe's
    modules (``embed``, ``mp``, ``readout``, ``ffn``), the task's loss
    (``mse`` for regression) and, for regression, the metrics ``rmse`` and
    ``mae`` on ``target_key``. Parameters are drawn
    from ``generator`` with flax's initializer families; the model is built
    on the CPU. ``optimizer`` defaults to Adam at ``learning_rate``.
    ``dtype="bfloat16"`` computes every module in bf16 (f32 parameters), as
    the JAX recipe's modules do."""
    dt = compute_dtype(dtype)
    if aggregation not in FLAT_READOUTS:
        raise ValueError(f"unknown aggregation {aggregation!r}; options: {sorted(FLAT_READOUTS)}")
    layout = resolve_gat_layout(layout, attention=attention)
    num_node_types = num_node_types if num_node_types is not None else DEFAULT_NUM_ATOM_TYPES
    num_edge_types = num_edge_types if num_edge_types is not None else DEFAULT_NUM_BOND_TYPES
    block_kw = dict(hidden_dim=hidden_dim, depth=depth, num_heads=num_heads, attention=attention,
                    dropout=dropout, dtype=dt)
    if layout in ("dense", "dense_packed"):
        embed = DenseGraphEmbedding(num_node_types, num_edge_types, hidden_dim=hidden_dim, dtype=dt)
        block = DenseGATBlock(**block_kw)
        readouts = PACKED_READOUTS if layout == "dense_packed" else DENSE_READOUTS
    else:
        embed = GraphEmbedding(num_node_types, num_edge_types, hidden_dim=hidden_dim, dtype=dt)
        block = GATBlock(**block_kw)
        readouts = FLAT_READOUTS
    output_size = head_size(num_tasks, _HEAD_WIDTH.get(task, num_classes))
    keys = {"preds": "ffn.preds", "targets": target_key, "mask": f"{target_key}_mask"}
    model = Model(
        modules={
            "embed": {"module": embed, "in_keys": ["inputs.G"], "out_keys": ["G"]},
            "mp": {"module": block, "in_keys": ["embed.G"], "out_keys": ["G"]},
            "readout": {"module": readout(readouts, aggregation, hidden_dim, dt), "in_keys": ["mp.G"],
                        "out_keys": ["H"]},
            "ffn": {
                "module": MLP(input_dim=hidden_dim, output_size=output_size,
                              hidden_dim=hidden_dim, num_layers=ffn_layers, dropout=dropout, dtype=dt),
                "in_keys": ["readout.H"],
                "out_keys": ["preds"],
            },
        },
        losses=task_losses(task, keys),
        metrics=metrics if metrics is not None else regression_metrics(task, keys),
        transforms=fill_pred_transform_keys(transforms, "ffn.preds"),
        optimizer=optimizer if optimizer is not None else OptimizerSpec("adam", learning_rate),
    )
    model.reset_parameters(generator)
    return model

