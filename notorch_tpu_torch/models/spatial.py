"""The spatial (3D) property predictors (``model.kind: spatial``): pointwise
embedding -> SchNet or GVP block -> spatial readout -> MLP head.

Port of ``notorch_tpu.models.spatial``: the JAX recipe's modules
(``embed``, ``backbone``, ``readout``, ``ffn``), the task's loss named
``loss`` on ``target_key`` and Adam at ``learning_rate``. The head is
``(num_tasks, k)`` wide for the task types of several outputs a task, with
``k`` 2 for multiclass and dirichlet (the JAX recipe has no
``num_classes``). ``backbone="schnet"`` (the default) builds a
:class:`~notorch_tpu_torch.nn.spatial.schnet.SchnetBlock`, whose neighbour
gathers take their gradient through row 8 on the card; ``"gvp"`` a
``GvpGNNBlock`` with the default ``impl`` (``"auto"``, the plain tensor
ops), as the JAX recipe builds it, so rows 14-15 are reached only by a
``GvpGNNBlock(impl: fused)`` in a declarative config.
"""

from __future__ import annotations

import torch

from notorch_tpu_torch.conf import DEFAULT_HIDDEN_DIM
from notorch_tpu_torch.model.model import Model, fill_pred_transform_keys
from notorch_tpu_torch.models.dmpnn import _HEAD_WIDTH, _LOSSES, head_size
from notorch_tpu_torch.nn.mlp import MLP
from notorch_tpu_torch.nn.spatial import agg as spatial_agg
from notorch_tpu_torch.nn.spatial.gvp import GvpGNNBlock
from notorch_tpu_torch.nn.spatial.pointwise import PointwiseEmbed
from notorch_tpu_torch.nn.spatial.schnet import SchnetBlock
from notorch_tpu_torch.training.optim import OptimizerSpec
from notorch_tpu_torch.transforms.vocab import DEFAULT_NUM_ATOM_TYPES

SPATIAL_AGGREGATIONS = {
    "sum": spatial_agg.Sum,
    "mean": spatial_agg.Mean,
    "max": spatial_agg.Max,
    "gated": spatial_agg.Gated,
}


def build_spatial_model(
    backbone: str = "schnet",
    num_tasks: int = 1,
    task: str = "regression",
    hidden_dim: int = DEFAULT_HIDDEN_DIM,
    depth: int = 3,
    radius: float = 5.0,
    max_neighbors: int = 16,
    neighbor_window: int | None = None,
    aggregation: str = "sum",
    ffn_layers: int = 1,
    num_node_types: int = DEFAULT_NUM_ATOM_TYPES,
    learning_rate: float = 1e-3,
    optimizer: OptimizerSpec | None = None,
    transforms: dict | None = None,
    target_key: str = "targets.y",
    generator: torch.Generator | None = None,
) -> Model:
    """The JAX recipe's model, its parameters drawn from ``generator`` and
    built on the CPU. ``neighbor_window`` is the banded neighbour search,
    valid whenever every cloud has at most ``window + 1`` atoms."""
    if task not in _LOSSES:
        raise ValueError(f"unknown task {task!r}; options: {list(_LOSSES)}")
    if aggregation not in SPATIAL_AGGREGATIONS:
        raise ValueError(f"unknown aggregation {aggregation!r}; options: {sorted(SPATIAL_AGGREGATIONS)}")
    if backbone == "schnet":
        block = SchnetBlock(hidden_dim=hidden_dim, depth=depth, radius=radius, max_neighbors=max_neighbors,
                            neighbor_window=neighbor_window)
    elif backbone == "gvp":
        block = GvpGNNBlock(scalar_dim=hidden_dim, vector_dim=max(hidden_dim // 8, 4), depth=depth, radius=radius,
                            max_neighbors=max_neighbors, neighbor_window=neighbor_window)
    else:
        raise ValueError(f"unknown spatial backbone {backbone!r}")
    readout = SPATIAL_AGGREGATIONS[aggregation]
    output_size = head_size(num_tasks, _HEAD_WIDTH.get(task, 2))
    modules = {
        "embed": {"module": PointwiseEmbed(num_types=num_node_types, hidden_dim=hidden_dim), "in_keys": ["inputs.P"],
                  "out_keys": ["P"]},
        "backbone": {"module": block, "in_keys": ["embed.P"], "out_keys": ["P"]},
        "readout": {"module": readout(hidden_dim) if aggregation == "gated" else readout(),
                    "in_keys": ["backbone.P"], "out_keys": ["H"]},
        "ffn": {"module": MLP(input_dim=hidden_dim, output_size=output_size,
                              hidden_dim=hidden_dim, num_layers=ffn_layers),
                "in_keys": ["readout.H"], "out_keys": ["preds"]},
    }
    keys = {"preds": "ffn.preds", "targets": target_key, "mask": f"{target_key}_mask"}
    model = Model(
        modules=modules,
        losses={"loss": {"fn": _LOSSES[task](), "in_keys": keys}},
        transforms=fill_pred_transform_keys(transforms, "ffn.preds"),
        optimizer=optimizer if optimizer is not None else OptimizerSpec("adam", learning_rate),
    )
    model.reset_parameters(generator)
    return model
