"""Multi-component models: N molecular inputs -> N encoders -> concat -> head.

Port of ``notorch_tpu.models.multicomponent``: per-component message
passing on the flat layout (``GraphEmbedding`` -> ``ChempropBlock`` -> a
readout), the readouts concatenated (with optional molecule-level extra
features) into one fingerprint, optionally normalised, and a shared FFN
head. Covers the reaction + solvent config together with
:mod:`notorch_tpu_torch.transforms.reaction`.
"""

from __future__ import annotations

import torch
from torch import nn

from notorch_tpu_torch.conf import DEFAULT_HIDDEN_DIM
from notorch_tpu_torch.model.model import Model, fill_pred_transform_keys
from notorch_tpu_torch.models.dmpnn import _HEAD_WIDTH, _LOSSES, FLAT_READOUTS, head_size, readout
from notorch_tpu_torch.nn.chemprop import ChempropBlock
from notorch_tpu_torch.nn.embed import GraphEmbedding
from notorch_tpu_torch.nn.glue import BatchNorm, Cat
from notorch_tpu_torch.nn.mlp import MLP
from notorch_tpu_torch.training.optim import OptimizerSpec
from notorch_tpu_torch.transforms.vocab import DEFAULT_NUM_ATOM_TYPES, DEFAULT_NUM_BOND_TYPES


class LayerNormModule(nn.Module):
    """flax's ``LayerNorm`` over the last axis (epsilon 1e-6), as the JAX
    module's inner ``LayerNorm_0`` (here ``layer_norm``)."""

    def __init__(self, features: int):
        super().__init__()
        self.layer_norm = nn.LayerNorm(features, eps=1e-6)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.layer_norm.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer_norm(x)


def build_multicomponent_dmpnn(
    component_keys: list[str],
    num_tasks: int = 1,
    task: str = "regression",
    hidden_dim: int = DEFAULT_HIDDEN_DIM,
    depth: int = 3,
    dropout: float = 0.0,
    aggregation: str = "mean",
    ffn_layers: int = 1,
    shared_encoder: bool = False,
    normalize_fingerprint: bool = True,
    norm: str = "layer",
    num_node_types: dict[str, int] | None = None,
    num_edge_types: dict[str, int] | None = None,
    learning_rate: float = 1e-4,
    optimizer: OptimizerSpec | None = None,
    transforms: dict | None = None,
    target_key: str = "targets.y",
    extra_features_key: str | None = None,
    extra_features_dim: int = 0,
    generator: torch.Generator | None = None,
) -> Model:
    """``component_keys``: input keys, e.g. ``["inputs.G1", "inputs.G2"]``.

    ``shared_encoder=True`` runs one embed and one block for every
    component, one set of parameters under ``embed_0``/``mp_0`` (the later
    components' names are aliases of the first's), as in the JAX package;
    otherwise each component has its own encoder. Vocabulary sizes come from
    ``num_node_types``/``num_edge_types`` keyed by component key (the
    shared encoder takes their maximum). ``norm`` is ``"layer"`` or
    ``"batch"``. Parameters are drawn from ``generator``; the model is built
    on the CPU. ``optimizer`` defaults to Adam at ``learning_rate``.
    """
    modules: dict = {}
    readout_keys = []

    def embed(**kw):
        return GraphEmbedding(kw.get("num_node_types", DEFAULT_NUM_ATOM_TYPES),
                              kw.get("num_edge_types", DEFAULT_NUM_BOND_TYPES), hidden_dim=hidden_dim)

    def block():
        return ChempropBlock(hidden_dim=hidden_dim, depth=depth, dropout=dropout)

    shared_embed = shared_mp = None
    if shared_encoder:
        kw = {}
        if num_node_types:
            kw["num_node_types"] = max(num_node_types.values())
        if num_edge_types:
            kw["num_edge_types"] = max(num_edge_types.values())
        shared_embed, shared_mp = embed(**kw), block()

    for i, key in enumerate(component_keys):
        kw = {}
        if num_node_types and key in num_node_types:
            kw["num_node_types"] = num_node_types[key]
        if num_edge_types and key in num_edge_types:
            kw["num_edge_types"] = num_edge_types[key]
        modules[f"embed_{i}"] = {"module": shared_embed if shared_encoder else embed(**kw), "in_keys": [key],
                                 "out_keys": ["G"]}
        modules[f"mp_{i}"] = {"module": shared_mp if shared_encoder else block(), "in_keys": [f"embed_{i}.G"],
                              "out_keys": ["G"]}
        modules[f"readout_{i}"] = {"module": readout(FLAT_READOUTS, aggregation, hidden_dim),
                                   "in_keys": [f"mp_{i}.G"], "out_keys": ["H"]}
        readout_keys.append(f"readout_{i}.H")

    # molecule-level extra features concatenated into the fingerprint
    if extra_features_key is not None:
        readout_keys = readout_keys + [extra_features_key]
    width = hidden_dim * len(component_keys) + extra_features_dim
    modules["fingerprint"] = {"module": Cat(), "in_keys": readout_keys, "out_keys": ["H"]}
    head_in = "fingerprint.H"
    if normalize_fingerprint:
        modules["norm"] = {"module": BatchNorm(width) if norm == "batch" else LayerNormModule(width),
                           "in_keys": ["fingerprint.H"], "out_keys": ["H"]}
        head_in = "norm.H"

    modules["ffn"] = {
        "module": MLP(input_dim=width, output_size=head_size(num_tasks, _HEAD_WIDTH.get(task, 2)),
                      hidden_dim=hidden_dim, num_layers=ffn_layers, dropout=dropout),
        "in_keys": [head_in],
        "out_keys": ["preds"],
    }
    losses = {
        "loss": {
            "fn": _LOSSES[task](),
            "in_keys": {"preds": "ffn.preds", "targets": target_key, "mask": f"{target_key}_mask"},
            "weight": 1.0,
        }
    }
    model = Model(
        modules=modules,
        losses=losses,
        transforms=fill_pred_transform_keys(transforms, "ffn.preds"),
        optimizer=optimizer if optimizer is not None else OptimizerSpec("adam", learning_rate),
    )
    model.reset_parameters(generator)
    return model
