"""Carry weights between the JAX package and the port.

The port keeps its own checkpoint format; these functions map the parameter
tree of a JAX ``Model`` (nested dicts of numpy arrays, as
``jax.device_get(state.params)`` returns: one ``modules__<name>`` group per
module that has parameters) to the ``state_dict`` of the port's
:class:`~notorch_tpu_torch.model.composed.ComposedNetwork` with the same
module names, and back. Each group is mapped by its kind, which its own keys
tell apart. No JAX is needed: the tree is plain numpy.

==================================================  ===================================
JAX (``/``-joined path below ``modules__<name>``)    port key below ``<name>.``
==================================================  ===================================
embedding (:class:`DenseGraphEmbedding`):
``node/embedding/embedding [n_atom_types, d]``       ``node.embedding.weight`` (same)
``edge/embedding/embedding [n_bond_types, d]``       ``edge.embedding.weight`` (same)
stacked layers (the dense blocks):
``layer_i/update/kernel [d, d]``                     ``weight[i]`` ``[depth, d, d]``,
                                                     stacked, kept ``[in, out]``
``layer_i/update/bias [d]``                          ``bias[i]`` ``[depth, d]``
dense layers (:class:`MLP`):
``dense_i/kernel [in, out]``                         ``dense_i.weight [out, in]``
                                                     (transposed for ``nn.Linear``)
``dense_i/bias [out]``                               ``dense_i.bias``
==================================================  ===================================

Readouts have no parameters, and so no group.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_GROUP = "modules__"
_LAYER = re.compile(r"(layer|dense)_(\d+)$")


def _indexed(tree: dict, prefix: str) -> list:
    """The ``<prefix>_0``, ``<prefix>_1``, ... entries of ``tree``, in order."""
    idx = sorted(int(m.group(2)) for k in tree if (m := _LAYER.match(k)) and m.group(1) == prefix)
    if idx != list(range(len(idx))):
        raise ValueError(f"{prefix}_i entries are not numbered 0..n-1: {sorted(tree)}")
    return [tree[f"{prefix}_{i}"] for i in idx]


def _kind_of_keys(keys, name: str) -> str:
    keys = set(keys)
    if keys & {"node", "edge", "node.embedding.weight", "edge.embedding.weight"}:
        return "embedding"
    if keys & {"layer_0", "weight"}:
        return "stacked"
    if keys & {"dense_0", "dense_0.weight"}:
        return "dense"
    raise ValueError(f"module {name!r}: cannot tell the parameter layout of keys {sorted(keys)}")


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX ``Model`` params -> the port's ``state_dict`` (see the module
    docstring for the mapping)."""
    bad = sorted(k for k in tree if not k.startswith(_GROUP))
    if bad:
        raise ValueError(f"unexpected parameter groups {bad}: expected {_GROUP}<name>")
    groups = {k[len(_GROUP):]: v for k, v in tree.items()}

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    sd = {}
    for name, group in groups.items():
        kind = _kind_of_keys(group, name)
        if kind == "embedding":
            for part in ("node", "edge"):
                sd[f"{name}.{part}.embedding.weight"] = t(group[part]["embedding"]["embedding"])
        elif kind == "stacked":
            layers = _indexed(group, "layer")
            sd[f"{name}.weight"] = torch.stack([t(layer["update"]["kernel"]) for layer in layers])
            sd[f"{name}.bias"] = torch.stack([t(layer["update"]["bias"]) for layer in layers])
        else:
            for i, dense in enumerate(_indexed(group, "dense")):
                sd[f"{name}.dense_{i}.weight"] = t(dense["kernel"]).T.contiguous()
                sd[f"{name}.dense_{i}.bias"] = t(dense["bias"])
    return sd


def params_to_jax(state_dict: dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`params_from_jax`: the port's ``state_dict`` -> the
    JAX parameter tree (numpy leaves)."""

    def a(x: torch.Tensor) -> np.ndarray:
        return x.detach().cpu().numpy()

    names: dict[str, list[str]] = {}
    for key in state_dict:
        name, _, rest = key.partition(".")
        names.setdefault(name, []).append(rest)
    tree = {}
    for name, keys in names.items():
        kind = _kind_of_keys(keys, name)
        if kind == "embedding":
            group = {
                part: {"embedding": {"embedding": a(state_dict[f"{name}.{part}.embedding.weight"])}}
                for part in ("node", "edge")
            }
        elif kind == "stacked":
            W, b = state_dict[f"{name}.weight"], state_dict[f"{name}.bias"]
            group = {f"layer_{i}": {"update": {"kernel": a(W[i]), "bias": a(b[i])}} for i in range(len(W))}
        else:
            n_dense = sum(1 for k in keys if _LAYER.match(k.split(".")[0]) and k.endswith(".weight"))
            group = {
                f"dense_{i}": {
                    "kernel": a(state_dict[f"{name}.dense_{i}.weight"]).T.copy(),
                    "bias": a(state_dict[f"{name}.dense_{i}.bias"]),
                }
                for i in range(n_dense)
            }
        tree[f"{_GROUP}{name}"] = group
    return tree
