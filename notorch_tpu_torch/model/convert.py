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
embedding (``DenseGraphEmbedding``, ``GraphEmbedding``; ``PointwiseEmbed`` has ``node`` alone):
``node/embedding/embedding [n_atom_types, d]``       ``node.embedding.weight`` (same)
``edge/embedding/embedding [n_bond_types, d]``       ``edge.embedding.weight`` (same)
stacked layers (the dense blocks, ``ChempropBlock``):
``layer_i/update/kernel [d, d]``                     ``weight[i]`` ``[depth, d, d]``,
                                                     stacked, kept ``[in, out]``
``layer_i/update/bias [d]``                          ``bias[i]`` ``[depth, d]``
``layer/update/kernel``, ``layer/update/bias``       ``weight [d, d]``, ``bias [d]``
(``ChempropBlock(shared=True)``)
(no ``bias`` leaf with ``bias=False``)               (no ``bias`` key)
dense layers (``MLP``, ``ChempropLayer``, the gated readouts, the
attention layers and blocks, ``GvpGNNBlock``'s ``in_proj`` and
``layer_i/{conv/message_j,update_j}/{W_h,W_mu,W_m,W_g}`` with the
``conv/ln/scalar_ln`` and ``ln/scalar_ln`` LayerNorms), at any depth of nesting:
``<path>/kernel [in, out]``                          ``<path>.weight [out, in]``
                                                     (transposed for ``nn.Linear``;
                                                     ``<path>`` ``/`` -> ``.``)
``<path>/bias [out]``                                ``<path>.bias``
``<path>/scale [d]`` (a flax ``LayerNorm``)          ``<path>.weight [d]`` (an
                                                     ``nn.LayerNorm``; 1-D, so
                                                     never transposed)
e.g. ``dense_i``, ``update``, ``a`` (also GATv2's
per-head ``DenseGeneral`` ``a``, kernel ``[dh, 1]``),
``in_proj``, ``attn_i/W_q``, ``ffn_i_0``
attention readouts (``SDPAttention``, ``DenseSDPAttention``, ``PackedSDPAttention``):
``query [1, d]``                                     ``query`` (same)
==================================================  ===================================

The other readouts have no parameters, and so no group.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_GROUP = "modules__"
_LAYER = re.compile(r"layer_(\d+)$")
# (kind, the group's JAX keys that name it, its port keys that name it);
# a group of none of these kinds is a tree of dense layers
_KINDS = (
    ("embedding", {"node", "edge"}, {"node.embedding.weight", "edge.embedding.weight"}),
    ("stacked", {"layer_0", "layer"}, {"weight"}),
    ("query", {"query"}, {"query"}),
)


def _stacked_layers(tree: dict) -> list:
    """The ``layer_0``, ``layer_1``, ... entries of ``tree``, in order."""
    idx = sorted(int(m.group(1)) for k in tree if (m := _LAYER.match(k)))
    if idx != list(range(len(idx))):
        raise ValueError(f"layer_i entries are not numbered 0..n-1: {sorted(tree)}")
    return [tree[f"layer_{i}"] for i in idx]


def _kind_of_keys(keys) -> str:
    keys = set(keys)
    for kind, jax_keys, port_keys in _KINDS:
        if keys & (jax_keys | port_keys):
            return kind
    return "dense"


def _dense_from_jax(sd: dict, prefix: str, tree: dict, t, name: str) -> None:
    """Every flax ``Dense``/``DenseGeneral`` ``{kernel [in, out], bias?}``
    below ``tree`` as an ``nn.Linear``'s ``weight [out, in]`` and ``bias``
    at its dotted path."""
    if not isinstance(tree, dict) or not tree:
        raise ValueError(f"module {name!r}: cannot tell the parameter layout at {prefix!r}: {tree!r}")
    if "kernel" in tree or "scale" in tree:
        sd[f"{prefix}.weight"] = t(tree["kernel"]).T.contiguous() if "kernel" in tree else t(tree["scale"])
        if "bias" in tree:
            sd[f"{prefix}.bias"] = t(tree["bias"])
        return
    for key, sub in tree.items():
        _dense_from_jax(sd, f"{prefix}.{key}", sub, t, name)


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
        kind = _kind_of_keys(group)
        if kind == "stacked" and "update" not in group.get("layer", group.get("layer_0", {})):
            kind = "dense"  # numbered layers that are not one update each (GvpGNNBlock's)
        if kind == "embedding":
            for part in ("node", "edge"):
                if part in group:
                    sd[f"{name}.{part}.embedding.weight"] = t(group[part]["embedding"]["embedding"])
        elif kind == "stacked":
            layers = [group["layer"]] if "layer" in group else _stacked_layers(group)
            stack = (lambda xs: xs[0]) if "layer" in group else torch.stack
            sd[f"{name}.weight"] = stack([t(layer["update"]["kernel"]) for layer in layers])
            if "bias" in layers[0]["update"]:
                sd[f"{name}.bias"] = stack([t(layer["update"]["bias"]) for layer in layers])
        elif kind == "query":
            sd[f"{name}.query"] = t(group["query"])
        else:
            _dense_from_jax(sd, name, group, t, name)
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
        kind = _kind_of_keys(keys)
        if kind == "embedding":
            group = {
                part: {"embedding": {"embedding": a(state_dict[f"{name}.{part}.embedding.weight"])}}
                for part in ("node", "edge") if f"{part}.embedding.weight" in keys
            }
        elif kind == "stacked":
            W, b = state_dict[f"{name}.weight"], state_dict.get(f"{name}.bias")

            def update(i):
                out = {"kernel": a(W if i is None else W[i])}
                if b is not None:
                    out["bias"] = a(b if i is None else b[i])
                return {"update": out}

            # a shared block keeps one [d, d] layer
            group = {"layer": update(None)} if W.dim() == 2 else {f"layer_{i}": update(i) for i in range(len(W))}
        elif kind == "query":
            group = {"query": a(state_dict[f"{name}.query"])}
        else:
            group = {}
            for key in keys:
                *path, leaf = key.split(".")
                node = group
                for part in path:
                    node = node.setdefault(part, {})
                value = a(state_dict[f"{name}.{key}"])
                if leaf == "weight" and value.ndim == 1:  # a LayerNorm's scale
                    node["scale"] = value
                elif leaf == "weight":
                    node["kernel"] = value.T.copy()
                else:
                    node[leaf] = value
        tree[f"{_GROUP}{name}"] = group
    return tree
