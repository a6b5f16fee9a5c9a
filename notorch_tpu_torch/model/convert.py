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
``conv/ln/scalar_ln`` and ``ln/scalar_ln`` LayerNorms, ``SchnetBlock``'s
``interaction_i/{in_proj,cfconv/filter_j,out_proj_j}``,
``GatedEquivariantBlock``'s ``W_1``, ``W_2`` (no bias) and ``mlp_j``; a
group named by ``layer_i`` entries is dense unless each holds one
``update``), at any depth of nesting:
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
stacked experts (``MixtureOfExperts``, ``nn.vmap``'s leading expert axis):
``experts/<path>/kernel [n, in, out]``               ``experts.<path>.weight [n, out, in]``
                                                     (the last two axes swapped)
``experts/<path>/bias [n, out]``                     ``experts.<path>.bias`` (same)
flax's auto-named inner modules, in any path:
``BatchNorm_0``, ``LayerNorm_0``                     ``batch_norm``, ``layer_norm``
``DenseRouter_0``, ``SparseRouter_0``                ``dense_router``, ``sparse_router``
attention readouts (``SDPAttention``, ``DenseSDPAttention``, ``PackedSDPAttention``):
``query [1, d]``                                     ``query`` (same)
the halo block (``HaloChempropBlock``, stacked ``[in, out]`` as there):
``weights [depth, d, d]``, ``biases [depth, d]``     ``weights``, ``biases`` (same)
running statistics (the ``batch_stats`` collection, ``BatchNorm``):
``<path>/mean``, ``<path>/var``                      ``<path>.running_mean``,
                                                     ``<path>.running_var`` (buffers)
==================================================  ===================================

The other readouts have no parameters, and so no group. The running
statistics go in with ``params_from_jax(params, batch_stats)`` and come out
with :func:`batch_stats_to_jax`; :func:`params_to_jax` leaves them out.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_GROUP = "modules__"
_LAYER = re.compile(r"layer_(\d+)$")
# flax's names of inner modules a JAX module creates unnamed -> the port's
_FLAX_NAMES = {"BatchNorm_0": "batch_norm", "LayerNorm_0": "layer_norm", "DenseRouter_0": "dense_router",
               "SparseRouter_0": "sparse_router"}
_PORT_NAMES = {v: k for k, v in _FLAX_NAMES.items()}
_STATS = {"mean": "running_mean", "var": "running_var"}
# (kind, the group's JAX keys that name it, its port keys that name it);
# a group of none of these kinds is a tree of dense layers
_KINDS = (
    ("embedding", {"node", "edge"}, {"node.embedding.weight", "edge.embedding.weight"}),
    ("stacked", {"layer_0", "layer"}, {"weight"}),
    ("query", {"query"}, {"query"}),
    ("halo", {"weights", "biases"}, {"weights", "biases"}),
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
    at its dotted path (a stacked kernel ``[n, in, out]`` as ``[n, out,
    in]``)."""
    if not isinstance(tree, dict) or not tree:
        raise ValueError(f"module {name!r}: cannot tell the parameter layout at {prefix!r}: {tree!r}")
    if "kernel" in tree or "scale" in tree:
        sd[f"{prefix}.weight"] = (t(tree["kernel"]).transpose(-1, -2).contiguous() if "kernel" in tree
                                  else t(tree["scale"]))
        if "bias" in tree:
            sd[f"{prefix}.bias"] = t(tree["bias"])
        return
    for key, sub in tree.items():
        _dense_from_jax(sd, f"{prefix}.{_FLAX_NAMES.get(key, key)}", sub, t, name)


def _stats_from_jax(sd: dict, prefix: str, tree: dict, t) -> None:
    """The ``batch_stats`` leaves below ``tree`` as ``running_*`` buffers."""
    for key, sub in tree.items():
        if key in _STATS:
            sd[f"{prefix}.{_STATS[key]}"] = t(sub)
        else:
            _stats_from_jax(sd, f"{prefix}.{_FLAX_NAMES.get(key, key)}", sub, t)


def params_from_jax(tree: dict, batch_stats: dict | None = None) -> dict[str, torch.Tensor]:
    """JAX ``Model`` params (and the ``batch_stats`` collection of
    ``state.extra_vars``, where the model has one) -> the port's
    ``state_dict`` (see the module docstring for the mapping)."""
    bad = sorted(k for k in {**tree, **(batch_stats or {})} if not k.startswith(_GROUP))
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
        elif kind == "halo":
            sd.update({f"{name}.{key}": t(group[key]) for key in ("weights", "biases")})
        else:
            _dense_from_jax(sd, name, group, t, name)
    for group, stats in (batch_stats or {}).items():
        _stats_from_jax(sd, group[len(_GROUP):], stats, t)
    return sd


def params_to_jax(state_dict: dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`params_from_jax`: the port's ``state_dict`` -> the
    JAX parameter tree (numpy leaves)."""

    def a(x: torch.Tensor) -> np.ndarray:
        return x.detach().cpu().numpy()

    names: dict[str, list[str]] = {}
    for key in state_dict:
        if key.endswith(tuple(_STATS.values())):
            continue  # batch_stats_to_jax
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
        elif kind == "halo":
            group = {key: a(state_dict[f"{name}.{key}"]) for key in ("weights", "biases")}
        else:
            group = {}
            for key in keys:
                *path, leaf = key.split(".")
                node = _node(group, path)
                value = a(state_dict[f"{name}.{key}"])
                if leaf == "weight" and value.ndim == 1:  # a LayerNorm's scale
                    node["scale"] = value
                elif leaf == "weight":
                    node["kernel"] = value.swapaxes(-1, -2).copy()
                else:
                    node[leaf] = value
        tree[f"{_GROUP}{name}"] = group
    return tree


def _node(tree: dict, path: list[str]) -> dict:
    """The subtree of ``tree`` at the port's dotted ``path`` (flax names)."""
    for part in path:
        tree = tree.setdefault(_PORT_NAMES.get(part, part), {})
    return tree


def batch_stats_to_jax(state_dict: dict[str, torch.Tensor]) -> dict:
    """The running statistics of the port's ``state_dict`` as the JAX
    ``batch_stats`` collection (numpy leaves; empty when there are none)."""
    tree: dict = {}
    stats = {v: k for k, v in _STATS.items()}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        if leaf in stats:
            _node(tree, [f"{_GROUP}{path[0]}", *path[1:]])[stats[leaf]] = value.detach().cpu().numpy()
    return tree
