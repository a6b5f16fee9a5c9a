"""Carry weights between the JAX package and the port.

The port keeps its own checkpoint format; these functions map a D-MPNN
parameter tree of ``notorch_tpu.models.dmpnn.build_dmpnn`` (nested dicts of
numpy arrays, as ``jax.device_get(state.params)`` returns) to the
``state_dict`` of :func:`notorch_tpu_torch.models.dmpnn.build_dmpnn` and
back. No JAX is needed: the tree is plain numpy.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LAYER = re.compile(r"(layer|dense)_(\d+)$")


def _indexed(tree: dict, prefix: str) -> list:
    """The ``<prefix>_0``, ``<prefix>_1``, ... entries of ``tree``, in order."""
    idx = sorted(int(m.group(2)) for k in tree if (m := _LAYER.match(k)) and m.group(1) == prefix)
    if idx != list(range(len(idx))):
        raise ValueError(f"{prefix}_i entries are not numbered 0..n-1: {sorted(tree)}")
    return [tree[f"{prefix}_{i}"] for i in idx]


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX D-MPNN params -> the port's ``state_dict``.

    ============================================  ===============================
    JAX (``/``-joined path, shape)                 port key (shape)
    ============================================  ===============================
    ``modules__embed/node/embedding/embedding``    ``embed.node.embedding.weight``
    ``[n_atom_types, d]``                          (same)
    ``modules__embed/edge/embedding/embedding``    ``embed.edge.embedding.weight``
    ``modules__mp/layer_i/update/kernel [d, d]``   ``mp.weight[i]`` ``[depth, d, d]``,
                                                   stacked, kept ``[in, out]``
    ``modules__mp/layer_i/update/bias [d]``        ``mp.bias[i]`` ``[depth, d]``
    ``modules__ffn/dense_i/kernel [in, out]``      ``ffn.dense_i.weight [out, in]``
                                                   (transposed for ``nn.Linear``)
    ``modules__ffn/dense_i/bias [out]``            ``ffn.dense_i.bias``
    ============================================  ===============================

    The readout has no parameters.
    """
    unknown = set(tree) - {"modules__embed", "modules__mp", "modules__ffn"}
    if unknown:
        raise ValueError(f"unexpected parameter groups {sorted(unknown)}")

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    embed, mp, ffn = tree["modules__embed"], tree["modules__mp"], tree["modules__ffn"]
    sd = {
        f"embed.{part}.embedding.weight": t(embed[part]["embedding"]["embedding"])
        for part in ("node", "edge")
    }
    layers = _indexed(mp, "layer")
    sd["mp.weight"] = torch.stack([t(layer["update"]["kernel"]) for layer in layers])
    sd["mp.bias"] = torch.stack([t(layer["update"]["bias"]) for layer in layers])
    for i, dense in enumerate(_indexed(ffn, "dense")):
        sd[f"ffn.dense_{i}.weight"] = t(dense["kernel"]).T.contiguous()
        sd[f"ffn.dense_{i}.bias"] = t(dense["bias"])
    return sd


def params_to_jax(state_dict: dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`params_from_jax`: the port's ``state_dict`` -> the
    JAX parameter tree (numpy leaves)."""

    def a(x: torch.Tensor) -> np.ndarray:
        return x.detach().cpu().numpy()

    embed = {
        part: {"embedding": {"embedding": a(state_dict[f"embed.{part}.embedding.weight"])}}
        for part in ("node", "edge")
    }
    W, b = state_dict["mp.weight"], state_dict["mp.bias"]
    mp = {f"layer_{i}": {"update": {"kernel": a(W[i]), "bias": a(b[i])}} for i in range(len(W))}
    n_dense = sum(1 for k in state_dict if k.startswith("ffn.dense_") and k.endswith(".weight"))
    ffn = {
        f"dense_{i}": {
            "kernel": a(state_dict[f"ffn.dense_{i}.weight"]).T.copy(),
            "bias": a(state_dict[f"ffn.dense_{i}.bias"]),
        }
        for i in range(n_dense)
    }
    return {"modules__embed": embed, "modules__mp": mp, "modules__ffn": ffn}
