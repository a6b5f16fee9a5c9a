"""Declarative key-space model composition.

Port of ``notorch_tpu.model.composed``: a model is declared as named
modules that read keys of a flat batch dict and write their results under
``<name>.<out_key>``. Inputs arrive under ``inputs.*``, targets under
``targets.*``.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

from torch import nn

__all__ = ["ComposedNetwork", "get_key", "make_network"]


def get_key(batch: Mapping[str, Any], key: str):
    try:
        return batch[key]
    except KeyError:
        raise KeyError(f"key {key!r} not in batch; available: {sorted(batch)}") from None


def _gather(batch: Mapping[str, Any], in_keys):
    if isinstance(in_keys, Mapping):
        return (), {kw: get_key(batch, k) for kw, k in in_keys.items()}
    return tuple(get_key(batch, k) for k in in_keys), {}


class ComposedNetwork(nn.ModuleDict):
    """Run named modules in order over the batch dict.

    The modules are the entries of this ``ModuleDict`` (so their parameters
    are ``<name>.<...>`` in the ``state_dict``); ``wiring`` holds one
    ``(name, in_keys, out_keys)`` per module, in execution order. ``in_keys``
    may be a sequence (positional) or a mapping (keyword). Module outputs
    (a single value or a tuple) are stored under ``<name>.<out_key>``.
    ``aliases`` maps a wired name to the entry whose module it runs: one
    module declared under several names (a shared encoder) is one entry,
    under its first name, with one set of parameters, as flax binds it.
    """

    def __init__(self, modules: Mapping[str, nn.Module], wiring: Sequence[tuple],
                 aliases: Mapping[str, str] | None = None):
        super().__init__(modules)
        self.wiring = tuple(wiring)
        self.aliases = dict(aliases or {})

    def forward(self, batch: Mapping[str, Any]) -> dict:
        batch = dict(batch)
        for name, in_keys, out_keys in self.wiring:
            args, kwargs = _gather(batch, in_keys)
            out = self[self.aliases.get(name, name)](*args, **kwargs)
            if not isinstance(out, tuple):
                out = (out,)
            if len(out) != len(out_keys):
                raise ValueError(
                    f"module {name!r} returned {len(out)} values for "
                    f"{len(out_keys)} out_keys {list(out_keys)}"
                )
            for key, value in zip(out_keys, out):
                batch[f"{name}.{key}"] = value
        return batch


def _toposort(modules: Mapping[str, Mapping[str, Any]]) -> list[str]:
    """Order modules by their key-space dependencies (module X consumes
    ``Y.<key>`` => Y runs first), keeping declaration order among
    independents."""
    names = list(modules)
    deps: dict[str, set[str]] = {}
    for name, cfg in modules.items():
        in_keys = cfg["in_keys"]
        keys = in_keys.values() if isinstance(in_keys, Mapping) else in_keys
        deps[name] = {
            k.split(".", 1)[0]
            for k in keys
            if "." in k and k.split(".", 1)[0] in modules
        }
    order: list[str] = []
    done: set[str] = set()
    while len(order) < len(names):
        progressed = False
        for name in names:
            if name not in done and deps[name] <= done:
                order.append(name)
                done.add(name)
                progressed = True
        if not progressed:
            cyc = sorted(set(names) - done)
            raise ValueError(f"module wiring has a dependency cycle among {cyc}")
    return order


def make_network(modules: Mapping[str, Mapping[str, Any]]) -> ComposedNetwork:
    """Build a :class:`ComposedNetwork` from module configs
    ``{name: {"module": m, "in_keys": [...], "out_keys": [...]}}``, run in
    the topological order of the key-space DAG. A module object declared
    under several names is held once, under the first of them in that
    order."""
    order = _toposort(modules)
    first: dict[int, str] = {}
    for name in order:
        first.setdefault(id(modules[name]["module"]), name)
    owner = {name: first[id(modules[name]["module"])] for name in order}
    return ComposedNetwork(
        {name: modules[name]["module"] for name in order if owner[name] == name},
        [
            (
                name,
                dict(modules[name]["in_keys"])
                if isinstance(modules[name]["in_keys"], Mapping)
                else tuple(modules[name]["in_keys"]),
                tuple(modules[name]["out_keys"]),
            )
            for name in order
        ],
        {name: o for name, o in owner.items() if o != name},
    )
