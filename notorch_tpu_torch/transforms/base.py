"""Transform protocol and pipeline composition.

Capability parity: reference ``notorch/transforms/base.py:10-45`` — a
``Transform`` maps one sample and knows how to ``collate`` a list of outputs;
``Pipeline`` chains transforms and collates with the last one.
"""

from __future__ import annotations

from typing import Any, ClassVar, Protocol, runtime_checkable


@runtime_checkable
class Transform(Protocol):
    _in_key_: ClassVar[str]
    _out_key_: ClassVar[str]

    def __call__(self, input: Any) -> Any: ...

    def collate(self, inputs: list) -> Any: ...


class GraphTransform(Transform, Protocol):
    @property
    def num_node_types(self) -> int: ...

    @property
    def num_edge_types(self) -> int: ...


class Pipeline:
    """Chain transforms; the in/out keys and collate come from the ends."""

    def __init__(self, *transforms):
        if not transforms:
            raise ValueError("Pipeline needs at least one transform")
        self.transforms = transforms
        self._in_key_ = getattr(transforms[0], "_in_key_", "input")
        self._out_key_ = getattr(transforms[-1], "_out_key_", "output")

    def __call__(self, input):
        out = input
        for t in self.transforms:
            out = t(out)
        return out

    def collate(self, inputs: list):
        return self.transforms[-1].collate(inputs)

    def __getattr__(self, name):
        # surface num_node_types etc. from the last transform that has them
        for t in reversed(self.__dict__.get("transforms", ())):
            if hasattr(t, name):
                return getattr(t, name)
        raise AttributeError(name)
