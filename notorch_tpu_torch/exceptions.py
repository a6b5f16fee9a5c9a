"""Framework exceptions.

Port of ``notorch_tpu.exceptions``: :class:`InvalidShapeError`,
:class:`InvalidChoiceError`, :func:`pretty_shape`, and
:class:`~notorch_tpu_torch.data.databases.ClosedDatabaseError` re-exported.
"""

from __future__ import annotations

from collections.abc import Collection, Sequence

from notorch_tpu_torch.data.databases import ClosedDatabaseError  # re-export

__all__ = ["InvalidShapeError", "ClosedDatabaseError", "InvalidChoiceError", "pretty_shape"]


def pretty_shape(shape: Sequence[int]) -> str:
    return " x ".join(str(s) for s in shape)


class InvalidShapeError(ValueError):
    def __init__(self, name: str, received: Sequence[int], expected: Collection[Sequence[int]]):
        exp = " | ".join(pretty_shape(s) for s in expected)
        super().__init__(f"argument {name!r} had invalid shape: got {pretty_shape(received)}, expected {exp}")


class InvalidChoiceError(ValueError):
    def __init__(self, choice, choices: Collection):
        super().__init__(f"invalid choice {choice!r}; expected one of {sorted(map(str, choices))}")
