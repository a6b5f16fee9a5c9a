"""Value -> index maps used by the type-index featurizers.

Capability parity: reference ``notorch/transforms/utils/inverse_index.py``.
``InverseIndexWithUnknown`` maps unseen keys to a trailing <UNK> slot; its
``len`` includes that slot so family offsets line up with the embedding table.
"""

from __future__ import annotations

from collections.abc import Collection, Hashable, Iterable, Mapping
from typing import TypeVar

KT = TypeVar("KT", bound=Hashable)


class InverseIndex(Mapping):
    """The logical inverse of a list: item -> its position."""

    def __init__(self, keys: Iterable):
        self._k2i = {k: i for i, k in enumerate(keys)}

    def __getitem__(self, key) -> int:
        return self._k2i[key]

    def get(self, key, default=None):
        return self._k2i.get(key, default)

    def __len__(self) -> int:
        return len(self._k2i)

    def __iter__(self):
        return iter(self._k2i)

    def __repr__(self):
        return str([str(k) for k in self._k2i]).replace("'", "")


class InverseIndexWithUnknown(InverseIndex):
    """An :class:`InverseIndex` with a trailing <UNK> slot for unseen keys."""

    def __getitem__(self, key) -> int:
        return super().get(key, len(self) - 1)

    def __len__(self) -> int:
        return super().__len__() + 1

    def __repr__(self):
        return super().__repr__() + " + <UNK>"


def build(choices: Collection | None, unknown_pad: bool = True):
    if choices is None:
        return None
    if not choices and not unknown_pad:
        raise ValueError("empty 'choices' with unknown_pad=False yields no valid keys")
    return InverseIndexWithUnknown(choices) if unknown_pad else InverseIndex(choices)
