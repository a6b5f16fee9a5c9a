"""Index samplers.

Capability parity: reference ``notorch/samplers.py`` — ``SeededSampler``
(reproducible shuffle) and ``ClassBalanceSampler`` (interleave active /
inactive molecules).
"""

from __future__ import annotations

from itertools import chain
from typing import Iterator

import numpy as np


class SequentialSampler:
    def __init__(self, n: int):
        self.n = n

    def __iter__(self) -> Iterator[int]:
        return iter(range(self.n))

    def __len__(self) -> int:
        return self.n


class SeededSampler:
    """Reproducibly shuffled indices; reshuffles each epoch.

    Two modes: by default the shuffle is STATEFUL (each ``__iter__``
    permutes the previous order — the reference's ``SeededSampler``
    semantics). After :meth:`set_epoch` the order becomes a pure function of
    ``(seed, epoch)`` — any epoch's sequence is reproducible without
    replaying the previous ones, which is what preemption-safe
    ``fit(resume=True)`` needs to fast-forward to the interrupted batch
    (``training/loop.py``; the loop calls ``set_epoch`` automatically)."""

    def __init__(self, n: int, seed: int):
        if seed is None:
            raise ValueError("SeededSampler must be seeded")
        self.seed = seed
        self.idxs = np.arange(n)
        self.rg = np.random.default_rng(seed)
        self._epoch: int | None = None

    def set_epoch(self, epoch: int) -> None:
        """Make the next ``__iter__`` order depend only on (seed, epoch)."""
        self._epoch = int(epoch)

    def __iter__(self) -> Iterator[int]:
        if self._epoch is not None:
            idxs = np.arange(len(self.idxs))
            np.random.default_rng((self.seed, self._epoch)).shuffle(idxs)
            return iter(idxs.tolist())
        self.rg.shuffle(self.idxs)
        return iter(self.idxs.tolist())

    def __len__(self) -> int:
        return len(self.idxs)


class ClassBalanceSampler:
    """Interleave actives (any positive target) and inactives 1:1."""

    def __init__(self, Y: np.ndarray, seed: int | None = None, shuffle: bool = False):
        self.shuffle = shuffle
        self.rg = np.random.default_rng(seed)
        idxs = np.arange(len(Y))
        actives = np.asarray(Y).astype(bool).any(1)
        self._pos = idxs[actives]
        self._neg = idxs[~actives]

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            self.rg.shuffle(self._pos)
            self.rg.shuffle(self._neg)
        return chain(*zip(self._pos.tolist(), self._neg.tolist()))

    def __len__(self) -> int:
        return 2 * min(len(self._pos), len(self._neg))
