"""Static-shape batch loader over the flat and dense layouts.

Port of ``notorch_tpu.data.batching``: featurizes on the host (with an
in-memory cache — featurization is pure), groups samples into fixed-size
batches (the last batch is padded and masked) and collates each batch into
the flat padded layout (``flat``, batch totals rounded up geometric
ladders, optionally with the tile-packed CSR metadata), the bin-packed
dense layout (``dense_packed``, ladder-rounded bin caps) or the
per-molecule dense layout (``dense``, node and edge counts rounded up
per-molecule ladders), exactly as the JAX loader does, so both packages
see the same arrays, in the same order when shuffled (``SeededSampler``)
and when sorted by size. Batches are numpy; the caller moves them to a
device. ``random_split`` and ``Subset`` split a dataset as the JAX package
does. ``PrefetchLoader`` is not ported.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from notorch_tpu_torch.conf import TARGET_KEY_PREFIX
from notorch_tpu_torch.data.dataset import MolecularDataset
from notorch_tpu_torch.data.dense import plan_bins
from notorch_tpu_torch.data.graph import BatchedGraph, Graph, with_csr_packing
from notorch_tpu_torch.data.samplers import SeededSampler, SequentialSampler
from notorch_tpu_torch.tasks import transforms as task_transforms


def bucket_ladder(quantum: int, max_value: int) -> list[int]:
    """Geometric ladder q, 1.5q, 2q, 3q, 4q, 6q, 8q, ... — step ratio <=1.5,
    so padding waste is <=50% and the number of shapes is O(log max)."""
    out = []
    base = quantum
    while base < max_value:
        out.append(base)
        out.append(base * 3 // 2)
        base *= 2
    out.append(base)
    return out


def round_up_ladder(value: int, ladder: list[int]) -> int:
    for b in ladder:
        if b >= value:
            return b
    return value  # beyond the ladder: exact


LAYOUTS = ("flat", "dense", "dense_packed")


class DataLoader:
    """Iterate batch dicts over a :class:`MolecularDataset`.

    ``layout="flat"`` pads each batch into one disjoint-union graph: the
    batch's node total plus the padding sink rounded up
    ``bucket_ladder(node_quantum, 1 << 22)``, its edge total rounded up
    ``bucket_ladder(edge_quantum, 1 << 23)``; ``csr_pack`` attaches the
    tile-packed CSR metadata (``with_csr_packing``) that ``impl="csr"``
    reduces through. A node cap on the ladder's 192 rung is not a multiple
    of 128 and raises there, as in the JAX package.

    ``layout="dense_packed"`` bin-packs each batch with the JAX loader's bin
    caps: ``E_b`` is ``bin_edges`` raised up the edge ladder to the batch's
    largest molecule, ``V_b`` is ``bin_nodes`` (default ``E_b // 2 + 8``) or
    the largest molecule plus its padding sink, whichever is larger, rounded
    up to a multiple of 8, and the bin count is rounded up its own ladder
    (the attention models' loaders pin ``bin_edges=256, bin_nodes=128``).
    ``layout="dense"`` pads each molecule into its own block: the batch's
    largest node count plus the padding sink rounded up ``bucket_ladder(16,
    1 << 16)``, its largest edge count rounded up ``bucket_ladder(32, 1 <<
    17)``.

    ``shuffle=True`` draws the order from a ``SeededSampler(len, seed)``;
    after :meth:`set_epoch` each epoch's order is a pure function of
    ``(seed, epoch)``, index for index the JAX loader's. ``sort_by_size``
    sorts the sampler's order stably by edge count, cuts it into batches
    and shuffles the batches with ``np.random.default_rng(seed)`` (drawn on
    from one epoch to the next, or ``default_rng((seed, epoch))`` after
    :meth:`set_epoch`), so each batch holds molecules of like size.
    """

    def __init__(
        self,
        dataset: MolecularDataset,
        batch_size: int = 64,
        sampler=None,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        layout: str = "dense_packed",
        sort_by_size: bool = False,
        node_quantum: int = 128,
        edge_quantum: int = 256,
        csr_pack: bool = False,
        bin_edges: int = 128,
        bin_nodes: int | None = None,
    ):
        if layout not in LAYOUTS:
            raise ValueError(
                f"unknown DataLoader layout {layout!r}: expected one of {list(LAYOUTS)}; the "
                "loader layout must match the model's resolved layout"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = SeededSampler(len(dataset), seed)
        else:
            self.sampler = SequentialSampler(len(dataset))
        self.drop_last = drop_last
        self.layout = layout
        self.csr_pack = csr_pack
        self.bin_edges, self.bin_nodes = bin_edges, bin_nodes
        self.bin_ladder = bucket_ladder(8, 1 << 12)
        if layout == "flat":  # batch totals
            self.node_ladder = bucket_ladder(node_quantum, 1 << 22)
            self.edge_ladder = bucket_ladder(edge_quantum, 1 << 23)
        else:  # per-molecule node and edge slots
            self.node_ladder = bucket_ladder(16, 1 << 16)
            self.edge_ladder = bucket_ladder(32, 1 << 17)
        self.sort_by_size = sort_by_size
        self.seed = seed
        self._rg = np.random.default_rng(seed)
        self._cache: dict[int, dict] = {}

    def set_epoch(self, epoch: int) -> None:
        """Make this epoch's batch order a pure function of (seed, epoch),
        where the sampler supports it; ``fit`` calls this each epoch so that
        a resumed run can re-derive the interrupted epoch's order. It keys the
        ``sort_by_size`` batch shuffle too."""
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)
        self._rg = np.random.default_rng((self.seed, int(epoch)))

    def _fetch(self, idx: int) -> dict:
        sample = self._cache.get(idx)
        if sample is None:
            sample = self._cache[idx] = self.dataset[idx]
        return sample

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _graph_size(self, idx: int) -> int:
        sample = self._fetch(idx)
        for mgr in self.dataset.transforms.values():
            if isinstance(sample[mgr.out_key], Graph):
                return sample[mgr.out_key].num_edges
        return 0

    def __iter__(self) -> Iterator[dict]:
        indices = list(iter(self.sampler))
        if self.sort_by_size:
            indices.sort(key=self._graph_size)
        chunks = [indices[s : s + self.batch_size] for s in range(0, len(indices), self.batch_size)]
        if self.sort_by_size:
            self._rg.shuffle(chunks)
        for chunk in chunks:
            if self.drop_last and len(chunk) < self.batch_size:
                continue
            yield self._collate([self._fetch(i) for i in chunk], chunk)

    def _collate(self, samples: list[dict], indices: list[int]) -> dict:
        graphs = [
            s[mgr.out_key]
            for mgr in self.dataset.transforms.values()
            for s in samples
            if isinstance(s[mgr.out_key], Graph)
        ]
        caps = None
        if graphs and self.layout == "flat":
            caps = (
                round_up_ladder(sum(g.num_nodes for g in graphs) + 1, self.node_ladder),
                round_up_ladder(max(sum(g.num_edges for g in graphs), 1), self.edge_ladder),
            )
        elif graphs and self.layout == "dense":
            max_e = max(max(g.num_edges for g in graphs), 2)
            caps = (
                round_up_ladder(max(g.num_nodes for g in graphs) + 1, self.node_ladder),
                round_up_ladder(max_e + max_e % 2, self.edge_ladder),
            )
        elif graphs:
            max_v = max(g.num_nodes for g in graphs) + 1
            max_e = max(max(g.num_edges for g in graphs), 2)
            max_e += max_e % 2
            e_b = max(self.bin_edges, round_up_ladder(max_e, self.edge_ladder))
            v_b = -(-max(max_v, e_b // 2 + 8 if self.bin_nodes is None else self.bin_nodes) // 8) * 8
            n_bins = len(plan_bins(graphs, v_b, e_b))
            caps = (v_b, e_b, round_up_ladder(n_bins, self.bin_ladder))
        batch = self.dataset.collate(
            samples, indices, graph_caps=caps, batch_cap=self.batch_size, layout=self.layout
        )
        if self.csr_pack:
            batch = {k: with_csr_packing(v) if isinstance(v, BatchedGraph) else v for k, v in batch.items()}
        return batch


def random_split(n: int, fractions: tuple[float, ...], seed: int = 0) -> tuple[np.ndarray, ...]:
    """Random index split, the JAX package's: one permutation from
    ``default_rng(seed)``, cut at ``int(f * n)`` for each fraction but the
    last, which takes the rest."""
    perm = np.random.default_rng(seed).permutation(n)
    sizes = [int(f * n) for f in fractions[:-1]]
    sizes.append(n - sum(sizes))
    out, at = [], 0
    for size in sizes:
        out.append(perm[at : at + size])
        at += size
    return tuple(out)


class Subset:
    """View of a dataset at fixed indices: inputs come from the parent's
    featurization, targets (and their statistics) from the subset's rows."""

    def __init__(self, dataset: MolecularDataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.transforms = dataset.transforms
        self.targets = dataset.targets
        self._target_arrays = {name: arr[self.indices] for name, arr in dataset._target_arrays.items()}

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int) -> dict:
        return self.dataset[int(self.indices[idx])]

    def collate(self, samples, indices, graph_caps=None, batch_cap=None, layout="dense_packed"):
        # indices here are positions within the subset
        return self.dataset.collate(
            samples, [int(self.indices[i]) for i in indices], graph_caps, batch_cap, layout
        )

    def build_task_transform_configs(self) -> dict:
        out = {}
        for name, spec in self.targets.items():
            cfg = task_transforms.build(spec.task, self._target_arrays[name])
            out[name] = {
                "preds": {"module": cfg["preds"], "key": None},
                "targets": {"module": cfg["targets"], "key": f"{TARGET_KEY_PREFIX}.{name}"},
            }
        return out
