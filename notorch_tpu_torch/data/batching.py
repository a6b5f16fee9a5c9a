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
device (:func:`to_device`, or a :class:`PrefetchLoader` on a thread of its
own, which also groups same-shape batches for ``Model.train_steps``).
``random_split`` and ``Subset`` split a dataset as the JAX package does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
from typing import Any, Iterator, Mapping

import numpy as np
import torch

from notorch_tpu_torch.conf import TARGET_KEY_PREFIX
from notorch_tpu_torch.data.dataset import MolecularDataset
from notorch_tpu_torch.data.dense import DenseBatchedGraph, plan_bins
from notorch_tpu_torch.data.graph import BatchedGraph, Graph, with_csr_packing
from notorch_tpu_torch.data.halo import HaloShard
from notorch_tpu_torch.data.point_cloud import BatchedPointCloud
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


# -- moving batches to a device, grouping and prefetching ---------------------

BATCH_TYPES = (BatchedGraph, DenseBatchedGraph, BatchedPointCloud, HaloShard)
SLOT_ALIGN = 256  # bytes: every array of a staged batch starts on this boundary


def to_device(batch: Mapping[str, Any], device) -> dict:
    """A host batch (numpy arrays, tensors, flat or dense graphs, point
    clouds) on ``device``."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, BATCH_TYPES):
            v = v.to(device)
        elif isinstance(v, np.ndarray):
            v = torch.from_numpy(v).to(device)
        elif isinstance(v, torch.Tensor):
            v = v.to(device)
        out[k] = v
    return out


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _array_fields(v) -> list[str]:
    """The array fields of a batch dataclass that hold an array."""
    return [f for f in v._ARRAYS if getattr(v, f) is not None]


def _leaf_signature(x):
    if x is None:
        return None
    if isinstance(x, np.ndarray):
        return tuple(x.shape), x.dtype.name
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype).removeprefix("torch.")
    return "opaque", type(x).__name__


def shape_signature(batch: Mapping[str, Any]) -> tuple:
    """Hashable (keys, classes, static fields, array shapes and dtypes):
    batches with equal signatures can be stacked into one group."""
    sig = []
    for key, v in batch.items():
        if isinstance(v, BATCH_TYPES):
            static = tuple((f.name, getattr(v, f.name)) for f in dataclasses.fields(v) if f.name not in v._ARRAYS)
            arrays = tuple((f, _leaf_signature(getattr(v, f))) for f in v._ARRAYS)
            sig.append((key, type(v).__name__, static, arrays))
        else:
            sig.append((key, _leaf_signature(v)))
    return tuple(sig)


class StackedBatch:
    """K same-shape batches stacked along a new leading axis, for
    ``Model.train_steps``; made by ``PrefetchLoader(stack=K)``. ``tree`` is
    a batch whose every array has the leading axis K (other values become
    lists of K); :func:`unstack_tree` takes step ``i``'s batch from it."""

    __slots__ = ("tree", "n")

    def __init__(self, tree, n: int):
        self.tree = tree
        self.n = n


def group_batches(items, k: int):
    """Group K consecutive same-signature batches, as the JAX loop and
    prefetcher group them: yields lists of batches, a full group of ``k``,
    or a shorter one where a batch of another signature or the end cut it
    off (a list of one each when ``k <= 1``); a :class:`StackedBatch` among
    ``items`` ends the pending group and passes through as it is."""
    pending: list = []
    pending_sig = None
    for item in items:
        stacked = isinstance(item, StackedBatch)
        sig = None if stacked or k <= 1 else shape_signature(item)
        if pending and (sig is None or sig != pending_sig):
            yield pending
            pending = []
        if sig is None:
            yield item if stacked else [item]
            continue
        pending.append(item)
        pending_sig = sig
        if len(pending) == k:
            yield pending
            pending = []
    if pending:
        yield pending


def _map_batch(batch: Mapping[str, Any], fn) -> dict:
    """``fn(key, field, value)`` on every value of ``batch`` (``field`` None
    for a top-level value), rebuilding the batch dataclasses."""
    out = {}
    for key, v in batch.items():
        if isinstance(v, BATCH_TYPES):
            out[key] = v.update(**{f: fn(key, f, getattr(v, f)) for f in _array_fields(v)})
        else:
            out[key] = fn(key, None, v)
    return out


def _get(batch, key: str, field: str | None):
    return batch[key] if field is None else getattr(batch[key], field)


def _arrays(batch: Mapping[str, Any]) -> list[tuple[str, str | None, Any]]:
    """``(key, field, array)`` of every array of a batch, in order (``field``
    None for a top-level array)."""
    out = []
    for key, v in batch.items():
        for field in (_array_fields(v) if isinstance(v, BATCH_TYPES) else [None]):
            x = _get(batch, key, field)
            if _is_array(x):
                out.append((key, field, x))
    return out


def stack_trees(batches: list[Mapping[str, Any]]) -> dict:
    """Stack a list of same-signature batches along a new leading axis on
    the host (``np.stack``; ``torch.stack`` for tensors)."""

    def stack(key, field, first):
        xs = [_get(b, key, field) for b in batches]
        if isinstance(first, np.ndarray):
            return np.stack(xs)
        if isinstance(first, torch.Tensor):
            return torch.stack(xs)
        return xs

    return _map_batch(batches[0], stack)


def unstack_tree(tree: Mapping[str, Any], i: int) -> dict:
    """Step ``i``'s batch of a stacked tree: each array's ``[i]``, a view."""
    return _map_batch(tree, lambda key, field, x: x[i])


def stack_size(tree: Mapping[str, Any]) -> int:
    """The leading (steps) axis of a stacked tree."""
    arrays = _arrays(tree)
    if not arrays:
        raise ValueError("a stacked batch needs at least one array")
    return int(arrays[0][2].shape[0])


def _contiguous_strides(shape: tuple) -> tuple:
    strides, n = [], 1
    for size in reversed(shape):
        strides.append(n)
        n *= size
    return tuple(reversed(strides))


def _tensor(x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x if x.flags.c_contiguous else x.copy(order="C"))
    return x


def stage(batches: list[Mapping[str, Any]], device, stream=None, stacked: bool = True):
    """``batches`` (same signature) on ``device`` as one stacked batch
    (``stacked=False``: the one batch of ``batches`` as it is). Returns
    ``(tree, buffer)``.

    On the card every array of every batch goes into one buffer, each at a
    ``SLOT_ALIGN``-byte boundary and each batch in a slot of the same size:
    host arrays are packed into one pinned host buffer and copied in one
    ``non_blocking`` transfer, arrays already on the card are copied into
    place there, both on ``stream`` (the current one when None). ``tree``'s
    arrays are strided views of the device ``buffer``: step ``i``'s ``[i]``
    is contiguous and starts aligned, so the kernels take it as it is. A
    pinned allocation that fails raises: there is no fallback to a pageable
    copy. Elsewhere :func:`stack_trees` and :func:`to_device`, ``buffer``
    None."""
    device = torch.device(device)
    if device.type != "cuda":
        return to_device(stack_trees(batches) if stacked else batches[0], device), None
    keys = [(key, field) for key, field, _ in _arrays(batches[0])]
    arrays = [[_tensor(_get(b, key, field)) for b in batches] for key, field in keys]
    offsets, slot = [], 0
    for x in (xs[0] for xs in arrays):
        offsets.append(slot)
        slot += -(-x.numel() * x.element_size() // SLOT_ALIGN) * SLOT_ALIGN
    slot, k = max(slot, SLOT_ALIGN), len(batches)
    from_card = bool(arrays) and arrays[0][0].is_cuda

    def views(raw: torch.Tensor) -> list[torch.Tensor]:
        out = []
        for xs, off in zip(arrays, offsets):
            shape, size = tuple(xs[0].shape), xs[0].element_size()
            out.append(torch.as_strided(raw.view(xs[0].dtype), (k, *shape),
                                        (slot // size, *_contiguous_strides(shape)), off // size))
        return out

    if from_card and stream is not None:  # the arrays' own work first
        stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        buffer = torch.empty(k * slot, dtype=torch.uint8, device=device)
        packed = buffer if from_card else torch.empty(k * slot, dtype=torch.uint8, pin_memory=True)
        for xs, view in zip(arrays, views(packed)):
            for i, x in enumerate(xs):
                view[i].copy_(x)
        if not from_card:
            buffer.copy_(packed, non_blocking=True)
    placed = dict(zip(keys, views(buffer)))

    def place(key, field, x):
        if (key, field) in placed:
            return placed[key, field] if stacked else placed[key, field][0]
        return [_get(b, key, field) for b in batches] if stacked else x

    return _map_batch(batches[0], place), buffer


def stacked_on(tree: Mapping[str, Any], device) -> dict:
    """A stacked tree on ``device``: as it is where its arrays are there
    already (a ``PrefetchLoader`` group), else restaged from its steps'
    batches (:func:`stage`), so that every step's arrays start aligned."""
    device = torch.device(device)
    first = _arrays(tree)[0][2]
    if isinstance(first, torch.Tensor) and first.device.type == device.type:
        return tree
    return stage([unstack_tree(tree, i) for i in range(stack_size(tree))], device)[0]


class PrefetchLoader:
    """Overlap the host input pipeline with the card's work.

    Port of the JAX ``PrefetchLoader``: wraps any re-iterable batch loader
    and, each epoch, a producer thread fills a queue of ``buffer_size``
    items, so featurizing, collating and copying batch ``i + 1 ..
    i + buffer_size`` runs while the card trains on batch ``i``. An
    exception in the producer is raised in the consumer; other attributes
    (``dataset``, ``batch_size``, ``set_epoch``) are the loader's.

    ``to_device=True`` (default) also moves each item to ``device`` (None:
    the card) on the producer thread. On the card each batch, or each
    stacked group as ONE transfer, is packed into pinned host memory and
    copied ``non_blocking`` on a side stream; the consumer's stream waits
    on an event recorded after the copy, and the device buffer is marked
    with ``record_stream`` so that the caching allocator does not hand it
    out again before the consumer's work on it is done. On the CPU the
    arrays become tensors.

    ``stack=K`` (> 1) groups K consecutive same-signature batches into a
    :class:`StackedBatch` for ``Model.train_steps``: a batch whose
    signature breaks a group, or that is left over at the end, comes
    through alone, as in the JAX loader. With ``to_device=False`` groups
    are stacked on the host.

    Closing the iterator early (a ``break``, early stopping, an exception)
    stops the producer: it never blocks on a full queue.
    """

    def __init__(self, loader, buffer_size: int = 4, to_device: bool = True, stack: int = 0, device=None):
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
        self.loader = loader
        self.buffer_size = buffer_size
        self.to_device = to_device
        self.stack = int(stack)
        self.device = device

    def __len__(self) -> int:
        return len(self.loader)

    def __getattr__(self, name):
        # delegate loader attributes (dataset, batch_size, set_epoch, ...)
        if name == "loader":
            raise AttributeError(name)
        return getattr(self.loader, name)

    def __iter__(self):
        from notorch_tpu_torch.utils import resolve_device

        device = resolve_device(self.device) if self.to_device else None
        on_card = device is not None and device.type == "cuda"
        q: queue.Queue = queue.Queue(maxsize=self.buffer_size)
        stop = threading.Event()
        done = object()
        errors: list[BaseException] = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            it = iter(self.loader)
            try:
                with torch.cuda.device(device) if on_card else contextlib.nullcontext():
                    side = torch.cuda.Stream(device) if on_card else None

                    def ship(group: list, stacked: bool) -> bool:
                        event = buffer = None
                        if device is None:
                            tree = stack_trees(group) if stacked else group[0]
                        else:
                            tree, buffer = stage(group, device, side, stacked)
                            if on_card:
                                event = torch.cuda.Event()
                                event.record(side)
                        return put((tree, event, buffer, len(group) if stacked else 0))

                    for group in group_batches(it, self.stack):
                        # a group cut short comes through batch by batch
                        if len(group) == self.stack > 1:
                            shipped = ship(group, True)
                        else:
                            shipped = all(ship([b], False) for b in group)
                        if not shipped:
                            return
            except BaseException as e:  # noqa: BLE001 -- raised again in the consumer
                errors.append(e)
            finally:
                close = getattr(it, "close", None)
                if callable(close):
                    close()
                put(done)

        thread = threading.Thread(target=produce, daemon=True, name="prefetch")
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    thread.join()
                    if errors:
                        raise errors[0]
                    return
                tree, event, buffer, n = item
                if event is not None:
                    consumer = torch.cuda.current_stream(device)
                    consumer.wait_event(event)
                    buffer.record_stream(consumer)
                yield StackedBatch(tree, n) if n else tree
        finally:
            stop.set()
            thread.join()
