"""Dataset: table rows -> featurized samples -> collated host batches.

Port of ``notorch_tpu.data.dataset``: per-sample database lookups
(:class:`DatabaseManager`), then transform chains, target attachment, and
a collate that produces ``inputs.*`` / ``targets.*`` keys in the flat,
per-molecule ``dense`` or bin-packed ``dense_packed`` layout; batches stay
numpy arrays on the host until the caller moves them to a device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np

from notorch_tpu_torch.conf import INPUT_KEY_PREFIX, TARGET_KEY_PREFIX
from notorch_tpu_torch.data.dense import pack_graphs_dense, pad_graphs_dense
from notorch_tpu_torch.data.graph import Graph, pad_graphs
from notorch_tpu_torch.tasks import transforms as task_transforms


@dataclass
class TransformManager:
    """Adapt a Transform to dict-record plumbing. Keys default from the
    transform's ``_in_key_``/``_out_key_`` classvars."""

    transform: Any
    in_key: str | None = None
    out_key: str | None = None

    def __post_init__(self):
        self.in_key = self.in_key or getattr(self.transform, "_in_key_", "input")
        self.out_key = self.out_key or getattr(self.transform, "_out_key_", "output")

    def update(self, sample: dict) -> dict:
        sample[self.out_key] = self.transform(sample[self.in_key])
        return sample

    def collate(self, values: list, **kwargs):
        return self.transform.collate(values, **kwargs)


@dataclass
class DatabaseManager:
    """Adapt a Database: fetch ``db[sample[in_key]]`` into ``out_key``."""

    db: Any
    in_key: str = "index"
    out_key: str = "X"

    def update(self, sample: dict) -> dict:
        sample[self.out_key] = self.db[sample[self.in_key]]
        return sample

    def collate(self, values: list, **kwargs):
        return self.db.collate(values)


@dataclass
class TargetSpec:
    """Columns + task type for one target group."""

    columns: Sequence[str]
    task: str = "regression"
    weight: float = 1.0


def _missing(v) -> bool:
    # csv readers give "" for an empty cell; DataFrames give NaN
    return v is None or v != v or (isinstance(v, str) and not v.strip())


class MolecularDataset:
    """A dataset over a table: a mapping of equal-length columns, or any
    object with ``to_dict("records")`` (a DataFrame).

    ``transforms``: featurization chains (``TransformManager`` or bare
    transforms), applied in order. ``databases``: keyed feature stores
    (``DatabaseManager``), looked up for each sample before its transforms
    run. ``targets``: named target groups read from the table's columns.
    """

    def __init__(
        self,
        df,
        transforms: Mapping[str, Any],
        databases: Mapping[str, DatabaseManager] | None = None,
        targets: Mapping[str, TargetSpec] | None = None,
    ):
        if hasattr(df, "to_dict"):
            self.records = df.to_dict("records")
        else:
            keys = list(df)
            n = len(df[keys[0]])
            self.records = [{k: df[k][i] for k in keys} for i in range(n)]
        self.transforms = {
            name: t if isinstance(t, TransformManager) else TransformManager(t)
            for name, t in transforms.items()
        }
        self.databases = dict(databases or {})
        self.targets = dict(targets or {})
        self._target_arrays = {
            name: self._extract_targets(spec) for name, spec in self.targets.items()
        }

    def _extract_targets(self, spec: TargetSpec) -> np.ndarray:
        cols = list(spec.columns)
        if self.records:
            missing = [c for c in cols if c not in self.records[0]]
            if missing:
                raise KeyError(
                    f"target column(s) {missing} not in the table; available: "
                    f"{sorted(self.records[0])}"
                )
        out = np.full((len(self.records), len(cols)), np.nan, dtype=np.float32)
        for i, rec in enumerate(self.records):
            for j, c in enumerate(cols):
                v = rec.get(c)
                if not _missing(v):
                    out[i, j] = float(v)
        return out

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> dict:
        sample = dict(self.records[idx])
        sample["index"] = idx
        for mgr in self.databases.values():
            mgr.update(sample)
        for mgr in self.transforms.values():
            mgr.update(sample)
        return sample

    def collate(
        self,
        samples: list[dict],
        indices: list[int],
        graph_caps: tuple | None = None,
        batch_cap: int | None = None,
        layout: str = "dense_packed",
    ) -> dict:
        """Build the batch dict with ``inputs.*`` / ``targets.*`` keys.

        ``layout="flat"``: one padded disjoint-union graph, ``graph_caps`` =
        ``(node_cap, edge_cap)``, ``batch_cap`` graph slots.
        ``layout="dense_packed"``: bin-packed dense blocks, ``graph_caps`` =
        ``(nodes_per_bin, edges_per_bin, bin_cap)``. ``layout="dense"``:
        one block per molecule, ``graph_caps`` = ``(nodes_per_graph,
        edges_per_graph)``, ``batch_cap`` blocks. Exact caps from the batch
        when None. Graph arrays and targets stay numpy.
        """
        if layout not in ("flat", "dense", "dense_packed"):
            raise ValueError(f"unknown layout {layout!r}: expected 'flat', 'dense' or 'dense_packed'")
        batch: dict[str, Any] = {}
        b_cap = batch_cap if batch_cap is not None else len(samples)

        for mgr in {**self.databases, **self.transforms}.values():
            values = [s[mgr.out_key] for s in samples]
            if not (values and isinstance(values[0], Graph)):
                # the manager's own collate (a fingerprint's or a feature
                # database's [B, width] array, padded to the batch's slots; a
                # list of molecules; padded point clouds)
                collated = mgr.collate(values)
                if isinstance(collated, np.ndarray):
                    collated = _pad_rows(collated, b_cap, fill=0.0)
                batch[f"{INPUT_KEY_PREFIX}.{mgr.out_key}"] = collated
                continue
            if layout == "flat":
                if graph_caps is not None:
                    v_cap, e_cap = graph_caps
                else:
                    v_cap = sum(g.num_nodes for g in values) + 1
                    e_cap = max(sum(g.num_edges for g in values), 1)
                collated = pad_graphs(values, v_cap, e_cap, graph_cap=b_cap, np_out=True)
            else:
                if graph_caps is not None:
                    v_b, e_b, *bin_cap = graph_caps
                else:
                    e_b = max(max((g.num_edges for g in values), default=2), 2)
                    e_b += e_b % 2
                    v_b = max(g.num_nodes for g in values) + 1
                    bin_cap = []
                if layout == "dense":
                    collated = pad_graphs_dense(values, v_b, e_b, graph_cap=b_cap, np_out=True)
                else:
                    collated = pack_graphs_dense(
                        values, v_b, e_b, mol_cap=b_cap, bin_cap=bin_cap[0] if bin_cap else None,
                        np_out=True,
                    )
            batch[f"{INPUT_KEY_PREFIX}.{mgr.out_key}"] = collated

        for name, arr in self._target_arrays.items():
            rows = arr[np.asarray(indices)]
            rows = _pad_rows(rows, b_cap, fill=np.nan)
            mask = ~np.isnan(rows)
            batch[f"{TARGET_KEY_PREFIX}.{name}"] = np.nan_to_num(rows, nan=0.0)
            batch[f"{TARGET_KEY_PREFIX}.{name}_mask"] = mask
        return batch

    def build_task_transform_configs(self) -> dict[str, dict]:
        """Per-target normalization transforms from *this* dataset's target
        statistics, in the same layout as ``notorch_tpu``'s."""
        out = {}
        for name, spec in self.targets.items():
            cfg = task_transforms.build(spec.task, self._target_arrays[name])
            out[name] = {
                "preds": {"module": cfg["preds"], "key": None},
                "targets": {"module": cfg["targets"], "key": f"{TARGET_KEY_PREFIX}.{name}"},
            }
        return out


def _pad_rows(arr, cap: int, fill: float = 0.0):
    arr = np.asarray(arr)
    if len(arr) >= cap:
        return arr
    pad = np.zeros((cap - len(arr),) + arr.shape[1:], dtype=arr.dtype)
    if fill != 0.0 and arr.dtype.kind == "f":
        pad[:] = fill
    return np.concatenate([arr, pad], axis=0)
