"""``python -m notorch_tpu_torch train``: config-driven training.

Port of ``notorch_tpu.cli.train`` for supervised ``model.kind: dmpnn``,
``gat``, ``graph_transformer`` and ``multicomponent`` configs, declarative
``model.modules`` configs (modules, losses and metrics built by name
through :mod:`notorch_tpu_torch.cli.registry`) and masked-atom pretraining
(``model.kind: pretrain``, :func:`run_pretrain`), for every task type of
``data.targets.*.task``: the same YAML/JSON configs with dotted-key
overrides, the default SMILES pipeline or a ``data.transforms.<name>.
transform`` built through the registry (``RxnToGraph``, ``MolToFP``, ...),
a random or scaffold ``data.split``, target transforms from training-split
statistics, AUROC and AUPRC on the host for every classification target,
the data layout from ``model.layout`` (``dense_packed``, with the attention
kinds' bins of 256 edge lanes and 128 node slots; the per-molecule
``dense`` for ``dense*`` layouts, whose train loader sorts by size;
``flat`` otherwise, the default of a declarative or multicomponent config,
with the tile-packed CSR metadata when the model reduces through ``impl:
csr``), Adam/AdamW/SGD with a rate or the Noam, cosine or warmup-cosine
schedule and ``clip_norm``, and the trainer's ``epochs``, ``batch_size``,
``seed``, ``prefetch`` (the input pipeline on a thread, 4 batches ahead by
default, 0 for none), ``steps_per_dispatch``, ``checkpoint_dir``,
``resume``, ``checkpoint_every``, ``max_to_keep``, ``best_by``/
``best_mode``, ``early_stopping`` and ``predictions_csv``. The checkpoint
directory it writes is what ``python -m notorch_tpu_torch predict`` serves.
The default SMILES transform is the C++ featurizer where a compiler exists.
Tables are CSV (the standard ``csv`` module) or parquet (``pyarrow``,
imported only for a parquet table), named by ``data.csv``/``data.parquet``
or inline by the ``${csv:...}``, ``${parquet:...}`` and ``${len:...}``
resolvers; ``yaml`` is imported only to read YAML.

``trainer.spmd: {data: D, graph: G}`` trains over a D x G mesh of
processes, as the JAX package does: masked-atom pretraining with the
``molecule`` or ``replicate`` partition (:func:`run_pretrain_spmd`), and a
supervised ``model.partition: halo`` config (:func:`run_halo_spmd`,
``configs/dmpnn_halo.yaml``); any other supervised ``spmd`` raises JAX's
``ValueError``, and a mesh that does not match the world's processes
raises ``make_mesh``'s. Under ``torchrun`` (``python -m torch.distributed.run
--nproc-per-node N -m notorch_tpu_torch train CONFIG ...``) the command
starts the process group itself (gloo with ``--cpu``, NCCL on the cards);
rank 0 alone prints. A single process is a world of one.

Usage::

    python -m notorch_tpu_torch train CONFIG.yaml [a.b=value ...] [--cpu]
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from notorch_tpu_torch.data.dataset import MolecularDataset, TargetSpec, TransformManager
from notorch_tpu_torch.training.optim import OptimizerSpec
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol
from notorch_tpu_torch.utils import resolve_device


def load_config(path: str | Path) -> dict:
    text = Path(path).read_text()
    if str(path).endswith((".yaml", ".yml")):
        import yaml

        return yaml.safe_load(text)
    return json.loads(text)


def apply_overrides(cfg: dict, overrides: list[str]) -> dict:
    """``a.b.c=value`` dotted-path overrides (values parsed as YAML)."""
    import yaml

    for ov in overrides:
        key, _, raw = ov.partition("=")
        value = yaml.safe_load(raw)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return cfg


class Table:
    """A data table's columns by name, each a list of cells: strings from a
    CSV file, Python values from a parquet file. A mapping of columns, as
    :class:`~notorch_tpu_torch.data.dataset.MolecularDataset` reads it,
    whose ``len`` is its row count (so ``${len:data.csv}`` counts rows, as
    a DataFrame's does in the JAX package)."""

    def __init__(self, columns: dict[str, list]):
        self.columns = columns

    def __getitem__(self, name: str) -> list:
        return self.columns[name]

    def __iter__(self):
        return iter(self.columns)

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()), []))


def read_table(path: str | Path) -> Table:
    """A CSV file as a :class:`Table` of cell strings."""
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None:
            raise ValueError(f"{path} has no header row")
        columns: dict[str, list[str]] = {name: [] for name in reader.fieldnames}
        for row in reader:
            for name in reader.fieldnames:
                columns[name].append(row[name])
    return Table(columns)


def read_parquet(path: str | Path) -> Table:
    """A parquet file as a :class:`Table`, read with ``pyarrow`` (imported
    here, only when a parquet table is asked for)."""
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError(f"reading the parquet table {path} needs pyarrow, which is not installed") from e
    return Table(pq.read_table(str(path)).to_pydict())


def data_table(cfg: dict) -> Table:
    """The table of a ``data`` config, as the JAX ``_read_table`` finds it:
    a table already loaded by a ``${csv:...}``/``${parquet:...}`` resolver,
    a ``parquet`` key, or a ``csv`` key (a path ending in ``.parquet`` or
    ``.pq`` is read as parquet)."""
    src = cfg.get("parquet") or cfg.get("csv")
    if src is None:
        raise KeyError("data config needs a 'csv' or 'parquet' entry")
    if isinstance(src, Table):
        return src
    path = str(src)
    if "parquet" in cfg or path.endswith((".parquet", ".pq")):
        return read_parquet(path)
    return read_table(path)


def resolve_config(cfg):
    """Resolve inline ``${csv:path}``, ``${parquet:path}`` and
    ``${len:dotted.path}`` string values anywhere in the config tree, as the
    JAX ``resolve_config`` does: the tables first, then the lengths, so
    ``${len:data.csv}`` is the row count of an inline-loaded table."""

    def walk(node, fn):
        if isinstance(node, dict):
            return {k: walk(v, fn) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, fn) for v in node]
        return fn(node)

    def load_tables(v):
        if isinstance(v, str) and v.endswith("}"):
            if v.startswith("${csv:"):
                return read_table(v[len("${csv:"):-1])
            if v.startswith("${parquet:"):
                return read_parquet(v[len("${parquet:"):-1])
        return v

    cfg = walk(cfg, load_tables)

    def deref(path: str):
        node = cfg
        for part in path.split("."):
            node = node[part]
        return node

    def resolve_len(v):
        if isinstance(v, str) and v.startswith("${len:") and v.endswith("}"):
            return len(deref(v[len("${len:"):-1]))
        return v

    return walk(cfg, resolve_len)


def smiles_pipeline():
    """The default SMILES -> Graph transform: the C++ featurizer
    (:class:`~notorch_tpu_torch.native.NativeSmiToGraph`) where a compiler
    exists, else ``Pipeline(SmiToMol(), MolToGraph())``; both give the
    same graphs, as in the JAX package."""
    from notorch_tpu_torch import native

    if native.available():
        return native.NativeSmiToGraph()
    return Pipeline(SmiToMol(), MolToGraph())


def build_dataset(cfg: dict) -> MolecularDataset:
    """The dataset of a ``data`` config: its table (:func:`data_table`),
    per ``transforms`` entry its ``transform`` built through the registry or
    else the default SMILES -> Graph transform (:func:`smiles_pipeline`; one
    on ``smiles_col`` without entries), and the ``targets`` groups."""
    from notorch_tpu_torch.cli.registry import build

    table = data_table(cfg)
    transforms = {}
    for name, tcfg in (cfg.get("transforms") or _default_transforms(cfg)).items():
        transform = build(tcfg["transform"]) if "transform" in tcfg else smiles_pipeline()
        transforms[name] = TransformManager(transform, in_key=tcfg.get("in_key"), out_key=tcfg.get("out_key"))
    targets = {
        name: TargetSpec(
            columns=tc["columns"], task=tc.get("task", "regression"), weight=tc.get("weight", 1.0)
        )
        for name, tc in (cfg.get("targets") or {}).items()
    }
    return MolecularDataset(table, transforms=transforms, targets=targets)


def _default_transforms(cfg: dict) -> dict:
    return {"graph": {"in_key": cfg.get("smiles_col", "smiles"), "out_key": "G"}}


def build_optimizer(cfg: dict | None) -> OptimizerSpec:
    """The optimizer of an ``optimizer`` config: ``name`` (adam, adamw or
    sgd, resolved through the registry), ``lr`` or a ``schedule`` (``noam``,
    else ``cosine``, else ``warmup_cosine``, in the JAX package's order of
    precedence, each with the JAX schedule's arguments), and
    ``clip_norm``."""
    from notorch_tpu_torch.cli.registry import resolve
    from notorch_tpu_torch.training import schedulers

    cfg = cfg or {"name": "adam", "lr": 1e-4}
    lr = cfg.get("lr", 1e-4)
    schedule = cfg.get("schedule")
    if isinstance(schedule, dict):
        if "noam" in schedule:
            lr = schedulers.noam_like_schedule(**schedule["noam"])
        elif "cosine" in schedule:
            lr = schedulers.cosine_decay_schedule(**schedule["cosine"])
        elif "warmup_cosine" in schedule:
            lr = schedulers.warmup_cosine_decay_schedule(**schedule["warmup_cosine"])
    spec = resolve(cfg.get("name", "adam"))(lr)
    clip = cfg.get("clip_norm")
    return dataclasses.replace(spec, clip_norm=float(clip)) if clip else spec


def build_model(cfg: dict, transforms: dict | None, generator: torch.Generator | None = None,
                optimizer: OptimizerSpec | None = None):
    """The model of a ``model`` config: ``kind: dmpnn``, ``multicomponent``
    (``build_multicomponent_dmpnn``), ``gat``, ``graph_transformer``
    (``build_gat`` with ``attention: sdp``) or ``spatial``
    (``build_spatial_model``), or declarative
    ``modules`` (with ``losses`` and ``metrics``) built by name through the
    registry, as the JAX ``build_model`` builds them. Parameters are drawn
    from ``generator``; the model is built on the CPU."""
    if "modules" in cfg:
        from notorch_tpu_torch.cli.registry import build
        from notorch_tpu_torch.model.model import Model

        model = Model(
            modules={
                name: {"module": build(m), "in_keys": m["in_keys"], "out_keys": m["out_keys"]}
                for name, m in cfg["modules"].items()
            },
            losses={
                name: {"fn": build(spec), "in_keys": spec["in_keys"], "weight": spec.get("weight", 1.0)}
                for name, spec in cfg.get("losses", {}).items()
            },
            metrics={
                name: {"fn": build(spec), "in_keys": spec["in_keys"]}
                for name, spec in cfg.get("metrics", {}).items()
            },
            transforms=transforms,
            optimizer=optimizer,
        )
        model.reset_parameters(generator)
        return model
    kind = cfg.get("kind", "dmpnn")
    kwargs = {k: v for k, v in cfg.items() if k not in ("kind", "pred_key")}
    if kind == "dmpnn":
        from notorch_tpu_torch.models.dmpnn import build_dmpnn

        return build_dmpnn(transforms=transforms, generator=generator, optimizer=optimizer, **kwargs)
    if kind == "multicomponent":
        from notorch_tpu_torch.models.multicomponent import build_multicomponent_dmpnn

        return build_multicomponent_dmpnn(transforms=transforms, generator=generator, optimizer=optimizer, **kwargs)
    if kind == "spatial":
        from notorch_tpu_torch.models.spatial import build_spatial_model

        return build_spatial_model(transforms=transforms, generator=generator, optimizer=optimizer, **kwargs)
    if kind in ("gat", "graph_transformer"):
        from notorch_tpu_torch.models.gat import build_gat

        if kind == "graph_transformer":
            kwargs.setdefault("attention", "sdp")
        return build_gat(transforms=transforms, generator=generator, optimizer=optimizer, **kwargs)
    raise ValueError(f"unknown model kind {kind!r}")


def save_predict_meta(checkpoint_dir, cfg: dict, transforms: dict, ds, pred_key: str) -> None:
    """Write ``predict_meta.json`` beside the checkpoints, in the schema of
    ``notorch_tpu.cli.train``: the model and optimizer config, the
    featurization config, and the task transforms (which bake in
    training-split target statistics)."""
    from notorch_tpu_torch.tasks import transforms as task_transforms

    meta = {
        "model": cfg.get("model", {}),
        "optimizer": cfg.get("optimizer"),
        "pred_key": pred_key,
        "data": {k: v for k, v in cfg.get("data", {}).items() if k in ("transforms", "smiles_col")},
        "transforms": {
            name: {
                "preds": task_transforms.serialize(t["preds"]["module"]),
                "targets": task_transforms.serialize(t["targets"]["module"]),
                "columns": list(ds.targets[name].columns),
                "task": ds.targets[name].task,
            }
            for name, t in transforms.items()
        },
    }
    path = Path(checkpoint_dir).absolute()
    path.mkdir(parents=True, exist_ok=True)
    (path / "predict_meta.json").write_text(json.dumps(meta, indent=1))


def resolve_model_cfg(model_cfg: dict) -> dict:
    """``model_cfg`` with ``layout: auto`` of a ``kind: dmpnn``, ``gat`` or
    ``graph_transformer`` config resolved, as the JAX ``run`` and
    ``run_predict`` resolve it, so that the data pipeline, the saved
    ``predict_meta`` and the built model agree; declarative configs pass
    through."""
    from notorch_tpu_torch.models.dmpnn import resolve_layout
    from notorch_tpu_torch.models.gat import KINDS, resolve_gat_layout

    model_cfg = dict(model_cfg)
    kind = model_cfg.get("kind", "dmpnn")
    if "modules" in model_cfg:
        return model_cfg
    if kind in KINDS:
        attention = model_cfg.get("attention", "sdp" if kind == "graph_transformer" else "gatv2")
        model_cfg["layout"] = resolve_gat_layout(model_cfg.get("layout", "auto"), attention=attention)
    elif kind == "dmpnn":
        model_cfg["layout"] = resolve_layout(
            model_cfg.get("layout", "auto"),
            dropout=model_cfg.get("dropout", 0.0),
            dtype=model_cfg.get("dtype"),
            graph_axis=model_cfg.get("graph_axis"),
            remat=model_cfg.get("remat", False),
            impl=model_cfg.get("impl", "gather"),
            aggregation=model_cfg.get("aggregation", "mean"),
            reduce=model_cfg.get("reduce", "sum"),
        )
    return model_cfg


def data_layout(model_cfg: dict) -> str:
    """The loader layout of a (resolved) model config, as the JAX ``run``
    picks it: ``dense_packed`` stays, any other ``dense*`` layout reads the
    per-molecule ``dense`` collate, and anything else (``flat``, the default
    of a declarative config) the flat one."""
    layout = str(model_cfg.get("layout", "flat"))
    if layout == "dense_packed":
        return "dense_packed"
    if layout.startswith("dense"):
        return "dense"
    return "flat"


def csr_pack(model_cfg: dict) -> bool:
    """Whether the loaders of a (resolved) model config carry the tile-packed
    CSR metadata: on the flat layout, when the model reduces through
    ``impl: csr`` (a ``kind: dmpnn`` config's ``model.impl``, or any
    declarative ``ChempropBlock``/``ChempropLayer``). The JAX ``run`` packs
    only for the first, and its ``run_predict`` never, so that serving there
    skips the kernel; here every loader of such a model packs."""
    if data_layout(model_cfg) != "flat":
        return False
    modules = (model_cfg.get("modules") or {}).values()
    return model_cfg.get("impl") == "csr" or any(
        m.get("class") in ("ChempropBlock", "ChempropLayer") and (m.get("args") or {}).get("impl") == "csr"
        for m in modules
    )


def loader_options(model_cfg: dict) -> dict:
    """The DataLoader options of a (resolved) model config, for every loader
    of a run: its ``layout``, ``csr_pack`` (see :func:`csr_pack`) and, for
    the attention kinds, the bins of :func:`~notorch_tpu_torch.models.gat.
    gat_loader_kwargs`."""
    from notorch_tpu_torch.models.gat import KINDS, gat_loader_kwargs

    layout = data_layout(model_cfg)
    options = {"layout": layout, "csr_pack": csr_pack(model_cfg)}
    if model_cfg.get("kind") in KINDS:
        options.update(gat_loader_kwargs(layout))
    return options


def refuse_point_clouds(model_cfg: dict) -> None:
    """Raise for a model that reads point clouds (``kind: spatial``, or a
    declarative module reading ``inputs.P``): the CLI's data path makes
    graphs from SMILES and yields no point clouds, in the JAX package too.
    Such models train and serve through ``build_model``, ``fit`` and
    ``predict`` on batches of ``pad_point_clouds``."""
    in_keys = [m.get("in_keys") or [] for m in (model_cfg.get("modules") or {}).values()]
    reads_clouds = any("inputs.P" in (keys.values() if isinstance(keys, dict) else keys) for keys in in_keys)
    if model_cfg.get("kind") == "spatial" or reads_clouds:
        raise ValueError(
            "this model reads point clouds, but the train and predict CLIs make graphs from SMILES and yield "
            "no point clouds (as in the JAX package): build it with build_model and train and serve it with "
            "fit and predict on batches of notorch_tpu_torch.data.point_cloud.pad_point_clouds"
        )




def classification_host_metrics(ds, pred_key: str) -> dict | None:
    """AUROC and AUPRC on the host (``<name>_auroc``, ``<name>_auprc``) for
    every classification target group of ``ds``, as the JAX ``run`` adds
    them; None when there is none."""
    from notorch_tpu_torch.tasks.metrics import AUPRC, AUROC

    host_metrics = {}
    for name, spec in ds.targets.items():
        if spec.task == "classification":
            keys = {"preds": pred_key, "targets": f"targets.{name}", "mask": f"targets.{name}_mask"}
            host_metrics[f"{name}_auroc"] = {"fn": AUROC(), "in_keys": keys}
            host_metrics[f"{name}_auprc"] = {"fn": AUPRC(), "in_keys": keys}
    return host_metrics or None


def prepare(cfg: dict, device: str | torch.device | None = None) -> dict:
    """Everything a training run needs, built from ``cfg`` as the JAX
    ``run`` builds it: the dataset and its split (random, or by scaffold),
    the task transforms from training-split statistics, the host metrics
    of the classification targets, the model initialised from
    ``torch.Generator().manual_seed(trainer.seed)`` on ``device``, and the
    train (shuffled by the seed), val and test loaders."""
    from notorch_tpu_torch.data.batching import DataLoader, Subset, random_split

    refuse_point_clouds(cfg.get("model", {}))
    device = resolve_device(device)
    trainer_cfg = cfg.get("trainer", {})
    seed = trainer_cfg.get("seed", 0)

    ds = build_dataset(cfg["data"])
    split = cfg["data"].get("split")
    train, val, test = ds, None, None
    if split:
        fractions = tuple(split.get("fractions", (0.8, 0.1, 0.1)))
        if split.get("kind") == "scaffold":
            from notorch_tpu_torch.data.splits import scaffold_split

            smiles_col = cfg["data"].get("smiles_col", "smiles")
            idxs = scaffold_split([rec[smiles_col] for rec in ds.records], fractions, seed=split.get("seed", 0))
        else:
            idxs = random_split(len(ds), fractions, seed=split.get("seed", 0))
        train = Subset(ds, idxs[0])
        val = Subset(ds, idxs[1]) if len(idxs) > 1 and len(idxs[1]) else None
        test = Subset(ds, idxs[2]) if len(idxs) > 2 and len(idxs[2]) else None

    transforms = train.build_task_transform_configs()
    pred_key = cfg.get("model", {}).get("pred_key", "ffn.preds")
    for t in transforms.values():
        t["preds"]["key"] = pred_key

    model_cfg = resolve_model_cfg(cfg.get("model", {}))
    options = loader_options(model_cfg)
    layout = options["layout"]
    cfg = {**cfg, "model": model_cfg}
    model = build_model(model_cfg, transforms, generator=torch.Generator().manual_seed(seed),
                        optimizer=build_optimizer(cfg.get("optimizer")))
    model.to(device)

    batch_size = trainer_cfg.get("batch_size", 64)

    def loader(part, **kw):
        if part is None:
            return None
        return DataLoader(part, batch_size=batch_size, **options, **kw)

    return {
        "cfg": cfg, "ds": ds, "train": train, "val": val, "test": test,
        "transforms": transforms, "pred_key": pred_key, "model": model, "layout": layout,
        "host_metrics": classification_host_metrics(ds, pred_key),
        "train_loader": loader(train, shuffle=True, seed=seed, sort_by_size=layout == "dense"),
        "val_loader": loader(val),
        "test_loader": loader(test),
    }


class _PretrainLoader:
    """Masked-atom batches ``{"inputs.G", "inputs.node_labels"}`` of
    ``graphs`` on the flat layout, at caps rounded up the ladders of the
    JAX loader (nodes from 256, edges from 512). Each pass masks the
    molecules anew (``MaskAtoms`` seeded ``seed + epoch``) and shuffles
    them; after :meth:`set_epoch` both are a pure function of (seed,
    epoch), so a resumed run re-derives any epoch's batches."""

    def __init__(self, graphs, mask_rate: float, batch_size: int, seed: int = 0, shuffle: bool = True):
        self.graphs, self.mask_rate, self.batch_size = graphs, mask_rate, batch_size
        self.seed, self.shuffle = seed, shuffle
        self._epoch = 0
        self._rg = np.random.default_rng(seed)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)
        self._rg = np.random.default_rng((self.seed, int(epoch)))

    def __len__(self) -> int:
        return -(-len(self.graphs) // self.batch_size)

    def __iter__(self):
        from notorch_tpu_torch.data.batching import bucket_ladder, round_up_ladder
        from notorch_tpu_torch.models.pretrain import MaskAtoms

        node_ladder = bucket_ladder(256, 1 << 22)
        edge_ladder = bucket_ladder(512, 1 << 22)
        masker = MaskAtoms(mask_rate=self.mask_rate, seed=self.seed + self._epoch)
        self._epoch += 1
        order = np.arange(len(self.graphs))
        if self.shuffle:
            self._rg.shuffle(order)
        for s in range(0, len(order), self.batch_size):
            chunk = [masker(self.graphs[i]) for i in order[s : s + self.batch_size]]
            node_cap = round_up_ladder(sum(g.num_nodes for g in chunk) + 1, node_ladder)
            edge_cap = round_up_ladder(max(sum(g.num_edges for g in chunk), 2), edge_ladder)
            bg, labels = MaskAtoms.collate(chunk, node_cap, edge_cap)
            yield {"inputs.G": bg, "inputs.node_labels": labels}


def prepare_pretrain(cfg: dict, device: str | torch.device | None = None) -> dict:
    """What a pretraining run needs, built from ``cfg`` as the JAX
    ``run_pretrain`` builds it: the ``data.smiles_col`` molecules of
    ``data.csv`` (the first ``data.limit``), featurized once; the
    masked-atom pretrainer (``hidden_dim``, ``depth``) from
    ``torch.Generator().manual_seed(trainer.seed)`` on ``device``; and the
    loader that masks them anew each epoch (``model.mask_rate``)."""
    from notorch_tpu_torch.models.pretrain import build_masked_atom_pretrainer

    device = resolve_device(device)
    model_cfg = {k: v for k, v in cfg.get("model", {}).items() if k not in ("kind", "mask_rate", "partition")}
    trainer_cfg = cfg.get("trainer", {})
    seed = trainer_cfg.get("seed", 0)
    model = build_masked_atom_pretrainer(optimizer=build_optimizer(cfg.get("optimizer")),
                                         generator=torch.Generator().manual_seed(seed), **model_cfg)
    graphs, mask_rate = pretrain_graphs(cfg)
    loader = _PretrainLoader(graphs, mask_rate, trainer_cfg.get("batch_size", 64), seed=seed)
    return {"model": model.to(device), "train_loader": loader}


def pretrain_graphs(cfg: dict) -> tuple[list, float]:
    """The pretraining molecules (the first ``data.limit`` of ``data.csv``'s
    ``data.smiles_col``), featurized once, and ``model.mask_rate``."""
    data_cfg = cfg["data"]
    smiles = data_table(data_cfg)[data_cfg.get("smiles_col", "smiles")][: data_cfg.get("limit") or None]
    pipe = smiles_pipeline()
    return [pipe(s) for s in smiles], cfg.get("model", {}).get("mask_rate", 0.15)


def _print_rank0(record: dict) -> None:
    """An epoch record as a JSON line, printed by global rank 0 alone."""
    from notorch_tpu_torch.parallel.distributed import process_info

    if process_info()[0] == 0:
        print(json.dumps({k: _jsonable(v) for k, v in record.items()}), flush=True)


def run_pretrain_spmd(cfg: dict, device: str | torch.device | None = None) -> dict:
    """Masked-atom pretraining over a ``data`` x ``graph`` mesh
    (``trainer.spmd: {data: D, graph: G}``), as the JAX ``run_pretrain``:
    the ``model.partition`` ``molecule`` (the default: each graph shard
    whole molecules, :func:`~notorch_tpu_torch.parallel.partition.
    build_molecule_spmd_batch` with the labels per shard) or ``replicate``
    (edge shards, :func:`~notorch_tpu_torch.parallel.partition.
    build_spmd_batch`); a graph axis only where G > 1. Every epoch's shuffle
    is drawn first, so the fixed caps (one shape a run) cover the groups
    the loop builds; a data shard takes ``batch_size // D`` molecules a
    step. Returns ``{"history", "model"}``."""
    from notorch_tpu_torch.data.batching import to_device
    from notorch_tpu_torch.models.pretrain import MaskAtoms, build_masked_atom_pretrainer
    from notorch_tpu_torch.parallel.distributed import process_info
    from notorch_tpu_torch.parallel.mesh import make_mesh
    from notorch_tpu_torch.parallel.partition import (
        build_molecule_spmd_batch,
        build_spmd_batch,
        partition_molecules,
    )
    from notorch_tpu_torch.parallel.spmd import SpmdTrainer

    device = resolve_device(device)
    trainer_cfg = cfg.get("trainer", {})
    spmd = trainer_cfg["spmd"]
    n_graph = spmd.get("graph", 1)
    n_data = spmd.get("data", process_info()[1] // n_graph)
    graph_axis = "graph" if n_graph > 1 else None
    mesh = make_mesh({"data": n_data, **({"graph": n_graph} if graph_axis else {})}, device.type)
    graphs, mask_rate = pretrain_graphs(cfg)
    model_cfg = {k: v for k, v in cfg.get("model", {}).items() if k not in ("kind", "mask_rate", "partition")}
    partition = cfg.get("model", {}).get("partition", "molecule")
    seed, epochs = trainer_cfg.get("seed", 0), trainer_cfg.get("epochs", 1)
    model = build_masked_atom_pretrainer(optimizer=build_optimizer(cfg.get("optimizer")),
                                         generator=torch.Generator().manual_seed(seed), graph_axis=graph_axis,
                                         partition=partition, **model_cfg).to(device)
    trainer = SpmdTrainer(model, mesh, data_axis="data", graph_axis=graph_axis).init()

    per = max(1, trainer_cfg.get("batch_size", 64) // n_data)
    group_size = per * n_data
    rg = np.random.default_rng(seed)
    orders = [rg.permutation(len(graphs)) for _ in range(epochs)]
    max_vs, max_es = [], []
    for order in orders:
        for s in range(0, len(order) - group_size + 1, group_size):
            for gi in range(n_data):
                grp = [graphs[i] for i in order[s + gi * per : s + (gi + 1) * per]]
                if partition == "molecule" and n_graph > 1:  # per-shard caps under the LPT assignment
                    for idx in partition_molecules(grp, n_graph):
                        max_vs.append(sum(grp[i].num_nodes for i in idx) + 1)
                        max_es.append(sum(grp[i].num_edges for i in idx))
                else:
                    max_vs.append(sum(g.num_nodes for g in grp) + 1)
                    max_es.append(sum(g.num_edges for g in grp))
    node_cap = -(-max(max_vs) // 8) * 8
    unit = 2 * n_graph if partition == "replicate" else 2
    edge_cap = -(-max(max_es) // unit) * unit

    def labels_of(grp) -> np.ndarray:
        labels = np.full(node_cap, -1, dtype=np.int32)
        off = 0
        for g in grp:
            labels[off : off + g.num_nodes] = g.node_labels
            off += g.num_nodes
        return labels

    history = []
    for epoch, order in enumerate(orders):
        masker = MaskAtoms(mask_rate=mask_rate, seed=seed + epoch)
        losses = []
        for s in range(0, len(order) - group_size + 1, group_size):
            groups = [[masker(graphs[i]) for i in order[s + gi * per : s + (gi + 1) * per]] for gi in range(n_data)]
            if partition == "molecule":
                batch = build_molecule_spmd_batch(groups, None, node_cap, edge_cap, per, n_graph_shards=n_graph,
                                                  node_attrs=("node_labels",))
            else:
                batch = build_spmd_batch(groups, None, node_cap, edge_cap, per, n_edge_shards=n_graph,
                                         extra_inputs={"node_labels": [labels_of(g) for g in groups]})
            logs = trainer.train_step(to_device(trainer.local_batch(batch), device))
            losses.append(logs["train/loss"])
        rec = {"epoch": epoch, "train/loss": float(np.mean([float(v) for v in losses]))}
        history.append(rec)
        _print_rank0(rec)
    return {"history": history, "model": model}


def run_halo_spmd(cfg: dict, device: str | torch.device | None = None) -> dict:
    """Supervised training with boundary-HALO graph partitioning
    (``model.partition: halo`` with ``trainer.spmd``;
    ``configs/dmpnn_halo.yaml``), as the JAX ``_run_halo_spmd``: every data
    group padded into ONE flat graph and split into node-block edge shards
    (:func:`~notorch_tpu_torch.parallel.partition.build_halo_spmd_batch`),
    whose message passing exchanges only boundary rows; the shuffles of
    every epoch drawn first for one step shape a run (:func:`~
    notorch_tpu_torch.parallel.partition.halo_spmd_caps`). The model,
    dataset, split and task transforms are :func:`prepare`'s. Returns
    ``{"history", "model"}``."""
    from notorch_tpu_torch.data.batching import to_device
    from notorch_tpu_torch.parallel.mesh import make_mesh
    from notorch_tpu_torch.parallel.partition import build_halo_spmd_batch, halo_spmd_caps
    from notorch_tpu_torch.parallel.spmd import SpmdTrainer

    device = resolve_device(device)
    trainer_cfg = cfg.get("trainer", {})
    spmd = trainer_cfg["spmd"]
    n_data, n_graph = spmd.get("data", 1), spmd.get("graph", 2)
    mesh = make_mesh({"data": n_data, "graph": n_graph}, device.type)
    run_ = prepare(cfg, device)
    model, train = run_["model"], run_["train"]
    graph_axis = run_["cfg"]["model"].get("graph_axis", "graph")
    trainer = SpmdTrainer(model, mesh, data_axis="data", graph_axis=graph_axis).init()
    seed, epochs = trainer_cfg.get("seed", 0), trainer_cfg.get("epochs", 1)
    per = max(1, trainer_cfg.get("batch_size", 64) // n_data)
    group_size = per * n_data

    out_key = next(iter(train.transforms.values())).out_key
    graphs = [train[i][out_key] for i in range(len(train))]
    target_arrays = dict(train._target_arrays)
    rg = np.random.default_rng(seed)
    orders = [rg.permutation(len(graphs)) for _ in range(epochs)]

    def iter_groups(order):
        for s0 in range(0, len(order) - group_size + 1, group_size):
            yield [order[s0 + gi * per : s0 + (gi + 1) * per] for gi in range(n_data)]

    max_v = max_e = 0
    all_groups = []
    for order in orders:
        for idxs in iter_groups(order):
            all_groups.append([[graphs[i] for i in idx] for idx in idxs])
            for idx in idxs:
                max_v = max(max_v, sum(graphs[i].num_nodes for i in idx) + 1)
                max_e = max(max_e, sum(graphs[i].num_edges for i in idx))
    unit = 8 * n_graph  # the node cap divides into n_graph node blocks
    node_cap = -(-max_v // unit) * unit
    edge_cap = -(-max_e // 2) * 2
    pair_cap, b_cap, h_cap = halo_spmd_caps(all_groups, node_cap, edge_cap, per, n_graph)

    history = []
    for epoch, order in enumerate(orders):
        losses = []
        for idxs in iter_groups(order):
            groups = [[graphs[i] for i in idx] for idx in idxs]
            targets = {name: [arr[np.asarray(idx)] for idx in idxs] for name, arr in target_arrays.items()}
            batch = build_halo_spmd_batch(groups, targets, node_cap, edge_cap, per, n_shards=n_graph,
                                          pair_cap=pair_cap, b_cap=b_cap, h_cap=h_cap)
            logs = trainer.train_step(to_device(trainer.local_batch(batch), device))
            losses.append(logs["train/loss"])
        rec = {"epoch": epoch, "train/loss": float(np.mean([float(v) for v in losses]))}
        history.append(rec)
        _print_rank0(rec)
    return {"history": history, "model": model}


def run_pretrain(cfg: dict, device: str | torch.device | None = None) -> dict:
    """Masked-atom self-supervised pretraining (``model.kind: pretrain``;
    with ``trainer.spmd``, :func:`run_pretrain_spmd`):
    :func:`prepare_pretrain`, then ``fit`` for ``trainer.epochs`` with
    ``checkpoint_dir``/``max_to_keep``, ``resume``, ``checkpoint_every`` and
    ``steps_per_dispatch``, the loader behind a :class:`~notorch_tpu_torch.
    data.batching.PrefetchLoader` of ``trainer.prefetch`` batches (default
    4; 0 for none) that also groups the batches (:func:`fit_loaders`), as
    :func:`run` trains. Returns
    ``{"history", "stopped_early", "model"}``."""
    from notorch_tpu_torch.training.checkpoint import Checkpointer
    from notorch_tpu_torch.training.loop import fit

    if cfg.get("trainer", {}).get("spmd"):
        return run_pretrain_spmd(cfg, device)
    run_ = prepare_pretrain(cfg, device)
    trainer_cfg = cfg.get("trainer", {})
    loader, _, steps_per_dispatch = fit_loaders(run_, trainer_cfg)
    checkpointer = None
    if trainer_cfg.get("checkpoint_dir"):
        checkpointer = Checkpointer(trainer_cfg["checkpoint_dir"], max_to_keep=trainer_cfg.get("max_to_keep", 3))
    result = fit(
        run_["model"], loader, epochs=trainer_cfg.get("epochs", 1),
        log_fn=lambda r: print(json.dumps({k: _jsonable(v) for k, v in r.items()}), flush=True),
        checkpointer=checkpointer, resume=trainer_cfg.get("resume", False),
        checkpoint_every=trainer_cfg.get("checkpoint_every", 0),
        steps_per_dispatch=steps_per_dispatch,
    )
    return {"history": result.history, "stopped_early": result.stopped_early, "model": run_["model"]}


def fit_loaders(run_: dict, trainer_cfg: dict) -> tuple:
    """``(train_loader, val_loader, steps_per_dispatch)`` as :func:`run`
    hands them to ``fit``, from :func:`prepare`'s (or
    :func:`prepare_pretrain`'s) loaders: with
    ``trainer.prefetch`` (default 4; 0 for none) each behind a
    :class:`~notorch_tpu_torch.data.batching.PrefetchLoader` of that many
    batches, the train loader's grouping ``trainer.steps_per_dispatch``
    same-shape batches into one transfer (and ``fit`` then told 1, as the
    JAX ``run`` does); without, ``fit`` groups them itself."""
    from notorch_tpu_torch.data.batching import PrefetchLoader

    train_loader, val_loader = run_["train_loader"], run_.get("val_loader")
    prefetch = trainer_cfg.get("prefetch", 4)
    steps_per_dispatch = trainer_cfg.get("steps_per_dispatch", 1)
    if prefetch:
        device = run_["model"].device
        train_loader = PrefetchLoader(train_loader, buffer_size=int(prefetch), device=device,
                                      stack=steps_per_dispatch if steps_per_dispatch > 1 else 0)
        steps_per_dispatch = 1
        if val_loader is not None:
            val_loader = PrefetchLoader(val_loader, buffer_size=int(prefetch), device=device)
    return train_loader, val_loader, steps_per_dispatch


def run(cfg: dict, device: str | torch.device | None = None) -> dict:
    """Config-driven training. ``device=None`` trains on the card and raises
    where there is none; ``device="cpu"`` runs the plain CPU path. Returns
    ``{"history", "stopped_early"}`` plus ``best_step``, ``test`` and
    ``predictions_csv`` where they apply. ``model.kind: pretrain`` runs
    :func:`run_pretrain`. Inline ``${csv:...}``, ``${parquet:...}`` and
    ``${len:...}`` values are resolved first (:func:`resolve_config`).

    As in the JAX ``run``, the train and validation loaders run behind a
    :class:`~notorch_tpu_torch.data.batching.PrefetchLoader` of
    ``trainer.prefetch`` batches (default 4; 0 for none), which featurizes,
    collates and copies the next batches to the card while it trains; with
    ``trainer.steps_per_dispatch`` K > 1 the train loader's prefetcher
    groups K same-shape batches into one copy, and ``fit`` runs each group
    as :meth:`~notorch_tpu_torch.model.model.Model.train_steps`. Neither
    changes the math."""
    from notorch_tpu_torch.training.checkpoint import Checkpointer
    from notorch_tpu_torch.training.loop import evaluate, fit, predict

    cfg = resolve_config(cfg)
    if cfg.get("model", {}).get("kind") == "pretrain":
        return run_pretrain(cfg, device)
    if cfg.get("trainer", {}).get("spmd"):
        if cfg.get("model", {}).get("partition") == "halo":
            return run_halo_spmd(cfg, device)
        raise ValueError(
            "trainer.spmd on supervised runs supports model.partition: halo (boundary-exchange graph sharding; "
            "configs/dmpnn_halo.yaml). For molecule-batch scaling use the library SpmdTrainer/DenseSpmdTrainer "
            "paths; kind: pretrain supports molecule/replicate spmd directly."
        )
    run_ = prepare(cfg, device)
    cfg, model, pred_key = run_["cfg"], run_["model"], run_["pred_key"]
    trainer_cfg = cfg.get("trainer", {})

    checkpointer = None
    if trainer_cfg.get("checkpoint_dir"):
        checkpointer = Checkpointer(
            trainer_cfg["checkpoint_dir"],
            max_to_keep=trainer_cfg.get("max_to_keep", 3),
            best_by=trainer_cfg.get("best_by"),
            best_mode=trainer_cfg.get("best_mode", "min"),
        )
        save_predict_meta(trainer_cfg["checkpoint_dir"], cfg, run_["transforms"], run_["ds"], pred_key)

    train_loader, val_loader, steps_per_dispatch = fit_loaders(run_, trainer_cfg)
    result = fit(
        model,
        train_loader,
        val_loader,
        epochs=trainer_cfg.get("epochs", 1),
        log_fn=lambda r: print(json.dumps({k: _jsonable(v) for k, v in r.items()}), flush=True),
        host_metrics=run_["host_metrics"],
        checkpointer=checkpointer,
        resume=trainer_cfg.get("resume", False),
        checkpoint_every=trainer_cfg.get("checkpoint_every", 0),
        steps_per_dispatch=steps_per_dispatch,
        early_stopping=trainer_cfg.get("early_stopping"),
    )
    out = {"history": result.history, "stopped_early": result.stopped_early}
    if checkpointer is not None and checkpointer.best_step() is not None:
        # test and predict with the best epoch's weights, not the last
        out["best_step"] = checkpointer.best_step()
        model.network.load_state_dict(checkpointer.restore(out["best_step"]))
    if run_["test_loader"] is not None:
        out["test"] = evaluate(model, run_["test_loader"], run_["host_metrics"])
        print(json.dumps({"test": {k: _jsonable(v) for k, v in out["test"].items()}}), flush=True)

    pred_csv = trainer_cfg.get("predictions_csv")
    if pred_csv:
        from notorch_tpu_torch.data.batching import DataLoader

        target = run_["test"] if run_["test"] is not None else run_["train"]
        loader = DataLoader(target, batch_size=trainer_cfg.get("batch_size", 64), **loader_options(cfg["model"]))
        flat = predict(model, loader, keys=[pred_key])[pred_key][: len(target)]
        flat = flat.reshape(len(target), -1)
        with open(pred_csv, "w") as f:
            f.write(",".join(f"pred_{i}" for i in range(flat.shape[1])) + "\n")
            for row in flat:
                f.write(",".join(f"{v:.6g}" for v in row) + "\n")
        out["predictions_csv"] = pred_csv
    return out


def _jsonable(v):
    try:
        return round(float(v), 6)
    except (TypeError, ValueError):
        return str(v)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m notorch_tpu_torch train", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("config", help="path to a YAML/JSON config")
    parser.add_argument("overrides", nargs="*", help="dotted-key overrides: a.b=val")
    parser.add_argument("--cpu", action="store_true", help="run the plain CPU path")
    args = parser.parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.overrides)
    device = "cpu" if args.cpu else None
    from notorch_tpu_torch.parallel import distributed

    if distributed.launched():  # one process of a torchrun world
        distributed.initialize(device=device)
    try:
        run(cfg, device=device)
    finally:
        if distributed.launched():
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
