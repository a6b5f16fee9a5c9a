"""Config, dataset and model builders shared by the port's entry points.

Port of the builders of ``notorch_tpu.cli.train``: the same YAML/JSON
configs, the default SMILES pipeline and ``model.kind: dmpnn``. The training
run itself (``run``, ``main``) comes with the training slice. Tables are
read with the standard ``csv`` module.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path

import torch

from notorch_tpu_torch.data.dataset import MolecularDataset, TargetSpec, TransformManager
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol


def load_config(path: str | Path) -> dict:
    text = Path(path).read_text()
    if str(path).endswith((".yaml", ".yml")):
        import yaml

        return yaml.safe_load(text)
    return json.loads(text)


def read_table(path: str | Path) -> dict[str, list[str]]:
    """A CSV file as a mapping of column name -> list of cell strings."""
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None:
            raise ValueError(f"{path} has no header row")
        columns: dict[str, list[str]] = {name: [] for name in reader.fieldnames}
        for row in reader:
            for name in reader.fieldnames:
                columns[name].append(row[name])
    return columns


def build_dataset(cfg: dict) -> MolecularDataset:
    """The dataset of a ``data`` config: a ``csv`` table, the default
    SMILES -> Graph pipeline per ``transforms`` entry (or one on
    ``smiles_col``), and the ``targets`` groups."""
    if "csv" not in cfg:
        raise KeyError("data config needs a 'csv' entry (parquet is not ported)")
    table = read_table(cfg["csv"])
    transforms = {}
    for name, tcfg in (cfg.get("transforms") or _default_transforms(cfg)).items():
        if "transform" in tcfg:
            raise NotImplementedError(
                f"data.transforms.{name}.transform: configurable transforms are not "
                "ported yet; the port featurizes with the default SMILES pipeline"
            )
        transforms[name] = TransformManager(
            Pipeline(SmiToMol(), MolToGraph()), in_key=tcfg.get("in_key"), out_key=tcfg.get("out_key")
        )
    targets = {
        name: TargetSpec(
            columns=tc["columns"], task=tc.get("task", "regression"), weight=tc.get("weight", 1.0)
        )
        for name, tc in (cfg.get("targets") or {}).items()
    }
    return MolecularDataset(table, transforms=transforms, targets=targets)


def _default_transforms(cfg: dict) -> dict:
    return {"graph": {"in_key": cfg.get("smiles_col", "smiles"), "out_key": "G"}}


def build_model(cfg: dict, transforms: dict | None, generator: torch.Generator | None = None):
    """The model of a ``model`` config (``kind: dmpnn``)."""
    if "modules" in cfg:
        raise NotImplementedError("declarative model.modules configs are not ported yet")
    kind = cfg.get("kind", "dmpnn")
    if kind != "dmpnn":
        raise NotImplementedError(f"model kind {kind!r} is not ported yet; only dmpnn is")
    from notorch_tpu_torch.models.dmpnn import build_dmpnn

    kwargs = {k: v for k, v in cfg.items() if k not in ("kind", "pred_key")}
    return build_dmpnn(transforms=transforms, generator=generator, **kwargs)


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
