"""``python -m notorch_tpu_torch predict``: inference from a checkpoint.

Rebuilds the model from the ``predict_meta.json`` beside the checkpoints
(the same schema ``notorch_tpu.cli.train`` writes: model config, a
``kind: dmpnn``, ``multicomponent``, ``gat`` or ``graph_transformer`` or a
declarative ``modules`` one, data config with its transforms, such as a
reaction's ``RxnToGraph``, task transforms baked from training-split
statistics), restores a
port checkpoint (:mod:`notorch_tpu_torch.training.checkpoint`), runs the
model over a CSV of molecules on the card, and writes its predictions
aligned row for row with the input, through the task's transform: data
units for regression, probabilities for classification, multiclass and
dirichlet. A head of ``k`` outputs a task gives ``t * k`` columns, named
``pred_<i>`` as in the JAX package; otherwise the columns are the training
target names.

Usage::

    python -m notorch_tpu_torch predict CHECKPOINT_DIR INPUT.csv -o preds.csv [--step N] [--cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from notorch_tpu_torch.cli.train import (
    build_dataset,
    build_model,
    loader_options,
    refuse_point_clouds,
    resolve_model_cfg,
)
from notorch_tpu_torch.data.batching import DataLoader
from notorch_tpu_torch.tasks import transforms as task_transforms
from notorch_tpu_torch.training.checkpoint import Checkpointer
from notorch_tpu_torch.training.loop import predict
from notorch_tpu_torch.utils import resolve_device

SERVE_CSR_NODE_QUANTUM = 256


def run_predict(
    checkpoint_dir: str | Path,
    csv: str | Path,
    out: str | Path | None = None,
    batch_size: int = 64,
    smiles_col: str | None = None,
    step: int | None = None,
    device: str | torch.device | None = None,
) -> dict[str, np.ndarray]:
    """Returns ``{column_name: np.ndarray[n]}`` and optionally writes a CSV.
    ``device=None`` runs on the card and raises where there is none; pass
    ``device="cpu"`` for the plain CPU path."""
    device = resolve_device(device)
    meta_path = Path(checkpoint_dir) / "predict_meta.json"
    if not meta_path.exists():
        raise FileNotFoundError(f"{meta_path} not found")
    meta = json.loads(meta_path.read_text())
    pred_key = meta["pred_key"]

    transforms = {
        name: {
            "preds": {"module": task_transforms.deserialize(t["preds"]), "key": pred_key},
            "targets": {
                "module": task_transforms.deserialize(t["targets"]),
                "key": f"targets.{name}",
            },
        }
        for name, t in meta["transforms"].items()
    }
    # metas written by run() hold the resolved layout; a hand-written meta
    # may still say "auto"
    refuse_point_clouds(meta["model"])
    model_cfg = resolve_model_cfg(meta["model"])
    model = build_model(model_cfg, transforms)
    model.network.load_state_dict(Checkpointer(checkpoint_dir).restore(step=step))
    model.to(device)

    data_cfg = dict(meta.get("data") or {})
    data_cfg["csv"] = str(csv)
    if smiles_col:
        data_cfg["smiles_col"] = smiles_col
    ds = build_dataset(data_cfg)  # no targets: inference CSVs need only molecules
    options = loader_options(model_cfg)
    if options["csr_pack"]:
        # packed for impl: csr as in training, so that serving runs the CSR
        # kernel; on a node ladder of multiples of 128 (256, 384, 512, ...),
        # which CSR packing takes at every rung, where the training ladder's
        # 192 rung would refuse a last batch of a few molecules. A node cap
        # changes no real molecule's prediction.
        options["node_quantum"] = SERVE_CSR_NODE_QUANTUM
    loader = DataLoader(ds, batch_size=batch_size, **options)

    preds = predict(model, loader, keys=[pred_key])
    flat = preds[pred_key][: len(ds)].reshape(len(ds), -1)

    names = _column_names(meta["transforms"], flat.shape[1])
    if out:
        with open(out, "w") as f:
            f.write(",".join(names) + "\n")
            for row in flat:
                f.write(",".join(f"{v:.6g}" for v in row) + "\n")
    return {name: flat[:, i] for i, name in enumerate(names)}


def _column_names(transform_meta: dict, width: int) -> list[str]:
    """The training target column names when the prediction width matches
    them exactly; otherwise positional names."""
    columns = [c for t in transform_meta.values() for c in t.get("columns", [])]
    if len(columns) == width:
        return [str(c) for c in columns]
    return [f"pred_{i}" for i in range(width)]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m notorch_tpu_torch predict", description=__doc__)
    parser.add_argument("checkpoint_dir", help="directory holding predict_meta.json and state_<step>.pt")
    parser.add_argument("csv", help="input CSV of molecules")
    parser.add_argument("-o", "--out", default="predictions.csv", help="output CSV path")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--smiles-col", default=None, help="override the SMILES column name")
    parser.add_argument("--step", type=int, default=None, help="checkpoint step (default latest)")
    parser.add_argument("--cpu", action="store_true", help="run the plain CPU path")
    args = parser.parse_args(argv)
    run_predict(
        args.checkpoint_dir,
        args.csv,
        out=args.out,
        batch_size=args.batch_size,
        smiles_col=args.smiles_col,
        step=args.step,
        device="cpu" if args.cpu else None,
    )
    print(json.dumps({"predictions_csv": args.out}))


if __name__ == "__main__":
    main()
