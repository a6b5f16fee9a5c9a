"""Warm host ms a training step of ``configs/dmpnn_regression.yaml`` (all of
``tests/data/lipo.csv``, the shipped model, optimizer and batch size) on the
card, at each of the trainer settings asked for, for one checkout of the port.

    python3 scripts/time_fit_settings.py [--root DIR] [--settings prefetch_0,prefetch_4,grouped]
                                         [--turns 2] [--switch-interval SECONDS]

``--root`` is the checkout whose ``notorch_tpu_torch`` trains (default: this
one), so that two commits are compared on one card by running this once for
each, in turns (parent, change, change, parent). The settings are the
``trainer`` options that ``run`` reads: ``prefetch_0`` (``prefetch: 0``: the
loader's host batches straight to ``fit``), ``prefetch_4`` (the default
``PrefetchLoader`` of 4) and ``grouped`` (``prefetch: 4,
steps_per_dispatch: 4``). A checkout without ``fit_loaders`` (one from before
``trainer.prefetch`` was honoured) times ``prefetch_0`` alone.

The model and loaders come from ``prepare``; one epoch warms up the
featurization cache, the kernels' build and their first launches. Then each
setting trains one epoch, in turns (each setting, then each again in reverse
order, ``--turns`` times), with the card synchronised around each epoch and
timed on the host's clock. ``--switch-interval`` sets the interpreter's
thread switch interval (``sys.setswitchinterval``) before the timing, to see
how much of a setting's time is threads waiting for the interpreter lock.
Where the checkout has ``stage``, it also times, on the host's clock with
the card synchronised at the end, putting one epoch's collated batches on
the card: ``to_device`` a batch (what ``prefetch: 0`` does),
``stage(stacked=False)`` a batch (what the prefetcher does with one batch,
on its side stream) and ``stage`` each group of up to 4 that ``fit``
forms at ``steps_per_dispatch: 4``, in ms a batch. Prints one JSON line: the card's name and power limit, per
setting the ms a step of each timed epoch, and the staging times.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SETTINGS = {"prefetch_0": {"prefetch": 0}, "prefetch_4": {}, "grouped": {"steps_per_dispatch": 4}}


def regression_config(root: Path) -> dict:
    """configs/dmpnn_regression.yaml as a dict (written out: the card's
    machine may lack a YAML parser)."""
    return {
        "data": {"csv": str(root / "tests" / "data" / "lipo.csv"), "smiles_col": "smiles",
                 "targets": {"y": {"columns": ["lipo"], "task": "regression"}},
                 "split": {"fractions": [0.8, 0.1, 0.1], "seed": 0}},
        "model": {"kind": "dmpnn", "hidden_dim": 256, "depth": 3, "aggregation": "mean", "ffn_layers": 1},
        "optimizer": {"name": "adam", "schedule": {"noam": {
            "warmup_steps": 100, "cooldown_steps": 1500, "init_lr": 1e-4, "max_lr": 1e-3, "final_lr": 1e-4}}},
        "trainer": {"epochs": 1, "batch_size": 64, "seed": 0},
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(HERE), help="the checkout whose notorch_tpu_torch trains")
    parser.add_argument("--settings", default=",".join(SETTINGS), help="comma-separated, of " + ", ".join(SETTINGS))
    parser.add_argument("--turns", type=int, default=2, help="passes over the settings, each forward and back")
    parser.add_argument("--switch-interval", type=float, default=None, help="sys.setswitchinterval, in seconds")
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    from notorch_tpu_torch.cli import train as cli
    from notorch_tpu_torch.data import batching
    from notorch_tpu_torch.training.loop import fit

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the card")
    names = args.settings.split(",")
    unknown = [n for n in names if n not in SETTINGS]
    if unknown:
        sys.exit(f"unknown settings {unknown}; known: {list(SETTINGS)}")
    if not hasattr(cli, "fit_loaders"):
        names = [n for n in names if n == "prefetch_0"]
    run_ = cli.prepare(regression_config(root))
    model, base = run_["model"], run_["train_loader"]
    fit(model, base, epochs=1)  # warm-up
    steps = len(base)

    def epoch(name: str):
        if not hasattr(cli, "fit_loaders"):
            return lambda: fit(model, base, epochs=1)
        loader, _, spd = cli.fit_loaders(run_, SETTINGS[name])
        return lambda: fit(model, loader, epochs=1, steps_per_dispatch=spd)

    if args.switch_interval is not None:
        sys.setswitchinterval(args.switch_interval)
    ms = {name: [] for name in names}
    for _ in range(args.turns):
        for name in (*names, *reversed(names)):
            run_epoch = epoch(name)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_epoch()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3 / steps)
    staging = None
    if hasattr(batching, "stage"):
        device = model.device
        batches = list(base)
        side = torch.cuda.Stream(device)

        def per_batch(put) -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            put()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / len(batches)

        ways = {
            "to_device": lambda: [batching.to_device(b, device) for b in batches],
            "stage_one_side_stream": lambda: [batching.stage([b], device, side, stacked=False) for b in batches],
            "stage_groups_of_4": lambda: [batching.stage(g, device) for g in batching.group_batches(batches, 4)],
        }
        staging = {name: [] for name in ways}
        for _ in range(args.turns):
            for name in (*ways, *reversed(ways)):
                staging[name].append(per_batch(ways[name]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(json.dumps({"root": args.root, "card": smi[0] if smi else None, "steps_per_epoch": steps,
                      "switch_interval_s": sys.getswitchinterval(), "warm_ms_per_step": ms,
                      "median_ms_per_step": {n: statistics.median(v) for n, v in ms.items()},
                      "staging_ms_per_batch": staging}), flush=True)


if __name__ == "__main__":
    main()
