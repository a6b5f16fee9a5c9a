"""The declarative graph transformer's whole run, port-CPU against JAX-CPU.

Each step of an attention model agrees between the packages within 1e-4
(``tests/test_torch_gat.py``), but Adam moves each weight by about its rate
whatever the gradient's size, so over a run rounding differences grow into
differences of the run. This file holds ``chip_smoke.py``'s calm attention
recipe (CALM_ATTENTION: hidden 32, depth 3, 4 heads, Adam at 1e-4, 4 epochs
of 8 steps) whole-run at ATTENTION_CALM_RTOL: the run in both packages from
JAX's initial weights, the JAX core the einsum path, the port's the fused
core (its plain version on the CPU). ``chip_smoke.py`` holds the same run
card against CPU at the same limit.

The drift of the recipe at another rate, or with one weight tensor of the
port's side scaled by 1.03, as ATTENTION_CALM_RTOL was chosen (its numbers
are in ``chip_smoke.py``), from the repo root::

    python -m tests.test_torch_attention_run LR [WEIGHT_TO_SCALE] [--threads N]
"""

import jax
import numpy as np
import optax
import torch

import chip_smoke
from notorch_tpu.cli.train import build_model as jax_build_model
from notorch_tpu.data.batching import DataLoader as JaxDataLoader
from notorch_tpu.data.dataset import MolecularDataset as JaxDataset
from notorch_tpu.data.dataset import TargetSpec as JaxTargetSpec
from notorch_tpu.data.dataset import TransformManager as JaxTM
from notorch_tpu.training.loop import fit as jax_fit
from notorch_tpu.transforms import MolToGraph as JaxMolToGraph
from notorch_tpu.transforms import Pipeline as JaxPipeline
from notorch_tpu.transforms import SmiToMol as JaxSmiToMol
from notorch_tpu_torch.cli.train import build_dataset
from notorch_tpu_torch.data.batching import DataLoader
from notorch_tpu_torch.model.convert import params_from_jax
from notorch_tpu_torch.training.loop import fit, to_device
from tests.test_torch_spatial import few_torch_threads  # noqa: F401 (autouse: the thread cap)

RECIPE = chip_smoke.CALM_ATTENTION


def datasets(path):
    """The molecules of ``path`` as a dataset of each package."""
    ds = build_dataset({"csv": str(path), "targets": {"y": {"columns": ["lipo"]}}})
    table = {"smiles": [r["smiles"] for r in ds.records], "lipo": [float(r["lipo"]) for r in ds.records]}
    pipe = JaxPipeline(JaxSmiToMol(), JaxMolToGraph())
    return ds, JaxDataset(table, {"graph": JaxTM(pipe, "smiles", "G")}, targets={"y": JaxTargetSpec(["lipo"])})


def jax_cfg() -> dict:
    """The recipe's model in the JAX package, its attention core the einsum
    path."""
    cfg = chip_smoke.declarative_attention_model_cfg(RECIPE["d"], chip_smoke.MODEL_CFG["depth"],
                                                      chip_smoke.GT_CFG["num_heads"])
    args = cfg["modules"]["mp"]["args"]
    args.pop("fwd_impl")
    args["impl"] = "jnp"
    return cfg


def attention_run_drift(directory, lr: float, scaled: str | None = None) -> tuple[float, list, list]:
    """The recipe's run on the CPU in both packages from JAX's initial
    weights, Adam at ``lr``; ``scaled`` names a weight tensor of the port's
    side to scale by 1.03 (a fault the gate must catch). Checks that the
    first step's loss agrees within 1e-4 and returns the largest relative
    difference of the per-epoch losses and both histories."""
    (train_ds, train_jds), (val_ds, val_jds) = map(datasets, chip_smoke.calm_attention_csvs(directory))
    loader = dict(batch_size=RECIPE["batch"], layout="dense")
    train, val = list(DataLoader(train_ds, **loader)), list(DataLoader(val_ds, **loader))
    jtrain, jval = list(JaxDataLoader(train_jds, **loader)), list(JaxDataLoader(val_jds, **loader))
    jmodel = jax_build_model(jax_cfg(), train_jds.build_task_transform_configs(), optax.adam(lr))
    state = jmodel.init(jax.random.PRNGKey(0), jtrain[0])
    weights = params_from_jax(jax.device_get(state.params))
    transforms = train_ds.build_task_transform_configs()

    def port_model():
        model = chip_smoke.calm_attention_model(transforms, "cpu", weights)
        for group in model.optimizer.param_groups:
            group["lr"] = lr
        return model

    first = port_model().train_step(to_device(train[0], "cpu"))["train/loss"]
    _, jlogs = jmodel.train_step(jmodel.init(jax.random.PRNGKey(0), jtrain[0]), jtrain[0])  # the state is donated
    np.testing.assert_allclose(float(first), float(jlogs["train/loss"]), rtol=1e-4)
    if scaled is not None:
        weights[scaled] = weights[scaled] * 1.03
    ours = fit(port_model(), train, val, epochs=RECIPE["epochs"]).history
    theirs = jax_fit(jmodel, state, jtrain, jval, epochs=RECIPE["epochs"]).history
    drift = max(abs(a[k] - float(b[k])) / abs(float(b[k])) for a, b in zip(ours, theirs)
                for k in ("train/loss", "val/loss"))
    return drift, ours, theirs


def test_calm_attention_run_stays_with_jax(tmp_path):
    """The calm recipe's whole run: the port's per-epoch losses stay within
    ATTENTION_CALM_RTOL of JAX's (measured 6.42e-6; a weight scaled by 1.03
    drifts 3.3e-2 to 4.9e-2), and the training loss falls."""
    drift, ours, _ = attention_run_drift(tmp_path, RECIPE["lr"])
    assert ours[-1]["train/loss"] < ours[0]["train/loss"], ours
    assert drift <= chip_smoke.ATTENTION_CALM_RTOL, drift


if __name__ == "__main__":
    import argparse
    import json
    import tempfile
    import time
    from pathlib import Path

    parser = argparse.ArgumentParser(description="port-CPU against JAX-CPU drift of the calm attention run")
    parser.add_argument("lr", type=float)
    parser.add_argument("scaled", nargs="?", help="a weight tensor of the port's side to scale by 1.03")
    parser.add_argument("--threads", type=int, help="torch's CPU threads (JAX's follow XLA_FLAGS)")
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    if args.threads:
        torch.set_num_threads(args.threads)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        drift, ours, theirs = attention_run_drift(Path(tmp), args.lr, args.scaled)
    print(json.dumps({"lr": args.lr, "scaled": args.scaled, "threads": torch.get_num_threads(), "drift": drift,
                      "port": [{k: float(h[k]) for k in ("train/loss", "val/loss")} for h in ours],
                      "jax": [{k: float(h[k]) for k in ("train/loss", "val/loss")} for h in theirs],
                      "seconds": time.perf_counter() - t0}))
