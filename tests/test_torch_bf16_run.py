"""The fused encoder with bf16 operands and a bf16 stash, whole runs,
port-CPU against JAX-CPU.

Each step of the bf16 block agrees with the JAX kernels within the sums'
order (``tests/test_torch_bf16_block.py``), but over a run Adam grows those
rounding differences. This file measures how far: ``chip_smoke.py``'s
``train_bf16_block`` model (the declarative whole-encoder config with
``matmul_dtype: bfloat16, stash_dtype: bfloat16``) trained by each package's
``run`` on the CPU from the port's initial weights (the JAX ``Model.init``
patched to take them), the largest relative difference of the per-epoch
losses and metrics being the drift. The test holds a narrow run (hidden 32,
192 molecules) at NARROW_RTOL; ``chip_smoke.py`` holds the full-width run
card against CPU at BF16_RUN_RTOL, chosen from the full-width drift.

The drift at full width, or with one weight tensor of the port's side
scaled by 1.03 (a fault the gate must catch), as BF16_RUN_RTOL was chosen
(its numbers are in ``chip_smoke.py``), from the repo root::

    python -m tests.test_torch_bf16_run D MOLECULES [WEIGHT_TO_SCALE] [--threads N]
"""

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke
from notorch_tpu.cli import train as jax_train_cli
from notorch_tpu.model.model import Model as JaxModel
from notorch_tpu_torch.cli import train as train_cli
from notorch_tpu_torch.model.convert import params_to_jax
from tests.test_torch_spatial import few_torch_threads  # noqa: F401 (autouse: the thread cap)

KEYS = ("train/loss", "val/loss", "val/rmse", "val/mae")
# the narrow run (hidden 32, 192 molecules) drifts 3.63e-7 at 8 threads and
# at one, and 9.2e-3 and 8.8e-2 with ffn.dense_0.weight or the block's
# weights scaled by 1.03 (python -m tests.test_torch_bf16_run 32 192
# [WEIGHT]): held at about 3x its drift
NARROW_RTOL = 1e-6


def bf16_run_drift(directory, d: int, molecules: int, scaled: str | None = None) -> tuple[float, list, list]:
    """Both packages' ``run`` of the bf16 encoder config at width ``d`` on the
    first ``molecules`` lipo molecules for chip_smoke.TRAIN_EPOCHS epochs
    (its data, optimizer and trainer), from the port's initial weights;
    ``scaled`` names a weight tensor of the port's side to scale by 1.03.
    Returns the largest relative difference of the per-epoch losses and
    metrics and both histories."""
    csv_path = chip_smoke.lipo_csv(directory, molecules)
    cfg = chip_smoke.train_config(csv_path, None, chip_smoke.bf16_block_model_cfg(d))
    cfg["trainer"].update(compilation_cache="off", prefetch=0)
    initial = params_to_jax(train_cli.prepare(cfg, "cpu")["model"].network.state_dict())
    build = train_cli.build_model

    def scaled_build(*args, **kwargs):
        model = build(*args, **kwargs)
        if scaled is not None:
            state = model.network.state_dict()
            state[scaled].mul_(1.03)
        return model

    train_cli.build_model = scaled_build
    try:
        ours = train_cli.run(cfg, device="cpu")["history"]
    finally:
        train_cli.build_model = build
    init_jax = JaxModel.init

    def from_port_weights(self, rng, batch):
        state = init_jax(self, rng, batch)
        params = jax.tree.map(jnp.asarray, initial)
        assert jax.tree.structure(params) == jax.tree.structure(state.params)
        return state.replace(params=params, opt_state=self.optimizer.init(params))

    JaxModel.init = from_port_weights
    try:
        theirs = jax_train_cli.run(cfg)["history"]
    finally:
        JaxModel.init = init_jax
    drift = max(abs(a[k] - float(b[k])) / max(abs(float(b[k])), 1e-12)
                for a, b in zip(ours, theirs) for k in KEYS)
    return drift, ours, theirs


def test_narrow_bf16_run_matches_jax(tmp_path):
    """The narrow run (hidden 32, 192 molecules, 2 epochs of 3 steps) in both
    packages: every epoch's losses and metrics within NARROW_RTOL."""
    drift, ours, theirs = bf16_run_drift(tmp_path, 32, 192)
    assert len(ours) == len(theirs) == chip_smoke.TRAIN_EPOCHS
    assert np.isfinite([h["train/loss"] for h in ours]).all()
    assert drift <= NARROW_RTOL, (drift, ours, theirs)


if __name__ == "__main__":
    import argparse
    import json
    import tempfile
    from pathlib import Path
    import time

    import torch

    parser = argparse.ArgumentParser(description="port-CPU against JAX-CPU drift of a whole bf16 encoder run")
    parser.add_argument("d", type=int)
    parser.add_argument("molecules", type=int)
    parser.add_argument("scaled", nargs="?", help="a weight tensor of the port's side to scale by 1.03")
    parser.add_argument("--threads", type=int, help="torch's CPU threads (JAX's follow XLA_FLAGS)")
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    if args.threads:
        torch.set_num_threads(args.threads)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        drift, ours, theirs = bf16_run_drift(Path(tmp), args.d, args.molecules, args.scaled)
    print(json.dumps({"d": args.d, "molecules": args.molecules, "scaled": args.scaled,
                      "threads": torch.get_num_threads(), "drift": drift,
                      "port": [{k: float(h[k]) for k in KEYS} for h in ours],
                      "jax": [{k: float(h[k]) for k in KEYS} for h in theirs],
                      "seconds": time.perf_counter() - t0}))
