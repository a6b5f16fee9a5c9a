"""Whole runs of bf16 models, port-CPU against JAX-CPU: ``model.dtype:
bfloat16`` on the D-MPNN recipe (the plain dense layout), the GAT recipe on
the flat layout, the graph-transformer recipe (its einsum core) and the
declarative graph transformer on TPU kernel rows 12b-13b (the JAX side in
interpret mode), each trained by its package's ``run`` on the CPU from the
port's initial weights (the JAX ``Model.init`` patched to take them), the
largest relative difference of the per-epoch losses and metrics being the
drift.

Each run is narrow (hidden 32, depth 2, 192 molecules, 2 epochs of 3
steps of ``chip_smoke.py``'s recipe: Adam with the Noam schedule). The
drifts measured are beside ``RUN_RTOL`` (python -m
tests.test_torch_bf16_model_run KIND [WEIGHT] prints one, with WEIGHT a
port tensor to scale by 1.03); each run is held at about 3x its drift,
under what the scaled weight gives.
"""

import jax
import jax.numpy as jnp
import pytest

import chip_smoke
from notorch_tpu.cli import train as jax_train_cli
from notorch_tpu.model.model import Model as JaxModel
from notorch_tpu_torch.cli import train as train_cli
from notorch_tpu_torch.model.convert import params_to_jax

KEYS = ("train/loss", "val/loss", "val/rmse", "val/mae")
D, DEPTH, MOLECULES = 32, 2, 192
# port-CPU against JAX-CPU drift of each narrow run (8 threads): D-MPNN
# 4.29e-4, flat GAT 8.58e-4, graph transformer 9.65e-4, declarative 7.54e-4;
# with the port's ffn.dense_0.weight scaled by 1.03 (python -m
# tests.test_torch_bf16_model_run KIND ffn.dense_0.weight, 2 threads) 5.4e-2,
# 3.2e-2, 6.4e-3 and 8.0e-3. Each gate lies about 3x over the first and under
# the second
RUN_RTOL = {"dmpnn": 1.3e-3, "gat_flat": 2.6e-3, "transformer": 3e-3, "declarative": 2.3e-3}


def model_cfg(kind: str) -> dict:
    """The model section of a bf16 run at width D and depth DEPTH."""
    if kind == "declarative":
        cfg = chip_smoke.bf16_transformer_model_cfg(D, DEPTH, 4)
        cfg["modules"]["mp"]["args"]["interpret"] = True  # the JAX side's Pallas kernels on the CPU
        return cfg
    base = {"dmpnn": chip_smoke.MODEL_CFG, "gat_flat": {**chip_smoke.GAT_CFG, "layout": "flat"},
            "transformer": chip_smoke.GT_CFG}[kind]
    return {**base, "hidden_dim": D, "depth": DEPTH, "dtype": "bfloat16"}


def run_drift(directory, kind: str, scaled: str | None = None) -> tuple[float, list, list]:
    """Both packages' ``run`` of a bf16 model kind from the port's initial
    weights; ``scaled`` names a port weight tensor to scale by 1.03.
    Returns the largest relative difference of the per-epoch losses and
    metrics, and both histories."""
    csv_path = chip_smoke.lipo_csv(directory, MOLECULES)
    cfg = chip_smoke.train_config(csv_path, None, model_cfg(kind))
    cfg["trainer"].update(compilation_cache="off", prefetch=0)
    initial = params_to_jax(train_cli.prepare(cfg, "cpu")["model"].network.state_dict())
    build = train_cli.build_model

    def scaled_build(*args, **kwargs):
        model = build(*args, **kwargs)
        if scaled is not None:
            model.network.state_dict()[scaled].mul_(1.03)
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


@pytest.mark.parametrize("kind", list(RUN_RTOL))
def test_bf16_run_matches_jax(tmp_path, kind):
    drift, ours, theirs = run_drift(tmp_path, kind)
    assert len(ours) == len(theirs) == chip_smoke.TRAIN_EPOCHS
    assert drift <= RUN_RTOL[kind], (drift, ours, theirs)


if __name__ == "__main__":
    import argparse
    import json
    import tempfile
    import time
    from pathlib import Path

    import torch

    parser = argparse.ArgumentParser(description="port-CPU against JAX-CPU drift of a narrow bf16 run")
    parser.add_argument("kind", choices=list(RUN_RTOL))
    parser.add_argument("scaled", nargs="?", help="a weight tensor of the port's side to scale by 1.03")
    parser.add_argument("--threads", type=int, help="torch's CPU threads")
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    if args.threads:
        torch.set_num_threads(args.threads)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        drift, ours, theirs = run_drift(Path(tmp), args.kind, args.scaled)
    print(json.dumps({"kind": args.kind, "scaled": args.scaled, "threads": torch.get_num_threads(), "drift": drift,
                      "port": [{k: float(h[k]) for k in KEYS} for h in ours],
                      "jax": [{k: float(h[k]) for k in KEYS} for h in theirs],
                      "seconds": time.perf_counter() - t0}))
