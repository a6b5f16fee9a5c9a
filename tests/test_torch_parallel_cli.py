"""``trainer.spmd`` through the train CLI, on 4 gloo processes under
``torchrun``, against the JAX package's ``run`` on 4 of the conftest's
virtual devices with the same overrides.

- ``configs/dmpnn_halo.yaml`` (``model.partition: halo``) at
  ``trainer.spmd={data: 2, graph: 2}``, hidden 16, depth 2, 2 epochs on a
  128-row lipo CSV: ``torchrun --standalone --nproc-per-node 4 -m
  notorch_tpu_torch train ... --cpu`` (``--standalone`` rendezvouses on a
  free localhost port); rank 0 alone prints the epoch lines.
- ``configs/pcqm4m_pretrain.yaml`` with the molecule partition on the same
  mesh, on ``tests/data/smis.csv``.
- In one process (a world of one): a supervised ``spmd`` without the halo
  partition raises JAX's ``ValueError``, and the shipped halo config's 2 x
  4 mesh raises ``make_mesh``'s.

Both packages start from the port's initial weights (the JAX
``SpmdTrainer.init`` is handed them), and every epoch's loss agrees with
JAX's at 1e-4 (the JAX CLI test's own tolerance,
``tests/test_halo.py::test_halo_cli_parity``).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from notorch_tpu.cli.train import apply_overrides as jax_apply_overrides
from notorch_tpu.cli.train import load_config as jax_load_config
from notorch_tpu.cli.train import run as jax_run
from notorch_tpu.parallel.spmd import SpmdTrainer as JaxSpmdTrainer
from notorch_tpu_torch.cli.train import apply_overrides, load_config, prepare, run
from notorch_tpu_torch.model.convert import params_to_jax
from notorch_tpu_torch.models.pretrain import build_masked_atom_pretrainer

from .test_torch_gat import ROOT, lipo_head

EPOCH_RTOL = 1e-4
HALO = ["model.hidden_dim=16", "model.depth=2", "trainer.epochs=2", "trainer.batch_size=32",
        "trainer.spmd={data: 2, graph: 2}"]
PRETRAIN = ["model.hidden_dim=16", "model.depth=2", "trainer.epochs=2", "trainer.batch_size=16",
            "trainer.spmd={data: 2, graph: 2}", "data.csv=tests/data/smis.csv", "data.limit=64"]


def torchrun(config: str, overrides: list[str]) -> list[dict]:
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
                           "-m", "notorch_tpu_torch", "train", config, *overrides, "--cpu"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]


def jax_history(config: str, overrides: list[str], initial: dict, monkeypatch) -> list[float]:
    """The JAX run's epoch losses, its SpmdTrainer started from ``initial``
    (the port's initial weights, as a JAX tree)."""
    init_jax = JaxSpmdTrainer.init

    def from_port_weights(self, rng, batch):
        state = init_jax(self, rng, batch)
        params = jax.tree.map(jnp.asarray, initial)
        assert jax.tree.structure(params) == jax.tree.structure(state.params)
        return state.replace(params=params, opt_state=self.model.optimizer.init(params))

    monkeypatch.setattr(JaxSpmdTrainer, "init", from_port_weights)
    cfg = jax_apply_overrides(jax_load_config(config), list(overrides))
    return [h["train/loss"] for h in jax_run(cfg)["history"]]


@pytest.fixture(scope="module")
def lipo128(tmp_path_factory):
    return lipo_head(tmp_path_factory.mktemp("cli") / "lipo128.csv", 128)


def test_halo_config_under_torchrun_matches_jax(lipo128, monkeypatch):
    overrides = [*HALO, f"data.csv={lipo128}"]
    lines = torchrun("configs/dmpnn_halo.yaml", overrides)
    assert [r["epoch"] for r in lines] == [0, 1]  # rank 0 alone prints
    losses = [r["train/loss"] for r in lines]
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    initial = params_to_jax(prepare(apply_overrides(load_config("configs/dmpnn_halo.yaml"), list(overrides)),
                                    "cpu")["model"].network.state_dict())
    np.testing.assert_allclose(losses, jax_history("configs/dmpnn_halo.yaml", overrides, initial, monkeypatch),
                               rtol=EPOCH_RTOL)


def test_molecule_partitioned_pretraining_under_torchrun_matches_jax(monkeypatch):
    lines = torchrun("configs/pcqm4m_pretrain.yaml", PRETRAIN)
    assert [r["epoch"] for r in lines] == [0, 1]
    model = build_masked_atom_pretrainer(hidden_dim=16, depth=2, generator=torch.Generator().manual_seed(0))
    initial = params_to_jax(model.network.state_dict())
    np.testing.assert_allclose([r["train/loss"] for r in lines],
                               jax_history("configs/pcqm4m_pretrain.yaml", PRETRAIN, initial, monkeypatch),
                               rtol=EPOCH_RTOL)


def test_spmd_refusals_match_jax(lipo128):
    """What JAX refuses, the port refuses with the same exception: a
    supervised spmd run without the halo partition; and a mesh that does
    not match the devices (the shipped halo config's 2 x 4 on one process
    here, as on a machine with one card)."""
    cfg = apply_overrides(load_config("configs/dmpnn_regression.yaml"),
                          [f"data.csv={lipo128}", "trainer.spmd={data: 1}"])
    with pytest.raises(ValueError, match="supports model.partition: halo"):
        run(cfg, device="cpu")
    with pytest.raises(ValueError, match="supports model.partition: halo"):
        jax_run(jax_apply_overrides(jax_load_config("configs/dmpnn_regression.yaml"),
                                    [f"data.csv={lipo128}", "trainer.spmd={data: 1}"]))
    shipped = apply_overrides(load_config("configs/dmpnn_halo.yaml"), [f"data.csv={lipo128}"])
    with pytest.raises(ValueError, match=r"mesh \{'data': 2, 'graph': 4\} does not match 1 devices"):
        run(shipped, device="cpu")
