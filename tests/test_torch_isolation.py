"""The port stands alone: importing every module of ``notorch_tpu_torch``
(and everything ``chip_smoke.py`` imports) loads neither JAX nor the JAX
package (nor ``h5py``, which only the HDF5 databases import, nor
``triton``, nor ``pandas`` or ``pyarrow``, which the card's machine lacks
and only a parquet table imports), and an entry point asked for the card where there is none raises
instead of running on the CPU."""

import json
import os
import subprocess
import sys

import pytest
import torch

from notorch_tpu_torch.cli import predict as predict_cli
from notorch_tpu_torch.cli import train as train_cli
from notorch_tpu_torch.utils import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import notorch_tpu_torch
names = [m.name for m in pkgutil.walk_packages(notorch_tpu_torch.__path__, "notorch_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "notorch_tpu", "h5py", "triton",
                                       "pandas", "pyarrow"))
print(json.dumps({"modules": names, "banned": banned}))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("kernels.dense_mpnn", "kernels.csr_segment", "kernels.dense_attention", "data.graph", "nn.ops",
                 "nn.embed", "nn.chemprop", "nn.agg", "nn.attention", "nn.attention_dense", "models.dmpnn",
                 "models.gat", "model.convert", "transforms.graph", "kernels.gvp_conv", "data.point_cloud",
                 "nn.rbf", "nn.spatial.neighbors", "nn.spatial.pointwise", "nn.spatial.agg", "nn.spatial.gvp",
                 "models.spatial",
                 "data.dataset", "data.batching", "cli.predict", "cli.registry", "cli.train", "tasks.losses", "tasks.metrics",
                 "training.loop", "training.checkpoint", "training.optim", "training.schedulers",
                 "nn.functional", "nn.glue", "nn.moe", "models.multicomponent", "models.pretrain",
                 "chem.fingerprint", "transforms.mol", "transforms.reaction",
                 "data.databases", "data.gvp", "exceptions", "transforms.point_cloud", "nn.spatial.schnet",
                 "nn.spatial.painn", "nn.dropout", "nn.init", "nn.mlp", "nn.chemprop_dense", "utils",
                 "native", "training.profiling", "training.debugging", "training.logging",
                 "parallel", "parallel.collectives", "parallel.dense_dp", "parallel.distributed", "parallel.expert",
                 "parallel.halo", "parallel.loader", "parallel.mesh", "parallel.partition", "parallel.spmd",
                 "data.halo", "__main__"):
        assert f"notorch_tpu_torch.{name}" in report["modules"]
    assert report["banned"] == []


def test_entry_point_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_cli.run_predict(tmp_path, tmp_path / "in.csv")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_cli.main([str(tmp_path), str(tmp_path / "in.csv")])
    cfg = {"data": {"csv": str(tmp_path / "in.csv")}, "trainer": {"checkpoint_dir": str(tmp_path / "c")}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.run(cfg)
    assert not (tmp_path / "c").exists()  # refused before it built or wrote anything
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_card():
    """No card: chip_smoke exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke runs for real there")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
