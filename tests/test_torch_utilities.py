"""The training utilities of the port against the JAX package on the CPU:
the cosine schedules against optax, ``build_optimizer``'s precedence, the
``${csv:}``/``${parquet:}``/``${len:}`` resolvers and parquet tables, the
metric loggers' files, ``grad_norm``, ``assert_finite``, ``debug_nans``,
``trace``/``annotate``/``StepTimer``, and the fused block's
``backward="jnp"`` against ``backward="stash"`` and JAX's
``fused_dense_mpnn_block_trainable`` (interpret mode) at
test_torch_block.py's tolerance (rtol = atol = 1e-4)."""

import csv
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from notorch_tpu.cli.train import resolve_config as jax_resolve_config
from notorch_tpu.kernels.dense_mpnn import fused_dense_mpnn_block_trainable as jax_trainable
from notorch_tpu.training import logging as jax_logging
from notorch_tpu.training.debugging import grad_norm as jax_grad_norm
from notorch_tpu_torch.cli.train import Table, build_dataset, build_optimizer, resolve_config, run
from notorch_tpu_torch.data.dense import pack_graphs_dense
from notorch_tpu_torch.kernels.dense_mpnn import FusedDenseMpnnBlockFn
from notorch_tpu_torch.nn.chemprop_dense import DenseGraphEmbedding, FusedDenseChempropBlock
from notorch_tpu_torch.training import logging as port_logging
from notorch_tpu_torch.training.debugging import assert_finite, debug_nans, grad_norm
from notorch_tpu_torch.training.profiling import StepTimer, annotate, device_sync, trace
from notorch_tpu_torch.training.schedulers import cosine_decay_schedule, warmup_cosine_decay_schedule
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIPE = Pipeline(SmiToMol(), MolToGraph())
SMIS = ["CCO", "c1ccccc1C(=O)O", "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "NC(=O)c1ccccc1", "O",
        "CC(=O)Nc1ccc(O)cc1", "C1CCNCC1", "FC(F)(F)c1ccccc1"]
TOL = dict(rtol=1e-4, atol=1e-4)
COSINE = [{"init_value": 1e-3, "decay_steps": 150},
          {"init_value": 1e-3, "decay_steps": 120, "alpha": 0.1, "exponent": 2.0}]
WARMUP_COSINE = [{"init_value": 0.0, "peak_value": 1e-3, "warmup_steps": 20, "decay_steps": 150,
                  "end_value": 1e-5},
                 {"init_value": 1e-4, "peak_value": 1e-3, "warmup_steps": 10, "decay_steps": 180, "exponent": 1.5}]


def _rel(got, ref):
    return np.abs(np.asarray(got) - ref) / np.maximum(np.abs(ref), 1e-30)


@pytest.mark.parametrize("kind, kw", [("cosine", c) for c in COSINE] + [("warmup_cosine", c) for c in WARMUP_COSINE])
def test_schedules_match_optax_and_drive_the_optimizer(kind, kw):
    steps = np.arange(201)
    ref_fn = optax.cosine_decay_schedule if kind == "cosine" else optax.warmup_cosine_decay_schedule
    ours = cosine_decay_schedule if kind == "cosine" else warmup_cosine_decay_schedule
    ref = np.asarray(jax.vmap(ref_fn(**kw))(jnp.asarray(steps)))
    assert _rel([ours(**kw)(int(s)) for s in steps], ref).max() <= 1e-6
    spec = build_optimizer({"name": "adam", "schedule": {kind: kw}})
    assert _rel([spec.lr(int(s)) for s in steps], ref).max() <= 1e-6
    # optax evaluates the schedule at the count before it increments
    w = torch.nn.Parameter(torch.zeros(3))
    opt, sched = spec.build([w])
    for step in range(4):
        assert opt.param_groups[0]["lr"] == spec.lr(step)
        w.grad = torch.ones(3)
        opt.step()
        sched.step()


def test_schedule_precedence_is_jax_s():
    noam = {"warmup_steps": 10, "cooldown_steps": 100, "init_lr": 1e-4, "max_lr": 1e-3, "final_lr": 1e-4}
    both = build_optimizer({"schedule": {"warmup_cosine": WARMUP_COSINE[0], "cosine": COSINE[0], "noam": noam}})
    assert both.lr(0) == pytest.approx(1e-4, rel=1e-6)  # noam first
    two = build_optimizer({"schedule": {"warmup_cosine": WARMUP_COSINE[0], "cosine": COSINE[0]}})
    assert two.lr(0) == pytest.approx(1e-3, rel=1e-6)  # then cosine
    assert build_optimizer({"lr": 3e-4, "schedule": {"other": {}}}).lr == 3e-4  # none named: the rate


@pytest.fixture(scope="module")
def lipo64(tmp_path_factory):
    import pandas as pd

    d = tmp_path_factory.mktemp("data")
    with open(os.path.join(ROOT, "tests", "data", "lipo.csv")) as f:
        rows = list(csv.reader(f))[:65]
    with open(d / "lipo64.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    pd.read_csv(d / "lipo64.csv").to_parquet(d / "lipo64.parquet")
    return d / "lipo64.csv", d / "lipo64.parquet"


@pytest.mark.parametrize("form", ["csv", "parquet"])
def test_resolvers_give_jax_s_row_counts_and_dataset(lipo64, form):
    path = lipo64[0] if form == "csv" else lipo64[1]
    cfg = {"data": {"csv": f"${{{form}:{path}}}", "targets": {"y": {"columns": ["lipo"]}}},
           "trainer": {"steps": "${len:data.csv}", "items": ["${len:data.csv}", 3]}}
    ours, theirs = resolve_config(cfg), jax_resolve_config(cfg)
    assert isinstance(ours["data"]["csv"], Table)
    assert ours["trainer"] == theirs["trainer"] == {"steps": 64, "items": [64, 3]}
    assert list(ours["data"]["csv"]) == list(theirs["data"]["csv"].columns) == ["smiles", "lipo"]
    ds = build_dataset(ours["data"])
    ref = theirs["data"]["csv"]
    assert [r["smiles"] for r in ds.records] == list(ref["smiles"])
    np.testing.assert_array_equal(ds._target_arrays["y"][:, 0], ref["lipo"].to_numpy(np.float32))
    for i in (0, 31, 63):
        g, want = ds[i]["G"], PIPE(ref["smiles"][i])
        assert all(np.array_equal(getattr(g, f), getattr(want, f)) for f in ("node_types", "edge_types", "src"))


def test_parquet_table_trains_as_its_csv(lipo64, tmp_path, capsys):
    def cfg(data):
        return {"data": {**data, "targets": {"y": {"columns": ["lipo"]}},
                         "split": {"fractions": [0.75, 0.25, 0.0], "seed": 0}},
                "model": {"kind": "dmpnn", "hidden_dim": 16, "depth": 2},
                "trainer": {"epochs": 1, "batch_size": 16, "seed": 0}}

    ref = run(cfg({"csv": str(lipo64[0])}), device="cpu")["history"]
    for data in ({"parquet": str(lipo64[1])}, {"csv": str(lipo64[1])}, {"csv": f"${{parquet:{lipo64[1]}}}"}):
        got = run(cfg(data), device="cpu")["history"]
        assert [{k: v for k, v in r.items() if k != "time"} for r in got] == \
            [{k: v for k, v in r.items() if k != "time"} for r in ref]


def test_parquet_without_pyarrow_names_it(monkeypatch, lipo64):
    import builtins

    real = builtins.__import__

    def no_pyarrow(name, *args, **kwargs):
        if name.startswith("pyarrow"):
            raise ImportError("No module named 'pyarrow'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    with pytest.raises(ImportError, match="pyarrow"):
        build_dataset({"parquet": str(lipo64[1])})
    assert len(build_dataset({"csv": str(lipo64[0])})) == 64  # CSV needs no pyarrow


RECORDS = [{"epoch": 0, "train/loss": 1.23456789, "name": "run"},
           {"epoch": 1, "train/loss": 0.5, "val/rmse": 2.0 / 3.0}]


def test_loggers_write_jax_s_files(tmp_path):
    for package, records in ((jax_logging, [{k: jnp.asarray(v) if isinstance(v, float) else v
                                             for k, v in r.items()} for r in RECORDS]),
                             (port_logging, [{k: torch.tensor(v) if isinstance(v, float) else v
                                              for k, v in r.items()} for r in RECORDS])):
        d = tmp_path / package.__name__.split(".")[0]
        out = io.StringIO()
        sink = package.MultiLogger(package.JSONLLogger(d / "log.jsonl"), package.CSVLogger(d / "log.csv"),
                                   package.StdoutLogger(out))
        for r in records:
            sink(r)
        (d / "stdout.txt").write_text(out.getvalue())
    a, b = tmp_path / "notorch_tpu", tmp_path / "notorch_tpu_torch"
    for name in ("log.csv", "stdout.txt"):
        assert (a / name).read_text() == (b / name).read_text()
    ja = [json.loads(line) for line in (a / "log.jsonl").read_text().splitlines()]
    jb = [json.loads(line) for line in (b / "log.jsonl").read_text().splitlines()]
    assert [list(r) for r in ja] == [list(r) for r in jb]
    assert [{k: v for k, v in r.items() if k != "wall_time"} for r in ja] == \
        [{k: v for k, v in r.items() if k != "wall_time"} for r in jb]


def test_grad_norm_matches_jax_and_assert_finite_names_entries():
    rng = np.random.default_rng(0)
    grads = {"w": rng.standard_normal((5, 7)).astype(np.float32), "b": [rng.standard_normal(3).astype(np.float32)]}
    ref = jax_grad_norm({k: jax.tree.map(jnp.asarray, v) for k, v in grads.items()})
    got = grad_norm({"w": torch.from_numpy(grads["w"]), "b": [torch.from_numpy(grads["b"][0])]})
    assert got == pytest.approx(ref, rel=1e-6)
    lin = torch.nn.Linear(4, 3)
    lin(torch.ones(2, 4)).sum().backward()
    ref = jax_grad_norm([jnp.asarray(p.grad.numpy()) for p in lin.parameters()])
    assert grad_norm(lin) == pytest.approx(ref, rel=1e-6)

    assert_finite(lin, "model")
    with torch.no_grad():
        lin.bias[1] = float("nan")
    with pytest.raises(FloatingPointError, match=r"model: \['bias'\]"):
        assert_finite(lin, "model")
    bad = {"a": torch.ones(2), "b": [np.array([1.0, np.inf]), torch.zeros(1, dtype=torch.int64)]}
    with pytest.raises(FloatingPointError, match=r"grads: \[\"\['b'\]\[0\]\"\]"):
        assert_finite(bad, "grads")


class _Log(torch.nn.Module):
    def forward(self, x):
        return torch.log(x)


def test_debug_nans_raises_in_forward_and_backward_and_restores():
    was = torch.is_anomaly_enabled()
    with debug_nans():
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="_Log"):
            _Log()(torch.tensor([-1.0, 2.0]))
        x = torch.tensor([0.0, 4.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):  # sqrt's backward at 0: 0 * inf
            torch.autograd.grad((torch.sqrt(x) * 0.0).sum(), x)
    assert torch.is_anomaly_enabled() == was
    _Log()(torch.tensor([-1.0]))  # outside the block: no check
    with debug_nans(False):
        _Log()(torch.tensor([-1.0]))


def test_trace_holds_the_annotation_and_step_timer_counts(tmp_path):
    timer = StepTimer(sync_every=2)
    timer.start()
    with trace(tmp_path / "trace"):
        for _ in range(4):
            with annotate("port_train_step"):
                out = torch.ones(64, 64) @ torch.ones(64, 64)
            timer.step(out)
    files = list((tmp_path / "trace").glob("trace.*.json"))
    assert len(files) == 1 and "port_train_step" in files[0].read_text()
    assert len(timer._times) == 2 and timer.steps_per_sec() > 0
    summary = timer.summary(edges_per_step=100, depth=3)
    assert summary["edges_per_sec"] == pytest.approx(summary["steps_per_sec"] * 300)
    assert device_sync({"a": [torch.full((2, 2), 0.5)]}) == 2.0 and device_sync({}) == 0.0


def _block_inputs(depth, d=32, E=64, V=40, seed=0):
    G = pack_graphs_dense([PIPE(s) for s in SMIS], V, E, bin_cap=4, np_out=True)
    rng = np.random.default_rng(seed)
    B = G.src.shape[0]
    return dict(
        h0=rng.standard_normal((B, E, d)).astype(np.float32), src=G.src, dst=G.dst, edge_mask=G.edge_mask,
        W=(rng.standard_normal((depth, d, d)) / np.sqrt(d)).astype(np.float32),
        b=(0.1 * rng.standard_normal((depth, d))).astype(np.float32),
        g=(rng.standard_normal((B, E, d)) * G.edge_mask[..., None]).astype(np.float32), n_nodes=V)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("residual", [True, False])
def test_jnp_backward_matches_jax_and_the_stash_path(reduce, residual):
    depth = 3
    x = _block_inputs(depth, seed=4)
    ref_out, vjp = jax.vjp(
        lambda h, w, b: jax_trainable(h, x["src"], x["dst"], x["edge_mask"], w, b, depth, x["n_nodes"], residual,
                                      2, True, None, reduce), x["h0"], x["W"], x["b"])
    ref = vjp(jnp.asarray(x["g"]))
    grads = {}
    for backward in ("jnp", "stash"):
        leaves = [torch.from_numpy(x[k]).requires_grad_() for k in ("h0", "W", "b")]
        out = FusedDenseMpnnBlockFn.apply(leaves[0], torch.from_numpy(x["src"]), torch.from_numpy(x["dst"]),
                                          torch.from_numpy(x["edge_mask"]), leaves[1], leaves[2], depth,
                                          x["n_nodes"], residual, reduce, backward)
        out.backward(torch.from_numpy(x["g"]))
        grads[backward] = [t.grad for t in leaves]
        if backward == "jnp":
            np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), **TOL)
    for ours, stash, theirs in zip(grads["jnp"], grads["stash"], ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)
        assert (ours - stash).abs().max() <= 1e-5 * stash.abs().max()


def test_jnp_backward_through_the_block():
    G = pack_graphs_dense([PIPE(s) for s in SMIS], 40, 64, mol_cap=10, bin_cap=4)
    embed = DenseGraphEmbedding(60, 20, hidden_dim=32)
    embed.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        G = embed(G)
    cot = torch.randn(G.node_feats.shape, generator=torch.Generator().manual_seed(3))
    blocks = {}
    for backward in ("stash", "jnp"):
        block = FusedDenseChempropBlock(hidden_dim=32, depth=3, backward=backward)
        block.reset_parameters(torch.Generator().manual_seed(1))
        (block(G).node_feats * cot).sum().backward()
        blocks[backward] = block
    for name in ("weight", "bias"):
        a, b = getattr(blocks["jnp"], name).grad, getattr(blocks["stash"], name).grad
        assert (a - b).abs().max() <= 1e-5 * b.abs().max(), name
