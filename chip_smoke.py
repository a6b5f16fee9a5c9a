"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of ``notorch_tpu_torch`` from the sources in this
checkout, holds each against its plain PyTorch version on the card, serves
the D-MPNN regression model of ``configs/dmpnn_regression.yaml`` (hidden
256, depth 3, mean readout, 1 FFN layer; random weights from a seed) on the
first 512 molecules of ``tests/data/lipo.csv`` through ``run_predict``,
checks that the request went through the kernel and matches the plain CPU
path, and times the kernel. Each phase prints one JSON line; the line
before the last is the card's name and power limit as ``nvidia-smi`` gives
them, and the last line is ``{"ok": true, "device": {...}}``. Any failure
exits non-zero without that line; so does a machine with no CUDA device.
"""

from __future__ import annotations

import csv
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from notorch_tpu_torch.cli.predict import run_predict
from notorch_tpu_torch.cli.train import build_dataset, save_predict_meta
from notorch_tpu_torch.data.batching import DataLoader
from notorch_tpu_torch.data.dense import pack_graphs_dense
from notorch_tpu_torch.kernels import build
from notorch_tpu_torch.kernels.dense_mpnn import (
    dense_mpnn_block_reference,
    edge_adjacency,
    fused_dense_mpnn_block,
)
from notorch_tpu_torch.models.dmpnn import build_dmpnn
from notorch_tpu_torch.training.checkpoint import Checkpointer

ROOT = Path(__file__).resolve().parent
N_MOLS, BATCH, SEED = 512, 64, 0
# the model of configs/dmpnn_regression.yaml (read without a YAML parser,
# which the card's machine may lack)
MODEL_CFG = {"kind": "dmpnn", "hidden_dim": 256, "depth": 3, "aggregation": "mean",
             "ffn_layers": 1, "layout": "dense_packed"}
# kernel vs plain and card vs CPU: both sides exact f32 (no TF32), summed in
# another order (FMA over k, sparse rows vs dense bmm) through depth 3
RTOL = ATOL = 1e-4
# H100 SXM peaks at its 700 W limit (NVIDIA data sheet): CUDA-core f32 rate
# and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def lipo_csv(directory: Path) -> Path:
    path = directory / f"lipo_head{N_MOLS}.csv"
    with open(ROOT / "tests" / "data" / "lipo.csv", newline="") as f:
        rows = list(csv.reader(f))[: N_MOLS + 1]
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return path


def kernel_inputs(G, d: int, depth: int, seed: int) -> list[torch.Tensor]:
    """Seeded h0/W/b on the index arrays of a real packed batch, on the card."""
    rng = np.random.default_rng(seed)
    B, E = G.src.shape
    h0 = rng.standard_normal((B, E, d)).astype(np.float32)
    W = (rng.standard_normal((depth, d, d)) / np.sqrt(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal((depth, d))).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(x)).cuda()
            for x in (h0, G.src, G.dst, G.edge_mask, W, b)]


def compare(args, depth: int, residual: bool, reduce: str, n_nodes: int) -> dict:
    out = fused_dense_mpnn_block(*args, depth=depth, n_nodes=n_nodes, residual=residual, reduce=reduce)
    ref = dense_mpnn_block_reference(*args, depth=depth, residual=residual, reduce=reduce)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    rec = {
        "shape": list(args[0].shape), "reduce": reduce, "residual": residual,
        "max_abs_err": float(err.max()),
        "max_abs_err_over_max_abs_ref": float(err.max() / ref.abs().max()),
        "within_tol": bool((err <= ATOL + RTOL * ref.abs()).all()),
        "finite": bool(torch.isfinite(out).all()),
    }
    if not (rec["within_tol"] and rec["finite"]):
        fail(f"kernel disagrees with its plain version: {rec}")
    return rec


def _elapsed_ms(run, iters: int) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_ms(fn, reps: int = 20, iters: int = 10, warmup: int = 3) -> dict:
    """Milliseconds per call of ``fn`` on the card, after a warm-up, with
    CUDA events. ``device``: ``reps`` calls captured in one CUDA graph and
    replayed ``iters`` times, so the host's launch cost stays out of the
    reading. ``eager``: ``reps * iters`` calls launched one by one from
    Python, as the serving path launches them. The inputs stay in the L2
    cache between calls, as they do on the serving path, where the gather
    before the block has just written ``h0``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as graph capture asks
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    eager = _elapsed_ms(fn, reps * iters)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    device = _elapsed_ms(graph.replay, iters) / reps
    del graph
    return {"device": device, "eager": eager}


def block_bound(args, depth: int, reduce: str) -> tuple[float, str, dict]:
    """Least time for the block on these inputs: the larger of its operations
    over the f32 peak and its bytes (inputs read once, output written once)
    over the memory rate. Operations count the W products and the nonzeros
    of this data's A, not E x E."""
    h0, src, dst, mask, W, b = args
    B, E, d = h0.shape
    nnz = int((edge_adjacency(src, dst, mask, mean=reduce == "mean") != 0).sum())
    ops = depth * (2 * B * E * d * d + 2 * nnz * d)
    nbytes = sum(t.numel() * t.element_size() for t in args) + h0.numel() * h0.element_size()
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, {"operations": ops, "bytes": nbytes, "nnz_A": nnz}


def profile_request(ckpt: Path, csv_path: Path) -> dict:
    """Device time of one warm request by kernel name (torch.profiler), and
    the share of the request's wall time the card was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_predict(ckpt, csv_path, batch_size=BATCH)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda k: -k[1],
    )
    busy_ms = sum(ms for _, ms, _ in kernels)
    return {
        "request_ms": wall_ms, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
        "block_kernel_ms": sum(ms for k, ms, _ in kernels if "dense_mpnn_layer" in k),
        "top": [{"name": k[:80], "ms": ms, "count": n} for k, ms, n in kernels[:6]],
    }


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device is available; this script measures the port on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    emit(phase="device", kind=kind, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    libs = build.build(verbose=True)
    emit(phase="build", seconds=time.perf_counter() - t0, libraries=[str(p.name) for p in libs.values()])

    depth, d = MODEL_CFG["depth"], MODEL_CFG["hidden_dim"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        csv_path = lipo_csv(tmp)
        ds = build_dataset({"csv": str(csv_path), "targets": {"y": {"columns": ["lipo"]}}})
        t0 = time.perf_counter()
        batches = list(DataLoader(ds, batch_size=BATCH))
        featurize_s = time.perf_counter() - t0
        serve_G = batches[0]["inputs.G"]  # the serving shape: 32 bins of 128 edge lanes
        # wide bins: the loader's 256-lane bins, filled with the largest molecules
        wide = sorted((ds[i]["G"] for i in range(len(ds))), key=lambda g: -g.num_edges)[:BATCH]
        wide_G = pack_graphs_dense(wide, 256 // 2 + 8, 256, np_out=True)

        # kernel vs plain version at the shapes the main path gives it
        serve_args = kernel_inputs(serve_G, d, depth, SEED)
        cases = [compare(serve_args, depth, res, red, serve_G.nodes_per_graph)
                 for red in ("sum", "mean") for res in (True, False)]
        wide_args = kernel_inputs(wide_G, d, depth, SEED + 1)
        cases += [compare(wide_args, depth, True, red, wide_G.nodes_per_graph) for red in ("sum", "mean")]
        emit(phase="kernel_vs_plain", rtol=RTOL, atol=ATOL, cases=cases)

        # serve: a port checkpoint of the seeded model, then run_predict on the card
        transforms = ds.build_task_transform_configs()
        model = build_dmpnn(transforms=transforms, generator=torch.Generator().manual_seed(SEED),
                            **{k: v for k, v in MODEL_CFG.items() if k != "kind"})
        ckpt = tmp / "ckpt"
        Checkpointer(ckpt).save(model.network.state_dict(), step=0)
        save_predict_meta(ckpt, {"model": MODEL_CFG, "data": {"smiles_col": "smiles"}},
                          transforms, ds, "ffn.preds")

        fused_dense_mpnn_block.launches = 0
        t0 = time.perf_counter()
        gpu = run_predict(ckpt, csv_path, batch_size=BATCH)["lipo"]
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = fused_dense_mpnn_block.launches
        if launches != depth * len(batches):
            fail(f"the kernel ran {launches} times; the request needs {depth} x {len(batches)}")
        t0 = time.perf_counter()
        run_predict(ckpt, csv_path, batch_size=BATCH)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        profiled = profile_request(ckpt, csv_path)
        cpu = run_predict(ckpt, csv_path, batch_size=BATCH, device="cpu")["lipo"]
        err = np.abs(gpu - cpu)
        ok = gpu.shape == (N_MOLS,) and np.isfinite(gpu).all() and bool((err <= ATOL + RTOL * np.abs(cpu)).all())
        emit(phase="serve", molecules=N_MOLS, batches=len(batches), kernel_launches=launches,
             request_s_cold=cold_s, request_s_warm=warm_s, host_featurize_pack_s=featurize_s,
             profile=profiled, max_abs_err_vs_cpu=float(err.max()),
             pred_mean=float(gpu.mean()), pred_std=float(gpu.std()), ok=bool(ok))
        if not ok:
            fail("card predictions disagree with the CPU plain path or are not finite")

    # time the kernel and its plain version at the serving shape
    kw = dict(depth=depth, residual=True, reduce="sum")
    kernel_t = time_ms(lambda: fused_dense_mpnn_block(*serve_args, n_nodes=serve_G.nodes_per_graph, **kw))
    plain_t = time_ms(lambda: dense_mpnn_block_reference(*serve_args, **kw))
    ms, plain_ms = kernel_t["device"], plain_t["device"]
    bound_ms, bound_by, work = block_bound(serve_args, depth, "sum")
    emit(phase="time", shape=list(serve_args[0].shape), depth=depth, reduce="sum", ms=ms,
         plain_ms=plain_ms, eager_ms=kernel_t["eager"], plain_eager_ms=plain_t["eager"],
         bound_ms=bound_ms, bound_by=bound_by, **work,
         library_ms=None, library_note="no single PyTorch call computes the fused block")
    emit(kernels=[{
        "name": "fused_dense_mpnn_block",
        "route": "cuda",
        "source": "notorch_tpu_torch/csrc/dense_mpnn.cu",
        "replaces": "notorch_tpu/kernels/dense_mpnn.py:749",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }])
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": kind, "count": count})


if __name__ == "__main__":
    main()
