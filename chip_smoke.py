"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of ``notorch_tpu_torch`` from the sources in this
checkout and drives the port's paths with the D-MPNN regression model of
``configs/dmpnn_regression.yaml`` (hidden 256, depth 3, mean readout, 1 FFN
layer, Adam with the Noam schedule, batch 64; random weights from a seed):

- serve: ``run_predict`` of the first 512 molecules of ``tests/data/lipo.csv``
  from a checkpoint of the seeded model, against the plain CPU path;
- train: ``run(cfg)`` on the first 1,024 molecules for 2 epochs, against
  the same run on the CPU, and ``run_predict`` of the checkpoint it wrote;
- train epoch: a warm epoch timed and profiled, then an epoch with the
  recompute backward against the stash backward's;
- train declarative: ``run(cfg)`` of the same data, optimizer and trainer
  with a declarative ``model.modules`` config on the per-molecule dense
  layout, whose block is the whole fused encoder (``fuse_ends: true``), on
  the card against the CPU;
- serve declarative: ``run_predict`` of that run's checkpoint, 512
  molecules, card against CPU;
- dbuf: the double-buffered block forward, which no module calls, in a
  phase of its own;
- flat kernels: the two CSR segment sums against their plain versions at
  the first flat lipo batch and at a random case with empty and over-full
  nodes, the packed sum twice, bit for bit; the row-pointer sum, which no
  module calls, on the dst-sorted copy of each flat batch in a phase of its
  own;
- train flat: ``run(cfg)`` of the same config with ``model.impl: csr`` (the
  flat layout, every E->V reduce through the packed kernel) on the card
  against the CPU, and ``run_predict`` of its checkpoint, 512 molecules;
- train/serve declarative flat: the model of
  ``configs/declarative_example.yaml`` (hidden 128, the gather block, the
  gated readout) for one epoch, card against CPU, and its checkpoint served;
- attention kernels: the four entries of the attention core (rows 10-13)
  against their plain versions at the graph transformer's first packed
  batch, the dense loader's first and widest batches and random bins of
  V = 256, E = 512, edge bias on and off, each backward twice, bit for
  bit; rows 10-11, which no module calls, over the graph transformer's
  packed batches in a phase of their own;
- train/serve declarative attention: a declarative graph transformer
  (``DenseGATBlock`` with ``impl: fused, fwd_impl: pallas``, hidden 256,
  depth 3, 4 heads) on the per-molecule dense layout, whose every forward
  runs row 12 and every backward row 13, card against CPU, 2 epochs, then
  its checkpoint served;
- train/serve graph transformer and gat: ``configs/graph_transformer_
  regression.yaml`` (2 epochs) and ``configs/gat_regression.yaml`` (1
  epoch) as shipped, on their bins of 256 edge lanes and 128 node slots, no
  kernel of the port on their paths (nor of the JAX package on its), card
  against CPU, then served;
- GVP kernels: the fused GVP message convolution's forward and recompute
  backward (rows 14-15) against their plain versions at the GVP model's
  first training batch, clouds with empty neighbourhoods and padding rows,
  and a node count that JAX's tile halving takes down to 8, each twice, bit
  for bit;
- train/serve declarative GVP: the GVP model of ``notorch_tpu.models.
  spatial`` at full width (scalar 256, vector 32, depth 3, 16 neighbours)
  as a declarative config whose ``GvpGNNBlock(impl: fused)`` runs row 14
  in every layer's forward and row 15 in every backward, ``fit`` for 2
  epochs on 512 synthetic clouds (8 steps an epoch, a validation batch),
  card against CPU epoch by epoch and every step in lockstep, then
  ``predict`` of the 512 clouds from its checkpoint;
- train/serve GVP recipe: ``kind: spatial, backbone: gvp`` (its conv the
  plain tensor ops, no kernel of the port), one epoch, card against CPU,
  then served.

Every kernel is held against its plain PyTorch version on the card at the
shapes these paths give it, each path's launch counts are read, and the
kernels are timed. Each phase prints one JSON line; then come a ``kernels``
line, the card's name and power limit as ``nvidia-smi`` gives them, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero without that
line; so does a machine with no CUDA device.
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
from notorch_tpu_torch.cli.train import build_dataset, build_model, prepare, run, save_predict_meta
from notorch_tpu_torch.data.batching import DataLoader
from notorch_tpu_torch.data.dense import pack_graphs_dense
from notorch_tpu_torch.data.graph import csr_row_ptr, pack_edges_by_tile, sort_edges_by_dst
from notorch_tpu_torch.data.point_cloud import (
    PointCloud,
    cloud_batches,
    coordination_targets,
    make_clouds,
    pad_point_clouds,
)
from notorch_tpu_torch.kernels import build, gvp_conv
from notorch_tpu_torch.kernels.csr_segment import (
    csr_segment_sum,
    csr_segment_sum_packed,
    csr_segment_sum_packed_reference,
    csr_segment_sum_reference,
)
from notorch_tpu_torch.kernels.dense_attention import (
    dense_attention_bwd_reference,
    dense_attention_reference,
    fused_dense_attention_bwd,
    fused_dense_attention_bwd_v2,
    fused_dense_attention_fwd,
    fused_dense_attention_fwd_v2,
)
from notorch_tpu_torch.kernels.dense_mpnn import (
    dense_encoder_bwd_reference,
    dense_encoder_reference,
    dense_mpnn_block_bwd_reference,
    dense_mpnn_block_reference,
    dense_mpnn_block_stash_reference,
    edge_adjacency,
    fused_dense_encoder_bwd,
    fused_dense_encoder_fwd,
    fused_dense_mpnn_block,
    fused_dense_mpnn_block_bwd,
    fused_dense_mpnn_block_bwd_stash,
    fused_dense_mpnn_block_dbuf,
    fused_dense_mpnn_block_stash,
)
from notorch_tpu_torch.kernels.gvp_conv import (
    fused_gvp_conv_bwd,
    fused_gvp_conv_fwd,
    gvp_conv_bwd_reference,
    gvp_conv_preactivations,
    gvp_conv_reference,
    weight_shapes,
)
from notorch_tpu_torch.models.dmpnn import build_dmpnn
from notorch_tpu_torch.models.gat import gat_loader_kwargs
from notorch_tpu_torch.training.checkpoint import Checkpointer
from notorch_tpu_torch.nn.rbf import RBFEmbedding
from notorch_tpu_torch.nn.spatial.neighbors import radius_neighbors
from notorch_tpu_torch.training.loop import fit, predict, to_device
from notorch_tpu_torch.training.optim import OptimizerSpec
from notorch_tpu_torch.transforms.vocab import DEFAULT_NUM_ATOM_TYPES, DEFAULT_NUM_BOND_TYPES

ROOT = Path(__file__).resolve().parent
N_MOLS, BATCH, SEED = 512, 64, 0
TRAIN_MOLS, TRAIN_EPOCHS = 1024, 2
# the config of configs/dmpnn_regression.yaml (written out here: the card's
# machine may lack a YAML parser)
MODEL_CFG = {"kind": "dmpnn", "hidden_dim": 256, "depth": 3, "aggregation": "mean", "ffn_layers": 1}
OPTIMIZER_CFG = {"name": "adam", "schedule": {"noam": {
    "warmup_steps": 100, "cooldown_steps": 1500, "init_lr": 1e-4, "max_lr": 1e-3, "final_lr": 1e-4}}}
# kernel vs plain and card vs CPU: both sides exact f32 (no TF32), summed in
# another order (FMA over k, sparse rows vs dense bmm) through depth 3
RTOL = ATOL = 1e-4
# gradients: atol is ATOL times the tensor's largest magnitude, because g_W
# and g_b sum B * E products each, so an element's rounding follows the size
# of the terms it sums, not its own size, which cancellation can make small
# the card's training run vs the CPU's, per-epoch means: Adam moves each
# weight by about the rate whatever its gradient's size, so a gradient that
# is round-off on both sides can move a weight by up to the rate the other
# way; over the run's steps that stays far below this, and a fault does not
TRAIN_RTOL = 1e-3
# the attention models' runs, card vs CPU: there Adam turns rounding noise
# into rate-sized steps that differ between the two devices (the
# pure-noise gradients of the biases of W_k, W_bias and GATv2's a, which
# move no softmax, and the gradient elements of the blocks' ReLU
# feed-forward that a pre-activation within rounding of zero flips on one
# device), and the runs drift apart step by step whatever computes them:
# over 26 steps the graph-transformer recipe, whose path holds no kernel of
# the port, drifted up to 1.7e-2 and the declarative graph transformer up
# to 1.5e-2 (H100, 700 W), while each step from the same weights agreed
# within 2.3e-7 in loss. So every step is checked in lockstep, from the same
# weights and optimizer state on both devices, and the whole runs only
# against a gross fault
ATTENTION_RUN_RTOL = 1e-1
# lockstep: each step's loss, relative (measured up to 2.3e-7), and each
# gradient at LOCKSTEP_GRAD_RTOL times its largest magnitude: one flipped
# ReLU unit moves a gradient element by that node's whole term (measured up
# to 1.5e-2 of a tensor's largest magnitude); a wrong or missing gradient
# term moves it by its own size. The pure-noise biases are left out
LOCKSTEP_RTOL = 1e-4
LOCKSTEP_GRAD_RTOL = 1e-1
ZERO_GRADIENTS = ("W_k.bias", "W_bias.bias", "a.bias")
# H100 SXM peaks at its 700 W limit (NVIDIA data sheet): CUDA-core f32 rate
# and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# the segment sums against their plain versions: one f32 add per term, in
# another order on each side (the plain version's atomics on the card), so an
# element's rounding follows the sum of its terms' magnitudes: atol is
# SUM_ATOL times that sum (a sink or over-full node sums thousands of terms)
SUM_ATOL = 1e-5
TPU_KERNELS = "notorch_tpu/kernels/dense_mpnn.py"
TPU_CSR = "notorch_tpu/kernels/csr_segment.py"
TPU_ATTN = "notorch_tpu/kernels/dense_attention.py"
ATTN_SOURCE = "notorch_tpu_torch/csrc/dense_attention.cu"
TPU_GVP = "notorch_tpu/kernels/gvp_conv.py"
GVP_SOURCE = "notorch_tpu_torch/csrc/gvp_conv.cu"
KERNELS = {  # wrapper -> (source, the TPU kernel's entry it replaces)
    fused_dense_mpnn_block: ("notorch_tpu_torch/csrc/dense_mpnn.cu", f"{TPU_KERNELS}:749"),
    fused_dense_mpnn_block_stash: ("notorch_tpu_torch/csrc/dense_mpnn.cu", f"{TPU_KERNELS}:436"),
    fused_dense_mpnn_block_bwd_stash: ("notorch_tpu_torch/csrc/dense_mpnn_bwd.cu", f"{TPU_KERNELS}:494"),
    fused_dense_mpnn_block_bwd: ("notorch_tpu_torch/csrc/dense_mpnn_bwd.cu", f"{TPU_KERNELS}:687"),
    fused_dense_encoder_fwd: ("notorch_tpu_torch/csrc/dense_mpnn.cu", f"{TPU_KERNELS}:999"),
    fused_dense_encoder_bwd: ("notorch_tpu_torch/csrc/dense_mpnn_bwd.cu", f"{TPU_KERNELS}:1058"),
    fused_dense_mpnn_block_dbuf: ("notorch_tpu_torch/csrc/dense_mpnn.cu", f"{TPU_KERNELS}:1272"),
    csr_segment_sum: ("notorch_tpu_torch/csrc/csr_segment.cu", f"{TPU_CSR}:245"),
    csr_segment_sum_packed: ("notorch_tpu_torch/csrc/csr_segment.cu", f"{TPU_CSR}:179"),
    fused_dense_attention_fwd: (ATTN_SOURCE, f"{TPU_ATTN}:265"),
    fused_dense_attention_bwd: (ATTN_SOURCE, f"{TPU_ATTN}:297"),
    fused_dense_attention_fwd_v2: (ATTN_SOURCE, f"{TPU_ATTN}:539"),
    fused_dense_attention_bwd_v2: (ATTN_SOURCE, f"{TPU_ATTN}:573"),
    fused_gvp_conv_fwd: (GVP_SOURCE, f"{TPU_GVP}:414"),
    fused_gvp_conv_bwd: (GVP_SOURCE, f"{TPU_GVP}:445"),
}
# the model sections of configs/graph_transformer_regression.yaml and
# configs/gat_regression.yaml (their data, optimizer and trainer sections
# are configs/dmpnn_regression.yaml's)
GT_CFG = {"kind": "graph_transformer", "hidden_dim": 256, "depth": 3, "num_heads": 4, "aggregation": "mean",
          "ffn_layers": 1}
GAT_CFG = {"kind": "gat", "hidden_dim": 256, "depth": 3, "num_heads": 4, "attention": "gatv2",
           "aggregation": "mean", "ffn_layers": 1}
# the GVP model of notorch_tpu.models.spatial at its defaults (scalar 256,
# vector 256 // 8 = 32, depth 3, radius 5, 16 neighbours, 16 RBF bases, sum
# readout, 1 FFN layer, Adam at 1e-3), its neighbour search banded at 24 (the
# synthetic clouds have at most 25 atoms); the recipe runs the plain conv
GVP_RECIPE = {"kind": "spatial", "backbone": "gvp", "hidden_dim": 256, "depth": 3, "radius": 5.0,
              "max_neighbors": 16, "neighbor_window": 24, "aggregation": "sum", "ffn_layers": 1}
GVP_LR, GVP_WINDOW = 1e-3, 24
# synthetic clouds (make_clouds: 10-25 atoms, the JAX bench's draw) with the
# coordination-number target, batches of 64 padded to a multiple of 64 nodes:
# 8 training steps an epoch and one validation batch
GVP_CLOUDS, GVP_VAL_CLOUDS, GVP_EPOCHS = 512, 64, 2
# rows 14-15's gradients against their plain versions, and the GVP runs'
# gradients card against CPU: a ReLU pre-activation within rounding of zero
# takes one side in one computation and the other side in the other, and the
# gradients then differ by that slot's whole term (at the first batch's
# 17,235 live slots the worst gradient moved by 1.7e-3 in relative L2,
# element by element by far more than ATOL: H100, 700 W).
# So the kernels' gradients are held element by element on the same inputs
# with the slots whose pre-activation in some layer lies within KINK_TOL of
# that layer's largest |pre-activation| of zero masked out on both sides
# (masking a slot changes no other slot's pre-activations), and on the
# inputs as they are, and in the GVP runs' lockstep, by each tensor's
# relative L2 distance at KINK_GRAD_L2
KINK_TOL = 1e-5
KINK_GRAD_L2 = 1e-2
# the GVP runs, card against CPU, per-epoch losses: the run starts at a loss
# near 600, and Adam, moving each weight by about the rate whatever its
# gradient's size, grows rounding differences into differences of the run.
# The same run in the port and in the JAX package, both on the CPU in exact
# float32 from the same weights, drifts apart by up to 1.17e-1 (the long test
# tests/test_torch_spatial.py::test_gvp_full_width_run_drifts_apart_in_both_
# packages), so the whole runs are held at that, and every step in lockstep
GVP_RUN_RTOL = 1.17e-1
# rows 14-15's stages in a profile: fragments of their kernels' names
GVP_STAGES = {
    fused_gvp_conv_fwd: ("fwd_weights_", "fwd_node_", "fwd_layer0_in_", "fwd_layer_gemm<0,", "fwd_layer_gemm<1,",
                         "fwd_layer_gemm<2,", "fwd_mean_"),
    fused_gvp_conv_bwd: ("sweep_", "node_grad_", "wgrad_"),
}


def declarative_model_cfg(d: int = 256, depth: int = 3) -> dict:
    """The declarative twin of MODEL_CFG on the per-molecule dense layout:
    embedding, the whole-encoder block (``fuse_ends: true``), the mean
    readout and the MLP head, with the MSE loss and the RMSE/MAE metrics."""
    keys = {"preds": "ffn.preds", "targets": "targets.y", "mask": "targets.y_mask"}
    return {
        "layout": "dense",
        "pred_key": "ffn.preds",
        "modules": {
            "embed": {"class": "DenseGraphEmbedding",
                      "args": {"num_node_types": DEFAULT_NUM_ATOM_TYPES,
                               "num_edge_types": DEFAULT_NUM_BOND_TYPES, "hidden_dim": d},
                      "in_keys": ["inputs.G"], "out_keys": ["G"]},
            "mp": {"class": "FusedDenseChempropBlock",
                   "args": {"hidden_dim": d, "depth": depth, "fuse_ends": True},
                   "in_keys": ["embed.G"], "out_keys": ["G"]},
            "readout": {"class": "DenseMean", "in_keys": ["mp.G"], "out_keys": ["H"]},
            "ffn": {"class": "MLP",
                    "args": {"input_dim": d, "output_size": 1, "hidden_dim": d, "num_layers": 1},
                    "in_keys": ["readout.H"], "out_keys": ["preds"]},
        },
        "losses": {"mse": {"class": "MSE", "in_keys": dict(keys)}},
        "metrics": {"rmse": {"class": "RMSE", "in_keys": dict(keys)},
                    "mae": {"class": "MetricMAE", "in_keys": dict(keys)}},
    }


def declarative_attention_model_cfg(d: int = 256, depth: int = 3, heads: int = 4) -> dict:
    """The declarative graph transformer on the attention kernels' path:
    declarative_model_cfg with the block DenseGATBlock(attention: sdp,
    impl: fused, fwd_impl: pallas), so that each forward runs row 12 and
    each backward row 13 in every layer."""
    cfg = declarative_model_cfg(d, depth)
    cfg["modules"]["mp"] = {"class": "DenseGATBlock",
                            "args": {"attention": "sdp", "impl": "fused", "fwd_impl": "pallas",
                                     "hidden_dim": d, "depth": depth, "num_heads": heads},
                            "in_keys": ["embed.G"], "out_keys": ["G"]}
    return cfg


def declarative_flat_model_cfg(d: int = 128) -> dict:
    """The model section of configs/declarative_example.yaml (written out:
    the card's machine may lack a YAML parser): GraphEmbedding ->
    ChempropBlock (the default gather impl) -> Gated -> MLP on the flat
    layout, the MSE loss and the RMSE metric."""
    keys = {"preds": "ffn.preds", "targets": "targets.y", "mask": "targets.y_mask"}
    return {
        "pred_key": "ffn.preds",
        "modules": {
            "embed": {"class": "GraphEmbedding", "args": {"hidden_dim": d},
                      "in_keys": ["inputs.G"], "out_keys": ["G"]},
            "mp": {"class": "ChempropBlock", "args": {"hidden_dim": d, "depth": 3, "residual": True},
                   "in_keys": ["embed.G"], "out_keys": ["G"]},
            "readout": {"class": "Gated", "args": {"input_dim": d}, "in_keys": ["mp.G"], "out_keys": ["H"]},
            "ffn": {"class": "MLP",
                    "args": {"input_dim": d, "output_size": 1, "hidden_dim": d, "num_layers": 1},
                    "in_keys": ["readout.H"], "out_keys": ["preds"]},
        },
        "losses": {"mse": {"class": "MSE", "in_keys": dict(keys), "weight": 1.0}},
        "metrics": {"rmse": {"class": "RMSE", "in_keys": dict(keys)}},
    }


def declarative_gvp_model_cfg(d: int = 256, dv: int = 32, depth: int = 3) -> dict:
    """The declarative GVP model on the kernel path (the YAML in README.md):
    PointwiseEmbed -> GvpGNNBlock(impl: fused, neighbor_window: 24) ->
    SpatialSum -> MLP, the MSE loss; every forward runs row 14 and every
    backward row 15 in each layer."""
    keys = {"preds": "ffn.preds", "targets": "targets.y", "mask": "targets.y_mask"}
    return {
        "modules": {
            "embed": {"class": "PointwiseEmbed", "args": {"hidden_dim": d}, "in_keys": ["inputs.P"],
                      "out_keys": ["P"]},
            "backbone": {"class": "GvpGNNBlock",
                         "args": {"scalar_dim": d, "vector_dim": dv, "depth": depth, "radius": 5.0,
                                  "max_neighbors": 16, "neighbor_window": GVP_WINDOW, "impl": "fused"},
                         "in_keys": ["embed.P"], "out_keys": ["P"]},
            "readout": {"class": "SpatialSum", "in_keys": ["backbone.P"], "out_keys": ["H"]},
            "ffn": {"class": "MLP", "args": {"input_dim": d, "output_size": 1, "hidden_dim": d, "num_layers": 1},
                    "in_keys": ["readout.H"], "out_keys": ["preds"]},
        },
        "losses": {"loss": {"class": "MSE", "in_keys": keys}},
    }


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launches() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def lipo_csv(directory: Path, n: int) -> Path:
    path = directory / f"lipo_head{n}.csv"
    with open(ROOT / "tests" / "data" / "lipo.csv", newline="") as f:
        rows = list(csv.reader(f))[: n + 1]
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


def encoder_inputs(G, d: int, depth: int, seed: int) -> list[torch.Tensor]:
    """Seeded node and edge features, W/b and cotangents of both outputs
    (nonzero on every lane, padded ones included) on the index arrays of a
    real per-molecule dense batch, on the card."""
    rng = np.random.default_rng(seed)
    (B, E), V = G.src.shape, G.node_mask.shape[1]
    f32 = lambda *shape, scale=1.0: (scale * rng.standard_normal(shape)).astype(np.float32)
    arrays = (f32(B, V, d), f32(B, E, d), G.src, G.dst, G.edge_mask,
              f32(depth, d, d, scale=1 / np.sqrt(d)), f32(depth, d, scale=0.1), f32(B, V, d), f32(B, E, d))
    return [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in arrays]


def cotangent(G, d: int, seed: int) -> torch.Tensor:
    """A seeded cotangent that is zero on padded lanes, as the block's
    masked scatter gives the backward."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(G.src.shape + (d,)) * G.edge_mask[..., None]
    return torch.from_numpy(g.astype(np.float32)).cuda()


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


def held(what: str, got: torch.Tensor, ref: torch.Tensor, grad: bool) -> float:
    """Fail unless ``got`` is finite and within tolerance of ``ref`` on
    every element; returns the largest absolute error."""
    err = (got - ref).abs()
    scale = float(ref.abs().max())
    atol = ATOL * scale if grad else ATOL
    if not (torch.isfinite(got).all() and (err <= atol + RTOL * ref.abs()).all()):
        fail(f"{what} disagrees with its plain version: max abs err {float(err.max())}, "
             f"largest |ref| {scale}, atol {atol}")
    return float(err.max())


def compare_training(args, g, depth: int, residual: bool, reduce: str, n_nodes: int) -> dict:
    """Rows 2-4 against their plain versions on every lane: the stash
    forward's output and stash, and g_h0, g_W, g_b of both backwards; the
    stash backward twice, bit for bit."""
    h0, src, dst, mask, W, b = args
    kw = dict(depth=depth, n_nodes=n_nodes, residual=residual, reduce=reduce)
    ref_kw = dict(depth=depth, residual=residual, reduce=reduce)
    out, hs = fused_dense_mpnn_block_stash(*args, **kw)
    first = fused_dense_mpnn_block_bwd_stash(h0, hs, src, dst, mask, W, g, **kw)
    second = fused_dense_mpnn_block_bwd_stash(h0, hs, src, dst, mask, W, g, **kw)
    recompute = fused_dense_mpnn_block_bwd(h0, src, dst, mask, W, b, g, **kw)
    ref_out, ref_hs = dense_mpnn_block_stash_reference(*args, **ref_kw)
    ref = dense_mpnn_block_bwd_reference(h0, ref_hs, src, dst, mask, W, g, **ref_kw)
    torch.cuda.synchronize()
    case = f"E={h0.shape[1]} depth={depth} {reduce} residual={residual}"
    errs = {"stash_fwd": held(f"stash forward out ({case})", out, ref_out, False)}
    if depth > 1:
        errs["stash_fwd"] = max(errs["stash_fwd"], held(f"stash ({case})", hs, ref_hs, False))
    elif hs is not None:
        fail("the stash forward returned a stash at depth 1")
    names = ("g_h0", "g_W", "g_b")
    for key, grads in (("bwd_stash", first), ("bwd_recompute", recompute)):
        errs[key] = max(held(f"{key} {n} ({case})", x, r, True) for n, x, r in zip(names, grads, ref))
    rel = max(float((x - r).abs().max() / r.abs().max()) for grads in (first, recompute)
              for x, r in zip(grads, ref))
    repeatable = all(torch.equal(x, y) for x, y in zip(first, second))
    if not repeatable:
        fail(f"two calls of the stash backward on the same inputs differ ({case})")
    return {"shape": list(h0.shape), "depth": depth, "reduce": reduce, "residual": residual,
            "max_abs_err": errs, "max_grad_err_over_max_abs_ref": rel, "bitwise_repeatable": True}


def compare_encoder(x, depth: int, residual: bool, reduce: str) -> dict:
    """Rows 5-6 against their plain versions on every lane: node and edge
    hiddens with and without the stash, the stash, and g_nf, g_ef, g_W, g_b
    for cotangents that are nonzero on padded lanes; the backward twice,
    bit for bit."""
    nf, ef, src, dst, mask, W, b, gn, ge = x
    kw = dict(depth=depth, residual=residual, reduce=reduce)
    nh, eh, _ = fused_dense_encoder_fwd(nf, ef, src, dst, mask, W, b, **kw)
    snh, seh, hs = fused_dense_encoder_fwd(nf, ef, src, dst, mask, W, b, stash=True, **kw)
    first = fused_dense_encoder_bwd(nf, ef, hs, src, dst, mask, W, gn, ge, **kw)
    second = fused_dense_encoder_bwd(nf, ef, hs, src, dst, mask, W, gn, ge, **kw)
    ref_nh, ref_eh, ref_hs = dense_encoder_reference(nf, ef, src, dst, mask, W, b, stash=True, **kw)
    ref = dense_encoder_bwd_reference(nf, ef, ref_hs, src, dst, mask, W, gn, ge, **kw)
    torch.cuda.synchronize()
    case = f"V={nf.shape[1]} E={ef.shape[1]} depth={depth} {reduce} residual={residual}"
    fwd = [held(f"encoder {n} ({case})", got, r, False)
           for n, got, r in (("nh", nh, ref_nh), ("eh", eh, ref_eh), ("stash nh", snh, ref_nh),
                             ("stash eh", seh, ref_eh))]
    if depth > 1:
        fwd.append(held(f"encoder stash ({case})", hs, ref_hs, False))
    elif hs is not None:
        fail("the encoder forward returned a stash at depth 1")
    names = ("g_nf", "g_ef", "g_W", "g_b")
    bwd = [held(f"encoder backward {n} ({case})", got, r, True) for n, got, r in zip(names, first, ref)]
    if not all(torch.equal(p, q) for p, q in zip(first, second)):
        fail(f"two calls of the encoder backward on the same inputs differ ({case})")
    rel = max(float((p - r).abs().max() / r.abs().max()) for p, r in zip(first, ref))
    return {"shape": {"B": nf.shape[0], "V": nf.shape[1], "E": ef.shape[1], "d": ef.shape[2]},
            "depth": depth, "reduce": reduce, "residual": residual,
            "max_abs_err": {"fwd": max(fwd), "bwd": max(bwd)},
            "max_grad_err_over_max_abs_ref": rel, "bitwise_repeatable": True}


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
    Python, as the serving and training paths launch them. The inputs stay
    in the L2 cache between calls, as they do on those paths, where the
    ops before the call have just written them."""
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops: int, n_bytes: int) -> tuple[float, str]:
    """Least time for ``ops`` f32 operations moving ``n_bytes``: the larger
    of operations over the f32 peak and bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def layer_ops(args, reduce: str) -> tuple[int, int, int]:
    """Operations of one forward layer and of one layer of the reverse sweep
    on these inputs: the W-sized products, and ``A`` (or ``Aᵀ``) counted at
    the nonzeros of this data's operator, not E x E. Also returns nnz(A)."""
    h0, src, dst, mask = args[:4]
    B, E, d = h0.shape
    nnz = int((edge_adjacency(src, dst, mask, mean=reduce == "mean") != 0).sum())
    return 2 * B * E * d * d + 2 * nnz * d, 4 * B * E * d * d + 2 * nnz * d, nnz


def encoder_ops(x) -> tuple[int, int, int]:
    """Operations of the encoder forward and backward on these inputs: the
    block's (``layer_ops``) at depth, plus the gather's adds (B * E * d)
    and the masked scatter's (one add per real edge and column) forward;
    backward, the scatter's VJP (one add per real edge and column), h0's
    recompute and the gather's VJP (B * E * d each). Also returns nnz(A)."""
    nf, ef, src, dst, mask, W = x[:6]
    depth = W.shape[0]
    B, E, d = ef.shape
    fwd, bwd, nnz = layer_ops((ef, src, dst, mask), "sum")
    n_real = int(mask.sum())
    return depth * fwd + B * E * d + n_real * d, depth * bwd + n_real * d + 2 * B * E * d, nnz


def profile_busy(run, top: int = 8, width: int = 80) -> dict:
    """Run ``run()`` under torch.profiler: wall time on the host's clock,
    device time by kernel name (the ``top`` longest, names cut to ``width``
    characters), and the share of the wall time the card was busy. User
    annotations (such as ``Optimizer.step#Adam.step``) are left out: their
    device span covers kernels that are counted already."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
        key=lambda k: -k[1],
    )
    busy_ms = sum(ms for _, ms, _ in kernels)
    by_kernel = {}
    for fragment in ("dense_mpnn_plain_kernel", "dense_mpnn_ends_kernel", "adjoint_kernel",
                     "weight_grad_partial", "reduce_chunks", "input_grad_kernel", "attn_kernel",
                     "attn_rows_kernel", "attn_cols_kernel"):
        by_kernel[fragment] = sum(ms for k, ms, _ in kernels if fragment in k)
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
        "block_kernels_ms": by_kernel,
        "top": [{"name": k[:width], "ms": ms, "count": n} for k, ms, n in kernels[:top]],
    }


def train_config(csv_path: Path, checkpoint_dir: Path | None, model: dict | None = None) -> dict:
    """configs/dmpnn_regression.yaml as a dict, on ``csv_path`` for
    ``TRAIN_EPOCHS`` epochs; ``model`` replaces its model section."""
    trainer = {"epochs": TRAIN_EPOCHS, "batch_size": BATCH, "seed": SEED}
    if checkpoint_dir is not None:
        trainer["checkpoint_dir"] = str(checkpoint_dir)
    return {
        "data": {"csv": str(csv_path), "smiles_col": "smiles",
                 "targets": {"y": {"columns": ["lipo"], "task": "regression"}},
                 "split": {"fractions": [0.8, 0.1, 0.1], "seed": 0}},
        "model": dict(MODEL_CFG) if model is None else model,
        "optimizer": OPTIMIZER_CFG,
        "trainer": trainer,
    }


def rel_diff(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def serve_phase(tmp: Path, ds, csv_path: Path, n_batches: int) -> int:
    """A port checkpoint of the seeded model, served by run_predict on the
    card and on the CPU. Returns the block kernel's launches."""
    depth = MODEL_CFG["depth"]
    transforms = ds.build_task_transform_configs()
    model = build_dmpnn(transforms=transforms, generator=torch.Generator().manual_seed(SEED),
                        layout="dense_packed", **{k: v for k, v in MODEL_CFG.items() if k != "kind"})
    ckpt = tmp / "ckpt"
    Checkpointer(ckpt).save(model.network.state_dict(), step=0)
    save_predict_meta(ckpt, {"model": {**MODEL_CFG, "layout": "dense_packed"},
                             "data": {"smiles_col": "smiles"}}, transforms, ds, "ffn.preds")

    reset_launches()
    t0 = time.perf_counter()
    gpu = run_predict(ckpt, csv_path, batch_size=BATCH)["lipo"]
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    counts = launches()
    if counts["fused_dense_mpnn_block"] != depth * n_batches or sum(counts.values()) != depth * n_batches:
        fail(f"serving launched {counts}; the request needs the block kernel {depth} x {n_batches} times")
    t0 = time.perf_counter()
    run_predict(ckpt, csv_path, batch_size=BATCH)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    profiled = profile_busy(lambda: run_predict(ckpt, csv_path, batch_size=BATCH))
    cpu = run_predict(ckpt, csv_path, batch_size=BATCH, device="cpu")["lipo"]
    err = np.abs(gpu - cpu)
    ok = gpu.shape == (N_MOLS,) and np.isfinite(gpu).all() and bool((err <= ATOL + RTOL * np.abs(cpu)).all())
    emit(phase="serve", molecules=N_MOLS, batches=n_batches, kernel_launches=counts,
         request_s_cold=cold_s, request_s_warm=warm_s, profile=profiled,
         max_abs_err_vs_cpu=float(err.max()), pred_mean=float(gpu.mean()),
         pred_std=float(gpu.std()), ok=bool(ok))
    if not ok:
        fail("card predictions disagree with the CPU plain path or are not finite")
    return counts["fused_dense_mpnn_block"]


def compare_runs(card: dict, cpu: dict, what: str, epochs: int = TRAIN_EPOCHS,
                 rtol: float = TRAIN_RTOL) -> dict[str, float]:
    """Relative differences of the per-epoch loss and metrics and the test
    metrics of two ``run`` results; fails beyond ``rtol``."""
    if len(card["history"]) != epochs or len(cpu["history"]) != epochs:
        fail(f"{what}: expected {epochs} epochs, got {len(card['history'])} and {len(cpu['history'])}")
    diffs = {}
    for epoch, (a, b) in enumerate(zip(card["history"], cpu["history"])):
        for key in sorted(k for k in b if k.startswith(("train/", "val/"))):
            diffs[f"epoch{epoch}/{key}"] = rel_diff(a[key], b[key])
    for key in sorted(cpu["test"]):
        diffs[f"test/{key}"] = rel_diff(card["test"][key], cpu["test"][key])
    worst = max(diffs.values())
    if not worst <= rtol:
        fail(f"{what}: the card's training run and the CPU's differ by {worst} relative: {diffs}")
    return diffs


def train_phase(tmp: Path) -> dict[str, int]:
    """run(cfg) on the card and on the CPU, compared epoch by epoch; the
    card's checkpoint served on the card. Returns the kernels' launches of
    the card's run."""
    depth = MODEL_CFG["depth"]
    csv_path = lipo_csv(tmp, TRAIN_MOLS)
    card_ckpt, cpu_ckpt = tmp / "train_card", tmp / "train_cpu"

    reset_launches()
    t0 = time.perf_counter()
    card = run(train_config(csv_path, card_ckpt))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = launches()
    steps = Checkpointer(card_ckpt).latest_step()
    if not steps:
        fail(f"the card's run wrote no checkpoint in {card_ckpt}")
    expect = {**{fn.__name__: 0 for fn in KERNELS if fn is not fused_dense_mpnn_block},
              "fused_dense_mpnn_block_stash": depth * steps, "fused_dense_mpnn_block_bwd_stash": steps}
    if any(counts[k] != v for k, v in expect.items()) or counts["fused_dense_mpnn_block"] == 0:
        fail(f"training {steps} steps launched {counts}; expected {expect} and the forward "
             "kernel for evaluation")

    t0 = time.perf_counter()
    cpu = run(train_config(csv_path, cpu_ckpt), device="cpu")
    cpu_s = time.perf_counter() - t0
    diffs = compare_runs(card, cpu, "training run")

    served = run_predict(card_ckpt, csv_path, batch_size=BATCH)["lipo"]
    served_cpu = run_predict(card_ckpt, csv_path, batch_size=BATCH, device="cpu")["lipo"]
    torch.cuda.synchronize()
    serve_err = np.abs(served - served_cpu)
    serve_ok = (served.shape == (TRAIN_MOLS,) and bool(np.isfinite(served).all())
                and bool((serve_err <= ATOL + RTOL * np.abs(served_cpu)).all()))
    steps_per_epoch = steps // TRAIN_EPOCHS
    emit(phase="train", molecules=TRAIN_MOLS, epochs=TRAIN_EPOCHS, steps=steps,
         kernel_launches=counts, run_s_card=card_s, run_s_cpu=cpu_s,
         warm_epoch_ms_per_step=card["history"][-1]["time"] * 1e3 / steps_per_epoch,
         history_card=card["history"], history_cpu=cpu["history"],
         test_card=card["test"], test_cpu=cpu["test"], rel_diff_vs_cpu=diffs,
         rel_tol=TRAIN_RTOL, served_molecules=len(served),
         served_max_abs_err_card_vs_cpu=float(serve_err.max()), served_ok=serve_ok)
    if not serve_ok:
        fail("the trained checkpoint's predictions are not finite or differ between card and CPU")
    return counts


def train_epoch_phase(tmp: Path) -> dict[str, int]:
    """A warm training epoch (stash backward) timed on the host's clock and
    profiled, then an epoch from the same initial weights with the
    recompute backward, against the stash epoch. Returns the recompute
    epoch's launches."""
    depth = MODEL_CFG["depth"]
    cfg = train_config(lipo_csv(tmp, TRAIN_MOLS), None)
    stash, recompute = prepare(cfg), prepare(cfg)
    recompute["model"].network["mp"].backward = "recompute"
    loader = stash["train_loader"]
    steps = len(loader)

    first = fit(stash["model"], loader, epochs=1)  # also fills the loader's featurization cache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit(stash["model"], loader, epochs=1)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3 / steps
    profiled = profile_busy(lambda: fit(stash["model"], loader, epochs=1))

    reset_launches()
    other = fit(recompute["model"], recompute["train_loader"], epochs=1)
    torch.cuda.synchronize()
    counts = launches()
    expect = {**{fn.__name__: 0 for fn in KERNELS}, "fused_dense_mpnn_block": depth * steps,
              "fused_dense_mpnn_block_bwd": steps}
    if counts != expect:
        fail(f"an epoch with the recompute backward launched {counts}; expected {expect}")
    loss_diff = rel_diff(other.history[0]["train/loss"], first.history[0]["train/loss"])
    emit(phase="train_epoch", steps=steps, warm_ms_per_step=warm_ms,
         profiled_ms_per_step=profiled["wall_ms"] / steps, profile=profiled,
         recompute_kernel_launches=counts, recompute_vs_stash_train_loss_rel_diff=loss_diff,
         rel_tol=TRAIN_RTOL)
    if not loss_diff <= TRAIN_RTOL:
        fail(f"the recompute backward's epoch differs from the stash backward's by {loss_diff}")
    return counts


def train_declarative_phase(tmp: Path) -> tuple[dict[str, int], Path]:
    """run(cfg) of the declarative whole-encoder config on the card and on
    the CPU, compared epoch by epoch. Returns the card run's launches and
    its checkpoint directory."""
    depth = MODEL_CFG["depth"]
    csv_path = lipo_csv(tmp, TRAIN_MOLS)
    card_ckpt = tmp / "declarative_card"
    model = declarative_model_cfg(MODEL_CFG["hidden_dim"], depth)

    reset_launches()
    t0 = time.perf_counter()
    card = run(train_config(csv_path, card_ckpt, model))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = launches()
    steps = Checkpointer(card_ckpt).latest_step()
    if not steps:
        fail(f"the declarative run wrote no checkpoint in {card_ckpt}")
    # the training forward stashes (depth launches a step); evaluation runs
    # the forward alone (depth launches a batch); one backward call a step
    eval_fwd = counts["fused_dense_encoder_fwd"] - depth * steps
    others = {k: v for k, v in counts.items() if k not in ("fused_dense_encoder_fwd", "fused_dense_encoder_bwd")}
    if (counts["fused_dense_encoder_bwd"] != steps or eval_fwd <= 0 or eval_fwd % depth
            or any(others.values())):
        fail(f"the declarative run of {steps} steps launched {counts}; expected the encoder's "
             f"backward {steps} times, its forward {depth} times a step and a batch, and nothing else")

    t0 = time.perf_counter()
    cpu = run(train_config(csv_path, tmp / "declarative_cpu", model), device="cpu")
    cpu_s = time.perf_counter() - t0
    diffs = compare_runs(card, cpu, "declarative run")
    emit(phase="train_declarative", molecules=TRAIN_MOLS, epochs=TRAIN_EPOCHS, steps=steps,
         kernel_launches=counts, run_s_card=card_s, run_s_cpu=cpu_s,
         warm_epoch_ms_per_step=card["history"][-1]["time"] * 1e3 / (steps // TRAIN_EPOCHS),
         history_card=card["history"], history_cpu=cpu["history"], test_card=card["test"],
         test_cpu=cpu["test"], rel_diff_vs_cpu=diffs, rel_tol=TRAIN_RTOL)
    return counts, card_ckpt


def serve_declarative_phase(tmp: Path, ckpt: Path, n_batches: int) -> dict[str, int]:
    """run_predict of the declarative checkpoint on N_MOLS molecules, on the
    card against the CPU; cold and warm request time and the busy share of
    a warm request. Returns the request's launches."""
    depth = MODEL_CFG["depth"]
    csv_path = lipo_csv(tmp, N_MOLS)
    reset_launches()
    t0 = time.perf_counter()
    gpu = run_predict(ckpt, csv_path, batch_size=BATCH)["lipo"]
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    counts = launches()
    expect = {**{fn.__name__: 0 for fn in KERNELS}, "fused_dense_encoder_fwd": depth * n_batches}
    if counts != expect:
        fail(f"serving the declarative checkpoint launched {counts}; expected {expect}")
    t0 = time.perf_counter()
    run_predict(ckpt, csv_path, batch_size=BATCH)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    profiled = profile_busy(lambda: run_predict(ckpt, csv_path, batch_size=BATCH))
    cpu = run_predict(ckpt, csv_path, batch_size=BATCH, device="cpu")["lipo"]
    err = np.abs(gpu - cpu)
    ok = gpu.shape == (N_MOLS,) and bool(np.isfinite(gpu).all()) and bool((err <= ATOL + RTOL * np.abs(cpu)).all())
    emit(phase="serve_declarative", molecules=N_MOLS, batches=n_batches, kernel_launches=counts,
         request_s_cold=cold_s, request_s_warm=warm_s, profile=profiled,
         max_abs_err_vs_cpu=float(err.max()), pred_mean=float(gpu.mean()), pred_std=float(gpu.std()),
         ok=ok)
    if not ok:
        fail("the declarative checkpoint's card predictions disagree with the CPU or are not finite")
    return counts


def dbuf_phase(inputs: list[tuple[list[torch.Tensor], int]]) -> tuple[int, float, list[dict]]:
    """Row 7, which no module calls, run in a phase of its own on each
    ``(args, n_nodes)`` for sum and mean, residual on and off; then held
    against its plain version and row 1 (those launches do not count).
    Returns its launches, its largest error and the cases."""
    depth = MODEL_CFG["depth"]
    reset_launches()
    runs = []
    for args, n_nodes in inputs:
        for reduce in ("sum", "mean"):
            for residual in (True, False):
                kw = dict(depth=depth, n_nodes=n_nodes, residual=residual, reduce=reduce)
                runs.append((args, kw, fused_dense_mpnn_block_dbuf(*args, mols_per_tile=8, **kw)))
    torch.cuda.synchronize()
    count = launches()["fused_dense_mpnn_block_dbuf"]
    if count != depth * len(runs):
        fail(f"the dbuf phase launched {launches()}; expected the dbuf kernel {depth} x {len(runs)} times")
    cases = []
    for args, kw, out in runs:
        row1 = fused_dense_mpnn_block(*args, **kw)
        ref = dense_mpnn_block_reference(*args, depth=depth, residual=kw["residual"], reduce=kw["reduce"])
        torch.cuda.synchronize()
        case = f"B={args[0].shape[0]} E={args[0].shape[1]} {kw['reduce']} residual={kw['residual']}"
        err = held(f"dbuf ({case})", out, ref, False)
        cases.append({"shape": list(args[0].shape), "reduce": kw["reduce"], "residual": kw["residual"],
                      "max_abs_err": err, "max_abs_diff_vs_row_1": float((out - row1).abs().max()),
                      "equal_bits_to_row_1": bool(torch.equal(out, row1))})
    return count, max(c["max_abs_err"] for c in cases), cases


def held_sum(what: str, got: torch.Tensor, plain, data: torch.Tensor, *index) -> tuple[float, bool]:
    """Fail unless a segment sum ``got`` is finite and within SUM_ATOL times
    each element's sum of |terms| of ``plain(data, *index)`` on the card
    (``plain`` run on |data| gives those sums). Returns the largest absolute
    error and whether ``got`` has the bits of the plain version on the CPU,
    which adds each row's terms in the kernel's order."""
    ref, mass = plain(data, *index), plain(data.abs(), *index)
    err = (got - ref).abs()
    if not (torch.isfinite(got).all() and (err <= SUM_ATOL * mass).all()):
        fail(f"{what} disagrees with its plain version: max abs err {float(err.max())}")
    on_cpu = plain(data.cpu(), *(i.cpu() if isinstance(i, torch.Tensor) else i for i in index))
    return float(err.max()), bool(torch.equal(got.cpu(), on_cpu))


def flat_inputs(G, d: int, seed: int) -> dict[str, torch.Tensor]:
    """Seeded messages on every edge lane of a packed flat batch, with its
    packing and its dst-sorted copy (messages permuted along), on the card."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((G.num_edges, d)).astype(np.float32)
    sorted_G, perm = sort_edges_by_dst(G)
    arrays = {"data": data, "perm": G.csr_perm, "packed_dst": G.csr_dst, "dst": G.dst,
              "edge_mask": G.edge_mask, "sorted_data": data[perm], "sorted_dst": sorted_G.dst,
              "row_ptr": csr_row_ptr(sorted_G.dst, G.num_nodes)}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in arrays.items()}


def random_flat_inputs(d: int, seed: int, V: int = 2048, E: int = 4096) -> dict[str, torch.Tensor]:
    """Random ids over V nodes: a third of the nodes empty, node 5 with 600
    in-edges (over-full for a 128-node tile's usual budget), in random
    order for the packed sum and sorted for the row-pointer sum."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(V)[np.arange(V) % 3 != 0], size=E - 600)
    dst = rng.permutation(np.concatenate([ids, np.full(600, 5)])).astype(np.int32)
    perm, packed_dst, _ = pack_edges_by_tile(dst, num_nodes=V)
    data = rng.standard_normal((E, d)).astype(np.float32)
    order = np.argsort(dst, kind="stable")
    arrays = {"data": data, "perm": perm, "packed_dst": packed_dst, "dst": dst,
              "edge_mask": np.ones(E, bool), "sorted_data": data[order], "sorted_dst": dst[order],
              "row_ptr": csr_row_ptr(dst[order], V)}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in arrays.items()}


def flat_kernels_phase(cases: dict[str, dict]) -> tuple[float, float, list[dict]]:
    """Rows 8-9 against their plain versions on each case (launches made
    here do not count for any path); row 9 twice, bit for bit. Returns the
    largest errors of rows 8 and 9 and the cases."""
    records = []
    for name, x in cases.items():
        V = x["row_ptr"].shape[0] - 1
        packed = csr_segment_sum_packed(x["data"], x["perm"], x["packed_dst"], V)
        again = csr_segment_sum_packed(x["data"], x["perm"], x["packed_dst"], V)
        rowptr = csr_segment_sum(x["sorted_data"], x["sorted_dst"], x["row_ptr"], V)
        torch.cuda.synchronize()
        if not torch.equal(packed, again):
            fail(f"two calls of the packed segment sum differ ({name})")
        err9, bits9 = held_sum(f"csr_segment_sum_packed ({name})", packed, csr_segment_sum_packed_reference,
                               x["data"], x["perm"], x["packed_dst"], V)
        err8, bits8 = held_sum(f"csr_segment_sum ({name})", rowptr, csr_segment_sum_reference,
                               x["sorted_data"], x["row_ptr"], V)
        counts = torch.diff(x["row_ptr"])
        records.append({"case": name, "V": V, "E": x["data"].shape[0], "d": x["data"].shape[1],
                        "real_edges": int(x["edge_mask"].sum()), "empty_nodes": int((counts == 0).sum()),
                        "max_in_degree": int(counts.max()), "budget": x["perm"].shape[0] // (V // 128),
                        "max_abs_err": {"csr_segment_sum": err8, "csr_segment_sum_packed": err9},
                        "equal_bits_to_cpu_plain": {"csr_segment_sum": bits8, "csr_segment_sum_packed": bits9},
                        "packed_bitwise_repeatable": True})
    return (max(r["max_abs_err"]["csr_segment_sum"] for r in records),
            max(r["max_abs_err"]["csr_segment_sum_packed"] for r in records), records)


def rowptr_phase(batches: list[dict], d: int) -> tuple[int, float]:
    """Row 8, which no module calls, on the dst-sorted copy of each flat
    batch (the E->V reduce as sort_edges_by_dst and csr_row_ptr feed it),
    seeded messages; then held against its plain version (those calls do not
    count). Returns its launches and largest error."""
    inputs = [flat_inputs(b["inputs.G"], d, SEED + 20 + i) for i, b in enumerate(batches)]
    reset_launches()
    outs = [csr_segment_sum(x["sorted_data"], x["sorted_dst"], x["row_ptr"], x["row_ptr"].shape[0] - 1)
            for x in inputs]
    torch.cuda.synchronize()
    count = launches()["csr_segment_sum"]
    if count != len(batches) or sum(launches().values()) != count:
        fail(f"the row-pointer phase launched {launches()}; expected csr_segment_sum {len(batches)} times")
    err = max(held_sum("csr_segment_sum (flat batch)", out, csr_segment_sum_reference, x["sorted_data"],
                       x["row_ptr"], x["row_ptr"].shape[0] - 1)[0] for out, x in zip(outs, inputs))
    return count, err


def train_flat_phase(tmp: Path) -> tuple[dict[str, int], Path]:
    """run(cfg) with model.impl: csr (the flat layout) on the card and on the
    CPU, compared epoch by epoch; every E->V reduce of the card's run goes
    through row 9. Returns the card run's launches and checkpoint."""
    depth = MODEL_CFG["depth"]
    csv_path = lipo_csv(tmp, TRAIN_MOLS)
    card_ckpt = tmp / "flat_card"
    model = {**MODEL_CFG, "impl": "csr"}
    reset_launches()
    t0 = time.perf_counter()
    card = run(train_config(csv_path, card_ckpt, model))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = launches()
    steps = Checkpointer(card_ckpt).latest_step()
    if not steps:
        fail(f"the flat run wrote no checkpoint in {card_ckpt}")
    # (depth + 1) reduces a forward: each training step and each evaluated batch
    packed = counts["csr_segment_sum_packed"]
    others = {k: v for k, v in counts.items() if k != "csr_segment_sum_packed"}
    if packed <= (depth + 1) * steps or packed % (depth + 1) or any(others.values()):
        fail(f"the flat run of {steps} steps launched {counts}; expected the packed sum {depth + 1} "
             "times a step and an evaluated batch, and nothing else")
    t0 = time.perf_counter()
    cpu = run(train_config(csv_path, tmp / "flat_cpu", model), device="cpu")
    cpu_s = time.perf_counter() - t0
    diffs = compare_runs(card, cpu, "flat run")
    emit(phase="train_flat", molecules=TRAIN_MOLS, epochs=TRAIN_EPOCHS, steps=steps, kernel_launches=counts,
         run_s_card=card_s, run_s_cpu=cpu_s,
         warm_epoch_ms_per_step=card["history"][-1]["time"] * 1e3 / (steps // TRAIN_EPOCHS),
         history_card=card["history"], history_cpu=cpu["history"], test_card=card["test"],
         test_cpu=cpu["test"], rel_diff_vs_cpu=diffs, rel_tol=TRAIN_RTOL)
    return counts, card_ckpt


def serve_checkpoint_phase(tmp: Path, ckpt: Path, phase: str, expect: dict[str, int]) -> dict[str, int]:
    """run_predict of a checkpoint on N_MOLS molecules, on the card against
    the CPU; cold and warm request time and the busy share of a warm
    request. Fails unless the request launched exactly ``expect`` (every
    other kernel 0). Returns the request's launches."""
    csv_path = lipo_csv(tmp, N_MOLS)
    reset_launches()
    t0 = time.perf_counter()
    gpu = run_predict(ckpt, csv_path, batch_size=BATCH)["lipo"]
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    counts = launches()
    if counts != {**{fn.__name__: 0 for fn in KERNELS}, **expect}:
        fail(f"{phase}: the request launched {counts}; expected {expect} and nothing else")
    t0 = time.perf_counter()
    run_predict(ckpt, csv_path, batch_size=BATCH)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    profiled = profile_busy(lambda: run_predict(ckpt, csv_path, batch_size=BATCH))
    cpu = run_predict(ckpt, csv_path, batch_size=BATCH, device="cpu")["lipo"]
    err = np.abs(gpu - cpu)
    ok = gpu.shape == (N_MOLS,) and bool(np.isfinite(gpu).all()) and bool((err <= ATOL + RTOL * np.abs(cpu)).all())
    emit(phase=phase, molecules=N_MOLS, kernel_launches=counts, request_s_cold=cold_s,
         request_s_warm=warm_s, profile=profiled, max_abs_err_vs_cpu=float(err.max()),
         pred_mean=float(gpu.mean()), pred_std=float(gpu.std()), ok=ok)
    if not ok:
        fail(f"{phase}: the card's predictions disagree with the CPU or are not finite")
    return counts


def train_declarative_flat_phase(tmp: Path) -> Path:
    """One epoch of configs/declarative_example.yaml's model (flat, the
    gather block, the gated readout; no kernel of the port on its path) on
    the card and on the CPU, compared. Returns the card's checkpoint."""
    csv_path = lipo_csv(tmp, TRAIN_MOLS)
    card_ckpt = tmp / "declarative_flat_card"
    model = declarative_flat_model_cfg()
    cfg = train_config(csv_path, card_ckpt, model)
    cfg["trainer"]["epochs"] = 1
    reset_launches()
    t0 = time.perf_counter()
    card = run(cfg)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = launches()
    if any(counts.values()):
        fail(f"the declarative flat run launched {counts}; its path has no kernel of the port")
    cpu_cfg = train_config(csv_path, tmp / "declarative_flat_cpu", model)
    cpu_cfg["trainer"]["epochs"] = 1
    t0 = time.perf_counter()
    cpu = run(cpu_cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    diffs = compare_runs(card, cpu, "declarative flat run", epochs=1)
    emit(phase="train_declarative_flat", molecules=TRAIN_MOLS, epochs=1,
         steps=Checkpointer(card_ckpt).latest_step(), kernel_launches=counts, run_s_card=card_s,
         run_s_cpu=cpu_s, history_card=card["history"], history_cpu=cpu["history"],
         test_card=card["test"], test_cpu=cpu["test"], rel_diff_vs_cpu=diffs, rel_tol=TRAIN_RTOL)
    return card_ckpt


def attention_inputs(src, dst, mask, V: int, d: int, heads: int, seed: int, edge_bias: bool = True) -> list:
    """Seeded q, k, v, the edge bias (or None) and a cotangent over the
    index arrays ``src``, ``dst``, ``mask`` [B, E] of bins of V node slots,
    on the card: ``[q, k, v, eb, src, dst, edge_mask, g]``."""
    rng = np.random.default_rng(seed)
    B, E = src.shape
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    arrays = [f32(B, V, d), f32(B, V, d), f32(B, V, d), f32(B, heads, E) if edge_bias else None,
              src, dst, mask, f32(B, V, d)]
    return [None if x is None else torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in arrays]


def batch_attention_inputs(G, d: int, heads: int, seed: int, edge_bias: bool = True) -> list:
    """attention_inputs on a real dense batch (packed or per molecule)."""
    return attention_inputs(G.src, G.dst, G.edge_mask, G.node_mask.shape[1], d, heads, seed, edge_bias)


def random_attention_inputs(d: int, heads: int, seed: int, edge_bias: bool) -> list:
    """Four random bins of V = 256 node slots and E = 512 edge lanes: edges
    over the first 198 slots, so that slots 198-199 are bond-less molecules
    and 200-255 padding; a fifth of the lanes masked; every seventh lane
    repeats the pair before it (a pair with two edges)."""
    rng = np.random.default_rng(seed)
    src, dst = (rng.integers(0, 198, (4, 512)).astype(np.int32) for _ in range(2))
    src[:, 1::7], dst[:, 1::7] = src[:, :-1:7], dst[:, :-1:7]
    return attention_inputs(src, dst, rng.random((4, 512)) < 0.8, 256, d, heads, seed, edge_bias)


def compare_attention(x: list, heads: int, case: str) -> dict:
    """Rows 10-13 against their plain versions on every lane: forward at
    RTOL/ATOL, every gradient at ATOL times its largest magnitude; each
    backward twice, bit for bit."""
    q, k, v, eb, src, dst, mask, g = x
    args = (q, k, v, eb, src, dst, mask)
    ref = dense_attention_reference(*args, heads)
    ref_grads = dense_attention_bwd_reference(*args, g, heads)
    errs = {}
    for fwd, bwd in ((fused_dense_attention_fwd, fused_dense_attention_bwd),
                     (fused_dense_attention_fwd_v2, fused_dense_attention_bwd_v2)):
        out = fwd(*args, num_heads=heads)
        first = bwd(*args, g, num_heads=heads)
        second = bwd(*args, g, num_heads=heads)
        torch.cuda.synchronize()
        errs[fwd.__name__] = held(f"{fwd.__name__} ({case})", out, ref, False)
        names = ("g_q", "g_k", "g_v", "g_eb")[: 4 if eb is not None else 3]
        errs[bwd.__name__] = max(held(f"{bwd.__name__} {n} ({case})", a, r, True)
                                 for n, a, r in zip(names, first, ref_grads))
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            fail(f"two calls of {bwd.__name__} on the same inputs differ ({case})")
    B, V, d = q.shape
    return {"case": case, "B": B, "V": V, "E": src.shape[1], "d": d, "heads": heads,
            "edge_bias": eb is not None, "real_edges": int(mask.sum()), "live_pairs": live_pairs(x),
            "max_abs_err": errs, "bitwise_repeatable": True}


def live_pairs(x: list) -> int:
    """The (bin, i, j) pairs with a real edge j -> i: the lanes of the
    masked softmax that hold weight."""
    q, _, _, _, src, dst, mask, _ = x
    ids = torch.arange(q.shape[1], device=q.device)
    S = ((dst.long()[:, None, :] == ids[None, :, None]) & mask[:, None, :]).float()
    Gm = (src.long()[:, :, None] == ids[None, None, :]).float()
    return int((torch.bmm(S, Gm) > 0).sum())


def attention_v1_phase(batches: list[dict], d: int, heads: int) -> tuple[int, float, float]:
    """Rows 10-11, which no module calls, on seeded q/k/v/eb and cotangents
    over each batch of the graph transformer's packed loader, in a phase of
    their own; then held against their plain versions (those calls launch
    nothing). Returns the launches of each and their largest errors."""
    inputs = [batch_attention_inputs(b["inputs.G"], d, heads, SEED + 40 + i) for i, b in enumerate(batches)]
    reset_launches()
    outs = [(fused_dense_attention_fwd(*x[:7], num_heads=heads),
             fused_dense_attention_bwd(*x[:7], x[7], num_heads=heads)) for x in inputs]
    torch.cuda.synchronize()
    counts = launches()
    n = len(batches)
    if counts != {**{fn.__name__: 0 for fn in KERNELS}, "fused_dense_attention_fwd": n,
                  "fused_dense_attention_bwd": n}:
        fail(f"the v1 attention phase launched {counts}; expected rows 10 and 11 {n} times each")
    fwd_err = bwd_err = 0.0
    for x, (out, grads) in zip(inputs, outs):
        fwd_err = max(fwd_err, held("fused_dense_attention_fwd (packed batch)", out,
                                    dense_attention_reference(*x[:7], heads), False))
        ref = dense_attention_bwd_reference(*x[:7], x[7], heads)
        bwd_err = max(bwd_err, *(held("fused_dense_attention_bwd (packed batch)", a, r, True)
                                 for a, r in zip(grads, ref)))
    return n, fwd_err, bwd_err


def train_run_phase(tmp: Path, phase: str, model: dict, epochs: int, check) -> tuple[dict[str, int], Path]:
    """run(cfg) of ``model`` with the data, optimizer and trainer of
    MODEL_CFG's config on the card and on the CPU, compared epoch by epoch
    at ATTENTION_RUN_RTOL, then every step of that run in lockstep.
    ``check(counts, steps)`` returns what is wrong with the card run's
    launches, or None. Returns the launches and the card's checkpoint."""
    csv_path = lipo_csv(tmp, TRAIN_MOLS)
    card_ckpt = tmp / f"{phase}_card"
    cfg = train_config(csv_path, card_ckpt, model)
    cfg["trainer"]["epochs"] = epochs
    reset_launches()
    t0 = time.perf_counter()
    card = run(cfg)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = launches()
    steps = Checkpointer(card_ckpt).latest_step()
    if not steps:
        fail(f"{phase}: the card's run wrote no checkpoint in {card_ckpt}")
    wrong = check(counts, steps)
    if wrong:
        fail(f"{phase}: the card's run of {steps} steps launched {counts}; {wrong}")
    cpu_cfg = train_config(csv_path, tmp / f"{phase}_cpu", model)
    cpu_cfg["trainer"]["epochs"] = epochs
    t0 = time.perf_counter()
    cpu = run(cpu_cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    diffs = compare_runs(card, cpu, phase, epochs=epochs, rtol=ATTENTION_RUN_RTOL)
    emit(phase=phase, molecules=TRAIN_MOLS, epochs=epochs, steps=steps, kernel_launches=counts,
         run_s_card=card_s, run_s_cpu=cpu_s,
         warm_epoch_ms_per_step=card["history"][-1]["time"] * 1e3 / (steps // epochs),
         history_card=card["history"], history_cpu=cpu["history"], test_card=card["test"],
         test_cpu=cpu["test"], rel_diff_vs_cpu=diffs, rel_tol=ATTENTION_RUN_RTOL,
         lockstep=lockstep(train_config(csv_path, None, model), epochs, phase))
    return counts, card_ckpt


def lockstep(cfg: dict, epochs: int, what: str) -> dict:
    """Every step of ``cfg``'s run taken on the card and on the CPU from the
    card's weights and optimizer state (copied to the CPU before each step),
    on the run's own batches in its order: fails unless each step's loss
    agrees within LOCKSTEP_RTOL relative and each gradient, but those of
    ZERO_GRADIENTS, within LOCKSTEP_GRAD_RTOL times its largest magnitude."""
    card, cpu = prepare(cfg), prepare(cfg, "cpu")["model"]
    model, loader = card["model"], card["train_loader"]
    loss_diff, grad_diff, worst = 0.0, 0.0, None
    steps = 0
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        for batch in loader:
            cpu.network.load_state_dict(model.network.state_dict())
            cpu.optimizer.load_state_dict(model.optimizer.state_dict())
            ours = model.train_step(to_device(batch, model.device))
            theirs = cpu.train_step(to_device(batch, "cpu"))
            loss_diff = max(loss_diff, rel_diff(float(ours["train/loss"]), float(theirs["train/loss"])))
            grads = {n: p.grad for n, p in cpu.network.named_parameters()}
            for name, p in model.network.named_parameters():
                if name.endswith(ZERO_GRADIENTS):
                    continue
                ref = grads[name]
                err = float((p.grad.cpu() - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
                if err > grad_diff:
                    grad_diff, worst = err, name
            steps += 1
    if not (loss_diff <= LOCKSTEP_RTOL and grad_diff <= LOCKSTEP_GRAD_RTOL):
        fail(f"{what}: in lockstep the card's steps and the CPU's differ: loss {loss_diff} relative, "
             f"gradients {grad_diff} of their largest magnitude ({worst})")
    return {"steps": steps, "max_loss_rel_diff": loss_diff, "max_grad_err_over_max": grad_diff,
            "worst_gradient": worst, "rtol": LOCKSTEP_RTOL, "grad_rtol_over_max": LOCKSTEP_GRAD_RTOL}


def no_kernel(counts: dict[str, int], steps: int) -> str | None:
    return None if not any(counts.values()) else "its path has no kernel of the port"


def declarative_attention_launches(counts: dict[str, int], steps: int) -> str | None:
    """Each training step: row 12 in every layer's forward and row 13 in
    every layer's backward; each evaluated batch: row 12 in every layer."""
    depth = MODEL_CFG["depth"]
    fwd, bwd = counts["fused_dense_attention_fwd_v2"], counts["fused_dense_attention_bwd_v2"]
    others = {k: v for k, v in counts.items() if k not in ("fused_dense_attention_fwd_v2",
                                                             "fused_dense_attention_bwd_v2")}
    if bwd != depth * steps or fwd <= depth * steps or fwd % depth or any(others.values()):
        return (f"expected row 13 {depth} times a step, row 12 {depth} times a step and an evaluated "
                "batch, and nothing else")
    return None


def sdpa_inputs(x: list, heads: int) -> tuple:
    """q, k, v as [B, H, V, dh] and the additive mask plus bias [B, H, V, V]
    (0 plus the summed edge bias on a live pair, -inf elsewhere) for
    scaled_dot_product_attention, built beforehand."""
    q, k, v, eb, src, dst, mask, _ = x
    B, V, d = q.shape
    ids = torch.arange(V, device=q.device)
    S = ((dst.long()[:, None, :] == ids[None, :, None]) & mask[:, None, :]).float()
    Gm = (src.long()[:, :, None] == ids[None, None, :]).float()
    bias = torch.zeros(B, heads, V, V, device=q.device) if eb is None else (S[:, None] * eb[:, :, None, :]) @ Gm[:, None]
    additive = torch.where((torch.bmm(S, Gm) > 0)[:, None], bias, float("-inf")).contiguous()
    heads_of = lambda t: t.reshape(B, V, heads, d // heads).transpose(1, 2).contiguous()  # noqa: E731
    return heads_of(q), heads_of(k), heads_of(v), additive


def library_sdpa(x: list, heads: int, bwd: bool):
    """torch.nn.functional.scaled_dot_product_attention with the additive
    mask and bias built beforehand (a row with no live pair gives NaN there,
    where the kernels give 0: a yardstick of time, not of values); for the
    backward rows, its forward and autograd backward (q, k, v and the
    additive mask's gradients), as the recompute backward also recomputes
    the forward."""
    import torch.nn.functional as F

    q, k, v, additive = sdpa_inputs(x, heads)
    if not bwd:
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=additive)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, additive)]
    g = torch.randn_like(q)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3])
        return torch.autograd.grad(out, leaves, g)

    return fwd_bwd


def attention_work(x: list, heads: int, bwd: bool) -> tuple[int, int, int]:
    """Operations and bytes of one call on these inputs: the products at
    this data's live pairs (per pair and head, 4 dh forward: the score and
    the combine; 10 dh backward: the recomputed score, g_alpha, g_q, g_k and
    g_v), each input read once and each output written once. Also returns
    the operations of the same products run densely over every V x V lane,
    as the TPU kernels run them."""
    q, k, v, eb, src, dst, mask, g = x
    B, V, d = q.shape
    per_pair = (10 if bwd else 4) * (d // heads)
    ins = nbytes(q, k, v, src, dst, mask, *([eb] if eb is not None else []), *([g] if bwd else []))
    outs = nbytes(q) * (3 if bwd else 1) + (nbytes(eb) if bwd and eb is not None else 0)
    return live_pairs(x) * heads * per_pair, ins + outs, B * heads * V * V * per_pair


def library_index_add(x: dict):
    """``torch.zeros(...).index_add_`` over the real edges (padding edges go
    to a trash row through a prepared index): the same function as row 9."""
    V, d = x["row_ptr"].shape[0] - 1, x["data"].shape[1]
    index = torch.where(x["edge_mask"], x["dst"], V).long()
    return lambda: torch.zeros(V + 1, d, device=index.device).index_add_(0, index, x["data"])[:V]


def library_segment_reduce(x: dict):
    """``torch.segment_reduce(..., offsets=row_ptr)``: the same function as
    row 8."""
    offsets = x["row_ptr"].long()
    return lambda: torch.segment_reduce(x["sorted_data"], "sum", offsets=offsets, unsafe=True)


def gvp_data() -> tuple[list[dict], list[dict]]:
    """The GVP runs' data: GVP_CLOUDS training and GVP_VAL_CLOUDS validation
    clouds from their seeds, in batches of 64 clouds."""
    train, val = make_clouds(GVP_CLOUDS, seed=SEED), make_clouds(GVP_VAL_CLOUDS, seed=SEED + 1)
    return (cloud_batches(train, coordination_targets(train), batch_size=BATCH),
            cloud_batches(val, coordination_targets(val), batch_size=BATCH))


def gvp_kernel_inputs(P, seed: int, d: int = 256, dv: int = 32, nb: int = 16, K: int = 16) -> dict:
    """Rows 14-15's operands as GvpConv makes them from the batch ``P`` on
    the card: the banded neighbour lists (radius 5, window 24), the RBF
    features and unit vectors of the coordinates; seeded s, v, split weights
    (scaled by 1/sqrt(fan in)) and cotangents."""
    P = P.to("cuda")
    nbrs, mask, dists = radius_neighbors(P.coords, P.batch_index, 5.0, K, window=GVP_WINDOW)
    N = nbrs.shape[0]
    rbf = RBFEmbedding(0.0, 5.0, nb)(dists).reshape(N * K, nb)
    disp = P.coords[nbrs.long()] - P.coords[:, None, :]
    unit = (disp / torch.sqrt((disp**2).sum(-1, keepdim=True) + 1e-8)).reshape(N * K, 3)
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).cuda()

    weights = [f32(*shape, scale=1 / np.sqrt(shape[0]) if len(shape) == 2 else 0.1)
               for shape in weight_shapes(d, dv, nb)]
    args = [f32(N, d), f32(N, dv), f32(N, dv), f32(N, dv), nbrs, mask, rbf,
            *(unit[:, i: i + 1].contiguous() for i in range(3)), weights]
    return {"args": args, "cot": [f32(N, d), f32(N, dv), f32(N, dv), f32(N, dv)], "N": N,
            "live_rows": int(mask.sum()), "padded_rows": N * K}


def gvp_cases(train_batches: list[dict]) -> dict[str, dict]:
    """The first training batch; clouds with isolated atoms (empty
    neighbourhoods) and many padding rows; a node count that JAX's tile
    halving takes down to 8."""
    first = train_batches[0]["inputs.P"]
    clouds = make_clouds(40, seed=SEED + 5)
    for i in range(0, 40, 3):  # an atom 100 A from the rest of its cloud
        coords = clouds[i].coords.copy()
        coords[0] += 100.0
        clouds[i] = PointCloud(clouds[i].node_types, coords)
    sparse = pad_point_clouds(clouds, 1024, graph_cap=40)
    odd = make_clouds(60, seed=SEED + 6)
    atoms = sum(c.num_nodes for c in odd)
    cap = 8 * (-(-atoms // 8) | 1)  # an odd multiple of 8
    return {"first_training_batch": gvp_kernel_inputs(first, SEED + 50),
            "empty_neighbourhoods_and_padding": gvp_kernel_inputs(sparse, SEED + 51),
            "tile_falls_to_8": gvp_kernel_inputs(pad_point_clouds(odd, cap, graph_cap=60), SEED + 52)}


def kink_free(args: list) -> tuple[list, int]:
    """``args`` with the slots masked whose ReLU pre-activation in some layer
    (the plain forward's, in float64) lies within KINK_TOL of that layer's
    largest |pre-activation| of zero; also returns how many were masked."""
    wide = [a.double() if a.is_floating_point() else a for a in args[:10]] + [[w.double() for w in args[10]]]
    near = torch.zeros(args[5].numel(), dtype=torch.bool, device=args[5].device)
    for mid in gvp_conv_preactivations(*wide, GVP_WINDOW):
        near |= (mid.abs() < KINK_TOL * mid.abs().max()).any(1)
    near = near.reshape(args[5].shape) & args[5]
    return args[:5] + [(args[5] & ~near).contiguous()] + args[6:], int(near.sum())


def compare_gvp(x: dict, case: str) -> dict:
    """Rows 14-15 against their plain versions: the four outputs at
    RTOL/ATOL; every cotangent (features, rbf, unit vectors, the 25 weights)
    by relative L2 at KINK_GRAD_L2, and on the inputs with the slots near a
    ReLU kink masked (kink_free) element by element at ATOL times its
    largest magnitude; each entry twice, bit for bit."""
    args, cot = x["args"], x["cot"]
    out = fused_gvp_conv_fwd(*args, window=GVP_WINDOW)
    again = fused_gvp_conv_fwd(*args, window=GVP_WINDOW)
    first = fused_gvp_conv_bwd(*args, *cot, window=GVP_WINDOW)
    second = fused_gvp_conv_bwd(*args, *cot, window=GVP_WINDOW)
    ref = gvp_conv_reference(*args, GVP_WINDOW)
    ref_grads = gvp_conv_bwd_reference(*args, *cot, GVP_WINDOW)
    smooth, n_kink = kink_free(args)
    smooth_grads = fused_gvp_conv_bwd(*smooth, *cot, window=GVP_WINDOW)
    smooth_ref = gvp_conv_bwd_reference(*smooth, *cot, GVP_WINDOW)
    torch.cuda.synchronize()
    fwd = max(held(f"fused_gvp_conv_fwd output {i} ({case})", a, r, False) for i, (a, r) in enumerate(zip(out, ref)))
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        fail(f"two calls of fused_gvp_conv_fwd on the same inputs differ ({case})")
    flat = lambda g: list(g[:8]) + list(g[8])  # noqa: E731
    names = ["g_s", "g_vx", "g_vy", "g_vz", "g_rbf2d", "g_ux", "g_uy", "g_uz"] + [f"g_w{i}" for i in range(25)]
    if not all(torch.equal(a, b) for a, b in zip(flat(first), flat(second))):
        fail(f"two calls of fused_gvp_conv_bwd on the same inputs differ ({case})")
    l2 = {n: float((a - r).norm() / r.norm().clamp_min(1e-30)) for n, a, r in zip(names, flat(first), flat(ref_grads))}
    worst_l2 = max(l2, key=l2.get)
    if not l2[worst_l2] <= KINK_GRAD_L2:
        fail(f"fused_gvp_conv_bwd {worst_l2} ({case}) differs from its plain version by {l2[worst_l2]} in relative L2")
    bwd = max(held(f"fused_gvp_conv_bwd {n} ({case}, kinks masked)", a, r, True)
              for n, a, r in zip(names, flat(smooth_grads), flat(smooth_ref)))
    N, K = args[4].shape
    tile = 64
    while N % tile:
        tile //= 2
    empty = int((args[5].sum(1) == 0).sum())
    return {"case": case, "N": N, "K": K, "live_rows": x["live_rows"], "padded_rows": x["padded_rows"],
            "empty_neighbourhoods": empty, "jax_tile": tile, "slots_near_a_kink": n_kink,
            "max_abs_err": {"fused_gvp_conv_fwd": fwd, "fused_gvp_conv_bwd": bwd},
            "bwd_max_rel_l2_unmasked": l2[worst_l2], "bwd_worst_unmasked": worst_l2, "bitwise_repeatable": True}


def time_gvp(fn, x: dict) -> tuple[dict, list[dict], dict[str, float], float]:
    """Row 14 or 15 (``fn``) on ``x``: its time_ms, the kernels of 5 calls
    in a profile, their device ms a call by stage (GVP_STAGES: row 14's
    weights' copies, per-node products, layer 0's input, each layer's
    products and the masked mean; row 15's recompute and reverse sweep,
    gather's VJP and weight gradients), and its scratch in MiB."""
    if fn is fused_gvp_conv_bwd:
        kernel = lambda: fused_gvp_conv_bwd(*x["args"], *x["cot"], window=GVP_WINDOW)  # noqa: E731
    else:
        kernel = lambda: fused_gvp_conv_fwd(*x["args"], window=GVP_WINDOW)  # noqa: E731
    t = time_ms(kernel)
    breakdown = profile_busy(lambda: [kernel() for _ in range(5)], top=40, width=160)["top"]
    stages = {stage.rstrip("_,"): sum(k["ms"] for k in breakdown if stage in k["name"]) / 5 for stage in GVP_STAGES[fn]}
    (N, K), ds, dv, nb = x["args"][4].shape, x["args"][0].shape[1], x["args"][1].shape[1], x["args"][6].shape[1]
    lib = gvp_conv._lib()
    floats = (lib.gvp_conv_bwd_scratch_floats if fn is fused_gvp_conv_bwd else lib.gvp_conv_fwd_scratch_floats)
    return t, breakdown, stages, floats(N, K, ds, dv, nb) * 4 / 2**20


def gvp_model(cfg: dict, device: str):
    """The model of ``cfg`` with weights from SEED, Adam at GVP_LR, on ``device``."""
    model = build_model(cfg, None, generator=torch.Generator().manual_seed(SEED),
                        optimizer=OptimizerSpec("adam", GVP_LR))
    return model.to(device)


def gvp_lockstep(cfg: dict, batches: list[dict], epochs: int, what: str) -> dict:
    """Every step of the run taken on the card and on the CPU from the card's
    weights and optimizer state: fails unless each step's loss agrees within
    LOCKSTEP_RTOL relative and each gradient within KINK_GRAD_L2 in
    relative L2 distance."""
    card, cpu = gvp_model(cfg, "cuda"), gvp_model(cfg, "cpu")
    loss_diff, grad_diff, worst, steps = 0.0, 0.0, None, 0
    for _ in range(epochs):
        for batch in batches:
            cpu.network.load_state_dict(card.network.state_dict())
            cpu.optimizer.load_state_dict(card.optimizer.state_dict())
            ours = card.train_step(to_device(batch, "cuda"))
            theirs = cpu.train_step(to_device(batch, "cpu"))
            loss_diff = max(loss_diff, rel_diff(float(ours["train/loss"]), float(theirs["train/loss"])))
            grads = dict(cpu.network.named_parameters())
            for name, p in card.network.named_parameters():
                ref = grads[name].grad
                if p.grad is None and ref is None:  # a path that reaches no output
                    continue
                err = float((p.grad.cpu() - ref).norm() / ref.norm().clamp_min(1e-30))
                if err > grad_diff:
                    grad_diff, worst = err, name
            steps += 1
    if not (loss_diff <= LOCKSTEP_RTOL and grad_diff <= KINK_GRAD_L2):
        fail(f"{what}: in lockstep the card's steps and the CPU's differ: loss {loss_diff} relative, "
             f"gradients {grad_diff} in relative L2 ({worst})")
    return {"steps": steps, "max_loss_rel_diff": loss_diff, "max_grad_rel_l2": grad_diff, "worst_gradient": worst,
            "rtol": LOCKSTEP_RTOL, "grad_rel_l2_tol": KINK_GRAD_L2}


def train_gvp_phase(tmp: Path, phase: str, cfg: dict, train: list[dict], val: list[dict], epochs: int,
                    expect_fwd_per_batch: int) -> tuple[dict[str, int], Path]:
    """fit(cfg's model) for ``epochs`` on the card and on the CPU from the
    same weights, compared epoch by epoch at GVP_RUN_RTOL, then every step in
    lockstep. The card's run must launch row 15 ``expect_fwd_per_batch``
    times a step and row 14 as many times a step and an evaluated batch, and
    nothing else. Returns the launches and the card's checkpoint directory."""
    ckpt = tmp / f"{phase}_card"
    reset_launches()
    card = gvp_model(cfg, "cuda")
    t0 = time.perf_counter()
    card_run = fit(card, train, val, epochs=epochs, checkpointer=Checkpointer(ckpt))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = launches()
    steps, n = card.step, expect_fwd_per_batch
    expect = {**{fn.__name__: 0 for fn in KERNELS}, "fused_gvp_conv_fwd": n * (steps + epochs * len(val)),
              "fused_gvp_conv_bwd": n * steps}
    if counts != expect:
        fail(f"{phase}: the card's run of {steps} steps launched {counts}; expected {expect}")
    t0 = time.perf_counter()
    cpu_run = fit(gvp_model(cfg, "cpu"), train, val, epochs=epochs)
    cpu_s = time.perf_counter() - t0
    diffs = {f"epoch{e}/{k}": rel_diff(a[k], b[k]) for e, (a, b) in enumerate(zip(card_run.history, cpu_run.history))
             for k in ("train/loss", "val/loss")}
    worst = max(diffs.values())
    falls = epochs < 2 or card_run.history[-1]["train/loss"] < card_run.history[0]["train/loss"]
    emit(phase=phase, clouds=len(train) * BATCH, epochs=epochs, steps=steps, kernel_launches=counts,
         first_batch_nodes=train[0]["inputs.P"].num_nodes, run_s_card=card_s, run_s_cpu=cpu_s,
         warm_epoch_ms_per_step=card_run.history[-1]["time"] * 1e3 / len(train),
         history_card=card_run.history, history_cpu=cpu_run.history, rel_diff_vs_cpu=diffs, rel_tol=GVP_RUN_RTOL,
         loss_falls=falls, lockstep=gvp_lockstep(cfg, train, epochs, phase))
    if not worst <= GVP_RUN_RTOL:
        fail(f"{phase}: the card's run and the CPU's differ by {worst} relative: {diffs}")
    if not falls:
        fail(f"{phase}: the training loss did not fall: {card_run.history}")
    return counts, ckpt


def serve_gvp_phase(ckpt: Path, cfg: dict, batches: list[dict], phase: str, expect: dict[str, int]) -> dict[str, int]:
    """predict of ``batches`` from the checkpoint's weights on the card (cold
    and warm, and the busy share of a warm request) against the CPU at
    RTOL/ATOL; fails unless the request launched exactly ``expect``."""
    weights = Checkpointer(ckpt).restore()
    card, cpu = gvp_model(cfg, "cuda"), gvp_model(cfg, "cpu")
    card.network.load_state_dict(weights)
    cpu.network.load_state_dict(weights)
    reset_launches()
    t0 = time.perf_counter()
    got = predict(card, batches, keys=["ffn.preds"])["ffn.preds"]
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    counts = launches()
    if counts != {**{fn.__name__: 0 for fn in KERNELS}, **expect}:
        fail(f"{phase}: the request launched {counts}; expected {expect} and nothing else")
    t0 = time.perf_counter()
    predict(card, batches, keys=["ffn.preds"])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    profiled = profile_busy(lambda: predict(card, batches, keys=["ffn.preds"]))
    ref = predict(cpu, batches, keys=["ffn.preds"])["ffn.preds"]
    err = np.abs(got - ref)
    n = len(batches) * BATCH
    ok = got.shape == (n, 1) and bool(np.isfinite(got).all()) and bool((err <= ATOL + RTOL * np.abs(ref)).all())
    emit(phase=phase, clouds=n, kernel_launches=counts, request_s_cold=cold_s, request_s_warm=warm_s,
         profile=profiled, max_abs_err_vs_cpu=float(err.max()), pred_mean=float(got.mean()),
         pred_std=float(got.std()), ok=ok)
    if not ok:
        fail(f"{phase}: the card's predictions disagree with the CPU or are not finite")
    return counts


def gvp_work(x: dict, bwd: bool) -> tuple[int, int, int]:
    """Operations and bytes of one call on these inputs, and the operations
    counted at every padded row. The products the function needs: per node
    s Wsi, s Wsj and v Whi, v Whj (each 3 components); per live (node,
    neighbour) row nrm Wnrm, rbf Wrbf, the gate and v Wmu of layer 0 and
    v Wh, s Ws, nrm Wnrm, the gate and v Wmu of layers 1 and 2; two
    operations a multiply-add. The backward recomputes the forward and takes
    two products per forward product (the input's and the weight's
    cotangents): three times the forward. Each input read once, each output
    written once."""
    s, vx, _, _, nbrs, mask, rbf, ux, _, _, weights = x["args"]
    (N, ds), dv, nb = s.shape, vx.shape[1], rbf.shape[1]
    h0 = 2 * dv + 1
    per_node = 2 * ds * ds + 6 * dv * h0
    per_row = h0 * ds + nb * ds + ds * dv + 3 * h0 * dv + 2 * (6 * dv * dv + ds * ds + 2 * dv * ds)
    scale = 3 if bwd else 1
    ops = scale * 2 * (N * per_node + x["live_rows"] * per_row)
    padded_ops = scale * 2 * (N * per_node + x["padded_rows"] * per_row)
    ins = nbytes(*x["args"][:10], *weights) + (nbytes(*x["cot"]) if bwd else 0)
    outs = (nbytes(*x["args"][:4], rbf, *x["args"][7:10], *weights) if bwd else nbytes(s, vx) + 2 * nbytes(vx))
    return ops, ins + outs, padded_ops


def kernel_record(fn, path_launches: int, max_abs_err: float, kernel_t: dict, plain_t: dict,
                  bound_ms: float, bound_by: str, library_t: dict | None = None) -> dict:
    source, replaces = KERNELS[fn]
    return {"name": fn.__name__, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches, "max_abs_err": max_abs_err, "ms": kernel_t["device"],
            "plain_ms": plain_t["device"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None if library_t is None else library_t["device"]}


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
        csv_path = lipo_csv(tmp, N_MOLS)
        ds = build_dataset({"csv": str(csv_path), "targets": {"y": {"columns": ["lipo"]}}})
        batches = list(DataLoader(ds, batch_size=BATCH))
        main_G = batches[0]["inputs.G"]  # the serving and training shape: 32 bins of 128 edge lanes
        # wide bins: the loader's 256-lane bins, filled with the largest molecules
        wide = sorted((ds[i]["G"] for i in range(len(ds))), key=lambda g: -g.num_edges)[:BATCH]
        wide_G = pack_graphs_dense(wide, 256 // 2 + 8, 256, np_out=True)

        # the kernels against their plain versions at the shapes the paths give them
        main_args = kernel_inputs(main_G, d, depth, SEED)
        wide_args = kernel_inputs(wide_G, d, depth, SEED + 1)
        cases = [compare(main_args, depth, res, red, main_G.nodes_per_graph)
                 for red in ("sum", "mean") for res in (True, False)]
        cases += [compare(wide_args, depth, True, red, wide_G.nodes_per_graph) for red in ("sum", "mean")]
        emit(phase="kernel_vs_plain", rtol=RTOL, atol=ATOL, cases=cases)

        train_cases = []
        for G, seed, residuals in ((main_G, SEED, (True, False)), (wide_G, SEED + 1, (True,))):
            for depth_ in (depth, 1):
                args = kernel_inputs(G, d, depth_, seed)
                g = cotangent(G, d, seed + 10)
                train_cases += [compare_training(args, g, depth_, res, red, G.nodes_per_graph)
                                for red in ("sum", "mean") for res in residuals]
        emit(phase="train_kernels_vs_plain", rtol=RTOL, atol=ATOL,
             grad_atol="ATOL x the largest |value| of each gradient", cases=train_cases)

        # rows 5-6 at the per-molecule dense loader's first batch of these
        # molecules and at its widest batch over all of lipo (sorted by size)
        dense_batches = list(DataLoader(ds, batch_size=BATCH, layout="dense"))
        dense_G = dense_batches[0]["inputs.G"]
        lipo = build_dataset({"csv": str(ROOT / "tests" / "data" / "lipo.csv"),
                              "targets": {"y": {"columns": ["lipo"]}}})
        widest_G = max((b["inputs.G"] for b in DataLoader(lipo, batch_size=BATCH, layout="dense",
                                                          sort_by_size=True)),
                       key=lambda G: (G.src.shape[1], G.node_mask.shape[1]))
        encoder_cases = [compare_encoder(encoder_inputs(G, d, depth_, seed), depth_, res, red)
                         for G, seed in ((dense_G, SEED + 2), (widest_G, SEED + 3))
                         for depth_ in (depth, 1) for red in ("sum", "mean") for res in (True, False)]
        emit(phase="encoder_vs_plain", rtol=RTOL, atol=ATOL,
             grad_atol="ATOL x the largest |value| of each gradient", cases=encoder_cases)

        dense_args = kernel_inputs(dense_G, d, depth, SEED + 4)
        dbuf_launches, dbuf_err, dbuf_cases = dbuf_phase(
            [(main_args, main_G.nodes_per_graph), (dense_args, dense_G.nodes_per_graph)])
        emit(phase="dbuf_vs_plain", rtol=RTOL, atol=ATOL, launches=dbuf_launches, cases=dbuf_cases)

        # rows 8-9 at the first flat lipo batch (V = 2048, E = 4096) and a random case
        flat_batches = list(DataLoader(ds, batch_size=BATCH, layout="flat", csr_pack=True))
        flat_G = flat_batches[0]["inputs.G"]
        flat_x = flat_inputs(flat_G, d, SEED + 5)
        rowptr_err, packed_err, flat_cases = flat_kernels_phase(
            {"lipo_first_flat_batch": flat_x, "random_empty_and_overfull": random_flat_inputs(d, SEED + 6)})
        emit(phase="flat_kernels_vs_plain", sum_atol=f"{SUM_ATOL} x each element's sum of |terms|",
             cases=flat_cases)
        rowptr_launches, rowptr_path_err = rowptr_phase(flat_batches, d)
        emit(phase="rowptr", batches=len(flat_batches), launches=rowptr_launches, max_abs_err=rowptr_path_err)

        # rows 10-13 at the graph transformer's first packed batch (16 bins of
        # V = 128, E = 256), the dense loader's first and widest batches, and
        # random wider bins, edge bias on and off
        heads = GT_CFG["num_heads"]
        gt_batches = list(DataLoader(ds, batch_size=BATCH, **gat_loader_kwargs("dense_packed")))
        packed_attn_G = gt_batches[0]["inputs.G"]
        attn_cases = [compare_attention(batch_attention_inputs(G, d, heads, SEED + 30 + i, on), heads,
                                        f"{name}, edge bias {'on' if on else 'off'}")
                      for i, (name, G) in enumerate((("packed_first_batch", packed_attn_G),
                                                     ("dense_first_batch", dense_G),
                                                     ("dense_widest_batch", widest_G)))
                      for on in (True, False)]
        attn_cases += [compare_attention(random_attention_inputs(d, heads, SEED + 35, on), heads,
                                         f"random V=256 E=512, edge bias {'on' if on else 'off'}")
                       for on in (True, False)]
        emit(phase="attention_kernels_vs_plain", rtol=RTOL, atol=ATOL,
             grad_atol="ATOL x the largest |value| of each gradient", cases=attn_cases)
        v1_launches, v1_fwd_err, v1_bwd_err = attention_v1_phase(gt_batches, d, heads)
        emit(phase="attention_v1", batches=len(gt_batches), launches={"fused_dense_attention_fwd": v1_launches,
                                                                      "fused_dense_attention_bwd": v1_launches},
             max_abs_err={"fused_dense_attention_fwd": v1_fwd_err, "fused_dense_attention_bwd": v1_bwd_err})

        served = serve_phase(tmp, ds, csv_path, len(batches))
        trained = train_phase(tmp)
        recomputed = train_epoch_phase(tmp)
        declarative, declarative_ckpt = train_declarative_phase(tmp)
        serve_declarative_phase(tmp, declarative_ckpt, len(dense_batches))
        flat_trained, flat_ckpt = train_flat_phase(tmp)
        serve_checkpoint_phase(tmp, flat_ckpt, "serve_flat",
                         {"csr_segment_sum_packed": (depth + 1) * len(flat_batches)})
        serve_checkpoint_phase(tmp, train_declarative_flat_phase(tmp), "serve_declarative_flat", {})
        attention, attention_ckpt = train_run_phase(
            tmp, "train_declarative_attention", declarative_attention_model_cfg(d, depth, heads), TRAIN_EPOCHS,
            declarative_attention_launches)
        serve_checkpoint_phase(tmp, attention_ckpt, "serve_declarative_attention",
                               {"fused_dense_attention_fwd_v2": depth * len(dense_batches)})
        serve_checkpoint_phase(tmp, train_run_phase(tmp, "train_graph_transformer", dict(GT_CFG), TRAIN_EPOCHS,
                                                    no_kernel)[1], "serve_graph_transformer", {})
        serve_checkpoint_phase(tmp, train_run_phase(tmp, "train_gat", dict(GAT_CFG), 1, no_kernel)[1], "serve_gat", {})

        # rows 14-15 against their plain versions, then the GVP model both ways
        gvp_train, gvp_val = gvp_data()
        gvp_x = gvp_cases(gvp_train)
        gvp_records = [compare_gvp(x, name) for name, x in gvp_x.items()]
        emit(phase="gvp_kernels_vs_plain", rtol=RTOL, atol=ATOL,
             grad_atol="ATOL x the largest |value| of each gradient", cases=gvp_records)
        gvp_cfg = declarative_gvp_model_cfg()
        gvp_depth = gvp_cfg["modules"]["backbone"]["args"]["depth"]
        gvp_trained, gvp_ckpt = train_gvp_phase(tmp, "train_declarative_gvp", gvp_cfg, gvp_train, gvp_val,
                                                GVP_EPOCHS, gvp_depth)
        gvp_served = serve_gvp_phase(gvp_ckpt, gvp_cfg, gvp_train, "serve_declarative_gvp",
                                     {"fused_gvp_conv_fwd": gvp_depth * len(gvp_train)})
        recipe_ckpt = train_gvp_phase(tmp, "train_gvp_recipe", dict(GVP_RECIPE), gvp_train, gvp_val, 1, 0)[1]
        serve_gvp_phase(recipe_ckpt, dict(GVP_RECIPE), gvp_train, "serve_gvp_recipe", {})

    # time each kernel and its plain version at the serving and training shape
    h0, src, dst, mask, W, b = main_args
    g = cotangent(main_G, d, SEED + 10)
    kw = dict(depth=depth, n_nodes=main_G.nodes_per_graph, residual=True, reduce="sum")
    ref_kw = dict(depth=depth, residual=True, reduce="sum")
    out, hs = fused_dense_mpnn_block_stash(*main_args, **kw)
    g_h0, g_W, g_b = fused_dense_mpnn_block_bwd_stash(h0, hs, src, dst, mask, W, g, **kw)
    fwd_ops, bwd_ops, nnz = layer_ops(main_args, "sum")
    runs = {
        fused_dense_mpnn_block: (
            lambda: fused_dense_mpnn_block(*main_args, **kw),
            lambda: dense_mpnn_block_reference(*main_args, **ref_kw),
            depth * fwd_ops, nbytes(*main_args, out)),
        fused_dense_mpnn_block_stash: (
            lambda: fused_dense_mpnn_block_stash(*main_args, **kw),
            lambda: dense_mpnn_block_stash_reference(*main_args, **ref_kw),
            depth * fwd_ops, nbytes(*main_args, out, hs)),
        fused_dense_mpnn_block_bwd_stash: (
            lambda: fused_dense_mpnn_block_bwd_stash(h0, hs, src, dst, mask, W, g, **kw),
            lambda: dense_mpnn_block_bwd_reference(h0, hs, src, dst, mask, W, g, **ref_kw),
            depth * bwd_ops, nbytes(h0, hs, src, dst, mask, W, g, g_h0, g_W, g_b)),
        fused_dense_mpnn_block_bwd: (
            lambda: fused_dense_mpnn_block_bwd(h0, src, dst, mask, W, b, g, **kw),
            lambda: dense_mpnn_block_bwd_reference(
                h0, dense_mpnn_block_stash_reference(*main_args, **ref_kw)[1], src, dst, mask, W, g,
                **ref_kw),
            (depth - 1) * fwd_ops + depth * bwd_ops, nbytes(*main_args, g, g_h0, g_W, g_b)),
    }
    # rows 5-6 at the dense loader's first batch, with the stash, as the
    # declarative run trains; row 7 at row 1's shape
    enc = encoder_inputs(dense_G, d, depth, SEED + 2)
    nf, ef, _, _, _, _, _, gn, ge = enc
    enc_kw = dict(depth=depth, residual=True, reduce="sum")
    nh, eh, enc_hs = fused_dense_encoder_fwd(*enc[:7], stash=True, **enc_kw)
    enc_grads = fused_dense_encoder_bwd(nf, ef, enc_hs, *enc[2:6], gn, ge, **enc_kw)
    enc_fwd_ops, enc_bwd_ops, enc_nnz = encoder_ops(enc)
    runs[fused_dense_encoder_fwd] = (
        lambda: fused_dense_encoder_fwd(*enc[:7], stash=True, **enc_kw),
        lambda: dense_encoder_reference(*enc[:7], stash=True, **enc_kw),
        enc_fwd_ops, nbytes(*enc[:7], nh, eh, enc_hs))
    runs[fused_dense_encoder_bwd] = (
        lambda: fused_dense_encoder_bwd(nf, ef, enc_hs, *enc[2:6], gn, ge, **enc_kw),
        lambda: dense_encoder_bwd_reference(nf, ef, enc_hs, *enc[2:6], gn, ge, **enc_kw),
        enc_bwd_ops, nbytes(nf, ef, enc_hs, *enc[2:6], gn, ge, *enc_grads))
    runs[fused_dense_mpnn_block_dbuf] = (
        lambda: fused_dense_mpnn_block_dbuf(*main_args, mols_per_tile=8, **kw),
        lambda: dense_mpnn_block_reference(*main_args, **ref_kw),
        depth * fwd_ops, nbytes(*main_args, out))
    # rows 8-9 at the first flat lipo batch: all 4,096 rows dst-sorted for
    # row 8 (the padding edges' rows go to the sink), the real edges for row 9
    x, V = flat_x, flat_G.num_nodes
    n_real, E = int(x["edge_mask"].sum()), flat_G.num_edges
    runs[csr_segment_sum_packed] = (
        lambda: csr_segment_sum_packed(x["data"], x["perm"], x["packed_dst"], V),
        lambda: csr_segment_sum_packed_reference(x["data"], x["perm"], x["packed_dst"], V),
        n_real * d, n_real * d * 4 + nbytes(x["perm"], x["packed_dst"]) + V * d * 4)
    runs[csr_segment_sum] = (
        lambda: csr_segment_sum(x["sorted_data"], x["sorted_dst"], x["row_ptr"], V),
        lambda: csr_segment_sum_reference(x["sorted_data"], x["row_ptr"], V),
        E * d, nbytes(x["sorted_data"], x["row_ptr"]) + V * d * 4)
    libraries = {
        csr_segment_sum_packed: (library_index_add(x), "torch.zeros(V + 1, d).index_add_ over the real edges"),
        csr_segment_sum: (library_segment_reduce(x), "torch.segment_reduce(sum, offsets=row_ptr)"),
    }
    path_launches = {
        fused_dense_mpnn_block: served,
        fused_dense_mpnn_block_stash: trained["fused_dense_mpnn_block_stash"],
        fused_dense_mpnn_block_bwd_stash: trained["fused_dense_mpnn_block_bwd_stash"],
        fused_dense_mpnn_block_bwd: recomputed["fused_dense_mpnn_block_bwd"],
        fused_dense_encoder_fwd: declarative["fused_dense_encoder_fwd"],
        fused_dense_encoder_bwd: declarative["fused_dense_encoder_bwd"],
        fused_dense_mpnn_block_dbuf: dbuf_launches,
        csr_segment_sum: rowptr_launches,
        csr_segment_sum_packed: flat_trained["csr_segment_sum_packed"],
    }
    errors = {
        fused_dense_mpnn_block: max(c["max_abs_err"] for c in cases),
        fused_dense_mpnn_block_stash: max(c["max_abs_err"]["stash_fwd"] for c in train_cases),
        fused_dense_mpnn_block_bwd_stash: max(c["max_abs_err"]["bwd_stash"] for c in train_cases),
        fused_dense_mpnn_block_bwd: max(c["max_abs_err"]["bwd_recompute"] for c in train_cases),
        fused_dense_encoder_fwd: max(c["max_abs_err"]["fwd"] for c in encoder_cases),
        fused_dense_encoder_bwd: max(c["max_abs_err"]["bwd"] for c in encoder_cases),
        fused_dense_mpnn_block_dbuf: dbuf_err,
        csr_segment_sum: max(rowptr_err, rowptr_path_err),
        csr_segment_sum_packed: packed_err,
    }
    shapes = {fn: (list(h0.shape), nnz) for fn in runs}
    shapes[fused_dense_encoder_fwd] = shapes[fused_dense_encoder_bwd] = (
        {"B": ef.shape[0], "V": nf.shape[1], "E": ef.shape[1], "d": d}, enc_nnz)
    shapes[csr_segment_sum] = shapes[csr_segment_sum_packed] = (
        {"V": V, "E": E, "d": d, "real_edges": n_real}, None)
    records = []
    for fn, (kernel, plain, ops, n_bytes) in runs.items():
        kernel_t, plain_t = time_ms(kernel), time_ms(plain)
        library, library_note = libraries.get(
            fn, (None, "no single PyTorch call computes the fused block, the encoder or their backwards"))
        library_t = None if library is None else time_ms(library)
        bound_ms, bound_by = bound(ops, n_bytes)
        emit(phase="time", kernel=fn.__name__, shape=shapes[fn][0],
             depth=None if fn in libraries else depth, reduce="sum",
             ms=kernel_t["device"], plain_ms=plain_t["device"], eager_ms=kernel_t["eager"],
             plain_eager_ms=plain_t["eager"], bound_ms=bound_ms, bound_by=bound_by,
             operations=ops, bytes=n_bytes, nnz_A=shapes[fn][1],
             library_ms=None if library_t is None else library_t["device"], library_note=library_note)
        records.append(kernel_record(fn, path_launches[fn], errors[fn], kernel_t, plain_t,
                                     bound_ms, bound_by, library_t))
    # rows 10-13 at both of their shapes; the kernels line takes rows 12-13
    # at the dense first batch (the declarative path's) and rows 10-11 at
    # the packed first batch (the graph transformer's bins)
    attn_x = {"packed_first_batch": batch_attention_inputs(packed_attn_G, d, heads, SEED + 30),
              "dense_first_batch": batch_attention_inputs(dense_G, d, heads, SEED + 32)}
    attn_path = {fused_dense_attention_fwd: ("packed_first_batch", v1_launches, v1_fwd_err),
                 fused_dense_attention_bwd: ("packed_first_batch", v1_launches, v1_bwd_err),
                 fused_dense_attention_fwd_v2: ("dense_first_batch", attention["fused_dense_attention_fwd_v2"], 0.0),
                 fused_dense_attention_bwd_v2: ("dense_first_batch", attention["fused_dense_attention_bwd_v2"], 0.0)}
    for fn, (path_shape, path_count, phase_err) in attn_path.items():
        bwd = fn in (fused_dense_attention_bwd, fused_dense_attention_bwd_v2)
        path_err = max(phase_err, *(c["max_abs_err"][fn.__name__] for c in attn_cases))
        for shape, ax in attn_x.items():
            kernel = ((lambda fn=fn, ax=ax: fn(*ax[:7], ax[7], num_heads=heads)) if bwd
                      else (lambda fn=fn, ax=ax: fn(*ax[:7], num_heads=heads)))
            plain = ((lambda ax=ax: dense_attention_bwd_reference(*ax[:7], ax[7], heads)) if bwd
                     else (lambda ax=ax: dense_attention_reference(*ax[:7], heads)))
            kernel_t, plain_t = time_ms(kernel), time_ms(plain)
            library_t = time_ms(library_sdpa(ax, heads, bwd))
            ops, n_bytes, dense_ops = attention_work(ax, heads, bwd)
            bound_ms, bound_by = bound(ops, n_bytes)
            # rows 10-11 at their path's shape: each pass's device time over
            # 20 calls (the profiler can drop the records of a run's last
            # microseconds, which would hold all of 5 calls of a few us)
            breakdown = (profile_busy(lambda kernel=kernel: [kernel() for _ in range(20)])["top"]
                         if shape == path_shape and fn in (fused_dense_attention_fwd, fused_dense_attention_bwd)
                         else None)
            emit(phase="time", kernel=fn.__name__, shape={"case": shape, "B": ax[0].shape[0], "V": ax[0].shape[1],
                                                          "E": ax[4].shape[1],
                                                          "d": d, "heads": heads, "live_pairs": live_pairs(ax)},
                 ms=kernel_t["device"], plain_ms=plain_t["device"], eager_ms=kernel_t["eager"],
                 plain_eager_ms=plain_t["eager"], bound_ms=bound_ms, bound_by=bound_by, operations=ops,
                 dense_operations=dense_ops, bytes=n_bytes, library_ms=library_t["device"],
                 library_note=("scaled_dot_product_attention forward and autograd backward" if bwd else
                               "scaled_dot_product_attention") + ", the additive mask and bias built beforehand",
                 **({} if breakdown is None else {"kernels_of_20_calls": breakdown}))
            if shape == path_shape:
                records.append(kernel_record(fn, path_count, path_err, kernel_t, plain_t, bound_ms, bound_by,
                                             library_t))
    # rows 14-15 at the GVP model's first training batch
    gx = gvp_x["first_training_batch"]
    for fn, bwd in ((fused_gvp_conv_fwd, False), (fused_gvp_conv_bwd, True)):
        plain = ((lambda: gvp_conv_bwd_reference(*gx["args"], *gx["cot"], GVP_WINDOW)) if bwd
                 else (lambda: gvp_conv_reference(*gx["args"], GVP_WINDOW)))
        kernel_t, breakdown, stages, scratch_mb = time_gvp(fn, gx)
        plain_t = time_ms(plain)
        ops, n_bytes, padded_ops = gvp_work(gx, bwd)
        bound_ms, bound_by = bound(ops, n_bytes)
        emit(phase="time", kernel=fn.__name__,
             shape={"N": gx["N"], "K": 16, "ds": 256, "dv": 32, "nb": 16, "live_rows": gx["live_rows"],
                    "padded_rows": gx["padded_rows"]},
             ms=kernel_t["device"], plain_ms=plain_t["device"], eager_ms=kernel_t["eager"],
             plain_eager_ms=plain_t["eager"], bound_ms=bound_ms, bound_by=bound_by, operations=ops,
             operations_at_padded_rows=padded_ops, bound_ms_at_padded_rows=bound(padded_ops, n_bytes)[0],
             bytes=n_bytes, library_ms=None, library_note="none: no single PyTorch call",
             launches={"train": gvp_trained[fn.__name__], "serve": gvp_served[fn.__name__]},
             kernels_of_5_calls=breakdown, stages_ms=stages, scratch_mb=scratch_mb)
        records.append(kernel_record(fn, gvp_trained[fn.__name__],
                                     max(c["max_abs_err"][fn.__name__] for c in gvp_records),
                                     kernel_t, plain_t, bound_ms, bound_by))
    # row 8 again with the padding sink's run cut (row pointers clipped at
    # the last real edge): what the sink's 358-row run costs
    cut = torch.clamp(x["row_ptr"], max=n_real)
    emit(phase="time_rowptr_without_sink", shape=shapes[csr_segment_sum][0],
         ms=time_ms(lambda: csr_segment_sum(x["sorted_data"], x["sorted_dst"], cut, V))["device"])
    missing = [r["name"] for r in records if r["launches"] <= 0]
    if missing:
        fail(f"kernels never launched on their path: {missing}")
    emit(kernels=records)
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": kind, "count": count})


if __name__ == "__main__":
    main()
