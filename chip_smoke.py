"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of ``notorch_tpu_torch`` from the sources in this
checkout and drives the port's paths with the D-MPNN regression model of
``configs/dmpnn_regression.yaml`` (hidden 256, depth 3, mean readout, 1 FFN
layer, Adam with the Noam schedule, batch 64; random weights from a seed):

- utilities: the JAX train CLI's default input path. The C++ featurizer
  (``notorch_tpu_torch.native``, which ``run`` uses wherever a compiler
  exists) against the Python pipeline on the first 1,024 lipo molecules,
  array for array, with both host times; ``configs/dmpnn_regression.yaml``
  as shipped (all of lipo) through ``run(cfg)`` for 2 epochs at three
  settings, ``prefetch: 0``, the default ``prefetch: 4`` and ``prefetch: 4,
  steps_per_dispatch: 4``, which must end with the same bits in every
  parameter and Adam state, launch rows 1-3 and 8 alike and log the same
  losses, then warm epochs of each timed in turns and profiled; 3 steps of the block
  with ``backward: jnp`` in lockstep with ``backward: stash`` (row 1, no
  row 2 or 3); and, in a fresh process, a warm epoch of the grouped
  setting under ``trace``/``annotate``/``StepTimer``;
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
- dbuf: the depth-fused block forward (row 7, one launch a call, a group
  of blocks a bin), which no module calls, in a phase of its own;
- flat kernels: the two CSR segment sums against their plain versions at
  the first flat lipo batch and at a random case with empty and over-full
  nodes, each twice, bit for bit, with the bits of the CPU plain version;
  the row-pointer sum (row 8) on the dst-sorted copy of each flat batch in a
  phase of its own, as before the paths called it; then row 8 as every path
  calls it through ``nn/ops.py`` ``segment_sum`` (the stable sort of the
  ids, then the kernel) at the main path's node scatter and PackedMean's sum
  and count, twice, with ``index_add``'s CPU bits;
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
- train/serve classification: ``configs/dmpnn_multitask_classification.
  yaml`` as shipped (12 masked BCE tasks, the scaffold split, Adam at 1e-3,
  the recipe's block: rows 2 and 3 on every step, row 1 on every evaluated
  batch) on 1,024 lipo molecules with 12 structural labels, a fifth
  missing, for 2 epochs, card against CPU epoch by epoch (losses, val AUROC
  and AUPRC), a warm epoch timed and profiled, then its checkpoint served
  (12 probabilities a molecule);
- task heads: one train step of each other head (multiclass with 3
  classes, mve, evidential, dirichlet) at full width on the first packed
  lipo batch, card against CPU from the same weights;
- train/serve multicomponent, reaction, MoE and pretrain: ``configs/
  multicomponent.yaml`` (two flat encoders, hidden 256, depth 3, layer
  norm; 1,024 lipo molecules each beside a solvent of ``tests/data/
  multi.csv``), ``configs/reaction_regression.yaml`` (REAC_DIFF CGR graphs
  of the 100 reactions of ``tests/data/rxns.csv`` with seeded targets,
  ``dense_packed``: rows 1-3), ``configs/moe_regression.yaml`` (1,024 lipo
  molecules, the sparse router) and ``configs/pcqm4m_pretrain.yaml``
  (hidden 512, depth 5, batches of 1,024 over lipo's 4,200 SMILES) as
  shipped, 2 epochs of ``run(cfg)`` each, card against CPU epoch by epoch,
  a warm epoch timed and profiled, then each checkpoint but the
  pretrainer's served, card against CPU; row 8 in all four;
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
  plain tensor ops, no kernel of the port but row 8 in its glue), one epoch,
  card against CPU, then served;
- train/serve SchNet: ``build_model({"kind": "spatial", "backbone":
  "schnet"})`` at the JAX recipe's defaults (hidden 256, depth 3, radius 5,
  16 neighbours, the sum readout, Adam at 1e-3; row 8 in its glue, the
  backward of each layer's neighbour gather included), 2 epochs on the GVP
  runs' clouds, card against CPU epoch by epoch at SCHNET_RUN_RTOL and every
  step in lockstep, then served from its checkpoint;
- sdf SchNet: 256 synthetic conformers written as an SDF file and read
  back through ``SDFDatabase``, ``MolecularDataset(databases=...)`` with
  ``MolToPointCloud`` and the loader, one epoch of ``fit`` (in lockstep
  with the CPU) and a ``predict`` on the card against the CPU;
- train/serve dropout and max: ``configs/dmpnn_regression.yaml`` with
  ``model.dropout: 0.1`` (auto -> the plain ``dense`` layout: the plain
  block, edge dropout on each layer's update and in the FFN, no kernel but
  row 8 in the embeddings' backward) and with ``model.reduce: max``
  (``dense_packed`` -> the plain block over the packed bins), 2 epochs of
  ``run(cfg)`` each on 1,024 molecules, card against CPU epoch by epoch at
  TRAIN_RTOL (the dropout masks are the same on both devices), a warm
  epoch timed and profiled (with the masks' share of it), then served, 512
  molecules card against CPU;
- dropout lockstep: LOCKSTEP_STEPS steps at dropout 0.1, card against CPU
  from the same weights and dropout streams, of the declarative graph
  transformer (rows 12-13 in every layer), ``configs/gat_regression.yaml``
  and the declarative GVP model;
- train/serve bf16 block: the declarative whole encoder with
  ``matmul_dtype: bfloat16, stash_dtype: bfloat16`` (rows 5-6's bf16
  instantiations) for 2 epochs, card against CPU at BF16_RUN_RTOL and every
  step in lockstep, then served at the bf16 hold; then the block alone
  (``fuse_ends: false``; rows 1-4's bf16 instantiations) for LOCKSTEP_STEPS
  steps in lockstep with each backward and a served batch;
- bf16 kernels: the depth-fused forward's bf16 mode (row 7b) in a phase of
  its own against its plain version at the bf16 holds and against row 1b bit
  for bit (both sum their products on the tensor cores in one order); row 8b (the
  glue's ordered bf16 sum) against the CPU's bits, on the glue's cases and on pairs
  of every class of BF16_PAIR_CLASSES (subnormals, signed zeros,
  infinities, ties, exponent gaps); the attention core's
  ``matmul_dtype="bfloat16"`` mode (rows 10b-13b on f32 inputs, which no
  module passes) over the packed and dense batches in a phase of its own,
  then all four entries in both bf16 modes against their plain versions;
- train/serve bf16 models: ``dtype: bfloat16`` on the declarative graph
  transformer (rows 12b-13b with bf16 inputs in every layer), on
  ``configs/dmpnn_regression.yaml`` (the plain dense layout) and on
  ``configs/gat_regression.yaml`` (GATv2 on packed bins; row 8b in their
  glue), 2 epochs each card against CPU (the attention runs every step in
  lockstep), a warm epoch timed and profiled, then served card against CPU
  at the bf16 hold;
- bf16 csr: row 9b (the packed sum on bf16 data, rounding each 128-slot
  chunk's f32 partial and each add of the partials to bf16, as the TPU
  kernel's grid does) against its plain version at the first flat lipo
  batch and at cases whose runs straddle one and two chunk boundaries,
  twice, bit for bit, with the CPU plain version's bits; then
  ``configs/dmpnn_regression.yaml`` with ``model.impl: csr`` and
  ``model.dtype: bfloat16`` (the flat block, every E->V sum through row 9b,
  row 8b in its glue), 2 epochs card against CPU at BF16_MODEL_RUN_RTOL, a
  warm epoch timed and profiled, and its checkpoint served, 512 molecules
  card against CPU at the bf16 hold;
- repeat: the thirteen paths' models (the recipe, its declarative twin,
  ``impl: csr``, the declarative graph transformer, the declarative GVP
  model, the GVP recipe, the classification model, whose masked BCE
  runs over NaN-filled targets, the multicomponent model, the SchNet
  recipe, the recipe at dropout 0.1, the bf16 encoder, the bf16 graph
  transformer and the bf16 ``impl: csr`` model) each take 3
  training steps twice from the
  same weights, and every parameter and Adam state tensor must have the
  same bits: every sum of the glue is fixed-order (``nn/ops.py``
  ``segment_sum`` and ``take`` through row 8), and the dropout masks come
  from the models' own generators;
- train attention calm: the calm attention recipe (hidden 32, Adam at
  1e-4) whole-run, card against CPU at ATTENTION_CALM_RTOL.

Row 8 runs on every path whose glue sums (ROW8_LAUNCHES: the readouts,
the packed block's node scatter and the backward of every gather), and each
path's launch counts expect it there.

Every kernel is held against its plain PyTorch version on the card at the
shapes these paths give it (rows 1b-7b and 10b-13b too, at the BF16
tolerances, and rows 8b and 9b bit for bit, each twice for the same bits), each path's launch counts
are read, and the kernels are timed. Each phase prints one JSON line; then come a ``kernels``
line, the card's name and power limit as ``nvidia-smi`` gives them, and last
- spatial bf16: the declarative SchNet and GVP models at ``dtype:
  bfloat16`` (``declarative_spatial_bf16_cfg``, full width; GVP's plain
  conv, the fused conv being f32 only) on two batches of the GVP clouds, 2
  epochs of ``fit`` card against CPU at SPATIAL_BF16_RUN_RTOL and every step
  in lockstep at the bf16 models' hold; SchNet's neighbour gathers launch
  row 8b;
- parallel: the parallel package at world size 1, in two fresh processes
  side by side (``parallel_child``: NCCL on the card, gloo on the CPU,
  each on a ``file://`` store): ``configs/dmpnn_halo.yaml`` through
  ``run(cfg)`` at ``trainer.spmd: {data: 1, graph: 1}`` (1,024 lipo
  molecules, 2 epochs) and the pretraining config's widths at the same
  mesh (a few steps, the molecule partition), card against CPU epoch by
  epoch, row 8 counted (ROW8_LAUNCHES); DenseSpmdTrainer on the regression
  config's packed batches (rows 2-3) and an MoE model sharded over an
  expert group of one, each 3 steps with the plain step's bits in every
  parameter and Adam state; the shipped halo config's 2 x 4 mesh raising
  ``make_mesh``'s ValueError; each sharded path's warm ms a step beside the
  plain step's;
``{"ok": true, "device": {...}}``. Any failure exits non-zero without that
line; so does a machine with no CUDA device.
"""

from __future__ import annotations

import csv
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from notorch_tpu_torch import native
from notorch_tpu_torch.chem.smiles import parse_smiles
from notorch_tpu_torch.cli.predict import run_predict
from notorch_tpu_torch.cli.train import (
    build_dataset,
    build_model,
    build_optimizer,
    fit_loaders,
    prepare,
    prepare_pretrain,
    run,
    save_predict_meta,
)
from notorch_tpu_torch.data.batching import DataLoader, StackedBatch
from notorch_tpu_torch.data.databases import SDFDatabase
from notorch_tpu_torch.data.dataset import DatabaseManager, MolecularDataset, TargetSpec
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
    segment_sum_in_order_reference,
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
    BF16_WRAPPERS,
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
from notorch_tpu_torch.training.profiling import StepTimer, annotate, trace
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol
from notorch_tpu_torch.transforms.point_cloud import MolToPointCloud
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
# the calm attention recipe: the declarative graph transformer at hidden 32,
# depth 3, 4 heads, Adam at 1e-4, the first 256 lipo molecules in batches of
# 32 (file order) for 4 epochs, the next 64 the validation set. Port-CPU
# against JAX-CPU from the same weights its per-epoch losses drift 6.42e-6 at
# 8 threads and 6.31e-6 at one (three fresh processes each, alike), at 3e-4
# 9.4e-6 and at 1e-3 1.45e-5, while one weight tensor of the port's side
# scaled by 1.03 drifts 3.3e-2 to 4.9e-2 (tests/test_torch_attention_run.py).
# So its whole run is held at ATTENTION_CALM_RTOL, about 3x its drift, port
# against JAX there and card against CPU here
CALM_ATTENTION = {"d": 32, "train": 256, "val": 64, "batch": 32, "epochs": 4, "lr": 1e-4}
ATTENTION_CALM_RTOL = 2e-5
# the bf16 encoder's run (train_bf16_block: bf16_block_model_cfg), card
# against CPU, per-epoch losses and metrics. Port-CPU against JAX-CPU the
# same run (TRAIN_MOLS molecules, TRAIN_EPOCHS epochs, from the same weights)
# drifts 7.73e-4 (three fresh processes, alike): an f32 ulp of a sum flips a
# bf16 rounding now and then, and Adam grows it; with one weight tensor of
# the port's side scaled by 1.03 it drifts 3.8e-3 (ffn.dense_0.weight), 5.2e-3
# (the node embedding) and 6.9e-3 (the block's weights) (python -m
# tests.test_torch_bf16_run 256 1024 [WEIGHT]). So BF16_RUN_RTOL lies about 3x
# over the drift and under every scaled weight, and every step is held in
# lockstep
BF16_RUN_RTOL = 2.5e-3
# rows 1-6 with bf16 operands against their plain versions: both round the
# same operands and sum in f32 in other orders, and an f32 ulp of a sum can
# flip the next operand's bf16 rounding (2^-8 relative), so each tensor is
# held elementwise at BF16_ELEMENT_TOL of its largest magnitude and in
# relative L2 at BF16_L2_TOL (tests/test_torch_gpu.py: measured 1.25e-3 and
# 1.8e-4 at most; the bf16 rows differ from the f32 rows by 4.5e-3 in L2)
BF16_ELEMENT_TOL, BF16_L2_TOL = 1e-2, 1e-3
# the dropout paths: configs/dmpnn_regression.yaml with model.dropout (auto
# -> the plain dense layout) or model.reduce: max (dense_packed -> the plain
# block over packed bins), and the rate of the lockstep phase's paths
DROPOUT = 0.1
# steps of each lockstep check that does not run a whole run (the dropout
# lockstep phase, the bf16 block alone)
LOCKSTEP_STEPS = 3
# the bf16 block alone (fuse_ends off), lockstep loss: its input h0 =
# nf[src] + ef differs between card and CPU by the embedding sums' rounding
# (7e-8), which flips a few of layer 0's bf16 roundings, and the flips grow
# through the layers to bf16's own scale: the first step's loss differed by
# 2.0e-4 (node hiddens 7.2e-4 in relative L2; H100, 700 W). The whole
# encoder rounds nf to bf16 before its gather, which absorbs those
# differences: its steps agree within 5.6e-7, under LOCKSTEP_RTOL
BF16_LOCKSTEP_RTOL = 1e-3
# lockstep: each step's loss, relative (measured up to 2.3e-7), and each
# gradient at LOCKSTEP_GRAD_RTOL times its largest magnitude: one flipped
# ReLU unit moves a gradient element by that node's whole term (measured up
# to 1.5e-2 of a tensor's largest magnitude); a wrong or missing gradient
# term moves it by its own size. The pure-noise biases are left out
LOCKSTEP_RTOL = 1e-4
LOCKSTEP_GRAD_RTOL = 1e-1
# model-wide dtype: bfloat16: every dense layer of the card (cuBLAS) and of
# the CPU sums its products in other orders, so a rounding to bf16 flips
# now and then and grows through the layers. Measured (H100 80GB HBM3,
# 700 W): the bf16 graph transformer's 26 steps in lockstep differ in loss
# by 2.85e-4 at most and in its gradients by 9.97e-2 in relative L2 (the
# edge-bias weights: g_s = alpha g_alpha - alpha D is a difference rounded
# to bf16), with a ReLU unit of the head switching sides (1.86e-1 of a
# tensor's largest magnitude); the bf16 GAT recipe's 7.9e-4 and 1.34e-1.
# That is bf16's own scale: on the CPU the same bf16 gradients differ from
# the f32 model's by up to 3.2e-1 in relative L2. The steps are held at
# about 3x those (BF16_MODEL_LOCKSTEP_RTOL, BF16_MODEL_GRAD_REL_L2); the
# D-MPNN's whole run drifted 1.01e-3 card against CPU, held at
# BF16_MODEL_RUN_RTOL; the attention runs whole at ATTENTION_RUN_RTOL (the
# transformer's drifted 1.71e-2, the GAT's 2.99e-2)
BF16_MODEL_LOCKSTEP_RTOL = 2.5e-3
BF16_MODEL_GRAD_REL_L2 = 4e-1
BF16_MODEL_RUN_RTOL = 3e-3
ZERO_GRADIENTS = ("W_k.bias", "W_bias.bias", "a.bias")
# H100 SXM peaks at its 700 W limit (NVIDIA data sheet): CUDA-core f32 rate
# and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# and the tensor cores' dense bf16 rate: the least time of a product of bf16
# operands with f32 sums, which the bf16 rows compute
PEAK_BF16_FLOPS = 989e12
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
# vector 256 // 8 = 32, depth 3, radius 5, 16 neighbours, 16 RBF bases, 1 FFN
# layer), its neighbour search banded at 24 (the synthetic clouds have at most
# 25 atoms), with the mean readout and Adam at 3e-5: the calm recipe of the
# whole-run check (GVP_RUN_RTOL below); the recipe runs the plain conv
GVP_RECIPE = {"kind": "spatial", "backbone": "gvp", "hidden_dim": 256, "depth": 3, "radius": 5.0,
              "max_neighbors": 16, "neighbor_window": 24, "aggregation": "mean", "ffn_layers": 1}
GVP_LR, GVP_WINDOW = 3e-5, 24
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
# the GVP runs, card against CPU, per-epoch losses. Adam moves each weight by
# about the rate whatever its gradient's size, so it grows rounding
# differences into differences of the run: with the sum readout (a loss near
# 600) at 1e-3 the same run in the port and in the JAX package, both on the
# CPU in exact float32 from the same weights, drifted apart by 1.18e-1. The
# recipe above drifts by 2.1e-5 (the long test
# tests/test_torch_spatial.py::test_gvp_full_width_run_drifts_apart_in_both_
# packages, which holds it at this limit), and a wrong weight by far more, so
# the whole runs are held at GVP_RUN_RTOL, and every step in lockstep
GVP_RUN_RTOL = 1e-3
# the SchNet recipe of notorch_tpu.models.spatial at its defaults (hidden 256,
# depth 3, radius 5, 16 neighbours, 16 RBF bases, the full neighbour search,
# the sum readout, 1 FFN layer, Adam at 1e-3) on the GVP runs' clouds: no
# kernel of the port but row 8 in its glue, the backward of its neighbour
# gathers included
SCHNET_RECIPE = {"kind": "spatial", "backbone": "schnet", "hidden_dim": 256, "depth": 3, "radius": 5.0,
                 "max_neighbors": 16}
SCHNET_LR = 1e-3
# the SchNet run, card against CPU, per-epoch losses (train_schnet): at
# these defaults the same run in the
# port and in the JAX package, both on the CPU in exact float32 from the same
# weights, drifts apart by 2.24e-5 at 8 threads (three fresh processes,
# alike) and 2.28e-5 at one, and with one weight tensor of the port's side
# scaled by 1.03 (the embedding, in_proj, a filter, out_proj_1, the head) by
# 0.133 to 0.483 (python -m tests.test_torch_schnet 256 512 1e-3 sum). So
# SCHNET_RUN_RTOL lies over 3x the drift and far under a wrong weight, and
# every step is held in lockstep, its gradients element by element (no ReLU)
SCHNET_RUN_RTOL = 1e-4
# the SDF phase: this many synthetic conformers (make_clouds) written as an
# SDF file, each type id 0-8 as the element CLOUD_ELEMENTS names, read back
# through SDFDatabase and MolToPointCloud, one epoch of fit and a predict
SDF_CONFORMERS = 256
CLOUD_ELEMENTS = ("C", "N", "O", "F", "P", "S", "Cl", "Br", "I")
# row 8's launches on each path (nn/ops.py segment_sum and take on the card):
# (a training step, an evaluated or served batch). The glue's segment sums
# launch it in the forward (the readouts' sums and counts, the packed block's
# node scatter, a segment softmax's denominator), the gathers that take a
# gradient in the backward (their segment sum over the ids): the embedding
# tables (node and edge; the point clouds' node), the packed block's h0, the
# flat block's takes (node_feats[src] once, per layer m_v[src] and h[rev],
# the gather impl's in-edges per reduce), a segment softmax's max and
# denominator, the GVP neighbour gathers (the vectors of layer 0 are zeros:
# no gradient). The declarative dense paths sum nothing else outside their
# kernels. The multicomponent model runs two flat encoders (depth 3, the
# gather block) and two Mean readouts, the MoE model one and one, the
# pretrainer one at depth 5 and no readout, the SchNet recipe its node table,
# its sum readout and one neighbour gather a layer (CPU rehearsal: nn/ops.py's
# card branches forced, the row-pointer sum counted). The dropout path (the
# plain dense block, a DenseMean readout) sums only in the embeddings'
# backward; the max path (the plain block over packed bins: one-hot products
# and scatter_reduce's max) there and in PackedMean's sum and count. The bf16
# paths' glue sums bf16 data, through row 8b (csr_segment_sum_bf16): the bf16
# graph transformer and the bf16 D-MPNN (the plain dense block, DenseMean) in
# their embeddings' backward, the bf16 GAT there and in PackedMean's sum and
# count (CPU rehearsal: nn/ops.py's ordered sums of bf16 data counted); the
# bf16 impl: csr model all of its glue's sums, as the f32 impl: csr model
# (CPU rehearsal: the ordered route forced for every dtype, its sums counted
# by dtype: all bf16); the halo model of configs/dmpnn_halo.yaml at world
# size 1 (no boundary, so no exchange) its embeddings', block's and
# readout's sums (the same rehearsal)
ROW8_LAUNCHES = {"recipe": (6, 3), "declarative": (2, 0), "impl_csr": (11, 2), "declarative_attention": (2, 0),
                 "flat": (17, 2), "graph_transformer": (4, 2), "gat": (4, 2), "declarative_gvp": (3, 2),
                 "gvp_recipe": (8, 2), "classification": (6, 3), "multicomponent": (30, 4), "reaction": (6, 3),
                 "moe": (15, 2), "pretrain": (19, 0), "schnet": (5, 1), "dropout": (2, 0), "max": (4, 2),
                 "bf16_transformer": (2, 0), "bf16_dmpnn": (2, 0), "bf16_gat": (4, 2), "bf16_csr": (11, 2),
                 "halo": (15, 0)}
# the forward's stages in a profile (rows 1, 2 and 5, and row 4's replay):
# fragments of its kernels' names (csrc/dense_mpnn.cu: the operator's bit
# rows and the encoder's gathered h0 once a call, then a layer's product
# relu(h) @ W and its operator pass, with the encoder's scatter in the last)
FWD_STAGES = ("mpnn_fwd_prep_", "mpnn_fwd_gemm_", "mpnn_fwd_apply_")
# the bf16 forward's product (rows 1b, 2b, 4b's replay and 5b): the tensor
# cores' kernel, by name in a profile
BF16_FWD_PRODUCT = "mpnn_fwd_gemm_mma_kernel"
# the reverse sweep's stages (rows 3, 4 and 6; csrc/dense_mpnn_bwd.cu: the
# copies of W^T and the operator's bit rows, the adjoint A^T g, the products
# g_mW W^T and relu(h)^T g_mW with their fixed-order chunk sums, the
# encoder's gather VJP), and row 4's forward replay
SWEEP_STAGES = ("bwd_prep_", "bwd_adjoint_", "bwd_gemm_", "bwd_node_grad_", *FWD_STAGES)
# rows 14-15's stages in a profile: fragments of their kernels' names
GVP_STAGES = {
    fused_gvp_conv_fwd: ("fwd_weights_", "fwd_node_", "fwd_layer0_in_", "fwd_layer_gemm<0,", "fwd_layer_gemm<1,",
                         "fwd_layer_gemm<2,", "fwd_mean_"),
    fused_gvp_conv_bwd: ("sweep_", "node_grad_", "wgrad_"),
}
# configs/dmpnn_multitask_classification.yaml written out (the Tox21 shape: 12
# BCE tasks with missing labels, the scaffold split; tests/test_torch_task_
# models.py holds these to the file), trained on TRAIN_MOLS lipo molecules
# with the 12 labels of structural_labels, a fifth missing
CLASSIFICATION_COLUMNS = ["NR-AR", "NR-AR-LBD", "NR-AhR", "NR-Aromatase", "NR-ER", "NR-ER-LBD", "NR-PPAR-gamma",
                          "SR-ARE", "SR-ATAD5", "SR-HSE", "SR-MMP", "SR-p53"]
CLASSIFICATION_MODEL_CFG = {"kind": "dmpnn", "task": "classification", "num_tasks": 12, "hidden_dim": 256,
                            "depth": 3, "aggregation": "mean"}
CLASSIFICATION_OPTIMIZER_CFG = {"name": "adam", "lr": 1.0e-3}
CLASSIFICATION_SPLIT = {"kind": "scaffold", "fractions": [0.8, 0.1, 0.1], "seed": 0}
# the other heads' lockstep step (task_heads): the task types, each with one
# task on the lipo column (mve, evidential) or on its tertile (multiclass and
# dirichlet, 3 classes)
HEAD_TASKS = ("multiclass", "mve", "evidential", "dirichlet")
HEAD_CLASSES = 3
# configs/multicomponent.yaml, configs/reaction_regression.yaml,
# configs/moe_regression.yaml and configs/pcqm4m_pretrain.yaml written out
# (tests/test_torch_multicomponent.py holds them to the files); slice_config
# points them at this run's data and epochs
_SPLIT = {"fractions": [0.8, 0.1, 0.1], "seed": 0}
_MOE_WIDTH = 128
SLICE_CONFIGS = {
    "multicomponent": {
        "data": {"csv": "tests/data/multi.csv",
                 "transforms": {"g1": {"in_key": "smiles1", "out_key": "G1"}, "g2": {"in_key": "smiles2", "out_key": "G2"}},
                 "targets": {"y": {"columns": ["y"], "task": "regression"}}},
        "model": {"kind": "multicomponent", "component_keys": ["inputs.G1", "inputs.G2"], "hidden_dim": 256, "depth": 3,
                  "pred_key": "ffn.preds"},
        "optimizer": {"name": "adam", "lr": 1.0e-3},
        "trainer": {"epochs": 20, "batch_size": 64, "seed": 0},
    },
    "reaction_regression": {
        "data": {"csv": "/path/to/reactions.csv",
                 "transforms": {"graph": {"transform": {"class": "RxnToGraph", "args": {"mode": "REAC_DIFF"}},
                                          "in_key": "rxn", "out_key": "G"}},
                 "targets": {"y": {"columns": ["target"], "task": "regression"}}, "split": dict(_SPLIT)},
        "model": {"kind": "dmpnn", "hidden_dim": 256, "depth": 3, "aggregation": "mean", "num_node_types": 57,
                  "num_edge_types": 27},
        "optimizer": {"name": "adam", "lr": 1.0e-3},
        "trainer": {"epochs": 40, "batch_size": 64, "seed": 0},
    },
    "moe_regression": {
        "data": {"csv": "tests/data/lipo.csv", "smiles_col": "smiles",
                 "targets": {"y": {"columns": ["lipo"], "task": "regression"}}, "split": dict(_SPLIT)},
        "model": {
            "pred_key": "ffn.preds",
            "modules": {
                "embed": {"class": "GraphEmbedding", "args": {"hidden_dim": _MOE_WIDTH}, "in_keys": ["inputs.G"],
                          "out_keys": ["G"]},
                "mp": {"class": "ChempropBlock", "args": {"hidden_dim": _MOE_WIDTH, "depth": 3, "residual": True},
                       "in_keys": ["embed.G"], "out_keys": ["G"]},
                "readout": {"class": "Mean", "in_keys": ["mp.G"], "out_keys": ["H"]},
                "ffn": {"class": "MoEMLP", "args": {"input_dim": _MOE_WIDTH, "output_size": 1, "hidden_dim": _MOE_WIDTH,
                                                   "num_experts": 4, "router_kind": "sparse", "k": 2},
                        "in_keys": ["readout.H"], "out_keys": ["preds", "aux"]},
            },
            "losses": {
                "mse": {"class": "MSE", "in_keys": {"preds": "ffn.preds", "targets": "targets.y", "mask": "targets.y_mask"},
                        "weight": 1.0},
                "aux": {"class": "SelfSupervisedLoss", "in_keys": {"inputs": "ffn.aux"}, "weight": 0.01},
            },
            "metrics": {"rmse": {"class": "RMSE", "in_keys": {"preds": "ffn.preds", "targets": "targets.y",
                                                             "mask": "targets.y_mask"}}},
        },
        "optimizer": {"name": "adam", "lr": 1.0e-3},
        "trainer": {"epochs": 5, "batch_size": 64, "seed": 0},
    },
    "pcqm4m_pretrain": {
        "data": {"csv": "/path/to/pcqm4mv2.csv", "smiles_col": "smiles"},
        "model": {"kind": "pretrain", "hidden_dim": 512, "depth": 5, "mask_rate": 0.15},
        "optimizer": {"name": "adam", "schedule": {"noam": {
            "warmup_steps": 10000, "cooldown_steps": 500000, "init_lr": 1.0e-4, "max_lr": 1.0e-3, "final_lr": 1.0e-4}}},
        "trainer": {"epochs": 10, "batch_size": 1024, "seed": 0, "checkpoint_dir": "./checkpoints/pcqm4m"},
    },
    "dmpnn_halo": {
        "data": {"csv": "tests/data/lipo.csv", "smiles_col": "smiles",
                 "targets": {"y": {"columns": ["lipo"], "task": "regression"}}},
        "model": {"kind": "dmpnn", "hidden_dim": 256, "depth": 3, "aggregation": "mean", "ffn_layers": 1,
                  "graph_axis": "graph", "partition": "halo"},
        "optimizer": {"name": "adam", "lr": 1.0e-3},
        "trainer": {"epochs": 5, "batch_size": 32, "seed": 0, "spmd": {"data": 2, "graph": 4}},
    },
}
# the reactions of tests/data/rxns.csv, each with a target from SEED
REACTIONS = ROOT / "tests" / "data" / "rxns.csv"


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


def bf16_block_model_cfg(d: int = 256, depth: int = 3, fuse_ends: bool = True, backward: str = "stash") -> dict:
    """declarative_model_cfg with the block's bf16 options (matmul_dtype and
    stash_dtype bfloat16): with ``fuse_ends`` the whole encoder (rows 5-6),
    else the block alone (rows 1-3, or 1 and 4 with ``backward:
    recompute``)."""
    cfg = declarative_model_cfg(d, depth)
    cfg["modules"]["mp"]["args"].update(matmul_dtype="bfloat16", stash_dtype="bfloat16", fuse_ends=fuse_ends,
                                        backward=backward)
    return cfg


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
    """The declarative GVP model on the kernel path (the YAML in README.md,
    with the mean readout of the calm recipe): PointwiseEmbed ->
    GvpGNNBlock(impl: fused, neighbor_window: 24) -> SpatialMean -> MLP,
    the MSE loss; every forward runs row 14 and every backward row 15 in
    each layer."""
    keys = {"preds": "ffn.preds", "targets": "targets.y", "mask": "targets.y_mask"}
    return {
        "modules": {
            "embed": {"class": "PointwiseEmbed", "args": {"hidden_dim": d}, "in_keys": ["inputs.P"],
                      "out_keys": ["P"]},
            "backbone": {"class": "GvpGNNBlock",
                         "args": {"scalar_dim": d, "vector_dim": dv, "depth": depth, "radius": 5.0,
                                  "max_neighbors": 16, "neighbor_window": GVP_WINDOW, "impl": "fused"},
                         "in_keys": ["embed.P"], "out_keys": ["P"]},
            "readout": {"class": "SpatialMean", "in_keys": ["backbone.P"], "out_keys": ["H"]},
            "ffn": {"class": "MLP", "args": {"input_dim": d, "output_size": 1, "hidden_dim": d, "num_layers": 1},
                    "in_keys": ["readout.H"], "out_keys": ["preds"]},
        },
        "losses": {"loss": {"class": "MSE", "in_keys": keys}},
    }


def declarative_spatial_bf16_cfg(backbone: str, d: int = 256, dv: int = 32, depth: int = 3) -> dict:
    """A declarative spatial model at ``dtype: bfloat16`` (ROADMAP item 5c):
    PointwiseEmbed -> ``backbone`` (``schnet``: SchnetBlock; ``gvp``:
    GvpGNNBlock with the plain conv, ``impl: auto``, as the fused kernels are
    f32 only) -> SpatialGated -> MLP, every module computing in bf16 (f32
    parameters), the MSE loss. The SchNet gathers' backward is TPU kernel
    row 8b on the card."""
    bf16 = {"dtype": "bfloat16"}
    if backbone == "schnet":
        block = {"class": "SchnetBlock", "args": {"hidden_dim": d, "depth": depth, "radius": 5.0,
                                                  "max_neighbors": 16, "neighbor_window": GVP_WINDOW, **bf16}}
    else:
        block = {"class": "GvpGNNBlock", "args": {"scalar_dim": d, "vector_dim": dv, "depth": depth, "radius": 5.0,
                                                  "max_neighbors": 16, "neighbor_window": GVP_WINDOW, "impl": "auto",
                                                  **bf16}}
    keys = {"preds": "ffn.preds", "targets": "targets.y", "mask": "targets.y_mask"}
    return {
        "modules": {
            "embed": {"class": "PointwiseEmbed", "args": {"hidden_dim": d, **bf16}, "in_keys": ["inputs.P"],
                      "out_keys": ["P"]},
            "backbone": {**block, "in_keys": ["embed.P"], "out_keys": ["P"]},
            "readout": {"class": "SpatialGated", "args": {"input_dim": d, **bf16}, "in_keys": ["backbone.P"],
                        "out_keys": ["H"]},
            "ffn": {"class": "MLP", "args": {"input_dim": d, "output_size": 1, "hidden_dim": d, "num_layers": 1,
                                             **bf16},
                    "in_keys": ["readout.H"], "out_keys": ["preds"]},
        },
        "losses": {"loss": {"class": "MSE", "in_keys": keys}},
    }


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# the wrappers whose kernels run other modes, counted apart: ``_bf16`` the bf16
# instantiations (rows 1b-6b, 7b, 8b, 9b and 10b-13b on bf16 inputs), ``_mm`` the
# attention core's matmul_dtype="bfloat16" on f32 inputs (rows 10b-13b)
ATTENTION_WRAPPERS = (fused_dense_attention_fwd, fused_dense_attention_bwd, fused_dense_attention_fwd_v2,
                      fused_dense_attention_bwd_v2)
MODE_COUNTS = {"_bf16": ("launches_bf16", (*BF16_WRAPPERS, fused_dense_mpnn_block_dbuf, csr_segment_sum,
                                           csr_segment_sum_packed, *ATTENTION_WRAPPERS)),
               "_mm": ("launches_mm", ATTENTION_WRAPPERS)}


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
    for attr, wrappers in MODE_COUNTS.values():
        for fn in wrappers:
            setattr(fn, attr, 0)


def launches() -> dict[str, int]:
    """Each kernel's launches by wrapper name; its other modes' under
    ``<name>_bf16`` and ``<name>_mm`` (MODE_COUNTS)."""
    return {**{fn.__name__: fn.launches for fn in KERNELS},
            **{f"{fn.__name__}{suffix}": getattr(fn, attr)
               for suffix, (attr, wrappers) in MODE_COUNTS.items() for fn in wrappers}}


def zero_counts() -> dict[str, int]:
    return {name: 0 for name in launches()}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def glue_launches(path: str, steps: int, batches: int) -> int:
    """Row 8's launches of ``steps`` training steps and ``batches`` evaluated
    or served batches of ``path`` (ROW8_LAUNCHES)."""
    per_step, per_batch = ROW8_LAUNCHES.get(path, (0, 0))
    return per_step * steps + per_batch * batches


# the utilities phase: the three settings of the input path that must train
# alike, their loss hold, the jnp backward's gradient hold (over each
# gradient's largest magnitude), its steps, the host-clock hold of
# StepTimer and its sync interval
UTILITY_SETTINGS = {"prefetch_0": {"prefetch": 0}, "prefetch_4": {},
                    "prefetch_4_steps_per_dispatch_4": {"prefetch": 4, "steps_per_dispatch": 4}}
UTILITY_LOSS_RTOL = 1e-6
JNP_GRAD_TOL = 1e-4
JNP_STEPS = 3
TIMER_RTOL = 0.1
TIMER_SYNC_EVERY = 4
NATIVE_MOLS = 1024
TRACE_ANNOTATION = "utilities_train_step"
TRACE_KERNEL = "mpnn_fwd_gemm_kernel"


def lipo_csv(directory: Path, n: int) -> Path:
    path = directory / f"lipo_head{n}.csv"
    with open(ROOT / "tests" / "data" / "lipo.csv", newline="") as f:
        rows = list(csv.reader(f))[: n + 1]
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return path


def lipo_rows_csv(path: Path, lo: int, hi: int) -> Path:
    """The lipo molecules ``[lo, hi)`` as a CSV at ``path``."""
    with open(ROOT / "tests" / "data" / "lipo.csv", newline="") as f:
        rows = list(csv.reader(f))
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows([rows[0], *rows[1 + lo: 1 + hi]])
    return path


def structural_labels(smiles: list[str], rng: np.random.Generator) -> np.ndarray:
    """12 binary labels that the structure decides (so that a model can
    learn them), a fifth of them missing (NaN, drawn from ``rng``): the
    labels of tests/test_multitask_classification.py, on the port's own
    SMILES parser."""
    rows = []
    for smi in smiles:
        m = parse_smiles(smi)
        n_atoms = m.GetNumAtoms()
        syms = [a.GetSymbol() for a in m.atoms]
        arom = sum(a.GetIsAromatic() for a in m.atoms)
        rows.append([float(x) for x in (
            "N" in syms, "O" in syms, "S" in syms, ("Cl" in syms) or ("Br" in syms) or ("F" in syms),
            arom > 0, arom >= 6, n_atoms > 20, n_atoms > 30,
            any(b.bond_type.name == "DOUBLE" for b in m.bonds), any(b.bond_type.name == "TRIPLE" for b in m.bonds),
            sum(a.formal_charge != 0 for a in m.atoms) > 0, m.GetNumBonds() > n_atoms)])
    labels = np.asarray(rows, dtype=np.float32)
    labels[rng.random(labels.shape) < 0.2] = np.nan
    return labels


def classification_csv(directory: Path, n: int) -> Path:
    """The first ``n`` lipo molecules with structural_labels (seeded by
    SEED) under CLASSIFICATION_COLUMNS, a missing label an empty cell."""
    path = directory / f"classification_head{n}.csv"
    with open(ROOT / "tests" / "data" / "lipo.csv", newline="") as f:
        smiles = [row["smiles"] for row in csv.DictReader(f)][:n]
    labels = structural_labels(smiles, np.random.default_rng(SEED))
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["smiles", *CLASSIFICATION_COLUMNS])
        for smi, row in zip(smiles, labels):
            writer.writerow([smi, *("" if np.isnan(v) else int(v) for v in row)])
    return path


def classification_config(csv_path: Path, checkpoint_dir: Path | None, model: dict | None = None) -> dict:
    """configs/dmpnn_multitask_classification.yaml as a dict on
    ``csv_path`` for ``TRAIN_EPOCHS`` epochs; ``model`` replaces its model
    section."""
    trainer = {"epochs": TRAIN_EPOCHS, "batch_size": BATCH, "seed": SEED}
    if checkpoint_dir is not None:
        trainer["checkpoint_dir"] = str(checkpoint_dir)
    return {
        "data": {"csv": str(csv_path), "smiles_col": "smiles",
                 "targets": {"y": {"columns": list(CLASSIFICATION_COLUMNS), "task": "classification"}},
                 "split": dict(CLASSIFICATION_SPLIT)},
        "model": dict(CLASSIFICATION_MODEL_CFG) if model is None else model,
        "optimizer": dict(CLASSIFICATION_OPTIMIZER_CFG),
        "trainer": trainer,
    }


def slice_config(name: str, csv_path: Path, checkpoint_dir: Path | None, epochs: int = TRAIN_EPOCHS,
                 model: dict | None = None) -> dict:
    """``SLICE_CONFIGS[name]`` (configs/<name>.yaml) on ``csv_path`` for
    ``epochs`` epochs, checkpointing to ``checkpoint_dir`` (none when
    None); ``model`` replaces its model section."""
    cfg = json.loads(json.dumps(SLICE_CONFIGS[name]))
    cfg["data"]["csv"] = str(csv_path)
    cfg["trainer"]["epochs"] = epochs
    cfg["trainer"].pop("checkpoint_dir", None)
    if checkpoint_dir is not None:
        cfg["trainer"]["checkpoint_dir"] = str(checkpoint_dir)
    if model is not None:
        cfg["model"] = model
    return cfg


def multicomponent_csv(directory: Path, n: int) -> Path:
    """``n`` rows of two components: ``smiles1`` and ``y`` the first ``n``
    lipo molecules and their target, ``smiles2`` the solvents of
    tests/data/multi.csv in turn."""
    path = Path(directory) / f"multicomponent_{n}.csv"
    with open(ROOT / "tests" / "data" / "lipo.csv", newline="") as f:
        lipo = list(csv.DictReader(f))[:n]
    with open(ROOT / "tests" / "data" / "multi.csv", newline="") as f:
        solvents = [row["smiles2"] for row in csv.DictReader(f)]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["smiles1", "smiles2", "y"])
        writer.writerows([row["smiles"], solvents[i % len(solvents)], row["lipo"]] for i, row in enumerate(lipo))
    return path


def reaction_csv(directory: Path) -> Path:
    """The reactions of REACTIONS with a standard normal ``target`` each,
    drawn from SEED."""
    path = Path(directory) / "reactions.csv"
    with open(REACTIONS, newline="") as f:
        rxns = [row["rxn"] for row in csv.DictReader(f)]
    targets = np.random.default_rng(SEED).normal(size=len(rxns))
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["rxn", "target"])
        writer.writerows([rxn, repr(float(y))] for rxn, y in zip(rxns, targets))
    return path


def calm_attention_csvs(directory: Path) -> tuple[Path, Path]:
    """The calm attention run's training and validation molecules."""
    n, m = CALM_ATTENTION["train"], CALM_ATTENTION["val"]
    return (lipo_rows_csv(Path(directory) / "calm_train.csv", 0, n),
            lipo_rows_csv(Path(directory) / "calm_val.csv", n, n + m))


def calm_attention_model(transforms: dict, device: str, weights: dict | None = None):
    """The calm attention run's model (declarative_attention_model_cfg at
    CALM_ATTENTION's width, weights from SEED or ``weights``, Adam at its
    rate) on ``device``."""
    cfg = declarative_attention_model_cfg(CALM_ATTENTION["d"], MODEL_CFG["depth"], GT_CFG["num_heads"])
    model = build_model(cfg, transforms, generator=torch.Generator().manual_seed(SEED),
                        optimizer=OptimizerSpec("adam", CALM_ATTENTION["lr"]))
    if weights is not None:
        model.network.load_state_dict(weights)
    return model.to(device)


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


def bound_bf16(ops: int, n_bytes: int) -> tuple[float, str]:
    """:func:`bound` with the operations at the tensor cores' bf16 rate."""
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS, n_bytes / PEAK_BYTES_PER_S
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
    for fragment in (*SWEEP_STAGES, "attn_rows_kernel", "attn_cols_kernel", "attn_cluster_kernel"):
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


def regression_config(checkpoint_dir: Path | None, **trainer) -> dict:
    """configs/dmpnn_regression.yaml as shipped (all of tests/data/lipo.csv)
    for TRAIN_EPOCHS epochs, with ``trainer`` options added."""
    cfg = train_config(ROOT / "tests" / "data" / "lipo.csv", checkpoint_dir)
    cfg["trainer"].update(trainer)
    return cfg


def same_bits(a, b) -> bool:
    """Whether two nested structures of tensors (a state dict, an optimizer
    state) hold the same bits."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a, key=str) == sorted(b, key=str) and all(
            same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    return a == b


def native_phase(tmp: Path) -> None:
    """The C++ featurizer on the first NATIVE_MOLS lipo molecules against the
    Python pipeline, array for array, and the CLI's default transform: fails
    unless the native featurizer builds, is the one ``build_dataset`` uses
    and gives the Python arrays. Prints both host times."""
    if not native.available():
        fail("the native featurizer is not available on the card's machine (no C++ compiler)")
    with open(ROOT / "tests" / "data" / "lipo.csv", newline="") as f:
        smiles = [row["smiles"] for row in csv.DictReader(f)][:NATIVE_MOLS]
    pipe = Pipeline(SmiToMol(), MolToGraph())
    native.featurize_batch(smiles[:8])  # the library is built and loaded
    t0 = time.perf_counter()
    graphs, status = native.featurize_batch(smiles)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.featurize_batch(smiles, n_threads=1)
    native_1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    python = [pipe(s) for s in smiles]
    python_s = time.perf_counter() - t0
    differ = [smi for smi, g, p, st in zip(smiles, graphs, python, status)
              if st or not all(np.array_equal(getattr(g, f), getattr(p, f))
                               for f in ("node_types", "edge_types", "src", "dst", "rev"))]
    default = build_dataset({"csv": str(lipo_csv(tmp, 8)),
                             "targets": {"y": {"columns": ["lipo"]}}}).transforms["graph"].transform
    emit(phase="native_featurizer", molecules=len(smiles), threads=min(os.cpu_count() or 1, 16),
         native_s=native_s, native_1_thread_s=native_1_s, python_s=python_s, differ=differ[:8],
         cli_default=type(default).__name__, library=native.library_path().name)
    if differ:
        fail(f"the native featurizer's graphs differ from the Python pipeline's for {len(differ)} molecules")
    if not isinstance(default, native.NativeSmiToGraph):
        fail(f"the CLI's default SMILES transform is {type(default).__name__}, not the native featurizer")


def settings_epochs() -> dict:
    """Warm epochs of the shipped regression config's training as ``run``
    feeds it at each of UTILITY_SETTINGS, one model and one loader (its
    featurization cached) behind each setting's wrapping, timed in turns
    (each setting, then each again in reverse order) on the host's clock;
    then one profiled epoch of each for the busy share. Also the host ms of
    one epoch's collation alone, a batch."""
    run_ = prepare(regression_config(None))
    model, base = run_["model"], run_["train_loader"]
    fit(model, base, epochs=1)  # fills the featurization cache
    steps = len(base)
    t0 = time.perf_counter()
    for _ in base:
        pass
    collate_ms = (time.perf_counter() - t0) * 1e3 / steps

    def epoch(name: str):
        loader, _, spd = fit_loaders(run_, UTILITY_SETTINGS[name])
        return lambda: fit(model, loader, epochs=1, steps_per_dispatch=spd)

    out = {name: {"warm_ms_per_step": []} for name in UTILITY_SETTINGS}
    for name in (*UTILITY_SETTINGS, *reversed(UTILITY_SETTINGS)):
        run_epoch = epoch(name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_epoch()
        torch.cuda.synchronize()
        out[name]["warm_ms_per_step"].append((time.perf_counter() - t0) * 1e3 / steps)
    for name in UTILITY_SETTINGS:
        profiled = profile_busy(epoch(name))
        out[name].update(profiled_ms_per_step=profiled["wall_ms"] / steps,
                         device_busy_ms_per_step=profiled["device_busy_ms"] / steps,
                         device_busy_share=profiled["device_busy_share"])
    return {"steps": steps, "collate_ms_per_batch": collate_ms, "settings": out}


def utilities_runs_phase(tmp: Path) -> dict[str, dict[str, int]]:
    """``run(cfg)`` of the shipped regression config at each of
    UTILITY_SETTINGS, counts set to 0 just before each: fails unless each
    launches what the recipe's run needs (rows 2-3 a step, row 1 an
    evaluated batch, row 8 as ROW8_LAUNCHES says), all three launch alike,
    end with the same bits in every parameter and Adam state and log the
    same losses within UTILITY_LOSS_RTOL. Then warm epochs of each, timed
    in turns and profiled (:func:`settings_epochs`). Returns each setting's
    launches."""
    runs = {}
    for name, trainer in UTILITY_SETTINGS.items():
        ckpt = tmp / f"utilities_{name}"
        reset_launches()
        t0 = time.perf_counter()
        out = run(regression_config(ckpt, **trainer))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launches()
        saved = Checkpointer(ckpt)
        steps = saved.latest_step()
        wrong = recipe_launches("recipe")(counts, steps or 0) if steps else "no checkpoint written"
        if wrong:
            fail(f"utilities {name}: {steps} steps launched {counts}; {wrong}")
        runs[name] = {"out": out, "counts": counts, "steps": steps, "run_s": seconds,
                      "state": saved.restore(), "train": saved.restore_train()}
    first, ref = next(iter(runs)), next(iter(runs.values()))
    diffs = {}
    for name, r in runs.items():
        if r["counts"] != ref["counts"] or r["steps"] != ref["steps"]:
            fail(f"utilities {name}: launched {r['counts']} in {r['steps']} steps; {first} launched "
                 f"{ref['counts']} in {ref['steps']}")
        if not (same_bits(r["state"], ref["state"]) and same_bits(r["train"]["optimizer"], ref["train"]["optimizer"])
                and r["train"]["step"] == ref["train"]["step"]):
            fail(f"utilities {name}: the parameters or Adam state differ in their bits from {first}'s")
        diffs[name] = compare_runs(r["out"], ref["out"], f"utilities {name} against {first}",
                                   rtol=UTILITY_LOSS_RTOL)
    timed = settings_epochs()
    emit(phase="utilities_runs", config="configs/dmpnn_regression.yaml", epochs=TRAIN_EPOCHS,
         steps=ref["steps"], kernel_launches=ref["counts"], same_bits=True, loss_rtol=UTILITY_LOSS_RTOL,
         max_rel_diff={name: max(d.values()) for name, d in diffs.items()},
         run_s={name: r["run_s"] for name, r in runs.items()},
         history={name: r["out"]["history"] for name, r in runs.items()}, warm_epoch=timed)
    return {name: r["counts"] for name, r in runs.items()}


def jnp_backward_phase() -> dict[str, int]:
    """JNP_STEPS steps of the shipped regression config's block with
    ``backward: jnp`` in lockstep with ``backward: stash`` (the jnp model
    takes the stash model's weights and Adam state before each step): fails
    unless every gradient agrees within JNP_GRAD_TOL of its largest
    magnitude and the jnp steps launch row 1 in every layer, row 8 as the
    recipe's step does, and no row 2 or 3."""
    cfg = regression_config(None)
    stash, jnp_run = prepare(cfg), prepare(cfg)
    ref, model = stash["model"], jnp_run["model"]
    model.network["mp"].backward = "jnp"
    loader = stash["train_loader"]
    loader.set_epoch(0)
    totals, worst, worst_name = zero_counts(), 0.0, None
    for _, batch in zip(range(JNP_STEPS), loader):
        model.network.load_state_dict(ref.network.state_dict())
        model.optimizer.load_state_dict(ref.optimizer.state_dict())
        x = to_device(batch, ref.device)
        ref.train_step(x)
        reset_launches()
        model.train_step(x)
        torch.cuda.synchronize()
        totals = {k: totals[k] + v for k, v in launches().items()}
        grads = dict(ref.network.named_parameters())
        for name, p in model.network.named_parameters():
            want = grads[name].grad
            err = float((p.grad - want).abs().max()) / max(float(want.abs().max()), 1e-30)
            if err > worst:
                worst, worst_name = err, name
    depth = MODEL_CFG["depth"]
    expect = {**zero_counts(), "fused_dense_mpnn_block": depth * JNP_STEPS,
              "csr_segment_sum": glue_launches("recipe", JNP_STEPS, 0)}
    emit(phase="jnp_backward_lockstep", steps=JNP_STEPS, max_grad_err_over_max=worst, worst_gradient=worst_name,
         tol=JNP_GRAD_TOL, kernel_launches=totals)
    if totals != expect:
        fail(f"the jnp backward's steps launched {totals}; expected {expect}")
    if not worst <= JNP_GRAD_TOL:
        fail(f"the jnp backward's gradients differ from the stash backward's by {worst} of their largest "
             f"magnitude ({worst_name})")
    return totals


def trace_child(out_dir: str) -> None:
    """Run by :func:`utilities_trace_phase` in a fresh process: a warm epoch
    of the grouped setting (``prefetch: 4, steps_per_dispatch: 4``) driven
    item by item under ``trace``, each dispatch under ``annotate`` and every
    step counted by a ``StepTimer``. Prints one JSON line."""
    trainer = UTILITY_SETTINGS["prefetch_4_steps_per_dispatch_4"]
    cfg = regression_config(None, **trainer)
    run_ = prepare(cfg)
    model = run_["model"]
    loader, _, spd = fit_loaders(run_, cfg["trainer"])
    fit(model, loader, epochs=1, steps_per_dispatch=spd)  # warm: featurization cache, first launches
    torch.cuda.synchronize()
    timer = StepTimer(sync_every=TIMER_SYNC_EVERY)
    steps = dispatches = 0
    with trace(out_dir):
        timer.start()
        t0 = time.perf_counter()
        for item in loader:
            with annotate(TRACE_ANNOTATION):
                stacked = isinstance(item, StackedBatch)
                logs = model.train_steps(item.tree) if stacked else model.train_step(item)
            for _ in range(item.n if stacked else 1):
                timer.step(logs)
                steps += 1
            dispatches += 1
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    files = sorted(Path(out_dir).glob("trace.*.json"))
    text = files[-1].read_text() if files else ""
    print(json.dumps({"steps": steps, "dispatches": dispatches, "host_steps_per_sec": steps / host_s,
                      "timer": timer.summary(), "synced_intervals": len(timer._times),
                      "trace_bytes": len(text), "annotation_in_trace": TRACE_ANNOTATION in text,
                      "kernel_in_trace": TRACE_KERNEL in text}), flush=True)


def utilities_trace_phase(tmp: Path) -> None:
    """:func:`trace_child` in a fresh process (a profile taken late in this
    one loses kernel records): fails unless the trace holds the annotation
    and the forward product's kernel, and StepTimer's steps_per_sec is
    within TIMER_RTOL of the host clock's."""
    out = tmp / "utilities_trace"
    proc = subprocess.run([sys.executable, "-c", "import sys, chip_smoke; chip_smoke.trace_child(sys.argv[1])",
                           str(out)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"the trace child exited {proc.returncode}: {proc.stderr[-3000:]}")
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    timer_rate, host_rate = record["timer"]["steps_per_sec"], record["host_steps_per_sec"]
    record["timer_vs_host_rel_diff"] = rel_diff(timer_rate, host_rate)
    emit(phase="utilities_trace", timer_rtol=TIMER_RTOL, **record)
    if not (record["annotation_in_trace"] and record["kernel_in_trace"]):
        fail(f"the trace lacks {TRACE_ANNOTATION!r} or {TRACE_KERNEL!r}")
    if not record["timer_vs_host_rel_diff"] <= TIMER_RTOL:
        fail(f"StepTimer's {timer_rate} steps/s and the host clock's {host_rate} differ by more than {TIMER_RTOL}")


def utilities_phases(tmp: Path) -> None:
    native_phase(tmp)
    utilities_runs_phase(tmp)
    jnp_backward_phase()
    utilities_trace_phase(tmp)


# the sharded paths at world size 1 (parallel_phase): steps of the bits
# checks, warm steps timed a path (the sharded trainer's and the plain
# Model.train_step's, on the same batch), the pretraining run's rows and
# batch (a few steps at the pretraining config's widths), and the CPU
# child's torch threads (it runs beside the card's child)
PARALLEL_STEPS, PARALLEL_TIMED_STEPS = 3, 10
PARALLEL_PRETRAIN_ROWS, PARALLEL_PRETRAIN_BATCH = 192, 64
PARALLEL_CPU_THREADS = 4
# the bf16 spatial models (spatial_bf16_phase): training batches of the GVP
# runs' clouds, Adam at the calm GVP rate (GVP_LR) for both backbones, their
# whole runs card against CPU at the bf16 run tolerance of the attention
# recipes, and each step in lockstep at the bf16 models' limits
# (BF16_MODEL_LOCKSTEP_RTOL, BF16_MODEL_GRAD_REL_L2). Measured at GVP_LR
# (H100 80GB HBM3, 700.00 W, at full width, 2 epochs of 2 batches): in
# lockstep the steps' losses differed by up to 9.6e-4 (SchNet) and 2.12e-3
# (GVP), each gradient by up to 3.48e-1 (SchNet's last output layers) and
# 2.8e-2 (GVP) in relative L2, the readout's score bias pure noise
# (ZERO_GRADIENTS); the whole runs drifted 1.56e-3 and 1.46e-3. SchNet at
# its recipe's 1e-3 is chaotic at bf16 (its whole run drifted 2.8e-1 in the
# last validation loss), so both run at GVP_LR
SPATIAL_BF16_BATCHES = 2
SPATIAL_BF16_RUN_RTOL = 1e-1


def timed_steps(step, batch) -> float:
    """Warm ms a step of ``step(batch)`` on the card: two steps, then
    PARALLEL_TIMED_STEPS timed by CUDA events."""
    for _ in range(2):
        step(batch)
    return _elapsed_ms(lambda: step(batch), PARALLEL_TIMED_STEPS)


def paired_ms(sharded, sharded_batch, plain, plain_batch) -> dict:
    """Warm ms a step of a sharded step and of the plain one, timed in turns
    (plain, sharded, sharded, plain)."""
    a, b, c, d = (timed_steps(*x) for x in ((plain, plain_batch), (sharded, sharded_batch),
                                           (sharded, sharded_batch), (plain, plain_batch)))
    return {"warm_ms_per_step": [b, c], "plain_warm_ms_per_step": [a, d]}


def parallel_child(device: str, store: str, out_path: str) -> None:
    """Run by :func:`parallel_phase` in a fresh process, a world of one on
    ``device`` (NCCL on the card, gloo on the CPU; rendezvous on the
    ``file://`` store ``store``); writes its results to ``out_path`` as
    JSON. Both devices: (b) ``configs/dmpnn_halo.yaml`` through ``run(cfg)``
    at ``trainer.spmd: {data: 1, graph: 1}`` on TRAIN_MOLS lipo molecules for
    TRAIN_EPOCHS epochs; (c) ``configs/pcqm4m_pretrain.yaml``'s widths through
    ``run(cfg)`` at the same mesh, the molecule partition, for one epoch of a
    few steps. The card alone: their row 8 launches; (a) DenseSpmdTrainer on
    the regression config's packed batches against ``Model.train_step``,
    every parameter and Adam state bit for bit, rows 2-3 counted; (d) an MoE
    model with ``shard_expert_params`` over an expert group of one against
    the unsharded model, bit for bit; (e) the shipped halo config's 2 x 4
    mesh raising ``make_mesh``'s ValueError; and each path's warm ms a step
    beside the plain step's."""
    from notorch_tpu_torch.models.pretrain import MaskAtoms, build_masked_atom_pretrainer
    from notorch_tpu_torch.parallel import distributed
    from notorch_tpu_torch.parallel.dense_dp import DenseSpmdTrainer
    from notorch_tpu_torch.parallel.expert import shard_expert_params
    from notorch_tpu_torch.parallel.mesh import make_mesh
    from notorch_tpu_torch.parallel.partition import build_halo_spmd_batch, build_molecule_spmd_batch
    from notorch_tpu_torch.parallel.spmd import SpmdTrainer

    if device == "cpu":
        torch.set_num_threads(PARALLEL_CPU_THREADS)
    distributed.initialize(f"file://{store}", 1, 0, device=device)
    tmp = Path(out_path).parent
    csv_path = lipo_csv(tmp, TRAIN_MOLS)
    out: dict = {}

    halo = slice_config("dmpnn_halo", csv_path, None)
    halo["trainer"]["spmd"] = {"data": 1, "graph": 1}
    reset_launches()
    t0 = time.perf_counter()
    result = run(halo, device=device)
    steps = TRAIN_EPOCHS * (TRAIN_MOLS // halo["trainer"]["batch_size"])
    out["halo"] = {"history": result["history"], "steps": steps, "run_s": time.perf_counter() - t0,
                   "launches": launches()}

    pretrain = slice_config("pcqm4m_pretrain", ROOT / "tests" / "data" / "lipo.csv", None, epochs=1)
    pretrain["data"]["limit"] = PARALLEL_PRETRAIN_ROWS
    pretrain["trainer"].update(batch_size=PARALLEL_PRETRAIN_BATCH, spmd={"data": 1, "graph": 1})
    reset_launches()
    t0 = time.perf_counter()
    result = run(pretrain, device=device)
    out["pretrain"] = {"history": result["history"], "steps": PARALLEL_PRETRAIN_ROWS // PARALLEL_PRETRAIN_BATCH,
                       "run_s": time.perf_counter() - t0, "launches": launches()}
    if device == "cpu":
        Path(out_path).write_text(json.dumps(out))
        return

    # (a) DenseSpmdTrainer on the packed batches against the plain step
    cfg = train_config(csv_path, None)
    plain, sharded = prepare(cfg, device)["model"], prepare(cfg, device)
    loader = sharded["train_loader"]
    batches = [to_device(b, device) for b, _ in zip(loader, range(PARALLEL_STEPS))]
    trainer = DenseSpmdTrainer(sharded["model"], make_mesh({"data": 1}, device)).init()
    for b in batches:
        plain.train_step(b)
    reset_launches()
    for b in batches:
        trainer.train_step(to_device(trainer.local_batch(b), device))
    dense_counts = launches()
    out["dense_spmd"] = {
        "steps": PARALLEL_STEPS, "same_bits": same_bits(plain.network.state_dict(), trainer.network.state_dict())
        and same_bits(plain.optimizer.state_dict(), trainer.model.optimizer.state_dict()),
        "launches": {k: v for k, v in dense_counts.items() if v},
        **paired_ms(trainer.train_step, trainer.local_batch(batches[0]), plain.train_step, batches[0])}

    # (d) expert parallelism over an expert group of one against the unsharded model
    moe_cfg = slice_config("moe_regression", csv_path, None)
    plain, sharded = prepare(moe_cfg, device)["model"], prepare(moe_cfg, device)
    moe_batches = [to_device(b, device) for b, _ in zip(sharded["train_loader"], range(PARALLEL_STEPS))]
    mesh = make_mesh({"data": 1, "expert": 1}, device)
    shard_expert_params(sharded["model"], mesh)
    trainer = SpmdTrainer(sharded["model"], mesh, "data", "expert").init()
    for b in moe_batches:
        plain.train_step(b)
        trainer.train_step(trainer.local_batch(as_stacked(b)))
    out["expert"] = {
        "steps": PARALLEL_STEPS, "same_bits": same_bits(plain.network.state_dict(), trainer.network.state_dict())
        and same_bits(plain.optimizer.state_dict(), trainer.model.optimizer.state_dict()),
        **paired_ms(trainer.train_step, trainer.local_batch(as_stacked(moe_batches[0])), plain.train_step,
                    moe_batches[0])}

    # (b), (c): the sharded step against the plain one on the same batch
    ds = build_dataset({"csv": str(csv_path), "targets": {"y": {"columns": ["lipo"]}}})
    group = [ds[i]["G"] for i in range(halo["trainer"]["batch_size"])]
    y = {"y": np.zeros((1, len(group), 1), np.float32)}
    halo_batch = build_halo_spmd_batch([group], y, 8 * 256, 4096, len(group), n_shards=1)
    gen = torch.Generator().manual_seed(SEED)
    halo_model = build_dmpnn(hidden_dim=256, depth=3, graph_axis="graph", partition="halo", generator=gen).to(device)
    trainer = SpmdTrainer(halo_model, make_mesh({"data": 1, "graph": 1}, device), "data", "graph").init()
    flat = build_dmpnn(hidden_dim=256, depth=3, layout="flat", generator=torch.Generator().manual_seed(SEED))
    out["halo"].update(paired_ms(
        trainer.train_step, to_device(trainer.local_batch(halo_batch), device), flat.to(device).train_step,
        to_device({"inputs.G": pad_graphs_flat(group), "targets.y": y["y"][0],
                   "targets.y_mask": np.ones((len(group), 1), bool)}, device)))
    masked = [MaskAtoms(seed=SEED)(g) for g in group]
    pre_batch = build_molecule_spmd_batch([masked], None, 8 * 256, 4096, len(masked), node_attrs=("node_labels",))
    pre_model = build_masked_atom_pretrainer(hidden_dim=512, depth=5, generator=torch.Generator().manual_seed(SEED))
    trainer = SpmdTrainer(pre_model.to(device), make_mesh({"data": 1}, device)).init()
    local = to_device(trainer.local_batch(pre_batch), device)
    out["pretrain"].update(paired_ms(trainer.train_step, local, pre_model.train_step, local))

    # (e) the shipped halo config's 2 x 4 mesh on one card
    try:
        run(slice_config("dmpnn_halo", csv_path, None), device=device)
        out["mesh_refusal"] = None
    except ValueError as e:
        out["mesh_refusal"] = str(e)
    Path(out_path).write_text(json.dumps(out))


def as_stacked(batch: dict) -> dict:
    """A single batch as the stacked batch of a 1 x 1 mesh: a ``[1, 1]``
    entry axis on every tensor."""
    def lift(v):
        if isinstance(v, torch.Tensor):
            return v[None, None]
        return v.update(**{f: None if getattr(v, f) is None else getattr(v, f)[None, None] for f in v._ARRAYS})

    return {k: lift(v) for k, v in batch.items()}


def pad_graphs_flat(graphs: list) -> "object":
    from notorch_tpu_torch.data.graph import pad_graphs

    return pad_graphs(graphs, 8 * 256, 4096, graph_cap=len(graphs), np_out=True)


def parallel_phase(tmp: Path) -> dict:
    """The parallel package at world size 1: :func:`parallel_child` on the
    card and, beside it, on the CPU, each a fresh process. Fails unless the
    halo and pretraining runs agree card against CPU epoch by epoch at
    TRAIN_RTOL, the card's halo run launches row 8 as ROW8_LAUNCHES["halo"]
    a step and the pretraining run as ROW8_LAUNCHES["pretrain"],
    DenseSpmdTrainer and the expert-sharded MoE model keep the plain step's
    bits, DenseSpmdTrainer launches rows 2 and 3, and the shipped halo
    config's mesh raises."""
    results, procs = {}, {}
    for device in ("cuda", "cpu"):
        directory = tmp / f"parallel_{device}"
        directory.mkdir()
        results[device] = directory / "out.json"
        procs[device] = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.parallel_child(*sys.argv[1:])", device,
             str(directory / "store"), str(results[device])], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    for device, proc in procs.items():
        try:
            _, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
        if proc.returncode != 0:
            fail(f"the parallel child on {device} exited {proc.returncode}: {err[-3000:]}")
    card, cpu = (json.loads(results[d].read_text()) for d in ("cuda", "cpu"))
    diffs = {f"{path}/epoch{e}": rel_diff(a["train/loss"], b["train/loss"])
             for path in ("halo", "pretrain")
             for e, (a, b) in enumerate(zip(card[path]["history"], cpu[path]["history"]))}
    row8 = {path: card[path]["launches"]["csr_segment_sum"] for path in ("halo", "pretrain")}
    expect_row8 = {path: glue_launches(path, card[path]["steps"], 0) for path in ("halo", "pretrain")}
    emit(phase="parallel", world_size=1, card=card, cpu_history={p: cpu[p]["history"] for p in ("halo", "pretrain")},
         rel_diff_vs_cpu=diffs, rel_tol=TRAIN_RTOL, row8=row8, expect_row8=expect_row8)
    if len(diffs) != TRAIN_EPOCHS + 1 or not max(diffs.values()) <= TRAIN_RTOL:
        fail(f"parallel: the sharded runs card against CPU differ: {diffs}")
    if row8 != expect_row8:
        fail(f"parallel: row 8 launched {row8} on the sharded runs; expected {expect_row8}")
    if not (card["dense_spmd"]["same_bits"] and card["expert"]["same_bits"]):
        fail("parallel: a sharded step at world size 1 lost the plain step's bits")
    if not all(card["dense_spmd"]["launches"].get(k, 0) > 0
               for k in ("fused_dense_mpnn_block_stash", "fused_dense_mpnn_block_bwd_stash")):
        fail(f"parallel: DenseSpmdTrainer did not launch rows 2 and 3: {card['dense_spmd']['launches']}")
    if not (card["mesh_refusal"] and "does not match 1 devices" in card["mesh_refusal"]):
        fail(f"parallel: the shipped halo config's mesh did not raise make_mesh's ValueError: {card['mesh_refusal']}")
    return card


def spatial_bf16_phase(gvp_train: list[dict], gvp_val: list[dict]) -> dict[str, int]:
    """The declarative SchNet and GVP models at dtype: bfloat16
    (declarative_spatial_bf16_cfg, full width) on SPATIAL_BF16_BATCHES
    training batches of the GVP clouds, Adam at GVP_LR: TRAIN_EPOCHS epochs
    of ``fit`` on the card and on the CPU from the same weights, held at
    SPATIAL_BF16_RUN_RTOL epoch by epoch, then every step in lockstep
    (BF16_MODEL_LOCKSTEP_RTOL, gradients at BF16_MODEL_GRAD_REL_L2 in
    relative L2 but ZERO_GRADIENTS). SchNet must launch row 8b. Returns
    SchNet's launches."""
    train = gvp_train[:SPATIAL_BF16_BATCHES]
    counts, lr = {}, GVP_LR
    for backbone in ("schnet", "gvp"):
        cfg = declarative_spatial_bf16_cfg(backbone)
        reset_launches()
        t0 = time.perf_counter()
        card_run = fit(gvp_model(cfg, "cuda", lr), train, gvp_val, epochs=TRAIN_EPOCHS)
        torch.cuda.synchronize()
        card_s, counts[backbone] = time.perf_counter() - t0, launches()
        cpu_run = fit(gvp_model(cfg, "cpu", lr), train, gvp_val, epochs=TRAIN_EPOCHS)
        diffs = {f"epoch{e}/{k}": rel_diff(a[k], b[k])
                 for e, (a, b) in enumerate(zip(card_run.history, cpu_run.history)) for k in ("train/loss", "val/loss")}
        emit(phase=f"train_{backbone}_bf16", clouds=len(train) * BATCH, epochs=TRAIN_EPOCHS, run_s_card=card_s,
             kernel_launches={k: v for k, v in counts[backbone].items() if v},
             history_card=card_run.history, history_cpu=cpu_run.history, rel_diff_vs_cpu=diffs,
             rel_tol=SPATIAL_BF16_RUN_RTOL,
             lockstep=gvp_lockstep(cfg, train, TRAIN_EPOCHS, f"train_{backbone}_bf16", lr,
                                   rtol=BF16_MODEL_LOCKSTEP_RTOL, grad_rel_l2=BF16_MODEL_GRAD_REL_L2,
                                   skip=ZERO_GRADIENTS))
        if not max(diffs.values()) <= SPATIAL_BF16_RUN_RTOL:
            fail(f"train_{backbone}_bf16: the card's run and the CPU's differ: {diffs}")
    if counts["schnet"]["csr_segment_sum_bf16"] <= 0:
        fail(f"train_schnet_bf16: row 8b never launched: {counts['schnet']}")
    return counts["schnet"]


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
    expect = {**zero_counts(), "fused_dense_mpnn_block": depth * n_batches,
              "csr_segment_sum": glue_launches("recipe", 0, n_batches)}
    if counts != expect:
        fail(f"serving launched {counts}; the request needs {expect}")
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
    for key in sorted(cpu.get("test", {})):  # runs without a split have no test set
        diffs[f"test/{key}"] = rel_diff(card["test"][key], cpu["test"][key])
    worst = max(diffs.values())
    if not worst <= rtol:
        fail(f"{what}: the card's training run and the CPU's differ by {worst} relative: {diffs}")
    return diffs


def train_phase(tmp: Path) -> dict[str, int]:
    """run(cfg) on the card and on the CPU, compared epoch by epoch; the
    card's checkpoint served on the card. Returns the kernels' launches of
    the card's run."""
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
    wrong = recipe_launches("recipe")(counts, steps)
    if wrong:
        fail(f"training {steps} steps launched {counts}; {wrong}")

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
    expect = {**zero_counts(), "fused_dense_mpnn_block": depth * steps,
              "fused_dense_mpnn_block_bwd": steps, "csr_segment_sum": glue_launches("recipe", steps, 0)}
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
    others = {k: v for k, v in counts.items()
              if k not in ("fused_dense_encoder_fwd", "fused_dense_encoder_bwd", "csr_segment_sum")}
    if (counts["fused_dense_encoder_bwd"] != steps or eval_fwd <= 0 or eval_fwd % depth
            or counts["csr_segment_sum"] != glue_launches("declarative", steps, 0) or any(others.values())):
        fail(f"the declarative run of {steps} steps launched {counts}; expected the encoder's "
             f"backward {steps} times, its forward {depth} times a step and a batch, row 8 "
             f"{glue_launches('declarative', steps, 0)} times (the embeddings' backward), and nothing else")

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
    expect = {**zero_counts(), "fused_dense_encoder_fwd": depth * n_batches}
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
    # imported here: the timing scripts load this module over older trees
    from notorch_tpu_torch.kernels.dense_mpnn import dbuf_groups

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
    if count != len(runs):
        fail(f"the dbuf phase launched {launches()}; expected the dbuf kernel {len(runs)} times, once a call")
    cases = []
    for args, kw, out in runs:
        row1 = fused_dense_mpnn_block(*args, **kw)
        ref = dense_mpnn_block_reference(*args, depth=depth, residual=kw["residual"], reduce=kw["reduce"])
        torch.cuda.synchronize()
        case = f"B={args[0].shape[0]} E={args[0].shape[1]} {kw['reduce']} residual={kw['residual']}"
        err = held(f"dbuf ({case})", out, ref, False)
        B, E, d = args[0].shape
        cases.append({"shape": [B, E, d], "reduce": kw["reduce"], "residual": kw["residual"],
                      "max_abs_err": err, "max_abs_diff_vs_row_1": float((out - row1).abs().max()),
                      "equal_bits_to_row_1": bool(torch.equal(out, row1)), "launch": dbuf_groups(B, E, d)})
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
    return ids_flat_inputs(rng.permutation(np.concatenate([ids, np.full(600, 5)])), V, d, rng)


# the cases of row 9b whose runs cross the packed layout's 128-slot chunks,
# over CHUNK_NODES nodes (chunk_case_ids)
CHUNK_CASES, CHUNK_NODES = ("straddle", "three_chunks"), 256


def chunk_case_ids(case: str) -> np.ndarray:
    """Edge ids over CHUNK_NODES nodes whose runs cross 128-slot chunks:
    ``straddle``, in each 128-node tile 120 in-edges of other nodes, then 16
    of one node and 16 of another, both runs crossing slot 128;
    ``three_chunks``, node 5's 300 in-edges among 200 random ones, over three
    chunks of a 512-slot budget."""
    rng = np.random.default_rng(7)
    if case == "straddle":
        return np.concatenate([part for base in (0, 128) for part in (
            base + 10 + rng.integers(0, 100, 120), np.full(16, base + 3), np.full(16, base + 120),
            base + rng.integers(0, 128, 40))]).astype(np.int32)
    return rng.permutation(np.concatenate([rng.integers(0, CHUNK_NODES, 200), np.full(300, 5)])).astype(np.int32)


def chunk_flat_inputs(case: str, d: int, seed: int) -> dict[str, torch.Tensor]:
    """ids_flat_inputs of chunk_case_ids(case)."""
    return ids_flat_inputs(chunk_case_ids(case), CHUNK_NODES, d, np.random.default_rng(seed))


def ids_flat_inputs(dst: np.ndarray, V: int, d: int, rng: np.random.Generator) -> dict[str, torch.Tensor]:
    """Seeded messages for the edges of ``dst`` (every edge real), packed by
    tile for the packed sum and sorted for the row-pointer sum, on the card."""
    dst = dst.astype(np.int32)
    E = len(dst)
    perm, packed_dst, _ = pack_edges_by_tile(dst, num_nodes=V)
    data = rng.standard_normal((E, d)).astype(np.float32)
    order = np.argsort(dst, kind="stable")
    arrays = {"data": data, "perm": perm, "packed_dst": packed_dst, "dst": dst,
              "edge_mask": np.ones(E, bool), "sorted_data": data[order], "sorted_dst": dst[order],
              "row_ptr": csr_row_ptr(dst[order], V)}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in arrays.items()}


def flat_kernels_phase(cases: dict[str, dict]) -> tuple[float, float, list[dict]]:
    """Rows 8-9 against their plain versions on each case (launches made
    here do not count for any path), each twice, bit for bit, and with the
    bits of its plain version on the CPU. Returns the largest errors of rows
    8 and 9 and the cases."""
    records = []
    for name, x in cases.items():
        V = x["row_ptr"].shape[0] - 1
        packed = csr_segment_sum_packed(x["data"], x["perm"], x["packed_dst"], V)
        again = csr_segment_sum_packed(x["data"], x["perm"], x["packed_dst"], V)
        rowptr = csr_segment_sum(x["sorted_data"], x["sorted_dst"], x["row_ptr"], V)
        rowptr_again = csr_segment_sum(x["sorted_data"], x["sorted_dst"], x["row_ptr"], V)
        torch.cuda.synchronize()
        if not torch.equal(packed, again):
            fail(f"two calls of the packed segment sum differ ({name})")
        if not torch.equal(rowptr, rowptr_again):
            fail(f"two calls of the row-pointer segment sum differ ({name})")
        err9, bits9 = held_sum(f"csr_segment_sum_packed ({name})", packed, csr_segment_sum_packed_reference,
                               x["data"], x["perm"], x["packed_dst"], V)
        if not bits9:
            fail(f"the packed segment sum does not give the CPU plain version's bits ({name})")
        err8, bits8 = held_sum(f"csr_segment_sum ({name})", rowptr, csr_segment_sum_reference,
                               x["sorted_data"], x["row_ptr"], V)
        if not bits8:
            fail(f"the row-pointer segment sum does not give the CPU plain version's bits ({name})")
        counts = torch.diff(x["row_ptr"])
        records.append({"case": name, "V": V, "E": x["data"].shape[0], "d": x["data"].shape[1],
                        "real_edges": int(x["edge_mask"].sum()), "empty_nodes": int((counts == 0).sum()),
                        "max_in_degree": int(counts.max()), "budget": x["perm"].shape[0] // (V // 128),
                        "max_abs_err": {"csr_segment_sum": err8, "csr_segment_sum_packed": err9},
                        "equal_bits_to_cpu_plain": {"csr_segment_sum": bits8, "csr_segment_sum_packed": bits9},
                        "bitwise_repeatable": True})
    return (max(r["max_abs_err"]["csr_segment_sum"] for r in records),
            max(r["max_abs_err"]["csr_segment_sum_packed"] for r in records), records)


def straddling_nodes(perm: torch.Tensor, packed_dst: torch.Tensor, V: int, tile_e: int = 128) -> int:
    """Nodes whose packed slots lie in more than one tile_e-slot chunk of
    their tile's budget: the nodes whose bf16 sum rounds more than once."""
    perm, packed_dst = perm.cpu().numpy(), packed_dst.cpu().numpy()
    budget = len(perm) // (V // 128)
    slots = np.nonzero(perm >= 0)[0]
    pairs = np.unique(np.stack([packed_dst[slots], slots % budget // tile_e]), axis=1)
    return int((np.bincount(pairs[0], minlength=V) > 1).sum())


def bf16_packed_phase(cases: dict[str, dict]) -> tuple[float, list[dict]]:
    """Row 9b on each case's messages cast to bf16 (launches made here do
    not count for any path), twice: both calls must give the bits of its
    plain version on the card and on the CPU. Returns 0 (the largest
    difference) and the cases."""
    from notorch_tpu_torch.kernels.csr_segment import csr_segment_sum_packed_bf16_reference

    records = []
    for name, x in cases.items():
        V = x["row_ptr"].shape[0] - 1
        data = x["data"].bfloat16()
        got = csr_segment_sum_packed(data, x["perm"], x["packed_dst"], V)
        again = csr_segment_sum_packed(data, x["perm"], x["packed_dst"], V)
        plain = csr_segment_sum_packed_bf16_reference(data, x["perm"], x["packed_dst"], V)
        torch.cuda.synchronize()
        cpu = csr_segment_sum_packed_bf16_reference(data.cpu(), x["perm"].cpu(), x["packed_dst"].cpu(), V)
        if got.dtype != torch.bfloat16 or not (torch.equal(got, again) and torch.equal(got, plain)
                                               and torch.equal(got.cpu(), cpu)):
            fail(f"row 9b ({name}): two calls differ, or differ from its plain version on the card or the CPU "
                 f"(max abs err {float((got.float() - plain.float()).abs().max())})")
        records.append({"case": name, "V": V, "E": data.shape[0], "d": data.shape[1],
                        "budget": x["perm"].shape[0] // (V // 128),
                        "straddling_nodes": straddling_nodes(x["perm"], x["packed_dst"], V),
                        "equal_bits_to_plain": True, "equal_bits_to_cpu_plain": True, "bitwise_repeatable": True})
    return 0.0, records


def glue_inputs(G, d: int, seed: int) -> dict[str, tuple]:
    """Row 8's calls on the main path at the packed training batch ``G``:
    the block's node scatter (``[B * E, d]`` edge hiddens into the ``B * V``
    node slots and a trash slot for the padding lanes) and PackedMean's sum
    and count (``[B * V, d]`` node hiddens and ``[B * V]`` ones into the
    molecules and a trash slot for the padding slots), seeded values, as
    ``(data, int64 ids, num_segments)`` on the card."""
    rng = np.random.default_rng(seed)
    B, V = G.node_mask.shape
    scatter = np.where(G.edge_mask, G.dst + V * np.arange(B)[:, None], B * V).reshape(-1)
    readout = G.node_graph.reshape(-1)
    arrays = {"node_scatter": (rng.standard_normal((scatter.size, d)), scatter, B * V + 1),
              "packed_mean_sum": (rng.standard_normal((readout.size, d)), readout, G.n_mols + 1),
              "packed_mean_count": (G.node_mask.reshape(-1), readout, G.n_mols + 1)}
    return {k: (torch.from_numpy(np.ascontiguousarray(x, np.float32)).cuda(),
                torch.from_numpy(ids.astype(np.int64)).cuda(), n) for k, (x, ids, n) in arrays.items()}


def glue_sums_phase(cases: dict[str, tuple]) -> tuple[float, list[dict]]:
    """nn/ops.py segment_sum (row 8 through the sort of its ids) on each
    case twice, held against the plain version on the card (index_add_) at
    SUM_ATOL times each element's sum of |terms|; fails unless both calls
    give the bits of index_add on the CPU. Returns the largest error and the
    cases, each with its longest run."""
    from notorch_tpu_torch.nn.ops import segment_sum

    records = []
    for name, (data, ids, n) in cases.items():
        got, again = segment_sum(data, ids, n), segment_sum(data, ids, n)
        torch.cuda.synchronize()

        def plain(x, i, n=n):
            return torch.zeros((n,) + tuple(x.shape[1:]), device=x.device).index_add_(0, i, x)

        err, bits = held_sum(f"segment_sum ({name})", got, plain, data, ids)
        if not (bits and torch.equal(got, again)):
            fail(f"segment_sum ({name}) does not give index_add's CPU bits on two calls")
        records.append({"case": name, "rows": data.shape[0], "d": data.shape[1] if data.dim() > 1 else 1,
                        "segments": n, "longest_run": int(torch.bincount(ids).max()), "max_abs_err": err,
                        "equal_bits_to_cpu_plain": bits, "bitwise_repeatable": True})
    return max(r["max_abs_err"] for r in records), records


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
    evaluated = packed // (depth + 1) - steps
    expect = {**zero_counts(), "csr_segment_sum_packed": (depth + 1) * (steps + evaluated),
              "csr_segment_sum": glue_launches("impl_csr", steps, evaluated)}
    if counts != expect or evaluated <= 0:
        fail(f"the flat run of {steps} steps launched {counts}; expected the packed sum {depth + 1} "
             f"times a step and an evaluated batch, and {expect}")
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


def serve_checkpoint_phase(tmp: Path, ckpt: Path, phase: str, expect: dict[str, int],
                           columns: tuple[str, ...] = ("lipo",), probabilities: bool = False,
                           csv_path: Path | None = None, bf16: bool = False) -> dict[str, int]:
    """run_predict of a checkpoint on the rows of ``csv_path`` (by default
    N_MOLS lipo molecules), on the card against the CPU: the prediction
    ``columns``, each within RTOL/ATOL of the CPU's (a model with bf16
    operands, ``bf16``: at BF16_ELEMENT_TOL of the largest |prediction|, and
    BF16_L2_TOL in relative L2) and finite (and in [0, 1] for
    ``probabilities``); cold and warm request time and the busy share of a
    warm request. Fails unless the request launched exactly ``expect``
    (every other kernel 0). Returns the request's launches."""
    csv_path = lipo_csv(tmp, N_MOLS) if csv_path is None else csv_path
    with open(csv_path, newline="") as f:
        n_rows = sum(1 for _ in csv.DictReader(f))

    def served(device=None) -> np.ndarray:
        out = run_predict(ckpt, csv_path, batch_size=BATCH, device=device)
        return np.stack([out[c] for c in columns], axis=1)

    reset_launches()
    t0 = time.perf_counter()
    gpu = served()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    counts = launches()
    if counts != {**zero_counts(), **expect}:
        fail(f"{phase}: the request launched {counts}; expected {expect} and nothing else")
    t0 = time.perf_counter()
    run_predict(ckpt, csv_path, batch_size=BATCH)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    profiled = profile_busy(lambda: run_predict(ckpt, csv_path, batch_size=BATCH))
    cpu = served("cpu")
    err = np.abs(gpu - cpu)
    close = (bool((err <= BF16_ELEMENT_TOL * np.abs(cpu).max()).all())
             and float(np.linalg.norm(gpu - cpu) / np.linalg.norm(cpu)) <= BF16_L2_TOL if bf16
             else bool((err <= ATOL + RTOL * np.abs(cpu)).all()))
    ok = (gpu.shape == (n_rows, len(columns)) and bool(np.isfinite(gpu).all()) and close
          and (not probabilities or bool(((gpu >= 0) & (gpu <= 1)).all())))
    emit(phase=phase, molecules=n_rows, columns=len(columns), kernel_launches=counts, request_s_cold=cold_s,
         request_s_warm=warm_s, profile=profiled, max_abs_err_vs_cpu=float(err.max()),
         pred_mean=float(gpu.mean()), pred_std=float(gpu.std()),
         pred_range=[float(gpu.min()), float(gpu.max())], ok=ok)
    if not ok:
        fail(f"{phase}: the card's predictions disagree with the CPU, are not finite or leave their range")
    return counts


def train_classification_phase(tmp: Path) -> tuple[dict[str, int], Path]:
    """run(cfg) of the multitask classification config (12 masked BCE
    tasks, the scaffold split, AUROC and AUPRC on the host) on the card and
    on the CPU from the same initial weights, compared epoch by epoch at
    TRAIN_RTOL (losses, val AUROC and AUPRC, and the test metrics); then a
    warm epoch on the card on the host's clock and profiled. Fails unless
    the run launched rows 2 and 3 on every step, row 1 on every evaluated
    batch and row 8 in the recipe's glue, and nothing else. Returns the
    launches and the card's checkpoint."""
    csv_path = classification_csv(tmp, TRAIN_MOLS)
    card_ckpt = tmp / "classification_card"
    reset_launches()
    t0 = time.perf_counter()
    card = run(classification_config(csv_path, card_ckpt))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = launches()
    steps = Checkpointer(card_ckpt).latest_step()
    if not steps:
        fail(f"train_classification: the card's run wrote no checkpoint in {card_ckpt}")
    wrong = recipe_launches("classification")(counts, steps)
    if wrong:
        fail(f"train_classification: {steps} steps launched {counts}; {wrong}")
    t0 = time.perf_counter()
    cpu = run(classification_config(csv_path, tmp / "classification_cpu"), device="cpu")
    cpu_s = time.perf_counter() - t0
    for key in ("val/y_auroc", "val/y_auprc"):
        if not all(np.isfinite(h[key]) for h in card["history"]):
            fail(f"train_classification: {key} is not finite: {card['history']}")
    diffs = compare_runs(card, cpu, "the classification run")

    warm = prepare(classification_config(csv_path, None))
    emit(phase="train_classification", molecules=TRAIN_MOLS, epochs=TRAIN_EPOCHS, steps=steps,
         split={k: len(warm[k]) for k in ("train", "val", "test")}, kernel_launches=counts, run_s_card=card_s,
         run_s_cpu=cpu_s, **warm_epoch(warm["model"], warm["train_loader"]),
         history_card=card["history"], history_cpu=cpu["history"], test_card=card["test"], test_cpu=cpu["test"],
         rel_diff_vs_cpu=diffs, rel_tol=TRAIN_RTOL)
    return counts, card_ckpt


def task_heads_phase(tmp: Path) -> dict[str, int]:
    """One train step of each head of HEAD_TASKS (the recipe at full width,
    one task) on the first packed batch of N_MOLS lipo molecules, on the
    card and on the CPU from the same weights: the loss within RTOL relative
    and every gradient within ATOL times its largest magnitude plus RTOL
    (``held``). Fails unless each step launched rows 2 and 3 and row 8's
    glue and nothing else. Returns the launches of the four steps."""
    depth = MODEL_CFG["depth"]
    path = tmp / "task_heads.csv"
    with open(ROOT / "tests" / "data" / "lipo.csv", newline="") as f:
        rows = list(csv.DictReader(f))[:N_MOLS]
    cuts = np.quantile([float(r["lipo"]) for r in rows], [1 / 3, 2 / 3])
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["smiles", "lipo", "lipo_class"])
        for r in rows:
            writer.writerow([r["smiles"], r["lipo"], int(np.searchsorted(cuts, float(r["lipo"])))])
    records, total = [], zero_counts()
    for task in HEAD_TASKS:
        column = "lipo_class" if task in ("multiclass", "dirichlet") else "lipo"
        ds = build_dataset({"csv": str(path), "targets": {"y": {"columns": [column], "task": task}}})
        batch = next(iter(DataLoader(ds, batch_size=BATCH)))
        transforms = ds.build_task_transform_configs()
        kw = {k: v for k, v in MODEL_CFG.items() if k != "kind"}
        models = [build_dmpnn(task=task, num_classes=HEAD_CLASSES, transforms=transforms, layout="dense_packed",
                              generator=torch.Generator().manual_seed(SEED), optimizer=OptimizerSpec("adam", 1e-3),
                              **kw).to(device) for device in ("cuda", "cpu")]
        reset_launches()
        logs = [m.train_step(to_device(batch, m.device)) for m in models]
        torch.cuda.synchronize()
        counts = launches()
        expect = {**zero_counts(), "fused_dense_mpnn_block_stash": depth,
                  "fused_dense_mpnn_block_bwd_stash": 1, "csr_segment_sum": glue_launches("recipe", 1, 0)}
        if counts != expect:
            fail(f"task_heads {task}: the card's step launched {counts}; expected {expect}")
        total = {k: total[k] + v for k, v in counts.items()}
        card_loss, cpu_loss = (float(x["train/loss"]) for x in logs)
        loss_diff = rel_diff(card_loss, cpu_loss)
        if not (np.isfinite(card_loss) and loss_diff <= RTOL):
            fail(f"task_heads {task}: the step's loss {card_loss} on the card, {cpu_loss} on the CPU")
        cpu_grads = dict(models[1].network.named_parameters())
        grad_err = max(held(f"task_heads {task} gradient {name}", p.grad.cpu(), cpu_grads[name].grad, True)
                       for name, p in models[0].network.named_parameters())
        records.append({"task": task, "head": list(models[0].network["ffn"].unflatten or ()),
                        "loss_card": card_loss, "loss_cpu": cpu_loss, "loss_rel_diff": loss_diff,
                        "max_grad_abs_err": grad_err, "kernel_launches": counts})
    emit(phase="task_heads", rtol=RTOL, atol=ATOL, grad_atol="ATOL x the largest |value| of each gradient",
         heads=records)
    return total


def warm_epoch(model, loader) -> dict:
    """A warm training epoch of ``model`` over ``loader`` (an epoch first
    fills the featurization cache): ms a step on the host's clock, and
    device ms a step and the busy share from a profiled epoch."""
    fit(model, loader, epochs=1)
    torch.cuda.synchronize()
    steps = len(loader)
    t0 = time.perf_counter()
    fit(model, loader, epochs=1)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3 / steps
    profiled = profile_busy(lambda: fit(model, loader, epochs=1))
    return {"warm_steps": steps, "warm_ms_per_step": warm_ms,
            "device_busy_ms_per_step": profiled["device_busy_ms"] / steps,
            "profiled_ms_per_step": profiled["wall_ms"] / steps, "profile": profiled}


def slice_run_phase(tmp: Path, phase: str, name: str, path: str, csv_path: Path, check) -> tuple[dict[str, int], Path]:
    """run(cfg) of configs/<name>.yaml as shipped (``SLICE_CONFIGS``) on
    ``csv_path`` for TRAIN_EPOCHS epochs on the card and on the CPU from the
    same seed, compared epoch by epoch at TRAIN_RTOL (losses, metrics and
    the test metrics where the config splits); ``check(counts, steps)``
    returns what is wrong with the card run's launches, or None; then a warm
    epoch on the card on the host's clock and profiled. Returns the card
    run's launches and checkpoint."""
    card_ckpt = tmp / f"{phase}_card"
    reset_launches()
    t0 = time.perf_counter()
    card = run(slice_config(name, csv_path, card_ckpt))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = launches()
    steps = Checkpointer(card_ckpt).latest_step()
    if not steps:
        fail(f"{phase}: the card's run wrote no checkpoint in {card_ckpt}")
    wrong = check(counts, steps)
    if wrong:
        fail(f"{phase}: the card's run of {steps} steps launched {counts}; {wrong}")
    t0 = time.perf_counter()
    cpu = run(slice_config(name, csv_path, tmp / f"{phase}_cpu"), device="cpu")
    cpu_s = time.perf_counter() - t0
    diffs = compare_runs(card, cpu, phase)
    cfg = slice_config(name, csv_path, None)
    warm = prepare_pretrain(cfg) if cfg["model"].get("kind") == "pretrain" else prepare(cfg)
    timing = warm_epoch(warm["model"], warm["train_loader"])
    emit(phase=phase, config=f"configs/{name}.yaml", data=csv_path.name, epochs=TRAIN_EPOCHS, steps=steps,
         kernel_launches=counts, row8_launches_per_step_and_batch=ROW8_LAUNCHES[path], run_s_card=card_s,
         run_s_cpu=cpu_s, **timing, history_card=card["history"], history_cpu=cpu["history"],
         test_card=card.get("test"), test_cpu=cpu.get("test"), rel_diff_vs_cpu=diffs, rel_tol=TRAIN_RTOL)
    return counts, card_ckpt


def slice_phases(tmp: Path) -> dict[str, dict[str, int]]:
    """The multicomponent, reaction, MoE and pretraining configs as shipped,
    each trained on the card against the CPU (slice_run_phase) and served
    from its checkpoint (the pretrainer has no serving path): the
    multicomponent model on TRAIN_MOLS lipo molecules each with a solvent of
    tests/data/multi.csv (served: N_MOLS rows), the reaction recipe on the
    100 reactions of REACTIONS (rows 1-3 and row 8; its bins reported), the
    MoE model on TRAIN_MOLS lipo molecules, the pretrainer on all of lipo's
    SMILES. Returns each run's launches."""
    depth = MODEL_CFG["depth"]
    runs = {}
    runs["multicomponent"], ckpt = slice_run_phase(tmp, "train_multicomponent", "multicomponent", "multicomponent",
                                                   multicomponent_csv(tmp, TRAIN_MOLS),
                                                   glue_only("multicomponent", evaluates=False))
    serve_checkpoint_phase(tmp, ckpt, "serve_multicomponent",
                           {"csr_segment_sum": glue_launches("multicomponent", 0, N_MOLS // BATCH)}, columns=("y",),
                           csv_path=multicomponent_csv(tmp, N_MOLS))

    rxn_csv = reaction_csv(tmp)
    rxn_batches = list(DataLoader(build_dataset(slice_config("reaction_regression", rxn_csv, None)["data"]),
                                  batch_size=BATCH))
    emit(phase="reaction_bins", batches=[{"bins": b["inputs.G"].src.shape[0], "edges_per_bin": b["inputs.G"].src.shape[1],
                                          "nodes_per_bin": b["inputs.G"].nodes_per_graph} for b in rxn_batches])
    runs["reaction"], ckpt = slice_run_phase(tmp, "train_reaction", "reaction_regression", "reaction", rxn_csv,
                                             recipe_launches("reaction"))
    serve_checkpoint_phase(tmp, ckpt, "serve_reaction",
                           {"fused_dense_mpnn_block": depth * len(rxn_batches),
                            "csr_segment_sum": glue_launches("reaction", 0, len(rxn_batches))},
                           columns=("target",), csv_path=rxn_csv)

    runs["moe"], ckpt = slice_run_phase(tmp, "train_moe", "moe_regression", "moe", lipo_csv(tmp, TRAIN_MOLS),
                                        glue_only("moe"))
    serve_checkpoint_phase(tmp, ckpt, "serve_moe", {"csr_segment_sum": glue_launches("moe", 0, N_MOLS // BATCH)})

    runs["pretrain"] = slice_run_phase(tmp, "train_pretrain", "pcqm4m_pretrain", "pretrain",
                                       ROOT / "tests" / "data" / "lipo.csv", glue_only("pretrain", evaluates=False))[0]
    return runs


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
    wrong = glue_only("flat")(counts, Checkpointer(card_ckpt).latest_step())
    if wrong:
        fail(f"the declarative flat run launched {counts}; {wrong}")
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
    if counts != {**zero_counts(), "fused_dense_attention_fwd": n,
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


def train_run_phase(tmp: Path, phase: str, model: dict, epochs: int, check, lockstep_rtol: float = LOCKSTEP_RTOL,
                    grad_rel_l2: float | None = None) -> tuple[dict[str, int], Path]:
    """run(cfg) of ``model`` with the data, optimizer and trainer of
    MODEL_CFG's config on the card and on the CPU, compared epoch by epoch
    at ATTENTION_RUN_RTOL, then every step of that run in lockstep (each
    step's loss at ``lockstep_rtol``, the gradients as ``lockstep`` holds
    them with ``grad_rel_l2``).
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
         lockstep=lockstep(train_config(csv_path, None, model), epochs, phase, rtol=lockstep_rtol,
                           grad_rel_l2=grad_rel_l2))
    return counts, card_ckpt


def attention_calm_run_phase(tmp: Path) -> None:
    """The calm attention recipe's whole run (fit of calm_attention_model for
    its epochs) on the card and on the CPU from the same weights, compared
    epoch by epoch at ATTENTION_CALM_RTOL; the card's run launches rows 12
    and 13 in every layer, row 8 in the embeddings' backward and nothing
    else."""
    depth, epochs = MODEL_CFG["depth"], CALM_ATTENTION["epochs"]
    train_csv, val_csv = calm_attention_csvs(tmp)
    train_ds, val_ds = (build_dataset({"csv": str(c), "targets": {"y": {"columns": ["lipo"]}}})
                        for c in (train_csv, val_csv))
    train, val = (list(DataLoader(x, batch_size=CALM_ATTENTION["batch"], layout="dense")) for x in (train_ds, val_ds))
    transforms = train_ds.build_task_transform_configs()
    reset_launches()
    t0 = time.perf_counter()
    card = fit(calm_attention_model(transforms, "cuda"), train, val, epochs=epochs).history
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = launches()
    steps = epochs * len(train)
    expect = {**zero_counts(), "fused_dense_attention_bwd_v2": depth * steps,
              "fused_dense_attention_fwd_v2": depth * (steps + epochs * len(val)),
              "csr_segment_sum": glue_launches("declarative_attention", steps, epochs * len(val))}
    if counts != expect:
        fail(f"the calm attention run launched {counts}; expected {expect}")
    cpu = fit(calm_attention_model(transforms, "cpu"), train, val, epochs=epochs).history
    diffs = {f"epoch{e}/{k}": rel_diff(a[k], b[k]) for e, (a, b) in enumerate(zip(card, cpu))
             for k in ("train/loss", "val/loss")}
    worst = max(diffs.values())
    emit(phase="train_attention_calm", recipe=CALM_ATTENTION, steps=steps, kernel_launches=counts,
         run_s_card=card_s, history_card=[{k: h[k] for k in ("train/loss", "val/loss")} for h in card],
         history_cpu=[{k: h[k] for k in ("train/loss", "val/loss")} for h in cpu], rel_diff_vs_cpu=diffs,
         max_rel_diff=worst, rel_tol=ATTENTION_CALM_RTOL)
    if not worst <= ATTENTION_CALM_RTOL:
        fail(f"the calm attention run: card and CPU differ by {worst} relative: {diffs}")


def lockstep(cfg: dict, epochs: int, what: str, max_steps: int | None = None, rtol: float = LOCKSTEP_RTOL,
             grad_rel_l2: float | None = None) -> dict:
    """Every step of ``cfg``'s run (its first ``max_steps``, where given)
    taken on the card and on the CPU from the card's weights, optimizer state
    and dropout streams (copied to the CPU before each step), on the run's
    own batches in its order: fails unless each step's loss
    agrees within ``rtol`` relative and each gradient, but those of
    ZERO_GRADIENTS, within LOCKSTEP_GRAD_RTOL times its largest magnitude
    (with ``grad_rel_l2``, within that in relative L2 instead: a bf16
    model's ReLU units near their kink switch between devices).
    Also gives each of those gradients' largest relative L2 distance over
    the steps, card against CPU."""
    card, cpu = prepare(cfg), prepare(cfg, "cpu")["model"]
    model, loader = card["model"], card["train_loader"]
    loss_diff, grad_diff, worst = 0.0, 0.0, None
    rel_l2: dict[str, float] = {}
    steps = 0
    cpu_generators = cpu.generators()
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        for batch in loader:
            if steps == max_steps:
                break
            cpu.network.load_state_dict(model.network.state_dict())
            cpu.optimizer.load_state_dict(model.optimizer.state_dict())
            for name, gen in model.generators().items():
                cpu_generators[name].set_state(gen.get_state())
            ours = model.train_step(to_device(batch, model.device))
            theirs = cpu.train_step(to_device(batch, "cpu"))
            loss_diff = max(loss_diff, rel_diff(float(ours["train/loss"]), float(theirs["train/loss"])))
            grads = {n: p.grad for n, p in cpu.network.named_parameters()}
            for name, p in model.network.named_parameters():
                if name.endswith(ZERO_GRADIENTS):
                    continue
                ref, got = grads[name], p.grad.cpu()
                err = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
                if err > grad_diff:
                    grad_diff, worst = err, name
                l2 = float(torch.linalg.vector_norm(got - ref)) / max(float(torch.linalg.vector_norm(ref)), 1e-30)
                rel_l2[name] = max(rel_l2.get(name, 0.0), l2)
            steps += 1
    worst_l2 = max(rel_l2.values(), default=0.0)
    grads_held = worst_l2 <= grad_rel_l2 if grad_rel_l2 is not None else grad_diff <= LOCKSTEP_GRAD_RTOL
    if not (loss_diff <= rtol and grads_held):
        fail(f"{what}: in lockstep the card's steps and the CPU's differ: loss {loss_diff} relative, "
             f"gradients {grad_diff} of their largest magnitude ({worst}), {worst_l2} in relative L2")
    return {"steps": steps, "max_loss_rel_diff": loss_diff, "max_grad_err_over_max": grad_diff,
            "worst_gradient": worst, "rtol": rtol,
            **({"grad_rel_l2_tol": grad_rel_l2} if grad_rel_l2 is not None else
               {"grad_rtol_over_max": LOCKSTEP_GRAD_RTOL}),
            "max_grad_rel_l2": worst_l2, "grad_rel_l2": rel_l2}


def glue_only(path: str, evaluates: bool = True, counter: str = "csr_segment_sum"):
    """The launch check of a path whose only kernel is row 8 in its glue:
    ROW8_LAUNCHES's count a step and a positive number of evaluated batches
    (none for a run that ``evaluates`` nothing), and no other kernel; on
    ``counter`` (``csr_segment_sum_bf16``: row 8b, a bf16 path's glue)."""
    per_step, per_batch = ROW8_LAUNCHES[path]

    def check(counts: dict[str, int], steps: int) -> str | None:
        evaluated = (counts[counter] - per_step * steps) / per_batch if evaluates else 0
        others = {k: v for k, v in counts.items() if k != counter}
        wrong_glue = (evaluated <= 0 or evaluated != int(evaluated) if evaluates
                      else counts[counter] != per_step * steps)
        if wrong_glue or any(others.values()):
            return (f"expected {counter} {per_step} times a step and {per_batch if evaluates else 0} times an "
                    "evaluated batch, and no other kernel")
        return None

    return check


def recipe_launches(path: str):
    """The launch check of a run of the D-MPNN recipe (``dense_packed``):
    rows 2 and 3 on every step, row 1 on every evaluated batch (at least
    one), row 8 as ROW8_LAUNCHES says for ``path``, and nothing else."""
    depth = MODEL_CFG["depth"]

    def check(counts: dict[str, int], steps: int) -> str | None:
        evaluated = counts["fused_dense_mpnn_block"] // depth
        expect = {**zero_counts(), "fused_dense_mpnn_block": depth * evaluated,
                  "fused_dense_mpnn_block_stash": depth * steps, "fused_dense_mpnn_block_bwd_stash": steps,
                  "csr_segment_sum": glue_launches(path, steps, evaluated)}
        if counts != expect or evaluated == 0:
            return f"expected {expect}, the forward kernel for evaluation"
        return None

    return check


def declarative_attention_launches(counts: dict[str, int], steps: int) -> str | None:
    """Each training step: row 12 in every layer's forward and row 13 in
    every layer's backward; each evaluated batch: row 12 in every layer."""
    depth = MODEL_CFG["depth"]
    fwd, bwd = counts["fused_dense_attention_fwd_v2"], counts["fused_dense_attention_bwd_v2"]
    others = {k: v for k, v in counts.items() if k not in ("fused_dense_attention_fwd_v2",
                                                             "fused_dense_attention_bwd_v2", "csr_segment_sum")}
    glue = glue_launches("declarative_attention", steps, 0)
    if (bwd != depth * steps or fwd <= depth * steps or fwd % depth or counts["csr_segment_sum"] != glue
            or any(others.values())):
        return (f"expected row 13 {depth} times a step, row 12 {depth} times a step and an evaluated "
                f"batch, row 8 {glue} times (the embeddings' backward), and nothing else")
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
    additive = torch.where((torch.bmm(S, Gm) > 0)[:, None], bias, float("-inf")).to(q.dtype).contiguous()
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
    return lambda: torch.zeros(V + 1, d, dtype=x["data"].dtype, device=index.device).index_add_(
        0, index, x["data"])[:V]


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


def clouds_sdf(path: Path, clouds: list[PointCloud]) -> dict[str, list]:
    """Write ``clouds`` to ``path`` as an SDF file of V2000 mol blocks (no
    bonds; each type id as the element CLOUD_ELEMENTS names, coordinates to
    4 decimals) and return a table of their coordination targets (``y``),
    one row a block in file order."""
    blocks = []
    for i, c in enumerate(clouds):
        atoms = "".join(f"{x:10.4f}{y:10.4f}{z:10.4f} {CLOUD_ELEMENTS[t]:<3} 0  0  0  0  0  0  0  0  0  0  0  0\n"
                        for (x, y, z), t in zip(c.coords, c.node_types[:, 0]))
        blocks.append(f"cloud {i}\n  synthetic\n\n{c.num_nodes:3d}{0:3d}  0  0  0  0  0  0  0  0999 V2000\n"
                      f"{atoms}M  END\n$$$$\n")
    path.write_text("".join(blocks))
    return {"y": coordination_targets(clouds)[:, 0].tolist()}


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
    breakdown = kernels_of_calls(kernel)
    stages = {stage.rstrip("_,"): sum(k["ms"] for k in breakdown if stage in k["name"]) / 5 for stage in GVP_STAGES[fn]}
    (N, K), ds, dv, nb = x["args"][4].shape, x["args"][0].shape[1], x["args"][1].shape[1], x["args"][6].shape[1]
    lib = gvp_conv._lib()
    floats = (lib.gvp_conv_bwd_scratch_floats if fn is fused_gvp_conv_bwd else lib.gvp_conv_fwd_scratch_floats)
    return t, breakdown, stages, floats(N, K, ds, dv, nb) * 4 / 2**20


def kernels_of_calls(kernel, calls: int = 5, top: int = 40, width: int = 160) -> list[dict]:
    """The ``top`` CUDA kernels (names cut to ``width`` characters) of
    ``calls`` calls of ``kernel`` in a profile: device ms summed over the
    calls, and launches. One call runs first in the profiler's warm-up
    step, whose records are thrown away: late in this script's run, a
    profile without it lost the kernels of its first call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for n in (1, calls):
            for _ in range(n):
                kernel()
            torch.cuda.synchronize()
            prof.step()
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
                     key=lambda e: -e.self_device_time_total)
    return [{"name": e.key[:width], "ms": e.self_device_time_total / 1e3, "count": e.count} for e in kernels[:top]]


def time_sweep(kernel, stage_names=SWEEP_STAGES) -> tuple[dict, list[dict], dict[str, float]]:
    """Row 3, 4 or 6 (``kernel``, a call on fixed inputs; or row 1, 2 or 5
    with FWD_STAGES): its time_ms, the kernels of 5 calls in a profile, and
    their device ms a call by stage."""
    t = time_ms(kernel)
    breakdown = kernels_of_calls(kernel)
    stages = {stage.rstrip("_"): sum(k["ms"] for k in breakdown if stage in k["name"]) / 5 for stage in stage_names}
    return t, breakdown, stages


def gvp_model(cfg: dict, device: str, lr: float = GVP_LR):
    """The point-cloud model of ``cfg`` with weights from SEED, Adam at
    ``lr``, on ``device``."""
    model = build_model(cfg, None, generator=torch.Generator().manual_seed(SEED),
                        optimizer=OptimizerSpec("adam", lr))
    return model.to(device)


def gvp_lockstep(cfg: dict, batches: list[dict], epochs: int, what: str, lr: float = GVP_LR,
                 elementwise: bool = False, max_steps: int | None = None, rtol: float = LOCKSTEP_RTOL,
                 grad_rel_l2: float = KINK_GRAD_L2, skip: tuple[str, ...] = ()) -> dict:
    """Every step of the run taken on the card and on the CPU from the card's
    weights and optimizer state: fails unless each step's loss agrees within
    ``rtol`` (LOCKSTEP_RTOL) relative and each gradient within
    ``grad_rel_l2`` (KINK_GRAD_L2) in relative L2 distance, or with
    ``elementwise`` (a model without ReLU kinks) within LOCKSTEP_GRAD_RTOL
    times its largest magnitude; gradients whose names end with one of
    ``skip`` (pure noise) are left out."""
    card, cpu = gvp_model(cfg, "cuda", lr), gvp_model(cfg, "cpu", lr)
    loss_diff, l2_diff, max_diff, worst, steps = 0.0, 0.0, 0.0, None, 0
    cpu_generators = cpu.generators()
    for _ in range(epochs):
        for batch in batches[:max_steps]:
            cpu.network.load_state_dict(card.network.state_dict())
            cpu.optimizer.load_state_dict(card.optimizer.state_dict())
            for name, gen in card.generators().items():
                cpu_generators[name].set_state(gen.get_state())
            ours = card.train_step(to_device(batch, "cuda"))
            theirs = cpu.train_step(to_device(batch, "cpu"))
            loss_diff = max(loss_diff, rel_diff(float(ours["train/loss"]), float(theirs["train/loss"])))
            grads = dict(cpu.network.named_parameters())
            for name, p in card.network.named_parameters():
                ref = grads[name].grad
                if (p.grad is None and ref is None) or (skip and name.endswith(skip)):  # no output / noise
                    continue
                got = p.grad.cpu()
                l2 = float((got - ref).norm() / ref.norm().clamp_min(1e-30))
                over_max = float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
                if (over_max if elementwise else l2) > (max_diff if elementwise else l2_diff):
                    worst = name
                l2_diff, max_diff = max(l2_diff, l2), max(max_diff, over_max)
            steps += 1
    grads_ok = max_diff <= LOCKSTEP_GRAD_RTOL if elementwise else l2_diff <= grad_rel_l2
    if not (loss_diff <= rtol and grads_ok):
        fail(f"{what}: in lockstep the card's steps and the CPU's differ: loss {loss_diff} relative, "
             f"gradients {l2_diff} in relative L2 and {max_diff} of their largest magnitude ({worst})")
    return {"steps": steps, "max_loss_rel_diff": loss_diff, "max_grad_rel_l2": l2_diff,
            "max_grad_err_over_max": max_diff, "worst_gradient": worst, "rtol": rtol,
            **({"grad_rtol_over_max": LOCKSTEP_GRAD_RTOL} if elementwise else {"grad_rel_l2_tol": grad_rel_l2})}


def train_gvp_phase(tmp: Path, phase: str, path: str, cfg: dict, train: list[dict], val: list[dict], epochs: int,
                    expect_fwd_per_batch: int, lr: float = GVP_LR, run_rtol: float = GVP_RUN_RTOL,
                    elementwise: bool = False) -> tuple[dict[str, int], Path]:
    """fit(cfg's point-cloud model, Adam at ``lr``) for ``epochs`` on the
    card and on the CPU from the same weights, compared epoch by epoch at
    ``run_rtol``, then every step in lockstep (gvp_lockstep). The card's run
    must launch row 15 ``expect_fwd_per_batch`` times a step and row 14 as
    many times a step and an evaluated batch, row 8 as ``path``'s glue does
    (ROW8_LAUNCHES), and nothing else. Returns the launches and the card's
    checkpoint directory."""
    ckpt = tmp / f"{phase}_card"
    reset_launches()
    card = gvp_model(cfg, "cuda", lr)
    t0 = time.perf_counter()
    card_run = fit(card, train, val, epochs=epochs, checkpointer=Checkpointer(ckpt))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = launches()
    steps, n = card.step, expect_fwd_per_batch
    expect = {**zero_counts(), "fused_gvp_conv_fwd": n * (steps + epochs * len(val)),
              "fused_gvp_conv_bwd": n * steps, "csr_segment_sum": glue_launches(path, steps, epochs * len(val))}
    if counts != expect:
        fail(f"{phase}: the card's run of {steps} steps launched {counts}; expected {expect}")
    t0 = time.perf_counter()
    cpu_run = fit(gvp_model(cfg, "cpu", lr), train, val, epochs=epochs)
    cpu_s = time.perf_counter() - t0
    diffs = {f"epoch{e}/{k}": rel_diff(a[k], b[k]) for e, (a, b) in enumerate(zip(card_run.history, cpu_run.history))
             for k in ("train/loss", "val/loss")}
    worst = max(diffs.values())
    falls = epochs < 2 or card_run.history[-1]["train/loss"] < card_run.history[0]["train/loss"]
    emit(phase=phase, clouds=len(train) * BATCH, epochs=epochs, steps=steps, kernel_launches=counts,
         first_batch_nodes=train[0]["inputs.P"].num_nodes, run_s_card=card_s, run_s_cpu=cpu_s,
         warm_epoch_ms_per_step=card_run.history[-1]["time"] * 1e3 / len(train),
         history_card=card_run.history, history_cpu=cpu_run.history, rel_diff_vs_cpu=diffs, rel_tol=run_rtol,
         loss_falls=falls, lockstep=gvp_lockstep(cfg, train, epochs, phase, lr, elementwise))
    if not worst <= run_rtol:
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
    if counts != {**zero_counts(), **expect}:
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


def sdf_schnet_phase(tmp: Path) -> dict[str, int]:
    """SDF_CONFORMERS synthetic conformers written as an SDF file into
    ``tmp`` and read back through SDFDatabase -> MolecularDataset
    (databases, then MolToPointCloud) -> DataLoader: one epoch of fit of the
    SchNet recipe on the card, then its predictions against the CPU's from
    the card's trained weights (RTOL/ATOL), and the epoch's steps card
    against CPU in lockstep (gvp_lockstep, element by element). The same
    epoch on the CPU from the same weights is reported beside the card's:
    SCHNET_RUN_RTOL was measured on train_schnet's run, not on this one,
    whose loss starts near 60 (seven type columns a sum-read atom). Fails
    unless the card launched row 8 as the SchNet path does (ROW8_LAUNCHES)
    and nothing else. Returns the launches of the fit and the predict."""
    sdf = tmp / "conformers.sdf"
    table = clouds_sdf(sdf, make_clouds(SDF_CONFORMERS, seed=SEED + 2))
    t0 = time.perf_counter()
    ds = MolecularDataset(table, transforms={"P": MolToPointCloud()},
                          databases={"mols": DatabaseManager(SDFDatabase(sdf), out_key="mol")},
                          targets={"y": TargetSpec(columns=["y"])})
    loader = DataLoader(ds, batch_size=BATCH)
    batches = list(loader)
    read_s = time.perf_counter() - t0
    cfg = dict(SCHNET_RECIPE)
    reset_launches()
    card = gvp_model(cfg, "cuda", SCHNET_LR)
    card_run = fit(card, loader, epochs=1).history
    got = predict(card, loader, keys=["ffn.preds"])["ffn.preds"]
    torch.cuda.synchronize()
    counts = launches()
    expect = {**zero_counts(),
              "csr_segment_sum": glue_launches("schnet", card.step, len(batches))}
    if counts != expect:
        fail(f"sdf_schnet: the card's epoch and request launched {counts}; expected {expect}")
    cpu = gvp_model(cfg, "cpu", SCHNET_LR)
    cpu_run = fit(cpu, loader, epochs=1).history
    loss_diff = rel_diff(card_run[0]["train/loss"], cpu_run[0]["train/loss"])
    cpu.network.load_state_dict({k: v.cpu() for k, v in card.network.state_dict().items()})
    ref = predict(cpu, loader, keys=["ffn.preds"])["ffn.preds"]
    err = np.abs(got - ref)
    ok = (got.shape == (SDF_CONFORMERS, 1) and bool(np.isfinite(got).all())
          and bool((err <= ATOL + RTOL * np.abs(ref)).all()))
    P = batches[0]["inputs.P"]
    emit(phase="sdf_schnet", conformers=SDF_CONFORMERS, sdf_bytes=sdf.stat().st_size, read_and_collate_s=read_s,
         first_batch={"nodes": P.num_nodes, "atoms": int(P.node_mask.sum()), "type_columns": P.node_feats.shape[1]},
         steps=card.step, kernel_launches=counts, train_loss_card=card_run[0]["train/loss"],
         train_loss_cpu=cpu_run[0]["train/loss"], loss_rel_diff=loss_diff,
         lockstep=gvp_lockstep(cfg, batches, 1, "sdf_schnet", SCHNET_LR, elementwise=True),
         max_abs_err_vs_cpu=float(err.max()), pred_mean=float(got.mean()), ok=ok)
    if not ok:
        fail("sdf_schnet: the card's epoch or predictions disagree with the CPU's, or are not finite")
    return counts


def mask_share(model, loader, device_busy_ms_per_step: float) -> dict:
    """The dropout masks of a warm epoch of ``model``: each ``Dropout.mask``
    call's host time (one seed drawn on the host, the integer ops enqueued)
    against the epoch's wall time, and the device time of the masks a step
    (each shape the epoch drew, formed alone in a CUDA graph of 20 calls)
    against ``device_busy_ms_per_step``."""
    from notorch_tpu_torch.nn.dropout import Dropout, keep_mask

    original, shapes, host = Dropout.mask, [], [0.0]

    def timed(self, shape, device):
        t0 = time.perf_counter()
        out = original(self, shape, device)
        host[0] += time.perf_counter() - t0
        shapes.append((tuple(shape), 1.0 - self.rate))
        return out

    fit(model, loader, epochs=1)
    Dropout.mask = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit(model, loader, epochs=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        Dropout.mask = original
    steps = len(loader)
    device_ms = {key: time_ms(lambda key=key: keep_mask(SEED, key[0], key[1], "cuda"))["device"]
                 for key in set(shapes)}
    mask_device = sum(device_ms[key] for key in shapes) / steps
    return {"masks_per_step": len(shapes) / steps, "mask_device_ms_per_step": mask_device,
            "mask_device_share_of_busy": mask_device / device_busy_ms_per_step,
            "mask_host_ms_per_step": host[0] * 1e3 / steps, "wall_ms_per_step": wall_ms / steps,
            "mask_host_share_of_wall": host[0] * 1e3 / wall_ms}


def config_run_phase(tmp: Path, phase: str, model: dict, check, rtol: float = TRAIN_RTOL,
                     masks: bool = False) -> tuple[dict[str, int], Path]:
    """run(cfg) of ``model`` with the data, optimizer and trainer of
    MODEL_CFG's config (TRAIN_MOLS molecules, TRAIN_EPOCHS epochs) on the
    card and on the CPU from the same seed, compared epoch by epoch at
    ``rtol``; ``check(counts, steps)`` returns what is wrong with the card
    run's launches, or None; then a warm epoch on the card on the host's
    clock and profiled (with ``masks``, the dropout masks' share of it).
    Returns the card run's launches and checkpoint."""
    csv_path = lipo_csv(tmp, TRAIN_MOLS)
    card_ckpt = tmp / f"{phase}_card"
    reset_launches()
    t0 = time.perf_counter()
    card = run(train_config(csv_path, card_ckpt, model))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = launches()
    steps = Checkpointer(card_ckpt).latest_step()
    if not steps:
        fail(f"{phase}: the card's run wrote no checkpoint in {card_ckpt}")
    wrong = check(counts, steps)
    if wrong:
        fail(f"{phase}: the card's run of {steps} steps launched {counts}; {wrong}")
    t0 = time.perf_counter()
    cpu = run(train_config(csv_path, tmp / f"{phase}_cpu", model), device="cpu")
    cpu_s = time.perf_counter() - t0
    diffs = compare_runs(card, cpu, phase, rtol=rtol)
    warm = prepare(train_config(csv_path, None, model))
    timing = warm_epoch(warm["model"], warm["train_loader"])
    if masks:
        timing["masks"] = mask_share(warm["model"], warm["train_loader"], timing["device_busy_ms_per_step"])
    emit(phase=phase, model=model, molecules=TRAIN_MOLS, epochs=TRAIN_EPOCHS, steps=steps,
         kernel_launches=counts, run_s_card=card_s, run_s_cpu=cpu_s, **timing,
         history_card=card["history"], history_cpu=cpu["history"], test_card=card["test"],
         test_cpu=cpu["test"], rel_diff_vs_cpu=diffs, rel_tol=rtol)
    return counts, card_ckpt


def dropout_paths(tmp: Path, n_batches: int) -> None:
    """configs/dmpnn_regression.yaml with model.dropout (the plain dense
    layout: no kernel of the port but row 8 in the embeddings' backward) and
    with model.reduce: max (dense_packed, the plain block over the packed
    bins: row 8 in the embeddings' backward and the packed readout), each
    trained card against CPU and served, 512 molecules card against CPU;
    the dropout run's masks are the same on both devices."""
    ckpt = config_run_phase(tmp, "train_dropout", {**MODEL_CFG, "dropout": DROPOUT}, glue_only("dropout", False),
                            masks=True)[1]
    serve_checkpoint_phase(tmp, ckpt, "serve_dropout", {})
    ckpt = config_run_phase(tmp, "train_max", {**MODEL_CFG, "reduce": "max"}, glue_only("max"))[1]
    serve_checkpoint_phase(tmp, ckpt, "serve_max", {"csr_segment_sum": glue_launches("max", 0, n_batches)})


def dropout_lockstep_phase(tmp: Path) -> None:
    """LOCKSTEP_STEPS steps at dropout DROPOUT, each card against CPU from the
    same weights, optimizer state and dropout streams: the declarative graph
    transformer on rows 12-13 (DenseGATBlock(impl: fused, fwd_impl:
    pallas)), configs/gat_regression.yaml, and the declarative GVP model
    (the GVP recipe, kind: spatial, has no dropout option in either
    package; the block's plain conv, as the fused one refuses dropout)."""
    depth, d, heads = MODEL_CFG["depth"], MODEL_CFG["hidden_dim"], GT_CFG["num_heads"]
    csv_path = lipo_csv(tmp, TRAIN_MOLS)
    attention = declarative_attention_model_cfg(d, depth, heads)
    attention["modules"]["mp"]["args"]["dropout"] = DROPOUT
    attention["modules"]["ffn"]["args"]["dropout"] = DROPOUT
    gvp = declarative_gvp_model_cfg()
    gvp["modules"]["backbone"]["args"].update(dropout=DROPOUT, impl="jnp")
    gvp["modules"]["ffn"]["args"]["dropout"] = DROPOUT
    records = {}
    for name, model in (("declarative_attention", attention), ("gat", {**GAT_CFG, "dropout": DROPOUT})):
        reset_launches()
        records[name] = lockstep(train_config(csv_path, None, model), 1, f"dropout lockstep {name}",
                                 max_steps=LOCKSTEP_STEPS)
        records[name]["kernel_launches"] = counts = launches()
        steps = records[name]["steps"]
        rows = (counts["fused_dense_attention_fwd_v2"], counts["fused_dense_attention_bwd_v2"])
        if steps != LOCKSTEP_STEPS or (name == "declarative_attention" and rows != (depth * steps,) * 2):
            fail(f"dropout lockstep {name}: {steps} steps launched {counts}; expected rows 12 and 13 "
                 f"{depth} times a step on the declarative graph transformer")
    gvp_train = gvp_data()[0]
    records["declarative_gvp"] = gvp_lockstep(gvp, gvp_train, 1, "dropout lockstep declarative_gvp",
                                              max_steps=LOCKSTEP_STEPS)
    emit(phase="dropout_lockstep", dropout=DROPOUT, paths=records)


def held_bf16(what: str, got: torch.Tensor, ref: torch.Tensor) -> dict:
    """Fail unless ``got`` is finite and within BF16_ELEMENT_TOL of ``ref``'s
    largest magnitude elementwise and BF16_L2_TOL in relative L2."""
    got, ref = got.float(), ref.float()
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    l2 = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref).clamp_min(1e-30))
    if not (bool(torch.isfinite(got).all()) and err <= BF16_ELEMENT_TOL * scale and l2 <= BF16_L2_TOL):
        fail(f"{what} (bf16) disagrees with its plain version: max abs err {err} of largest |ref| {scale}, "
             f"relative L2 {l2}")
    return {"max_abs_err": err, "max_abs_err_over_max_abs_ref": err / max(scale, 1e-30), "rel_l2": l2}


def bf16_kernels_phase(main_args, g, n_nodes: int, enc) -> tuple[dict, dict]:
    """Rows 1-6 with matmul_dtype="bfloat16" (rows 2, 3, 5 and 6 with an f32
    and a bf16 stash) at PERF.md's shapes (rows 1-4 the main path's 32 bins
    of 128 edge lanes, rows 5-6 the dense loader's first batch), each held
    against its plain version (held_bf16; the backward rows fed the kernel's
    own stash), called twice for the same bits, and timed as the f32 rows
    are (a CUDA graph of 20 calls), with their kernels' device ms a call by
    stage (FWD_STAGES, SWEEP_STAGES); the forward rows' products must be the
    tensor-core kernel (BF16_FWD_PRODUCT) and no other. The bound counts the
    products at the tensor cores' bf16 rate and the stash's bytes in its
    dtype. Returns each row's (max_abs_err, kernel time, plain time,
    bound_ms, bound_by) with the bf16 stash where it has one, and the
    phase's own launches."""
    depth = MODEL_CFG["depth"]
    h0, src, dst, mask, W, b = main_args
    nf, ef, _, _, _, _, _, gn, ge = enc
    mm = dict(matmul_dtype="bfloat16")
    kw = dict(depth=depth, n_nodes=n_nodes, residual=True, reduce="sum", **mm)
    ref_kw = dict(depth=depth, residual=True, reduce="sum", **mm)
    enc_kw = dict(depth=depth, residual=True, reduce="sum", **mm)
    fwd_ops, bwd_ops, _ = layer_ops(main_args, "sum")
    enc_fwd_ops, enc_bwd_ops, _ = encoder_ops(enc)
    reset_launches()
    rows, cases, product_records = {}, [], 0
    for stash in (None, "bfloat16"):
        out, hs = fused_dense_mpnn_block_stash(*main_args, stash_dtype=stash, **kw)
        grads = fused_dense_mpnn_block_bwd_stash(h0, hs, src, dst, mask, W, g, **kw)
        nh, eh, enc_hs = fused_dense_encoder_fwd(*enc[:7], stash=True, stash_dtype=stash, **enc_kw)
        enc_grads = fused_dense_encoder_bwd(nf, ef, enc_hs, *enc[2:6], gn, ge, **enc_kw)
        calls = {
            fused_dense_mpnn_block_stash: (
                lambda stash=stash: fused_dense_mpnn_block_stash(*main_args, stash_dtype=stash, **kw),
                lambda stash=stash: dense_mpnn_block_stash_reference(*main_args, stash_dtype=stash, **ref_kw),
                depth * fwd_ops, nbytes(*main_args, out, hs)),
            fused_dense_mpnn_block_bwd_stash: (
                lambda hs=hs: fused_dense_mpnn_block_bwd_stash(h0, hs, src, dst, mask, W, g, **kw),
                lambda hs=hs: dense_mpnn_block_bwd_reference(h0, hs, src, dst, mask, W, g, **ref_kw),
                depth * bwd_ops, nbytes(h0, hs, src, dst, mask, W, g, *grads)),
            fused_dense_encoder_fwd: (
                lambda stash=stash: fused_dense_encoder_fwd(*enc[:7], stash=True, stash_dtype=stash, **enc_kw),
                lambda stash=stash: dense_encoder_reference(*enc[:7], stash=True, stash_dtype=stash, **enc_kw),
                enc_fwd_ops, nbytes(*enc[:7], nh, eh, enc_hs)),
            fused_dense_encoder_bwd: (
                lambda enc_hs=enc_hs: fused_dense_encoder_bwd(nf, ef, enc_hs, *enc[2:6], gn, ge, **enc_kw),
                lambda enc_hs=enc_hs: dense_encoder_bwd_reference(nf, ef, enc_hs, *enc[2:6], gn, ge, **enc_kw),
                enc_bwd_ops, nbytes(nf, ef, enc_hs, *enc[2:6], gn, ge, *enc_grads)),
        }
        if stash is None:
            out1 = fused_dense_mpnn_block(*main_args, **kw)
            calls[fused_dense_mpnn_block] = (
                lambda: fused_dense_mpnn_block(*main_args, **kw),
                lambda: dense_mpnn_block_reference(*main_args, **ref_kw),
                depth * fwd_ops, nbytes(*main_args, out1))
            calls[fused_dense_mpnn_block_bwd] = (
                lambda: fused_dense_mpnn_block_bwd(h0, src, dst, mask, W, b, g, **kw),
                lambda: dense_mpnn_block_bwd_reference(
                    h0, dense_mpnn_block_stash_reference(*main_args, **ref_kw)[1], src, dst, mask, W, g, **ref_kw),
                (depth - 1) * fwd_ops + depth * bwd_ops, nbytes(*main_args, g, *grads))
        for fn, (kernel, plain, ops, n_bytes) in calls.items():
            first, second, ref = kernel(), kernel(), plain()
            first, second = [first] if torch.is_tensor(first) else first, [second] if torch.is_tensor(second) else second
            ref = [ref] if torch.is_tensor(ref) else ref
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(first, second) if x is not None):
                fail(f"{fn.__name__} (bf16, stash {stash}): two calls on the same inputs differ")
            errs = [held_bf16(f"{fn.__name__} output {i} (stash {stash})", x, r)
                    for i, (x, r) in enumerate(zip(first, ref)) if x is not None and r is not None]
            forward = fn in (fused_dense_mpnn_block, fused_dense_mpnn_block_stash, fused_dense_encoder_fwd)
            kernel_t, breakdown, stages = time_sweep(kernel, FWD_STAGES if forward else SWEEP_STAGES)
            products = {k["name"] for k in breakdown if "mpnn_fwd_gemm_" in k["name"]}
            if not all(BF16_FWD_PRODUCT in name for name in products):
                fail(f"{fn.__name__} (bf16, stash {stash}): its products ran {sorted(products)}, not only "
                     f"{BF16_FWD_PRODUCT}")
            product_records += len(products)
            plain_t = time_ms(plain)
            bound_ms, bound_by = bound_bf16(ops, n_bytes)
            case = {"kernel": f"{fn.__name__}_bf16", "stash_dtype": stash, "ms": kernel_t["device"],
                    "stages_ms": stages, "eager_ms": kernel_t["eager"], "plain_ms": plain_t["device"],
                    "bound_ms": bound_ms,
                    "bound_by": bound_by, "operations": ops, "bytes": n_bytes,
                    "max_abs_err": max(e["max_abs_err"] for e in errs),
                    "max_err_over_max_abs_ref": max(e["max_abs_err_over_max_abs_ref"] for e in errs),
                    "max_rel_l2": max(e["rel_l2"] for e in errs), "bitwise_repeatable": True}
            cases.append(case)
            if fn in (fused_dense_mpnn_block, fused_dense_mpnn_block_bwd) or stash is not None:
                rows[fn] = (case["max_abs_err"], kernel_t, plain_t, bound_ms, bound_by)
    if not product_records:  # (a late profile can lose some records, not all of a phase's)
        fail(f"no profile of the bf16 forward rows shows {BF16_FWD_PRODUCT}")
    counts = launches()
    emit(phase="bf16_kernels", shape={"rows_1_4": list(h0.shape), "rows_5_6": {"B": ef.shape[0], "V": nf.shape[1],
                                                                                "E": ef.shape[1]}},
         element_tol_over_max=BF16_ELEMENT_TOL, rel_l2_tol=BF16_L2_TOL, cases=cases,
         launches={k: v for k, v in counts.items() if k.endswith("_bf16")})
    return rows, counts


def bf16_block_phase(tmp: Path, n_batches: int) -> dict[str, int]:
    """The declarative whole-encoder config with matmul_dtype and stash_dtype
    bfloat16 (rows 5-6's bf16 instantiations): run(cfg) for TRAIN_EPOCHS
    epochs on the card and on the CPU, held at BF16_RUN_RTOL, every step in
    lockstep, its checkpoint served (card against CPU at the bf16 hold); then
    the block alone (fuse_ends false; rows 1-3's and row 4's bf16
    instantiations) for LOCKSTEP_STEPS steps in lockstep with each backward
    and one served batch. Returns the launches of the bf16 rows on these
    paths."""
    depth, d = MODEL_CFG["depth"], MODEL_CFG["hidden_dim"]
    model = bf16_block_model_cfg(d, depth)

    def check(counts: dict[str, int], steps: int) -> str | None:
        eval_fwd = counts["fused_dense_encoder_fwd_bf16"] - depth * steps
        others = {k: v for k, v in counts.items()
                  if k not in ("fused_dense_encoder_fwd_bf16", "fused_dense_encoder_bwd_bf16", "csr_segment_sum")}
        if (counts["fused_dense_encoder_bwd_bf16"] != steps or eval_fwd <= 0 or eval_fwd % depth
                or counts["csr_segment_sum"] != glue_launches("declarative", steps, 0) or any(others.values())):
            return (f"expected the encoder's bf16 backward {steps} times, its bf16 forward {depth} times a step "
                    "and a batch, row 8 in the embeddings' backward, and nothing else")
        return None

    counts, ckpt = config_run_phase(tmp, "train_bf16_block", model, check, rtol=BF16_RUN_RTOL)
    csv_path = lipo_csv(tmp, TRAIN_MOLS)
    emit(phase="bf16_block_lockstep", lockstep=lockstep(train_config(csv_path, None, model), TRAIN_EPOCHS,
                                                         "train_bf16_block"))
    served = serve_checkpoint_phase(tmp, ckpt, "serve_bf16_block",
                                    {"fused_dense_encoder_fwd_bf16": depth * n_batches}, bf16=True)
    path = {"fused_dense_encoder_fwd_bf16": counts["fused_dense_encoder_fwd_bf16"],
            "fused_dense_encoder_bwd_bf16": counts["fused_dense_encoder_bwd_bf16"]}
    records = {}
    for backward in ("stash", "recompute"):
        block = bf16_block_model_cfg(d, depth, fuse_ends=False, backward=backward)
        cfg = train_config(csv_path, None, block)
        reset_launches()
        records[backward] = lockstep(cfg, 1, f"bf16 block ({backward})", max_steps=LOCKSTEP_STEPS,
                                     rtol=BF16_LOCKSTEP_RTOL)
        built = prepare(cfg)
        predict(built["model"], [next(iter(built["train_loader"]))], keys=["ffn.preds"])
        records[backward]["kernel_launches"] = counts = launches()
        for name, n in counts.items():
            if name.endswith("_bf16") and name.startswith("fused_dense_mpnn"):
                path[name] = path.get(name, 0) + n
    want = {"stash": {"fused_dense_mpnn_block_stash_bf16": depth * LOCKSTEP_STEPS,
                      "fused_dense_mpnn_block_bwd_stash_bf16": LOCKSTEP_STEPS},
            "recompute": {"fused_dense_mpnn_block_bwd_bf16": LOCKSTEP_STEPS}}
    for backward, expect in want.items():
        got = records[backward]["kernel_launches"]
        # the recompute forward and the served batch run row 1
        row1 = depth * (LOCKSTEP_STEPS + 1) if backward == "recompute" else depth
        if any(got[k] != v for k, v in expect.items()) or got["fused_dense_mpnn_block_bf16"] != row1:
            fail(f"bf16 block ({backward}): launched {got}; expected {expect} and row 1 {row1} times")
    emit(phase="bf16_block_rows_1_4", paths=records, served_launches=served)
    return path


# model-wide dtype: bfloat16 (the D-MPNN and attention families): the
# declarative graph transformer on the attention kernels' path, at bf16
# (rows 12b and 13b with bf16 inputs in every layer), and the D-MPNN and GAT
# recipes with model.dtype: bfloat16 (no kernel but row 8b in their glue)
BF16 = "bfloat16"


def bf16_transformer_model_cfg(d: int = 256, depth: int = 3, heads: int = 4) -> dict:
    """declarative_attention_model_cfg with ``dtype: bfloat16`` on the
    embedding, the block and the head: each layer's q, k, v and edge bias
    come out of its dense layers in bf16, so every forward runs row 12b and
    every backward row 13b with bf16 inputs."""
    cfg = declarative_attention_model_cfg(d, depth, heads)
    for name in ("embed", "mp", "ffn"):
        cfg["modules"][name]["args"]["dtype"] = BF16
    return cfg


def bf16_transformer_launches(counts: dict[str, int], steps: int) -> str | None:
    """Each training step: row 12b in every layer's forward and row 13b in
    every layer's backward (bf16 inputs); each evaluated batch: row 12b in
    every layer; row 8b in the embeddings' backward; nothing else."""
    depth = MODEL_CFG["depth"]
    fwd, bwd = counts["fused_dense_attention_fwd_v2_bf16"], counts["fused_dense_attention_bwd_v2_bf16"]
    glue = glue_launches("bf16_transformer", steps, 0)
    others = {k: v for k, v in counts.items() if k not in (
        "fused_dense_attention_fwd_v2_bf16", "fused_dense_attention_bwd_v2_bf16", "csr_segment_sum_bf16")}
    if (bwd != depth * steps or fwd <= depth * steps or fwd % depth or counts["csr_segment_sum_bf16"] != glue
            or any(others.values())):
        return (f"expected row 13b {depth} times a step, row 12b {depth} times a step and an evaluated batch, "
                f"row 8b {glue} times (the embeddings' backward), and nothing else")
    return None


def bf16_models_phase(tmp: Path, n_dense_batches: int, n_gt_batches: int) -> dict[str, dict[str, int]]:
    """The bf16 graph transformer (rows 12b-13b in every layer) and the
    D-MPNN and GAT recipes with model.dtype: bfloat16, each trained for
    TRAIN_EPOCHS epochs on the card and on the CPU: the transformer's every
    step in lockstep (BF16_MODEL_LOCKSTEP_RTOL, BF16_MODEL_GRAD_REL_L2) and
    its whole run at ATTENTION_RUN_RTOL, as the f32 attention runs; the
    D-MPNN's whole run at BF16_MODEL_RUN_RTOL, the GAT's at
    ATTENTION_RUN_RTOL; a warm epoch of each timed and profiled; each
    checkpoint served, card against CPU at the bf16 hold. Returns each run's
    and request's launches."""
    depth, d, heads = MODEL_CFG["depth"], MODEL_CFG["hidden_dim"], GT_CFG["num_heads"]
    csv_path = lipo_csv(tmp, TRAIN_MOLS)
    runs = {}
    transformer = bf16_transformer_model_cfg(d, depth, heads)
    runs["train_bf16_transformer"], ckpt = train_run_phase(
        tmp, "train_bf16_transformer", transformer, TRAIN_EPOCHS, bf16_transformer_launches,
        lockstep_rtol=BF16_MODEL_LOCKSTEP_RTOL, grad_rel_l2=BF16_MODEL_GRAD_REL_L2)
    warm = prepare(train_config(csv_path, None, transformer))
    emit(phase="bf16_transformer_warm_epoch", **warm_epoch(warm["model"], warm["train_loader"]))
    runs["serve_bf16_transformer"] = serve_checkpoint_phase(
        tmp, ckpt, "serve_bf16_transformer", {"fused_dense_attention_fwd_v2_bf16": depth * n_dense_batches},
        bf16=True)
    runs["train_bf16_dmpnn"], ckpt = config_run_phase(tmp, "train_bf16_dmpnn", {**MODEL_CFG, "dtype": BF16},
                                                      glue_only("bf16_dmpnn", False, "csr_segment_sum_bf16"),
                                                      rtol=BF16_MODEL_RUN_RTOL)
    runs["serve_bf16_dmpnn"] = serve_checkpoint_phase(tmp, ckpt, "serve_bf16_dmpnn", {}, bf16=True)
    runs["train_bf16_gat"], ckpt = config_run_phase(tmp, "train_bf16_gat", {**GAT_CFG, "dtype": BF16},
                                                    glue_only("bf16_gat", counter="csr_segment_sum_bf16"),
                                                    rtol=ATTENTION_RUN_RTOL)
    runs["serve_bf16_gat"] = serve_checkpoint_phase(
        tmp, ckpt, "serve_bf16_gat", {"csr_segment_sum_bf16": glue_launches("bf16_gat", 0, n_gt_batches)},
        bf16=True)
    return runs


def bf16_csr_phase(tmp: Path, n_batches: int) -> dict[str, dict[str, int]]:
    """configs/dmpnn_regression.yaml with model.impl: csr and model.dtype:
    bfloat16 trained for TRAIN_EPOCHS epochs on the card and on the CPU, the
    whole run at BF16_MODEL_RUN_RTOL, a warm epoch timed and profiled; every
    E->V sum of the card's block through row 9b (depth + 1 a step and an
    evaluated batch), its glue's sums through row 8b. The checkpoint served,
    N_MOLS molecules card against CPU at the bf16 hold (``n_batches``
    requests' batches). Returns the run's and the request's launches."""
    depth = MODEL_CFG["depth"]

    def check(counts: dict[str, int], steps: int) -> str | None:
        evaluated = counts["csr_segment_sum_packed_bf16"] // (depth + 1) - steps
        expect = {**zero_counts(), "csr_segment_sum_packed_bf16": (depth + 1) * (steps + evaluated),
                  "csr_segment_sum_bf16": glue_launches("bf16_csr", steps, evaluated)}
        if counts != expect or evaluated <= 0:
            return f"expected row 9b {depth + 1} times a step and an evaluated batch: {expect}"
        return None

    runs = {}
    runs["train_bf16_csr"], ckpt = config_run_phase(tmp, "train_bf16_csr", {**MODEL_CFG, "impl": "csr", "dtype": BF16},
                                                    check, rtol=BF16_MODEL_RUN_RTOL)
    runs["serve_bf16_csr"] = serve_checkpoint_phase(
        tmp, ckpt, "serve_bf16_csr", {"csr_segment_sum_packed_bf16": (depth + 1) * n_batches,
                                      "csr_segment_sum_bf16": glue_launches("bf16_csr", 0, n_batches)}, bf16=True)
    return runs


def bf16_attention_phase(packed: list[list], dense: list[list], heads: int) -> tuple[dict, list[dict]]:
    """Rows 10b-13b. With ``matmul_dtype="bfloat16"`` on f32 inputs, which no
    module passes in either package: rows 10b-11b over the graph
    transformer's packed batches and rows 12b-13b over the dense loader's
    batches (``packed``, ``dense``: attention_inputs of each), in a phase of
    their own. Then every entry in both bf16 modes (bf16 inputs: a bf16
    model's q, k, v and bias) against its plain version on every lane at the
    first packed and dense batches (held_bf16), each call twice for the same
    bits, rows with no live pair zero (those launches do not count).
    Returns the phase's launches of each (entry, mode) and the cases."""
    mm = {"matmul_dtype": BF16}
    reset_launches()
    for x in packed:
        fused_dense_attention_fwd(*x[:7], num_heads=heads, **mm)
        fused_dense_attention_bwd(*x[:7], x[7], num_heads=heads, **mm)
    for x in dense:
        fused_dense_attention_fwd_v2(*x[:7], num_heads=heads, **mm)
        fused_dense_attention_bwd_v2(*x[:7], x[7], num_heads=heads, **mm)
    torch.cuda.synchronize()
    counts = launches()
    expect = {**zero_counts(), "fused_dense_attention_fwd_mm": len(packed),
              "fused_dense_attention_bwd_mm": len(packed), "fused_dense_attention_fwd_v2_mm": len(dense),
              "fused_dense_attention_bwd_v2_mm": len(dense)}
    if counts != expect:
        fail(f"the bf16 attention phase launched {counts}; expected {expect}")
    cases = []
    for case, x in (("packed_first_batch", packed[0]), ("dense_first_batch", dense[0])):
        for mode in ("bf16_inputs", "matmul_dtype"):
            xs = [t.bfloat16() if mode == "bf16_inputs" and t is not None and t.is_floating_point() else t
                  for t in x]
            kw = {} if mode == "bf16_inputs" else mm
            args = xs[:7]
            ref = dense_attention_reference(*args, heads, **kw)
            ref_grads = dense_attention_bwd_reference(*args, xs[7], heads, **kw)
            live = (dense_attention_reference(torch.ones_like(xs[0]), *args[1:], heads) != 0).any(-1)
            errs = {}
            for fwd, bwd in ((fused_dense_attention_fwd, fused_dense_attention_bwd),
                             (fused_dense_attention_fwd_v2, fused_dense_attention_bwd_v2)):
                outs = [fwd(*args, num_heads=heads, **kw), fwd(*args, num_heads=heads, **kw)]
                grads = [bwd(*args, xs[7], num_heads=heads, **kw), bwd(*args, xs[7], num_heads=heads, **kw)]
                torch.cuda.synchronize()
                if not (torch.equal(*outs) and all(torch.equal(a, b) for a, b in zip(*grads))):
                    fail(f"{fwd.__name__}/{bwd.__name__} ({mode}, {case}): two calls on the same inputs differ")
                if outs[0][~live].any() or grads[0][0][~live].any():
                    fail(f"{fwd.__name__}/{bwd.__name__} ({mode}, {case}): a row with no live pair is not zero")
                errs[fwd.__name__] = held_bf16(f"{fwd.__name__} ({mode}, {case})", outs[0], ref)
                errs[bwd.__name__] = max((held_bf16(f"{bwd.__name__} {n} ({mode}, {case})", a, r)
                                          for n, a, r in zip(("g_q", "g_k", "g_v", "g_eb"), grads[0], ref_grads)),
                                         key=lambda e: e["max_abs_err_over_max_abs_ref"])
            cases.append({"case": case, "mode": mode, "dtype": str(xs[0].dtype), "live_pairs": live_pairs(x),
                          "held": errs, "bitwise_repeatable": True})
    return {k: v for k, v in counts.items() if v}, cases


def dbuf_bf16_phase(inputs: list[tuple[list[torch.Tensor], int]]) -> tuple[int, float, list[dict]]:
    """Row 7b (matmul_dtype="bfloat16"), which no module calls, in a phase of
    its own on each ``(args, n_nodes)`` for sum and mean, residual on and
    off; then held against its plain version at the bf16 holds and against
    row 1b bit for bit (both multiply on the tensor cores, each output summed
    k16 by k16 in ascending k, and round at the same points; those launches
    do not count): the run fails where a bit differs. Returns its launches,
    its largest error and the cases."""
    depth = MODEL_CFG["depth"]
    reset_launches()
    runs = []
    for args, n_nodes in inputs:
        for reduce in ("sum", "mean"):
            for residual in (True, False):
                kw = dict(depth=depth, n_nodes=n_nodes, residual=residual, reduce=reduce, matmul_dtype=BF16)
                runs.append((args, kw, fused_dense_mpnn_block_dbuf(*args, mols_per_tile=8, **kw)))
    torch.cuda.synchronize()
    count = launches()["fused_dense_mpnn_block_dbuf_bf16"]
    if launches() != {**zero_counts(), "fused_dense_mpnn_block_dbuf_bf16": len(runs)}:
        fail(f"the dbuf bf16 phase launched {launches()}; expected row 7b {len(runs)} times, once a call")
    cases = []
    for args, kw, out in runs:
        row1b = fused_dense_mpnn_block(*args, **kw)
        ref = dense_mpnn_block_reference(*args, depth=depth, residual=kw["residual"], reduce=kw["reduce"],
                                         matmul_dtype=BF16)
        torch.cuda.synchronize()
        case = f"B={args[0].shape[0]} E={args[0].shape[1]} {kw['reduce']} residual={kw['residual']}"
        err = held_bf16(f"dbuf bf16 ({case})", out, ref)
        equal = bool(torch.equal(out, row1b))
        if not equal:
            fail(f"row 7b ({case}) differs from row 1b by {float((out - row1b).abs().max())}; "
                 "it must give row 1b's bits")
        cases.append({"shape": list(args[0].shape), "reduce": kw["reduce"], "residual": kw["residual"], **err,
                      "equal_bits_to_row_1b": equal})
    return count, max(c["max_abs_err"] for c in cases), cases


# classes of bf16 pairs (a, b) on which row 8b's one rounding of a + b is
# held to the f32 add rounded to bf16 (bf16_pairs)
BF16_PAIR_CLASSES = ("normal", "gap_14_20", "gap_100", "ties", "subnormal", "signed_zero", "inf")


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 (nearest, ties to even), as uint16 bits."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().view(torch.int16).numpy().view(np.uint16)


def bf16_pairs(kind: str, n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` pairs of bf16 values of one of BF16_PAIR_CLASSES, as uint16 bits
    ``(a, b)``: normal values over six decades; b 14-20 binades below a (where
    an f32 sum of the two stops being exact) or 100 below; exact ties (b an
    odd multiple of half a's ulp); subnormals (and the smallest normals);
    +0, -0 and exact cancellations; infinities (never +inf with -inf, whose
    sum is NaN) and sums that overflow. Both signs throughout."""
    rng = np.random.default_rng(seed)
    sign = lambda: rng.choice([-1.0, 1.0], size=n)  # noqa: E731
    if kind == "normal":
        a = sign() * rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)
        b = sign() * rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)
    elif kind in ("gap_14_20", "gap_100"):
        gap = rng.integers(14, 21, n) if kind == "gap_14_20" else np.full(n, 100)
        a = sign() * rng.uniform(1, 2, n) * 2.0 ** rng.integers(-10, 10, n)
        b = sign() * rng.uniform(1, 2, n) * np.abs(a) * 2.0 ** -gap.astype(np.float64)
    elif kind == "ties":
        e = rng.integers(-20, 20, n).astype(np.float64)
        a = sign() * (128 + rng.integers(0, 128, n)) * 2.0 ** (e - 7)
        b = sign() * (2 * rng.integers(0, 64, n) + 1) * 2.0 ** (e - 8)
    elif kind == "subnormal":
        sub = lambda: sign() * rng.integers(1, 128, n) * 2.0 ** -133  # noqa: E731
        a = sub()
        b = np.where(rng.random(n) < 0.5, sub(), sign() * rng.integers(128, 160, n) * 2.0 ** -133)
    elif kind == "signed_zero":
        x = sign() * rng.standard_normal(n)
        zeros = sign() * 0.0
        a = np.where(rng.random(n) < 0.5, zeros, x)
        b = np.select([rng.random(n) < 1 / 3, rng.random(n) < 0.5], [sign() * 0.0, -a], x)
    elif kind == "inf":
        big = np.float32(3.3895314e38)  # the largest bf16
        s = sign()
        a = np.where(rng.random(n) < 0.5, s * np.inf, s * big * rng.uniform(0.5, 1, n))
        b = np.where(rng.random(n) < 0.3, s * np.inf, np.where(rng.random(n) < 0.5, s * big * rng.uniform(0.5, 1, n),
                                                               sign() * rng.standard_normal(n)))
    else:
        raise ValueError(f"unknown pair class {kind!r}")
    return _bf16_bits(a), _bf16_bits(b)


def bf16_pair_rows(a: np.ndarray, b: np.ndarray, d: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Pairs as a segment sum: ``(data [2 * m, d] bf16, int64 ids, m)`` with
    segment i's rows a's and b's values i * d .. i * d + d - 1 (m = len(a) //
    d): row 8b's chain from zero gives each a + b rounded once."""
    m = len(a) // d
    rows = np.stack([a[: m * d].reshape(m, d), b[: m * d].reshape(m, d)], axis=1).reshape(2 * m, d)
    data = torch.from_numpy(rows.view(np.int16).copy()).view(torch.bfloat16)
    return data, torch.arange(m).repeat_interleave(2), m


def bf16_glue_phase(glue_x: dict[str, tuple]) -> tuple[float, list[dict]]:
    """Row 8b through ``nn/ops.py`` ``segment_sum`` on the glue cases of
    glue_inputs cast to bf16, and on pairs of every class of BF16_PAIR_CLASSES
    (each segment a pair, at d = 8 and d = 3): twice the same bits, and the
    CPU's ordered bf16 chain's bits. Returns 0 (the largest difference) and
    the cases."""
    from notorch_tpu_torch.nn.ops import segment_sum

    cases = {name: (data.bfloat16(), ids, n) for name, (data, ids, n) in glue_x.items()}
    for i, kind in enumerate(BF16_PAIR_CLASSES):
        for d in (8, 3):
            data, ids, n = bf16_pair_rows(*bf16_pairs(kind, 4096, SEED + 70 + i), d)
            cases[f"pairs_{kind}_d{d}"] = (data.cuda(), ids.cuda(), n)
    records = []
    for name, (data, ids, n) in cases.items():
        first, second = segment_sum(data, ids, n), segment_sum(data, ids, n)
        torch.cuda.synchronize()
        cpu = segment_sum(data.cpu(), ids.cpu(), n)
        if not (torch.equal(first, second) and torch.equal(first.cpu(), cpu)):
            fail(f"row 8b ({name}): two calls differ or the CPU's ordered bf16 chain gives other bits")
        records.append({"case": name, "rows": data.shape[0], "segments": n, "cpu_bits": True,
                        "bitwise_repeatable": True})
    return 0.0, records


# the repeat check: each path's model built from SEED takes REPEAT_STEPS
# train steps on its first training batches twice from the same weights, and
# every parameter and every Adam state tensor must come out with the same bits
REPEAT_STEPS, REPEAT_MOLS = 3, 256
REPEAT_PATHS = ("recipe", "declarative", "impl_csr", "declarative_attention", "declarative_gvp", "gvp_recipe",
                "classification", "multicomponent", "schnet", "dropout", "bf16_block", "bf16_transformer", "bf16_csr")


def repeat_model_cfg(path: str, d: int) -> dict:
    """The model section of a repeat path at hidden width ``d`` (the GVP
    vectors ``d // 8`` wide, as the JAX package's defaults make them): the
    REPEAT_PATHS (``classification``: the multitask classification config's
    model; ``multicomponent``: configs/multicomponent.yaml's), and the flat
    paths ``flat`` (configs/declarative_example.yaml's
    model) and ``flat_gat`` (the GAT recipe on the flat layout)."""
    depth, heads = MODEL_CFG["depth"], GT_CFG["num_heads"]
    return {"recipe": {**MODEL_CFG, "hidden_dim": d},
            "declarative": declarative_model_cfg(d, depth),
            "impl_csr": {**MODEL_CFG, "hidden_dim": d, "impl": "csr"},
            "declarative_attention": declarative_attention_model_cfg(d, depth, heads),
            "declarative_gvp": declarative_gvp_model_cfg(d, d // 8),
            "gvp_recipe": {**GVP_RECIPE, "hidden_dim": d},
            "schnet": {**SCHNET_RECIPE, "hidden_dim": d},
            "classification": {**CLASSIFICATION_MODEL_CFG, "hidden_dim": d},
            "multicomponent": {**SLICE_CONFIGS["multicomponent"]["model"], "hidden_dim": d},
            "flat": declarative_flat_model_cfg(d),
            "flat_gat": {**GAT_CFG, "hidden_dim": d, "layout": "flat"},
            "dropout": {**MODEL_CFG, "hidden_dim": d, "dropout": DROPOUT},
            "bf16_block": bf16_block_model_cfg(d, depth),
            "bf16_transformer": bf16_transformer_model_cfg(d, depth, heads),
            "bf16_csr": {**MODEL_CFG, "hidden_dim": d, "impl": "csr", "dtype": BF16}}[path]


def repeat_run(path: str, tmp: Path, device: str, d: int = 256, batch: int = BATCH,
               steps: int = REPEAT_STEPS) -> dict:
    """``steps`` train steps of ``path``'s model (weights from SEED; Adam
    with the Noam schedule of OPTIMIZER_CFG, the GVP models Adam at GVP_LR,
    the SchNet recipe at SCHNET_LR,
    the classification and multicomponent models their configs' Adam at
    1e-3) on its first training batches of ``batch`` (lipo molecules in the
    order the training loader shuffles them, with the classification
    config's labels and scaffold split for that path, each with a solvent
    for the multicomponent path, or synthetic clouds), taken twice from
    the same weights on ``device``. Returns the names of the parameters and
    Adam state tensors whose bits differ between the two (none where the path
    repeats bit for bit)."""
    cfg = repeat_model_cfg(path, d)
    if path in ("declarative_gvp", "gvp_recipe", "schnet"):
        clouds = make_clouds(steps * batch, seed=SEED)
        batches = cloud_batches(clouds, coordination_targets(clouds), batch_size=batch)[:steps]
        lr = SCHNET_LR if path == "schnet" else GVP_LR
        make, first = (lambda: gvp_model(cfg, device, lr)), gvp_model(cfg, device, lr)
    else:
        if path == "classification":
            run_cfg = classification_config(classification_csv(tmp, REPEAT_MOLS), None, cfg)
        elif path == "multicomponent":
            run_cfg = slice_config(path, multicomponent_csv(tmp, REPEAT_MOLS), None, model=cfg)
        else:
            run_cfg = train_config(lipo_csv(tmp, REPEAT_MOLS), None, cfg)
        run_cfg["trainer"]["batch_size"] = batch
        built = prepare(run_cfg, device)
        batches = [b for _, b in zip(range(steps), built["train_loader"])]
        model_cfg, transforms = built["cfg"]["model"], built["transforms"]
        first = built["model"]

        def make():
            return build_model(model_cfg, transforms, generator=torch.Generator().manual_seed(SEED),
                               optimizer=build_optimizer(run_cfg["optimizer"])).to(device)

    weights = {k: v.clone() for k, v in first.network.state_dict().items()}
    second = make()
    second.network.load_state_dict(weights)
    for name, gen in second.generators().items():  # the dropout paths' masks
        gen.set_state(first.generators()[name].get_state())
    for model in (first, second):
        for b in batches:
            model.train_step(to_device(b, device))
    names = [n for n, _ in first.network.named_parameters()]
    differ = [n for (n, a), (_, b) in zip(first.network.named_parameters(), second.network.named_parameters())
              if not torch.equal(a, b)]
    states = first.optimizer.state_dict()["state"], second.optimizer.state_dict()["state"]
    adam = 0
    for i in sorted(states[0]):
        for key, t in states[0][i].items():
            adam += 1
            if not torch.equal(torch.as_tensor(t), torch.as_tensor(states[1][i][key])):
                differ.append(f"adam {key} of {names[i]}")
    return {"path": path, "steps": len(batches), "parameters": len(names), "adam_tensors": adam, "differ": differ}


def repeat_phase(tmp: Path) -> None:
    """The repeat check of every path of REPEAT_PATHS at full width on the
    card: fails unless each comes out bit for bit the same twice."""
    records = [repeat_run(path, tmp, "cuda") for path in REPEAT_PATHS]
    emit(phase="repeat", steps=REPEAT_STEPS, paths=records)
    bad = {r["path"]: r["differ"] for r in records if r["differ"]}
    if bad:
        fail(f"runs that do not repeat bit for bit on the card: {bad}")


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


def table_gradient(G, d: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Row 8b's longest chain on the main path: the gradient of a bf16 atom
    embedding table on the dense batch ``G`` (its [B, V, 7] type ids; on the
    first lipo batch 21,504 ids into DEFAULT_NUM_ATOM_TYPES rows, the padding
    id a run of 9,513), seeded bf16 cotangents of width d, as ``(data, int64
    ids, num_segments)`` on the CPU."""
    ids = torch.as_tensor(np.asarray(G.node_feats)).reshape(-1).long()
    rng = np.random.default_rng(SEED + 60)
    data = torch.from_numpy(rng.standard_normal((ids.numel(), d)).astype(np.float32)).bfloat16()
    return data, ids, DEFAULT_NUM_ATOM_TYPES


def bf16_time_records(main_args, n_nodes: int, attn_x: dict[str, list], dense_G, heads: int,
                      path: dict, errors: dict) -> list[dict]:
    """Rows 7b, 8b and 10b-13b timed as their f32 rows are (a CUDA graph of
    20 calls) beside their plain versions, bounded by bound_bf16 (the
    products at the tensor cores' bf16 rate, the bytes in each tensor's
    dtype): row 7b at row 7's shape; rows 10b-11b (matmul_dtype) at the
    packed first batch, rows 12b-13b in both modes at the dense first batch
    (``attn_x``); row 8b at the bf16 transformer's node-table backward on the
    dense first batch (``table_gradient``: its run of 9,513 rows is the main
    path's longest chain; the plain version's bits twice, then timed, the
    plain version eager over 2 calls: its steps read the run lengths on the
    host, a launch or more a step), its bound the larger of the bytes bound
    and the chain floor (that run's adds times one add's latency on this
    card, ``chain_add_latency``). ``path``:
    each record's launches; ``errors``: its largest error against its plain
    version. Returns the kernels-line records."""
    depth, d = MODEL_CFG["depth"], MODEL_CFG["hidden_dim"]
    records = []
    kw = dict(depth=depth, n_nodes=n_nodes, residual=True, reduce="sum", matmul_dtype=BF16)
    out = fused_dense_mpnn_block_dbuf(*main_args, mols_per_tile=8, **kw)
    fwd_ops = layer_ops(main_args, "sum")[0]
    kernel_t = time_ms(lambda: fused_dense_mpnn_block_dbuf(*main_args, mols_per_tile=8, **kw))
    plain_t = time_ms(lambda: dense_mpnn_block_reference(*main_args, depth=depth, residual=True, reduce="sum",
                                                         matmul_dtype=BF16))
    bound_ms, bound_by = bound_bf16(depth * fwd_ops, nbytes(*main_args, out))
    emit(phase="time", kernel="fused_dense_mpnn_block_dbuf_bf16", shape=list(main_args[0].shape),
         ms=kernel_t["device"], plain_ms=plain_t["device"], eager_ms=kernel_t["eager"], bound_ms=bound_ms,
         bound_by=bound_by, operations=depth * fwd_ops, bytes=nbytes(*main_args, out), library_ms=None,
         library_note="none: no single PyTorch call", launches=path["fused_dense_mpnn_block_dbuf_bf16"])
    records.append(kernel_record(fused_dense_mpnn_block_dbuf, path["fused_dense_mpnn_block_dbuf_bf16"],
                                 errors["fused_dense_mpnn_block_dbuf_bf16"], kernel_t, plain_t, bound_ms, bound_by,
                                 name="fused_dense_mpnn_block_dbuf_bf16"))
    rows = [(fused_dense_attention_fwd, "_mm", "packed_first_batch"), (fused_dense_attention_bwd, "_mm",
                                                                       "packed_first_batch")]
    rows += [(fn, suffix, "dense_first_batch") for suffix in ("_bf16", "_mm")
             for fn in (fused_dense_attention_fwd_v2, fused_dense_attention_bwd_v2)]
    for fn, suffix, shape in rows:
        bwd = fn in (fused_dense_attention_bwd, fused_dense_attention_bwd_v2)
        x = attn_x[shape]
        if suffix == "_bf16":
            x = [t.bfloat16() if t is not None and t.is_floating_point() else t for t in x]
        kw = {} if suffix == "_bf16" else {"matmul_dtype": BF16}
        kernel = ((lambda fn=fn, x=x, kw=kw: fn(*x[:7], x[7], num_heads=heads, **kw)) if bwd
                  else (lambda fn=fn, x=x, kw=kw: fn(*x[:7], num_heads=heads, **kw)))
        plain = ((lambda x=x, kw=kw: dense_attention_bwd_reference(*x[:7], x[7], heads, **kw)) if bwd
                 else (lambda x=x, kw=kw: dense_attention_reference(*x[:7], heads, **kw)))
        kernel_t, plain_t = time_ms(kernel), time_ms(plain)
        library_t = time_ms(library_sdpa(x, heads, bwd))
        ops, n_bytes, dense_ops = attention_work(x, heads, bwd)
        bound_ms, bound_by = bound_bf16(ops, n_bytes)
        # each kernel's device time over 20 calls (row 11b's query and key
        # passes, row 13b's one cluster kernel)
        breakdown = profile_busy(lambda kernel=kernel: [kernel() for _ in range(20)])["top"]
        name = fn.__name__ + suffix
        emit(phase="time", kernel=name, shape={"case": shape, "B": x[0].shape[0], "V": x[0].shape[1],
                                              "E": x[4].shape[1], "d": d, "heads": heads, "dtype": str(x[0].dtype),
                                              "live_pairs": live_pairs(x)},
             ms=kernel_t["device"], plain_ms=plain_t["device"], eager_ms=kernel_t["eager"], bound_ms=bound_ms,
             bound_by=bound_by, operations=ops, dense_operations=dense_ops, bytes=n_bytes,
             library_ms=library_t["device"], kernels_of_20_calls=breakdown,
             library_note=(("scaled_dot_product_attention forward and autograd backward" if bwd else
                            "scaled_dot_product_attention") + f" on the {x[0].dtype} inputs, the additive mask and "
                           "bias built beforehand"), launches=path[name])
        records.append(kernel_record(fn, path[name], errors[name], kernel_t, plain_t, bound_ms, bound_by, library_t,
                                     name=name))
    from notorch_tpu_torch.kernels.csr_segment import chain_add_latency, segment_sum_in_order, sorted_segments

    data, ids, n = table_gradient(dense_G, d)
    data, ids = data.cuda(), ids.cuda()
    order, row_ptr = sorted_segments(ids, n)
    got = segment_sum_in_order(data, order, row_ptr, n)
    again = segment_sum_in_order(data, order, row_ptr, n)
    torch.cuda.synchronize()
    if not (torch.equal(got, again) and torch.equal(got.cpu(), segment_sum_in_order_reference(
            data.cpu(), order.cpu(), row_ptr.cpu(), n))):
        fail("row 8b at the table gradient: two calls differ or the plain version gives other bits")
    kernel_t = time_ms(lambda: segment_sum_in_order(data, order, row_ptr, n))
    segment_sum_in_order_reference(data, order, row_ptr, n)
    plain_ms = _elapsed_ms(lambda: segment_sum_in_order_reference(data, order, row_ptr, n), 2)
    library_t = time_ms(lambda: torch.zeros(n, d, dtype=torch.bfloat16, device="cuda").index_add_(0, ids, data))
    bytes_ms, _ = bound_bf16(ids.numel() * d, nbytes(data, order, row_ptr) + n * d * 2)
    longest = int(torch.bincount(ids).max())
    latency = chain_add_latency()
    chain_floor_ms = longest * latency["ns_per_add"] * 1e-6
    bound_ms, bound_by = max((bytes_ms, "bytes"), (chain_floor_ms, "operations"))
    emit(phase="time", kernel="csr_segment_sum_bf16", shape={"rows": ids.numel(), "d": d, "segments": n,
                                                             "longest_run": longest},
         ms=kernel_t["device"], eager_ms=kernel_t["eager"], plain_ms=plain_ms, plain_note="eager",
         library_ms=library_t["device"], library_note="torch.zeros(segments, d, bf16).index_add_ (one rounding, "
         "atomics in no fixed order)", bytes_bound_ms=bytes_ms, chain_floor_ms=chain_floor_ms,
         chain_add=latency, bound_ms=bound_ms, bound_by=bound_by,
         bound_note="the larger of the bytes over 3.35 TB/s and the chain floor: the longest run's adds, each "
         "waiting on the last, times one add's latency on this card (chain_add)",
         cpu_plain_bits=True, bitwise_repeatable=True, launches=path["csr_segment_sum_bf16"])
    records.append(kernel_record(csr_segment_sum, path["csr_segment_sum_bf16"], errors["csr_segment_sum_bf16"],
                                 kernel_t, {"device": plain_ms}, bound_ms, bound_by, library_t,
                                 name="csr_segment_sum_bf16"))
    return records


def kernel_record(fn, path_launches: int, max_abs_err: float, kernel_t: dict, plain_t: dict,
                  bound_ms: float, bound_by: str, library_t: dict | None = None, name: str | None = None) -> dict:
    source, replaces = KERNELS[fn]
    return {"name": name or fn.__name__, "route": "cuda", "source": source, "replaces": replaces,
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
        dbuf_bf16_launches, dbuf_bf16_err, dbuf_bf16_cases = dbuf_bf16_phase(
            [(main_args, main_G.nodes_per_graph), (dense_args, dense_G.nodes_per_graph)])
        emit(phase="dbuf_bf16_vs_plain", element_tol_over_max=BF16_ELEMENT_TOL, rel_l2_tol=BF16_L2_TOL,
             launches=dbuf_bf16_launches, cases=dbuf_bf16_cases)

        # rows 8-9 at the first flat lipo batch (V = 2048, E = 4096) and a random case
        flat_batches = list(DataLoader(ds, batch_size=BATCH, layout="flat", csr_pack=True))
        flat_G = flat_batches[0]["inputs.G"]
        flat_x = flat_inputs(flat_G, d, SEED + 5)
        rowptr_err, packed_err, flat_cases = flat_kernels_phase(
            {"lipo_first_flat_batch": flat_x, "random_empty_and_overfull": random_flat_inputs(d, SEED + 6)})
        emit(phase="flat_kernels_vs_plain", sum_atol=f"{SUM_ATOL} x each element's sum of |terms|",
             cases=flat_cases)
        # row 9b at the first flat lipo batch and at runs across chunk boundaries
        bf16_packed_err, bf16_packed_cases = bf16_packed_phase(
            {"lipo_first_flat_batch": flat_x, **{case: chunk_flat_inputs(case, d, SEED + 8 + i)
                                                 for i, case in enumerate(CHUNK_CASES)}})
        emit(phase="bf16_packed_vs_plain", cases=bf16_packed_cases)
        rowptr_launches, rowptr_path_err = rowptr_phase(flat_batches, d)
        emit(phase="rowptr", batches=len(flat_batches), launches=rowptr_launches, max_abs_err=rowptr_path_err)
        # row 8 as the glue calls it on the main path (nn/ops.py segment_sum)
        glue_x = glue_inputs(main_G, d, SEED + 7)
        glue_err, glue_cases = glue_sums_phase(glue_x)
        emit(phase="glue_sums_vs_plain", sum_atol=f"{SUM_ATOL} x each element's sum of |terms|", cases=glue_cases)
        glue_bf16_err, glue_bf16_cases = bf16_glue_phase(glue_x)
        emit(phase="glue_sums_bf16_vs_cpu", cases=glue_bf16_cases)

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
        # rows 10b-13b: matmul_dtype="bfloat16" over the packed and the dense
        # batches in a phase of their own, then both bf16 modes held
        bf16_attn_launches, bf16_attn_cases = bf16_attention_phase(
            [batch_attention_inputs(b["inputs.G"], d, heads, SEED + 40 + i) for i, b in enumerate(gt_batches)],
            [batch_attention_inputs(b["inputs.G"], d, heads, SEED + 50 + i) for i, b in enumerate(dense_batches)],
            heads)
        emit(phase="bf16_attention_kernels", element_tol_over_max=BF16_ELEMENT_TOL, rel_l2_tol=BF16_L2_TOL,
             launches=bf16_attn_launches, cases=bf16_attn_cases)

        # the JAX train CLI's default input path: the native featurizer, the
        # prefetcher, grouped steps, the jnp backward and the trace utilities
        utilities_phases(tmp)

        served = serve_phase(tmp, ds, csv_path, len(batches))
        trained = train_phase(tmp)
        recomputed = train_epoch_phase(tmp)
        declarative, declarative_ckpt = train_declarative_phase(tmp)
        serve_declarative_phase(tmp, declarative_ckpt, len(dense_batches))
        flat_trained, flat_ckpt = train_flat_phase(tmp)
        serve_checkpoint_phase(tmp, flat_ckpt, "serve_flat",
                               {"csr_segment_sum_packed": (depth + 1) * len(flat_batches),
                                "csr_segment_sum": glue_launches("impl_csr", 0, len(flat_batches))})
        serve_checkpoint_phase(tmp, train_declarative_flat_phase(tmp), "serve_declarative_flat",
                               {"csr_segment_sum": glue_launches("flat", 0, len(flat_batches))})
        attention, attention_ckpt = train_run_phase(
            tmp, "train_declarative_attention", declarative_attention_model_cfg(d, depth, heads), TRAIN_EPOCHS,
            declarative_attention_launches)
        serve_checkpoint_phase(tmp, attention_ckpt, "serve_declarative_attention",
                               {"fused_dense_attention_fwd_v2": depth * len(dense_batches)})
        serve_checkpoint_phase(tmp, train_run_phase(tmp, "train_graph_transformer", dict(GT_CFG), TRAIN_EPOCHS,
                                                    glue_only("graph_transformer"))[1], "serve_graph_transformer",
                               {"csr_segment_sum": glue_launches("graph_transformer", 0, len(gt_batches))})
        serve_checkpoint_phase(tmp, train_run_phase(tmp, "train_gat", dict(GAT_CFG), 1, glue_only("gat"))[1],
                               "serve_gat", {"csr_segment_sum": glue_launches("gat", 0, len(gt_batches))})

        # the multitask classification config (rows 1-3 and row 8's glue),
        # its checkpoint served, and one step of each other head
        classification_ckpt = train_classification_phase(tmp)[1]
        serve_checkpoint_phase(
            tmp, classification_ckpt, "serve_classification",
            {"fused_dense_mpnn_block": depth * len(batches),
             "csr_segment_sum": glue_launches("classification", 0, len(batches))},
            columns=tuple(CLASSIFICATION_COLUMNS), probabilities=True)
        task_heads_phase(tmp)

        # the multicomponent, reaction (rows 1-3), MoE and pretraining
        # configs as shipped, row 8 in all four
        slice_phases(tmp)

        # edge dropout (the plain dense layout) and max (the plain block over
        # packed bins) trained and served; dropout's other sites in lockstep;
        # rows 1-6's bf16 instantiations on the bf16 encoder's and block's paths
        dropout_paths(tmp, len(batches))
        dropout_lockstep_phase(tmp)
        bf16_path = bf16_block_phase(tmp, len(dense_batches))
        # model-wide bf16: the graph transformer on rows 12b-13b, the D-MPNN
        # and GAT recipes
        bf16_runs = bf16_models_phase(tmp, len(dense_batches), len(gt_batches))
        # the flat impl: csr D-MPNN at bf16: row 9b in every reduce
        bf16_csr_runs = bf16_csr_phase(tmp, len(flat_batches))

        # rows 14-15 against their plain versions, then the GVP model both ways
        gvp_train, gvp_val = gvp_data()
        gvp_x = gvp_cases(gvp_train)
        gvp_records = [compare_gvp(x, name) for name, x in gvp_x.items()]
        emit(phase="gvp_kernels_vs_plain", rtol=RTOL, atol=ATOL,
             grad_atol="ATOL x the largest |value| of each gradient", cases=gvp_records)
        gvp_cfg = declarative_gvp_model_cfg()
        gvp_depth = gvp_cfg["modules"]["backbone"]["args"]["depth"]
        gvp_trained, gvp_ckpt = train_gvp_phase(tmp, "train_declarative_gvp", "declarative_gvp", gvp_cfg, gvp_train,
                                                gvp_val, GVP_EPOCHS, gvp_depth)
        gvp_served = serve_gvp_phase(gvp_ckpt, gvp_cfg, gvp_train, "serve_declarative_gvp",
                                     {"fused_gvp_conv_fwd": gvp_depth * len(gvp_train),
                                      "csr_segment_sum": glue_launches("declarative_gvp", 0, len(gvp_train))})
        recipe_ckpt = train_gvp_phase(tmp, "train_gvp_recipe", "gvp_recipe", dict(GVP_RECIPE), gvp_train, gvp_val,
                                      1, 0)[1]
        serve_gvp_phase(recipe_ckpt, dict(GVP_RECIPE), gvp_train, "serve_gvp_recipe",
                        {"csr_segment_sum": glue_launches("gvp_recipe", 0, len(gvp_train))})

        # the SchNet recipe (row 8 in its glue) on the same clouds, served, and
        # one epoch and a request from an SDF file
        schnet_runs = {}
        schnet_runs["train_schnet"], schnet_ckpt = train_gvp_phase(
            tmp, "train_schnet", "schnet", dict(SCHNET_RECIPE), gvp_train, gvp_val, GVP_EPOCHS, 0, lr=SCHNET_LR,
            run_rtol=SCHNET_RUN_RTOL, elementwise=True)
        emit(phase="schnet_warm_epoch", **warm_epoch(gvp_model(dict(SCHNET_RECIPE), "cuda", SCHNET_LR), gvp_train))
        schnet_runs["serve_schnet"] = serve_gvp_phase(
            schnet_ckpt, dict(SCHNET_RECIPE), gvp_train, "serve_schnet",
            {"csr_segment_sum": glue_launches("schnet", 0, len(gvp_train))})
        schnet_runs["sdf_schnet"] = sdf_schnet_phase(tmp)
        # the spatial stacks at dtype: bfloat16 (SchNet's gathers: row 8b)
        schnet_runs["train_schnet_bf16"] = spatial_bf16_phase(gvp_train, gvp_val)

        # the parallel package at world size 1, in fresh processes (NCCL on
        # the card beside gloo on the CPU): rows 2-3 under DenseSpmdTrainer,
        # row 8 under the halo and pretraining runs
        parallel_phase(tmp)

        # every path's run twice from the same weights, bit for bit; the calm
        # attention recipe's whole run card against CPU
        repeat_phase(tmp)
        attention_calm_run_phase(tmp)

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
    bf16_rows, _ = bf16_kernels_phase(main_args, g, main_G.nodes_per_graph, enc)
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
    runs[csr_segment_sum_packed] = (  # called as the flat block calls it, dst and mask given
        lambda: csr_segment_sum_packed(x["data"], x["perm"], x["packed_dst"], V, dst=x["dst"],
                                       edge_mask=x["edge_mask"]),
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
        csr_segment_sum: trained["csr_segment_sum"],
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
        csr_segment_sum: max(rowptr_err, rowptr_path_err, glue_err),
        csr_segment_sum_packed: packed_err,
    }
    shapes = {fn: (list(h0.shape), nnz) for fn in runs}
    shapes[fused_dense_encoder_fwd] = shapes[fused_dense_encoder_bwd] = (
        {"B": ef.shape[0], "V": nf.shape[1], "E": ef.shape[1], "d": d}, enc_nnz)
    shapes[csr_segment_sum] = shapes[csr_segment_sum_packed] = (
        {"V": V, "E": E, "d": d, "real_edges": n_real, "longest_run": int(torch.diff(x["row_ptr"]).max())}, None)
    # rows 1, 2 and 5 count the layers they run; row 7 (one launch) and the
    # backward rows count one a call
    fwd_rows = (fused_dense_mpnn_block, fused_dense_mpnn_block_stash, fused_dense_encoder_fwd)
    sweeps = (fused_dense_mpnn_block_bwd_stash, fused_dense_mpnn_block_bwd, fused_dense_encoder_bwd)
    records = []
    for fn, (kernel, plain, ops, n_bytes) in runs.items():
        # rows 3, 4 and 6 with their sweep's kernels by stage, rows 1, 2 and 5 with the forward's
        kernel_t, breakdown, stages = (time_sweep(kernel) if fn in sweeps else
                                       time_sweep(kernel, FWD_STAGES) if fn in fwd_rows else
                                       (time_ms(kernel), None, None))
        plain_t = time_ms(plain)
        library, library_note = libraries.get(
            fn, (None, "no single PyTorch call computes the fused block, the encoder or their backwards"))
        library_t = None if library is None else time_ms(library)
        bound_ms, bound_by = bound(ops, n_bytes)
        emit(phase="time", kernel=fn.__name__, shape=shapes[fn][0],
             depth=None if fn in libraries else depth, reduce="sum",
             ms=kernel_t["device"], plain_ms=plain_t["device"], eager_ms=kernel_t["eager"],
             plain_eager_ms=plain_t["eager"], bound_ms=bound_ms, bound_by=bound_by,
             operations=ops, bytes=n_bytes, nnz_A=shapes[fn][1],
             library_ms=None if library_t is None else library_t["device"], library_note=library_note,
             launches=path_launches[fn],
             calls=path_launches[fn] // depth if fn in fwd_rows else path_launches[fn],
             **({} if breakdown is None else {"kernels_of_5_calls": breakdown, "stages_ms": stages}))
        records.append(kernel_record(fn, path_launches[fn], errors[fn], kernel_t, plain_t,
                                     bound_ms, bound_by, library_t))
    # rows 1-6's bf16 instantiations (bf16_kernels_phase's times; their
    # launches on the bf16 block's paths)
    for fn, (err, kernel_t, plain_t, bound_ms, bound_by) in bf16_rows.items():
        records.append(kernel_record(fn, bf16_path[f"{fn.__name__}_bf16"], err, kernel_t, plain_t, bound_ms,
                                     bound_by, name=f"{fn.__name__}_bf16"))
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
            # at each row's path shape: each kernel's device time over 20
            # calls (the profiler can drop the records of a run's last
            # microseconds, which would hold all of 5 calls of a few us)
            breakdown = (profile_busy(lambda kernel=kernel: [kernel() for _ in range(20)])["top"]
                         if shape == path_shape else None)
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
    # rows 7b, 8b and 10b-13b
    bf16_errors = {"fused_dense_mpnn_block_dbuf_bf16": dbuf_bf16_err, "csr_segment_sum_bf16": glue_bf16_err}
    for case in bf16_attn_cases:
        for name, err in case["held"].items():
            key = name + ("_bf16" if case["mode"] == "bf16_inputs" else "_mm")
            bf16_errors[key] = max(bf16_errors.get(key, 0.0), err["max_abs_err"])
    transformer_run = bf16_runs["train_bf16_transformer"]
    bf16_model_path = {"fused_dense_mpnn_block_dbuf_bf16": dbuf_bf16_launches, **bf16_attn_launches,
                       **{k: transformer_run[k] for k in ("fused_dense_attention_fwd_v2_bf16",
                                                          "fused_dense_attention_bwd_v2_bf16",
                                                          "csr_segment_sum_bf16")}}
    records += bf16_time_records(main_args, main_G.nodes_per_graph, attn_x, dense_G, heads, bf16_model_path,
                                 bf16_errors)
    # row 9b at row 9's shape (the first flat lipo batch's messages in bf16),
    # in the same call as row 9's time above
    from notorch_tpu_torch.kernels.csr_segment import csr_segment_sum_packed_bf16_reference

    xb = {**x, "data": x["data"].bfloat16()}
    kernel_t = time_ms(lambda: csr_segment_sum_packed(xb["data"], x["perm"], x["packed_dst"], V, dst=x["dst"],
                                                      edge_mask=x["edge_mask"]))
    plain_t = time_ms(lambda: csr_segment_sum_packed_bf16_reference(xb["data"], x["perm"], x["packed_dst"], V))
    library_t = time_ms(library_index_add(xb))
    n_bytes = n_real * d * 2 + nbytes(x["perm"], x["packed_dst"]) + V * d * 2
    bound_ms, bound_by = bound_bf16(n_real * d, n_bytes)
    row9b_launches = bf16_csr_runs["train_bf16_csr"]["csr_segment_sum_packed_bf16"]
    emit(phase="time", kernel="csr_segment_sum_packed_bf16", shape=shapes[csr_segment_sum_packed][0],
         ms=kernel_t["device"], plain_ms=plain_t["device"], eager_ms=kernel_t["eager"],
         plain_eager_ms=plain_t["eager"], bound_ms=bound_ms, bound_by=bound_by, operations=n_real * d,
         bytes=n_bytes, library_ms=library_t["device"],
         library_note="torch.zeros(V + 1, d, bf16).index_add_ over the real edges (one rounding, atomics in no "
         "fixed order)", launches=row9b_launches,
         launches_serve=bf16_csr_runs["serve_bf16_csr"]["csr_segment_sum_packed_bf16"])
    records.append(kernel_record(csr_segment_sum_packed, row9b_launches, bf16_packed_err, kernel_t, plain_t,
                                 bound_ms, bound_by, library_t, name="csr_segment_sum_packed_bf16"))
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
    # row 8 at the shapes the main path gives it: the kernel alone over the
    # sorted ids (a CUDA graph of 20 calls), and nn/ops.py segment_sum as the
    # glue calls it, the sort of the ids included (launched one by one)
    from notorch_tpu_torch.kernels.csr_segment import segment_sum_in_order, sorted_segments
    from notorch_tpu_torch.nn.ops import segment_sum

    for name, (data, ids, n) in glue_x.items():
        order, row_ptr = sorted_segments(ids, n)
        width = data.shape[1] if data.dim() > 1 else 1
        kernel_t = time_ms(lambda: segment_sum_in_order(data, order, row_ptr, n))
        plain_t = time_ms(lambda: torch.zeros((n,) + tuple(data.shape[1:]), device="cuda").index_add_(0, ids, data))
        call_ms = _elapsed_ms(lambda: segment_sum(data, ids, n), 200)
        bound_ms, bound_by = bound(data.shape[0] * width, nbytes(data, order, row_ptr) + n * width * 4)
        emit(phase="time_row8_path", case=name, shape={"rows": data.shape[0], "d": width, "segments": n,
                                                        "longest_run": int(torch.bincount(ids).max())},
             ms=kernel_t["device"], eager_ms=kernel_t["eager"], segment_sum_eager_ms=call_ms,
             plain_ms=plain_t["device"], library_ms=plain_t["device"],
             library_note="torch.zeros(segments, d).index_add_ (the plain version)", bound_ms=bound_ms,
             bound_by=bound_by)
    # row 8 on the SchNet path: each SchNet run's launches beside the recipe's
    row8 = next(r for r in records if r["name"] == "csr_segment_sum")
    row8["launches_schnet"] = {run: counts["csr_segment_sum"] for run, counts in schnet_runs.items()
                               if run != "train_schnet_bf16"}
    # row 8b on each bf16 path's runs and requests
    row8b = next(r for r in records if r["name"] == "csr_segment_sum_bf16")
    row8b["launches_bf16_paths"] = {run: counts["csr_segment_sum_bf16"] for run, counts in bf16_runs.items()}
    missing = [r["name"] for r in records if r["launches"] <= 0]
    missing += [f"csr_segment_sum on {run}" for run, n in row8["launches_schnet"].items() if n <= 0]
    if missing:
        fail(f"kernels never launched on their path: {missing}")
    emit(kernels=records)
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": kind, "count": count})


if __name__ == "__main__":
    main()
