"""The D-MPNN property predictor: embed -> message passing -> readout -> FFN.

Port of ``notorch_tpu.models.dmpnn`` for every task type (regression,
classification, multiclass, mve, evidential, dirichlet) on four layouts:

- the bin-packed dense layout (``dense_packed``, what ``layout="auto"``
  resolves to by default) and the per-molecule ``dense_fused`` layout, whose
  block is :class:`~notorch_tpu_torch.nn.chemprop_dense.
  FusedDenseChempropBlock` for ``reduce`` sum and mean, as in the JAX
  package; on ``dense_packed``, edge dropout or ``reduce="max"`` take the
  plain :class:`~notorch_tpu_torch.nn.chemprop_dense.DenseChempropBlock`
  over the same packed bins, as there;
- the plain per-molecule ``dense`` layout (what ``auto`` resolves to for
  edge dropout): ``DenseChempropBlock`` and the ``Dense*`` readouts on the
  per-molecule ``dense`` collate;
- the flat layout (``flat``, what ``auto`` resolves to for remat or an
  ``impl`` other than ``gather``): :class:`~notorch_tpu_torch.nn.embed.
  GraphEmbedding`, :class:`~notorch_tpu_torch.nn.chemprop.ChempropBlock`
  (sum, mean or max; ``impl`` gather, segment or csr) and every readout of
  :mod:`notorch_tpu_torch.nn.agg`.

The head is ``num_tasks`` wide, or ``(num_tasks, k)`` for the task types
with ``k`` outputs a task (``_HEAD_WIDTH``; ``num_classes`` for multiclass
and dirichlet); the loss is the task's (``_LOSSES``), named after the task
(``mse`` for regression), and regression alone has the default metrics
RMSE and MAE, on the same keys as there. Every layout takes the five
readouts (sum, mean, max, gated, sdp) and keeps its kernels whatever the
task. ``graph_axis`` with ``partition`` builds the graph-partitioned models
of the JAX package on the flat layout (``molecule``, ``replicate``,
``halo``; see :func:`build_dmpnn`), trained by
:class:`~notorch_tpu_torch.parallel.spmd.SpmdTrainer`.
"""

from __future__ import annotations

import torch

from notorch_tpu_torch.conf import DEFAULT_HIDDEN_DIM
from notorch_tpu_torch.model.model import Model, fill_pred_transform_keys
from notorch_tpu_torch.nn import agg
from notorch_tpu_torch.nn.chemprop import ChempropBlock
from notorch_tpu_torch.nn.chemprop_dense import (
    DenseChempropBlock,
    DenseGated,
    DenseGraphEmbedding,
    DenseMax,
    DenseMean,
    DenseSDPAttention,
    DenseSum,
    FusedDenseChempropBlock,
    PackedGated,
    PackedMax,
    PackedMean,
    PackedSDPAttention,
    PackedSum,
    refuse_bf16_state,
)
from notorch_tpu_torch.nn.embed import GraphEmbedding
from notorch_tpu_torch.nn.mlp import MLP
from notorch_tpu_torch.tasks import losses as L
from notorch_tpu_torch.tasks import metrics as M
from notorch_tpu_torch.training.optim import OptimizerSpec
from notorch_tpu_torch.transforms.vocab import DEFAULT_NUM_ATOM_TYPES, DEFAULT_NUM_BOND_TYPES
from notorch_tpu_torch.utils import compute_dtype

AGGREGATIONS = ("sum", "mean", "max", "gated", "sdp")
LAYOUTS = ("dense_packed", "dense_fused", "dense", "flat")
DENSE_READOUTS = {"sum": DenseSum, "mean": DenseMean, "max": DenseMax, "gated": DenseGated,
                  "sdp": DenseSDPAttention}
PACKED_READOUTS = {"sum": PackedSum, "mean": PackedMean, "max": PackedMax, "gated": PackedGated,
                   "sdp": PackedSDPAttention}
FLAT_READOUTS = {"sum": agg.Sum, "mean": agg.Mean, "max": agg.Max, "gated": agg.Gated,
                 "sdp": agg.SDPAttention}
REDUCES = ("sum", "mean", "max")
# outputs a task of each task type, where it is fixed (multiclass and
# dirichlet take num_classes), and each task type's loss
_HEAD_WIDTH = {"regression": 1, "classification": 1, "mve": 2, "evidential": 4}
_LOSSES = {
    "regression": L.MSE,
    "classification": L.BinaryCrossEntropy,
    "multiclass": L.CrossEntropy,
    "mve": L.MeanVarianceEstimation,
    "evidential": L.Evidential,
    "dirichlet": L.Dirichlet,
}


def head_size(num_tasks: int, per_task: int) -> int | tuple[int, int]:
    """The FFN's ``output_size``: ``num_tasks``, or ``(num_tasks,
    per_task)`` for a head of several outputs a task."""
    return num_tasks if per_task == 1 else (num_tasks, per_task)


def task_losses(task: str, keys: dict) -> dict:
    """The loss term of ``task`` on ``keys``, named after the task (``mse``
    for regression), as the JAX recipes name it."""
    if task not in _LOSSES:
        raise ValueError(f"unknown task {task!r}; options: {list(_LOSSES)}")
    return {task if task != "regression" else "mse": {"fn": _LOSSES[task](), "in_keys": keys, "weight": 1.0}}


def regression_metrics(task: str, keys: dict) -> dict:
    """The default metrics: ``rmse`` and ``mae`` for regression, none for
    the other task types."""
    if task != "regression":
        return {}
    return {"rmse": {"fn": M.RMSE(), "in_keys": keys}, "mae": {"fn": M.MAE(), "in_keys": keys}}


def readout(readouts: dict, aggregation: str, hidden_dim: int, dtype=None, **kwargs):
    """The ``aggregation`` readout of ``readouts`` at width ``hidden_dim``
    (the gated one's score layer computing in ``dtype``, as the JAX recipes
    build it), with ``kwargs`` (a flat readout's ``psum_axis``)."""
    width = {"gated": {"input_dim": hidden_dim, "dtype": dtype}, "sdp": {"key_dim": hidden_dim}}
    return readouts[aggregation](**width.get(aggregation, {}), **kwargs)


def resolve_layout(
    layout: str = "auto",
    *,
    dropout: float = 0.0,
    dtype=None,
    graph_axis: str | None = None,
    remat: bool = False,
    impl: str = "gather",
    aggregation: str = "mean",
    reduce: str = "sum",
) -> str:
    """The layout ``notorch_tpu.models.dmpnn.resolve_layout`` picks for the
    same arguments: ``"dense_packed"`` when no edge dropout, f32 state, no
    graph-axis partitioning, no remat and the default ``impl``; ``"dense"``
    for dropout or a non-f32 dtype; ``"flat"`` for partitioning, remat or a
    flat-specific ``impl``. Explicit layouts pass through unchanged."""
    if aggregation not in AGGREGATIONS:
        raise ValueError(f"unknown aggregation {aggregation!r}; options: {sorted(AGGREGATIONS)}")
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduce {reduce!r}; options: {sorted(REDUCES)}")
    if layout != "auto":
        return layout
    if graph_axis is not None or remat or impl != "gather":
        return "flat"
    if dtype is not None and str(dtype).removeprefix("torch.") != "float32":
        return "dense"
    if dropout and dropout > 0.0:
        return "dense"
    return "dense_packed"


def build_dmpnn(
    num_tasks: int = 1,
    task: str = "regression",
    num_classes: int = 2,
    hidden_dim: int = DEFAULT_HIDDEN_DIM,
    depth: int = 3,
    dropout: float = 0.0,
    aggregation: str = "mean",
    reduce: str = "sum",
    ffn_layers: int = 1,
    optimizer: OptimizerSpec | None = None,
    transforms: dict | None = None,
    num_node_types: int | None = None,
    num_edge_types: int | None = None,
    dtype=None,
    graph_axis: str | None = None,
    remat: bool = False,
    impl: str = "gather",
    layout: str = "auto",
    partition: str = "molecule",
    generator: torch.Generator | None = None,
) -> Model:
    """The canonical embed -> chemprop -> readout -> FFN predictor, with the
    same four modules (``embed``, ``mp``, ``readout``, ``ffn``) and keys as
    the JAX package's, the task's loss on ``targets.y`` and its mask, and
    for regression the metrics ``rmse`` and ``mae``. Parameters are drawn from ``generator``
    with flax's initializer families; the model is built on the CPU
    (``Model.to`` moves it). ``optimizer`` defaults to Adam at 1e-4.

    ``layout="dense_fused"`` is the fused block (``fuse_ends`` off) with a
    per-molecule readout, on the per-molecule ``dense`` collate, as in the
    JAX package; ``layout="dense"`` the plain ``DenseChempropBlock`` with a
    per-molecule readout on the same collate; ``dense_packed`` the fused
    block, or the plain one for edge dropout or ``reduce="max"``, with a
    ``Packed*`` readout. ``layout="flat"`` is ``GraphEmbedding`` ->
    ``ChempropBlock(impl, reduce, remat)`` -> the ``aggregation`` readout
    -> ``MLP``, on the flat collate (with ``csr_pack`` for ``impl="csr"``).

    ``graph_axis`` + ``partition`` select the graph-partitioned scheme, on
    the flat layout (``auto`` resolves to it; another layout raises JAX's
    ``ValueError``): ``"molecule"`` (default; shards hold whole molecules,
    :func:`~notorch_tpu_torch.parallel.partition.build_molecule_spmd_batch`;
    the readout's ``[G, d]`` psum is the only traffic), ``"halo"`` (nodes in
    contiguous blocks, boundary rows exchanged twice a layer by
    :class:`~notorch_tpu_torch.parallel.halo.HaloChempropBlock`; reduce sum,
    no dropout or remat) or ``"replicate"`` (edge shards over replicated
    nodes, a ``[V, d]`` psum every layer). The readout sums over the graph
    axis for ``molecule`` and ``halo``, the block for ``replicate``.

    ``dtype="bfloat16"`` computes the embeddings, the block, the readout
    and the head in bf16 (f32 parameters), as the JAX modules do; ``auto``
    then resolves to the plain ``dense`` layout, and ``flat`` takes every
    ``impl`` (``csr``: the packed sum's bf16 mode, TPU kernel row 9b). A
    bf16 model on a layout whose block is the fused kernels
    (``dense_packed`` without dropout or max, ``dense_fused``) raises
    ``NotImplementedError``, as the JAX package cannot run one (see
    :func:`~notorch_tpu_torch.nn.chemprop_dense.refuse_bf16_state`)."""
    layout = resolve_layout(
        layout, dropout=dropout, dtype=dtype, graph_axis=graph_axis,
        remat=remat, impl=impl, aggregation=aggregation, reduce=reduce,
    )
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; options: {list(LAYOUTS)}")
    if graph_axis is not None and layout != "flat":
        raise ValueError(
            f"graph-axis partitioning operates on the flat layout; got layout={layout!r} with graph_axis={graph_axis!r}"
        )
    if partition not in ("molecule", "replicate", "halo"):
        raise ValueError(f"unknown partition scheme {partition!r}")
    halo = partition == "halo" and graph_axis is not None
    if halo and (dropout or remat):
        raise ValueError("the halo message-passing block supports neither dropout nor remat; build with "
                         "dropout=0.0, remat=False")
    if halo and reduce != "sum":
        raise ValueError("the halo message-passing block implements reduce='sum' (its boundary exchange "
                         "accumulates partial sums)")
    mp_axis = graph_axis if partition == "replicate" else None
    readout_axis = graph_axis if partition in ("molecule", "halo") else None
    dt = compute_dtype(dtype)
    if layout == "dense_fused":
        if dropout and dropout > 0.0:
            raise ValueError(
                "the fused block does not support edge dropout; use layout='dense' "
                "(or layout='auto', which selects it)"
            )
        if reduce == "max":
            raise ValueError(
                "the fused block implements reduce='sum' and 'mean' (both fold into its "
                "linear edge operator); use layout='dense'/'dense_packed' for max"
            )
    num_node_types = num_node_types if num_node_types is not None else DEFAULT_NUM_ATOM_TYPES
    num_edge_types = num_edge_types if num_edge_types is not None else DEFAULT_NUM_BOND_TYPES
    if layout == "flat":
        embed = GraphEmbedding(num_node_types, num_edge_types, hidden_dim=hidden_dim, dtype=dt)
        if halo:
            from notorch_tpu_torch.parallel.halo import HaloChempropBlock

            block = HaloChempropBlock(axis=graph_axis, hidden_dim=hidden_dim, depth=depth)
        else:
            block = ChempropBlock(hidden_dim=hidden_dim, depth=depth, dropout=dropout, reduce=reduce,
                                  remat=remat, impl=impl, dtype=dt, psum_axis=mp_axis)
        head = readout(FLAT_READOUTS, aggregation, hidden_dim, dt, psum_axis=readout_axis)
    else:
        embed = DenseGraphEmbedding(num_node_types, num_edge_types, hidden_dim=hidden_dim, dtype=dt)
        plain = layout == "dense" or (dropout and dropout > 0.0) or reduce == "max"
        if plain:  # the fused kernels' operator is linear and has no dropout
            block = DenseChempropBlock(hidden_dim=hidden_dim, depth=depth, dropout=dropout, reduce=reduce,
                                       dtype=dt)
        else:
            if dt != torch.float32:
                refuse_bf16_state(f"dtype={dtype!r} on layout {layout!r}")
            block = FusedDenseChempropBlock(hidden_dim=hidden_dim, depth=depth, reduce=reduce)
        head = readout(PACKED_READOUTS if layout == "dense_packed" else DENSE_READOUTS, aggregation, hidden_dim,
                       dt)

    output_size = head_size(num_tasks, _HEAD_WIDTH.get(task, num_classes))
    modules = {
        "embed": {"module": embed, "in_keys": ["inputs.G"], "out_keys": ["G"]},
        "mp": {"module": block, "in_keys": ["embed.G"], "out_keys": ["G"]},
        "readout": {"module": head, "in_keys": ["mp.G"], "out_keys": ["H"]},
        "ffn": {
            "module": MLP(
                input_dim=hidden_dim, output_size=output_size,
                hidden_dim=hidden_dim, num_layers=ffn_layers, dropout=dropout, dtype=dt,
            ),
            "in_keys": ["readout.H"],
            "out_keys": ["preds"],
        },
    }
    keys = {"preds": "ffn.preds", "targets": "targets.y", "mask": "targets.y_mask"}
    model = Model(
        modules=modules,
        losses=task_losses(task, keys),
        metrics=regression_metrics(task, keys),
        transforms=fill_pred_transform_keys(transforms, "ffn.preds"),
        optimizer=optimizer,
    )
    model.reset_parameters(generator)
    return model
