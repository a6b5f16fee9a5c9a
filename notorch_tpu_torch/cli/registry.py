"""Name -> class registry for config-driven model composition.

Port of ``notorch_tpu.cli.registry``: every module, loss, metric, transform
and optimizer the port has is constructible by name from a YAML/JSON config
(``{"class": name, "args": {...}}``, nested ``{"class": ...}`` args built
first), under the JAX package's names. ``MetricMAE`` is the metric and
``MAE`` the loss, as there. ``adam``, ``adamw`` and ``sgd`` build the
port's :class:`~notorch_tpu_torch.training.optim.OptimizerSpec`.

A DOTTED name (``mypkg.blocks.MyBlock``) resolves by import behind the same
gate as in the JAX package: instantiating an import path named by a config
is code execution, so it is opt-in, by :func:`allow_imports` or by listing
trusted top-level packages in the ``NOTORCH_TPU_TORCH_TRUSTED_MODULES``
environment variable (comma-separated).
"""

from __future__ import annotations

import functools
import importlib
import os
from typing import Any, Callable

REGISTRY: dict[str, Callable] = {}
TRUSTED_MODULES_ENV = "NOTORCH_TPU_TORCH_TRUSTED_MODULES"

_ALLOW_IMPORTS = False


def allow_imports(flag: bool = True) -> None:
    """Globally permit dotted-path config resolution (see module docstring)."""
    global _ALLOW_IMPORTS
    _ALLOW_IMPORTS = bool(flag)


def register(name: str, fn: Callable | None = None):
    if fn is not None:
        REGISTRY[name] = fn
        return fn

    def deco(f):
        REGISTRY[name] = f
        return f

    return deco


def _resolve_import(path: str) -> Callable:
    top = path.split(".", 1)[0]
    trusted = {r.strip() for r in os.environ.get(TRUSTED_MODULES_ENV, "").split(",") if r.strip()}
    if not (_ALLOW_IMPORTS or top in trusted):
        raise PermissionError(
            f"config names the import path {path!r}, but arbitrary-class instantiation is "
            "disabled (it executes code named by the config). Enable it with "
            "notorch_tpu_torch.cli.registry.allow_imports(), or list trusted packages in "
            f"{TRUSTED_MODULES_ENV} (e.g. {top!r})."
        )
    module_path, _, attr = path.rpartition(".")
    obj = importlib.import_module(module_path)
    try:
        return getattr(obj, attr)
    except AttributeError:
        raise KeyError(f"module {module_path!r} has no attribute {attr!r}") from None


def resolve(name: str) -> Callable:
    try:
        return REGISTRY[name]
    except KeyError:
        pass
    if "." in name:
        return _resolve_import(name)
    raise KeyError(f"unknown component {name!r}; known: {sorted(REGISTRY)}")


def build(spec: dict | str) -> Any:
    """Build a component from ``{"class": name, "args": {...}}`` (or a bare
    name). Nested ``{"class": ...}`` dicts in args are built recursively."""
    if isinstance(spec, str):
        return resolve(spec)()
    kwargs = {}
    for k, v in (spec.get("args") or {}).items():
        if isinstance(v, dict) and "class" in v:
            v = build(v)
        kwargs[k] = v
    return resolve(spec["class"])(**kwargs)


def _populate() -> None:
    from notorch_tpu_torch.nn.agg import Gated, Max, Mean, SDPAttention, Sum
    from notorch_tpu_torch.nn.attention import GATBlock, GATv2Layer, GraphSelfAttention
    from notorch_tpu_torch.nn.attention_dense import DenseGATBlock, DenseGraphSelfAttention
    from notorch_tpu_torch.nn.chemprop import ChempropBlock, ChempropLayer
    from notorch_tpu_torch.nn.chemprop_dense import (
        DenseChempropBlock,
        DenseGraphEmbedding,
        DenseMax,
        DenseMean,
        DenseSum,
        FusedDenseChempropBlock,
    )
    from notorch_tpu_torch.nn import glue, moe
    from notorch_tpu_torch.nn.embed import GraphEmbedding
    from notorch_tpu_torch.nn.mlp import MLP
    from notorch_tpu_torch.nn.rbf import RBFEmbedding
    from notorch_tpu_torch.nn.spatial import agg as spatial_agg
    from notorch_tpu_torch.nn.spatial.gvp import GvpGNNBlock
    from notorch_tpu_torch.nn.spatial.painn import GatedEquivariantBlock
    from notorch_tpu_torch.nn.spatial.pointwise import Pointwise, PointwiseEmbed
    from notorch_tpu_torch.nn.spatial.schnet import SchnetBlock
    from notorch_tpu_torch.tasks import losses, metrics
    from notorch_tpu_torch.training.optim import OptimizerSpec
    from notorch_tpu_torch.transforms import (
        MolToFP,
        MolToGraph,
        MultiTypeAtomTransform,
        MultiTypeBondTransform,
        Pipeline,
        SmiToMol,
    )
    from notorch_tpu_torch.transforms.point_cloud import MolToPointCloud
    from notorch_tpu_torch.transforms.reaction import RxnToGraph

    for cls in [
        ChempropBlock,
        ChempropLayer,
        GraphEmbedding,
        Sum,
        Mean,
        Max,
        Gated,
        SDPAttention,
        DenseChempropBlock,
        DenseGraphEmbedding,
        DenseSum,
        DenseMean,
        DenseMax,
        FusedDenseChempropBlock,
        GATv2Layer,
        GraphSelfAttention,
        GATBlock,
        DenseGraphSelfAttention,
        DenseGATBlock,
        MLP,
        GvpGNNBlock,
        GatedEquivariantBlock,
        SchnetBlock,
        Pointwise,
        PointwiseEmbed,
        RBFEmbedding,
        moe.MixtureOfExperts,
        moe.MoEMLP,
        moe.DenseRouter,
        moe.SparseRouter,
        glue.Add,
        glue.Mul,
        glue.Cat,
        glue.Split,
        glue.MatMul,
        glue.Einsum,
        glue.Identity,
        glue.BatchNorm,
        glue.Residual,
        MolToGraph,
        MolToFP,
        SmiToMol,
        RxnToGraph,
        MolToPointCloud,
        MultiTypeAtomTransform,
        MultiTypeBondTransform,
        Pipeline,
    ]:
        register(cls.__name__, cls)
    register("SpatialSum", spatial_agg.Sum)
    register("SpatialMean", spatial_agg.Mean)
    register("SpatialMax", spatial_agg.Max)
    register("SpatialGated", spatial_agg.Gated)
    for name in ["MSE", "MAE", "BoundedMSE", "BoundedMAE", "MeanVarianceEstimation", "MVE", "Evidential",
                 "BinaryCrossEntropy", "BCE", "CrossEntropy", "XENT", "Dirichlet", "RankNContrastLoss",
                 "SelfSupervisedLoss"]:
        register(name, getattr(losses, name))
    for name in ["RMSE", "R2", "Accuracy", "AUROC", "AUPRC", "F1"]:
        register(name, getattr(metrics, name))
    register("MetricMAE", metrics.MAE)
    # called with the rate, as optax.adam(lr) is in the JAX package
    register("adam", functools.partial(OptimizerSpec, "adam"))
    register("adamw", functools.partial(OptimizerSpec, "adamw"))
    register("sgd", functools.partial(OptimizerSpec, "sgd"))


_populate()
