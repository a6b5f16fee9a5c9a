"""The model: a composed network plus its task transforms.

Port of ``notorch_tpu.model.model.Model`` for serving. Parameters live in
the network's modules (``Model.network``, an ``nn.Module``), not in a
separate state. ``losses`` and ``metrics`` are stored with the same layout
as the JAX package's but not evaluated yet: the train and eval steps come
with the training slice.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from notorch_tpu_torch.model.composed import ComposedNetwork, make_network


def fill_pred_transform_keys(transforms: Mapping | None, pred_key: str):
    """Point pred-side task transforms at ``pred_key`` where unset."""
    if not transforms:
        return transforms
    out = {}
    for name, cfg in transforms.items():
        cfg = dict(cfg)
        preds = cfg.get("preds")
        if preds and preds.get("module") is not None and preds.get("key") is None:
            cfg["preds"] = {**preds, "key": pred_key}
        out[name] = cfg
    return out


class Model:
    """``modules``: ``{name: {"module", "in_keys", "out_keys"}}``;
    ``transforms``: ``{name: {"preds": {"module", "key"}, "targets": ...}}``;
    ``losses``/``metrics``: ``{name: {"fn", "in_keys", "weight"}}``."""

    def __init__(
        self,
        modules: Mapping[str, Mapping],
        losses: Mapping[str, Mapping] | None = None,
        metrics: Mapping[str, Mapping] | None = None,
        transforms: Mapping[str, Mapping] | None = None,
    ):
        self.network: ComposedNetwork = make_network(modules)
        self.losses = dict(losses or {})
        self.metrics = dict(metrics or {})
        self.transforms = dict(transforms or {})

    @property
    def device(self) -> torch.device:
        return next(self.network.parameters()).device

    def to(self, device) -> "Model":
        self.network.to(device)
        return self

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Draw every parameter from ``generator``, module by module in
        execution order (flax's initializer families; see
        :mod:`notorch_tpu_torch.nn.init`)."""
        for module in self.network.values():
            if hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def _apply_transforms(self, batch: dict, mode: str) -> dict:
        """Apply ``targets`` or ``preds`` transforms in place-by-key.
        Missing keys are tolerated."""
        batch = dict(batch)
        for cfg in self.transforms.values():
            sub = cfg.get(mode)
            if not sub or sub.get("module") is None or sub.get("key") is None:
                continue
            key = sub["key"]
            if key in batch:
                batch[key] = sub["module"](batch[key])
        return batch

    def predict_step(self, batch: Mapping[str, Any]) -> dict:
        """Network outputs with the ``preds`` transforms applied (data units)."""
        self.network.eval()
        with torch.inference_mode():
            return self._apply_transforms(self.network(batch), "preds")
