"""Inference over a loader.

Port of ``notorch_tpu.training.loop.predict``; ``fit`` and ``evaluate``
come with the training slice.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from notorch_tpu_torch.data.dense import DenseBatchedGraph
from notorch_tpu_torch.model.model import Model


def to_device(batch: Mapping[str, Any], device) -> dict:
    """A host batch (numpy arrays, tensors, dense graphs) on ``device``."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, DenseBatchedGraph):
            v = v.to(device)
        elif isinstance(v, np.ndarray):
            v = torch.from_numpy(v).to(device)
        elif isinstance(v, torch.Tensor):
            v = v.to(device)
        out[k] = v
    return out


def predict(model: Model, loader, keys: list[str] | None = None) -> dict[str, np.ndarray]:
    """Inference pass applying the ``preds`` transforms: each batch goes to
    the model's device, outputs stay there until the end, and are
    concatenated on the host."""
    device = model.device
    accum: dict[str, list] = {}
    for batch in loader:
        out = model.predict_step(to_device(batch, device))
        for k, v in out.items():
            if keys is not None and k not in keys:
                continue
            if isinstance(v, torch.Tensor):
                accum.setdefault(k, []).append(v)
    return {k: np.concatenate([x.cpu().numpy() for x in v]) for k, v in accum.items()}
