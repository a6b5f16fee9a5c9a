"""The model: a composed network plus its losses, metrics, task transforms
and optimizer, with train, eval and predict steps.

Port of ``notorch_tpu.model.model.Model``. What the JAX package keeps in a
``TrainState`` lives here in objects: the parameters in the network's
modules (``Model.network``, an ``nn.Module``), the optimizer state in
``Model.optimizer``, the schedule's position in ``Model.scheduler`` and the
update count in ``Model.step``. A module that draws noise in training (the
sparse MoE router) keeps its own ``torch.Generator`` in ``generator``; the
training state carries every such generator's state, as the JAX state
carries its RNG. Running statistics (``BatchNorm``'s ``batch_stats``) are
buffers of their modules, in the ``state_dict``. Logging keys are the JAX package's: ``train/<name>``,
``train/loss``, ``val/<name>``, ``val/loss`` and the ``_count/val/<name>``
weights that :func:`~notorch_tpu_torch.training.loop.evaluate` averages by.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from notorch_tpu_torch.model.composed import ComposedNetwork, _gather, make_network
from notorch_tpu_torch.training.optim import OptimizerSpec, clip_by_global_norm_

EPS = 1e-6


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
    """``modules``: ``{name: {"module", "in_keys", "out_keys"}}``, any
    names, run in the order of their key-space dependencies;
    ``transforms``: ``{name: {"preds": {"module", "key"}, "targets": ...}}``;
    ``losses``/``metrics``: ``{name: {"fn", "in_keys", "weight"}}``;
    ``optimizer``: an :class:`~notorch_tpu_torch.training.optim.
    OptimizerSpec` (default Adam at 1e-4, as in the JAX package), built
    over the network's parameters here."""

    def __init__(
        self,
        modules: Mapping[str, Mapping],
        losses: Mapping[str, Mapping] | None = None,
        metrics: Mapping[str, Mapping] | None = None,
        transforms: Mapping[str, Mapping] | None = None,
        optimizer: OptimizerSpec | None = None,
    ):
        self.network: ComposedNetwork = make_network(modules)
        self.declared = list(modules)  # names as the config declares them
        self.losses = dict(losses or {})
        self.metrics = dict(metrics or {})
        self.transforms = dict(transforms or {})
        # the weighted sum of the loss terms is the loss; a metric's weight
        # in val/loss is EPS, as in the JAX package
        self.loss_weights = {name: cfg.get("weight", 1.0) for name, cfg in self.losses.items()}
        self.optimizer_spec = optimizer if optimizer is not None else OptimizerSpec()
        # Module.to moves parameters in place, so the optimizer built here
        # keeps pointing at them after Model.to
        self.optimizer, self.scheduler = self.optimizer_spec.build(self.network.parameters())
        self.step = 0

    @property
    def device(self) -> torch.device:
        return next(self.network.parameters()).device

    def to(self, device) -> "Model":
        self.network.to(device)
        return self

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Draw every parameter from ``generator``, module by module in
        declaration order (flax's initializer families; see
        :mod:`notorch_tpu_torch.nn.init`)."""
        for name in self.declared:
            module = self.network[name] if name in self.network else None  # None: an alias
            if hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    # -- training state -----------------------------------------------------
    def generators(self) -> dict[str, torch.Generator]:
        """The noise generators of the network's modules, by module path."""
        return {name: m.generator for name, m in self.network.named_modules()
                if isinstance(getattr(m, "generator", None), torch.Generator)}

    def train_state_dict(self) -> dict:
        """Everything but the parameters and buffers that a resumed run needs."""
        return {
            "optimizer": self.optimizer.state_dict(),
            "scheduler": None if self.scheduler is None else self.scheduler.state_dict(),
            "step": self.step,
            "generators": {name: g.get_state() for name, g in self.generators().items()},
        }

    def load_train_state_dict(self, state: Mapping) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])
        for name, g in self.generators().items():
            g.set_state(state["generators"][name])

    # -- shared pieces ------------------------------------------------------
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

    @staticmethod
    def _terms(fns: Mapping[str, Mapping], batch: dict) -> dict[str, torch.Tensor]:
        terms = {}
        for name, cfg in fns.items():
            args, kwargs = _gather(batch, cfg["in_keys"])
            terms[name] = cfg["fn"](*args, **kwargs)
        return terms

    def _term_counts(self, batch: dict) -> dict[str, torch.Tensor | float]:
        """Per-term normalizer totals: the batch weights that recombine
        per-batch masked means into the global masked mean, exactly the
        denominator ``masked_reduce`` used (the mask sum, times the sample
        weights where the term wires them)."""
        counts: dict[str, torch.Tensor | float] = {}
        for name, cfg in {**self.losses, **self.metrics}.items():
            ks = cfg["in_keys"]
            n = None
            if isinstance(ks, Mapping):
                mask_key, sw_key = ks.get("mask"), ks.get("sample_weights")
                mask = batch[mask_key].float() if mask_key in batch else None
                sw = batch[sw_key].float() if sw_key in batch else None
                targets = batch.get(ks.get("targets"))
                if sw is not None:
                    if mask is not None:
                        n = (mask * sw.reshape(sw.shape + (1,) * (mask.dim() - sw.dim()))).sum()
                    elif targets is not None:
                        n = sw.sum() * float(targets[0].numel())
                elif mask is not None:
                    n = mask.sum()
                elif targets is not None:
                    n = float(targets.numel())
            counts[name] = n if n is not None else 1.0
        return counts

    # -- steps --------------------------------------------------------------
    def train_step(self, batch: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        """One optimizer update on ``batch`` (already on the model's device):
        forward in training mode, the ``targets`` transforms, the weighted
        loss terms, backward, the clip where configured, the optimizer and
        the schedule. Returns ``train/<name>`` and ``train/loss`` as device
        scalars (no host sync)."""
        self.network.train()
        self.optimizer.zero_grad(set_to_none=True)
        out = self._apply_transforms(self.network(batch), "targets")
        terms = self._terms(self.losses, out)
        loss = sum(self.loss_weights.get(name, EPS) * v for name, v in terms.items())
        loss.backward()
        if self.optimizer_spec.clip_norm:
            clip_by_global_norm_(self.network.parameters(), float(self.optimizer_spec.clip_norm))
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.step += 1
        logs = {f"train/{k}": v.detach() for k, v in terms.items()}
        logs["train/loss"] = loss.detach()
        return logs

    def train_steps(self, stacked_batches: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        """K train steps in sequence on the device: ``stacked_batches`` is a
        batch whose every array has a leading steps axis K, on the model's
        device (the tree that :func:`~notorch_tpu_torch.data.batching.stage`
        returns, or a ``PrefetchLoader(stack=K)`` group's). No host sync
        between the steps; the parameters, optimizer state and schedule
        after it are those of K :meth:`train_step` calls, bit for bit.
        Returns the logs averaged over the K steps (device scalars), as the
        JAX ``train_steps`` averages its scan's."""
        from notorch_tpu_torch.data.batching import stack_size, unstack_tree

        logs = [self.train_step(unstack_tree(stacked_batches, i)) for i in range(stack_size(stacked_batches))]
        return {k: torch.stack([step[k] for step in logs]).mean(dim=0) for k in logs[0]}

    def eval_step(self, batch: Mapping[str, Any]) -> tuple[dict, dict]:
        """Losses and metrics of ``batch`` in eval mode, with no autograd
        (the block runs its forward kernel alone): ``(logs, outputs)``."""
        self.network.eval()
        with torch.no_grad():
            out = self._apply_transforms(self.network(batch), "targets")
            terms = self._terms(self.losses, out)
            metric_terms = self._terms(self.metrics, out)
            val_loss = sum(self.loss_weights.get(name, EPS) * v for name, v in terms.items())
            val_loss = val_loss + sum(
                self.loss_weights.get(name, EPS) * v for name, v in metric_terms.items()
            )
            logs = {f"val/{k}": v for k, v in {**terms, **metric_terms}.items()}
            logs["val/loss"] = val_loss
            counts = self._term_counts(out)
            logs.update({f"_count/val/{k}": v for k, v in counts.items()})
            if self.losses:
                logs["_count/val/loss"] = counts[next(iter(self.losses))]
        return logs, out

    def predict_step(self, batch: Mapping[str, Any]) -> dict:
        """Network outputs with the ``preds`` transforms applied (data units)."""
        self.network.eval()
        with torch.inference_mode():
            return self._apply_transforms(self.network(batch), "preds")
