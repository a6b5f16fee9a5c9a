"""Where a path's training step stops repeating on the card: one training
step of each of ``chip_smoke.py``'s repeat paths (``REPEAT_PATHS``), taken
twice from the same weights on the same batch, every module's output and
every parameter's gradient compared bit for bit; then the step once more
under ``torch.use_deterministic_algorithms(True, warn_only=True)``, which
names the operations that torch itself knows to be nondeterministic on the
card. Prints one JSON line a path (the first module whose output differs,
the gradients that differ, the operations named), then the card's name and
power limit.

    python3 scripts/repeat_probe.py [--root DIR] [PATH ...]

``--root`` is the checkout whose ``notorch_tpu_torch`` runs (default: this
one), so that a parent commit unpacked with ``git archive`` is probed the
same way.
"""

import argparse
import importlib.util
import json
import sys
import tempfile
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def outputs_of(x, prefix: str = "") -> dict:
    """The float tensors of a module's output (a tensor, a tuple or a batch
    object), by name."""
    import torch

    if torch.is_tensor(x):
        return {prefix: x}
    if isinstance(x, (tuple, list)):
        return {k: v for i, item in enumerate(x) for k, v in outputs_of(item, f"{prefix}[{i}]").items()}
    if hasattr(x, "__dict__"):
        return {f"{prefix}.{k}": v for k, v in vars(x).items() if torch.is_tensor(v) and v.is_floating_point()}
    return {}


def one_step(model, batch, weights):
    """Forward, loss and backward of one training step from ``weights``:
    each module's outputs in the order they ran, and every gradient."""
    model.network.load_state_dict(weights)
    model.optimizer.zero_grad(set_to_none=True)
    seen = []
    hooks = [mod.register_forward_hook(
        lambda m, i, o, name=name: seen.append((name, {k: v.detach().clone() for k, v in outputs_of(o).items()})))
        for name, mod in model.network.named_modules()]
    model.network.train()
    out = model._apply_transforms(model.network(batch), "targets")
    terms = model._terms(model.losses, out)
    sum(model.loss_weights[n] * v for n, v in terms.items()).backward()
    for h in hooks:
        h.remove()
    return seen, {n: p.grad.detach().clone() for n, p in model.network.named_parameters() if p.grad is not None}


def probe(smoke, path: str, tmp: Path) -> dict:
    import torch

    from notorch_tpu_torch.training.loop import to_device

    cfg = smoke.repeat_model_cfg(path, smoke.MODEL_CFG["hidden_dim"])
    if path in ("declarative_gvp", "gvp_recipe"):
        clouds = smoke.make_clouds(smoke.BATCH, seed=smoke.SEED)
        batch = smoke.cloud_batches(clouds, smoke.coordination_targets(clouds), batch_size=smoke.BATCH)[0]
        model = smoke.gvp_model(cfg, "cuda")
    else:
        built = smoke.prepare(smoke.train_config(smoke.lipo_csv(tmp, smoke.REPEAT_MOLS), None, cfg), "cuda")
        batch, model = next(iter(built["train_loader"])), built["model"]
    batch = to_device(batch, "cuda")
    weights = {k: v.clone() for k, v in model.network.state_dict().items()}
    (first, grads), (second, again) = one_step(model, batch, weights), one_step(model, batch, weights)
    differing = next((f"{name}{k}" for (name, a), (_, b) in zip(first, second) for k in a
                      if not torch.equal(a[k], b[k])), None)
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        one_step(model, batch, weights)
        torch.cuda.synchronize()
    torch.use_deterministic_algorithms(False)
    named = sorted({str(w.message).split(".")[0][:160] for w in caught if "determinis" in str(w.message)})
    return {"path": path, "first_differing_output": differing,
            "gradients_differing": [n for n in grads if not torch.equal(grads[n], again[n])],
            "nondeterministic_ops_named": named}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(HERE), help="the checkout whose package runs")
    parser.add_argument("paths", nargs="*", help="repeat paths (default: all of REPEAT_PATHS)")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        smoke.fail("no CUDA device is available; this script probes runs on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="repeat_probe_") as tmp:
        for path in args.paths or smoke.REPEAT_PATHS:
            print(json.dumps({"root": args.root, **probe(smoke, path, Path(tmp))}), flush=True)
    print(smoke.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
