"""The task modules of the port against the JAX package's, on the same
seeded numpy inputs: every loss (its value and its gradient with respect
to ``preds``, or to ``inputs`` for Rank-N-Contrast) with masks and sample
weights at rtol = 1e-5, atol = 1e-6; every device metric and host metric;
every task transform's ``build``, forward values and JSON record."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from notorch_tpu.tasks import losses as jax_losses
from notorch_tpu.tasks import metrics as jax_metrics
from notorch_tpu.tasks import transforms as jax_transforms
from notorch_tpu_torch.tasks import losses, metrics
from notorch_tpu_torch.tasks import transforms as task_transforms

TOL = dict(rtol=1e-5, atol=1e-6)
B, T, K = 16, 3, 4


def f32(rng, *shape, scale=1.0, shift=0.0):
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


def loss_case(name: str, rng) -> tuple:
    """(port loss, JAX loss, the differentiated array, the other keyword
    arrays) of ``name``, with a mask and sample weights where it takes
    them."""
    mask = rng.random((B, T)) > 0.25
    sw = rng.uniform(0.5, 2.0, B).astype(np.float32)
    binary = (rng.random((B, T)) > 0.5).astype(np.float32)
    classes = rng.integers(0, K, (B, T)).astype(np.float32)
    y = f32(rng, B, T)
    bounds = {"lt_mask": rng.random((B, T)) > 0.6, "gt_mask": rng.random((B, T)) > 0.6}
    spectra = rng.uniform(0.1, 1.0, (B, 8)).astype(np.float32)
    cases = {
        "MSE": (f32(rng, B, T), {"targets": y}),
        "MAE": (f32(rng, B, T), {"targets": y}),
        "BoundedMSE": (f32(rng, B, T), {"targets": y, **bounds}),
        "BoundedMAE": (f32(rng, B, T), {"targets": y, **bounds}),
        "MVE": (np.stack([f32(rng, B, T), rng.uniform(0.1, 2.0, (B, T)).astype(np.float32)], -1),
                {"targets": y}),
        "Evidential": (f32(rng, B, T, 4), {"targets": y}),
        "BCE": (f32(rng, B, T, scale=3.0), {"targets": binary}),
        "CrossEntropy": (f32(rng, B, T, K, scale=2.0), {"targets": classes}),
        "Dirichlet": (f32(rng, B, T, K, scale=2.0), {"targets": classes}),
        "BinaryMCCLoss": (f32(rng, B, T, scale=2.0), {"targets": binary}),
        "MulticlassMCCLoss": (f32(rng, B, T, K, scale=2.0), {"targets": classes}),
        "SID": (spectra, {"targets": spectra[::-1].copy() / spectra.sum(1, keepdims=True)}),
        "Wasserstein": (spectra, {"targets": spectra[::-1].copy() / spectra.sum(1, keepdims=True)}),
    }
    preds, kw = cases[name]
    if name in ("SID", "Wasserstein"):
        kw["mask"] = rng.random((B, 8)) > 0.2
    else:
        kw["mask"] = mask
    kw["sample_weights"] = sw
    return getattr(losses, name)(), getattr(jax_losses, name)(), preds, kw


LOSSES = ["MSE", "MAE", "BoundedMSE", "BoundedMAE", "MVE", "Evidential", "BCE", "CrossEntropy", "Dirichlet",
          "BinaryMCCLoss", "MulticlassMCCLoss", "SID", "Wasserstein"]


def value_and_grad_both(ours, theirs, x: np.ndarray, kw: dict):
    """Each package's value and gradient with respect to ``x``."""
    t = torch.from_numpy(x.copy()).requires_grad_()
    value = ours(t, **{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in kw.items()})
    (grad,) = torch.autograd.grad(value, t)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    jvalue, jgrad = jax.value_and_grad(lambda p: theirs(p, **jkw))(jnp.asarray(x))
    return (value.detach().numpy(), grad.numpy()), (np.asarray(jvalue), np.asarray(jgrad))


@pytest.mark.parametrize("weighted", [True, False], ids=["mask_and_weights", "plain"])
@pytest.mark.parametrize("name", LOSSES)
def test_loss_value_and_gradient_match_jax(name, weighted):
    rng = np.random.default_rng(LOSSES.index(name))
    ours, theirs, preds, kw = loss_case(name, rng)
    if not weighted:
        kw = {k: v for k, v in kw.items() if k not in ("mask", "sample_weights")}
    if name == "MulticlassMCCLoss":  # a hard argmax: no ties among a row's classes
        assert (np.sort(preds, -1)[..., 1:] - np.sort(preds, -1)[..., :-1]).min() > 1e-4
    (value, grad), (jvalue, jgrad) = value_and_grad_both(ours, theirs, preds, kw)
    np.testing.assert_allclose(value, jvalue, **TOL)
    np.testing.assert_allclose(grad, jgrad, **TOL)
    assert np.isfinite(grad).all() and np.abs(grad).max() > 0


def test_mcc_losses_take_task_weights():
    rng = np.random.default_rng(7)
    tw = np.array([0.5, 1.0, 2.0], np.float32)
    for name in ("BinaryMCCLoss", "MulticlassMCCLoss"):
        ours, theirs, preds, kw = loss_case(name, rng)
        kw["task_weights"] = tw
        (value, grad), (jvalue, jgrad) = value_and_grad_both(ours, theirs, preds, kw)
        np.testing.assert_allclose(value, jvalue, **TOL)
        np.testing.assert_allclose(grad, jgrad, **TOL)


@pytest.mark.parametrize("targets_dim", [1, 2])
def test_rank_n_contrast_matches_jax_in_inputs(targets_dim):
    """Value and gradient with respect to the embeddings."""
    rng = np.random.default_rng(11)
    x, y = f32(rng, 12, 8), f32(rng, 12, targets_dim)
    (value, grad), (jvalue, jgrad) = value_and_grad_both(losses.RankNContrastLoss(), jax_losses.RankNContrastLoss(),
                                                         x, {"targets": y})
    np.testing.assert_allclose(value, jvalue, **TOL)
    np.testing.assert_allclose(grad, jgrad, **TOL)
    other = losses.RankNContrastLoss(distance=losses.PNorm(p=3.0), temp=0.5)
    jother = jax_losses.RankNContrastLoss(distance=jax_losses.PNorm(p=3.0), temp=0.5)
    (value, grad), (jvalue, jgrad) = value_and_grad_both(other, jother, x, {"targets": y})
    np.testing.assert_allclose(value, jvalue, **TOL)
    np.testing.assert_allclose(grad, jgrad, **TOL)


def test_self_supervised_loss_passes_its_scalar_through():
    assert float(losses.SelfSupervisedLoss()(torch.tensor([2.5]))) == float(
        jax_losses.SelfSupervisedLoss()(jnp.asarray([2.5])))


def test_aliases_name_the_same_classes_as_jax():
    for alias, cls in (("MVE", "MeanVarianceEstimation"), ("BCE", "BinaryCrossEntropy"), ("XENT", "CrossEntropy")):
        assert getattr(losses, alias) is getattr(losses, cls)
        assert getattr(jax_losses, alias) is getattr(jax_losses, cls)


# -- metrics ------------------------------------------------------------------

DEVICE_METRICS = ["MAE", "RMSE", "BoundedMAE", "BoundedRMSE", "R2", "Accuracy", "AccuracyMulticlass"]


@pytest.mark.parametrize("name", DEVICE_METRICS)
def test_device_metric_matches_jax(name):
    rng = np.random.default_rng(DEVICE_METRICS.index(name) + 20)
    kw = {"mask": rng.random((B, T)) > 0.25, "sample_weights": rng.uniform(0.5, 2.0, B).astype(np.float32)}
    preds, targets = f32(rng, B, T), f32(rng, B, T)
    if name.startswith("Bounded"):
        kw.update(lt_mask=rng.random((B, T)) > 0.6, gt_mask=rng.random((B, T)) > 0.6)
    if name == "Accuracy":
        preds, targets = rng.random((B, T)).astype(np.float32), (rng.random((B, T)) > 0.5).astype(np.float32)
    ours, theirs = (getattr(m, name)() for m in (metrics, jax_metrics)) if name != "AccuracyMulticlass" else (
        metrics.Accuracy(task="multiclass"), jax_metrics.Accuracy(task="multiclass"))
    if name == "AccuracyMulticlass":
        preds, targets = f32(rng, B, T, K), rng.integers(0, K, (B, T)).astype(np.float32)
    for args in (kw, {k: v for k, v in kw.items() if k not in ("mask", "sample_weights")}):
        got = ours(torch.from_numpy(preds), torch.from_numpy(targets),
                   **{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in args.items()})
        ref = theirs(jnp.asarray(preds), jnp.asarray(targets), **{k: jnp.asarray(v) for k, v in args.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def host_cases(rng):
    """Scores with ties, a column with one class only, a column wholly
    masked, NaN targets (masked by default) and 1-D inputs."""
    n = 40
    scores = np.round(rng.random((n, 5)), 1)  # ties
    labels = (rng.random((n, 5)) > 0.5).astype(np.float64)
    labels[:, 2] = 1.0
    mask = rng.random((n, 5)) > 0.2
    mask[:, 3] = False
    nan_labels = labels.copy()
    nan_labels[rng.random((n, 5)) > 0.7] = np.nan
    return [dict(preds=scores, targets=labels, mask=mask), dict(preds=scores, targets=nan_labels),
            dict(preds=scores[:, 0], targets=labels[:, 0]),
            dict(preds=scores[:, 0], targets=labels[:, 0], mask=mask[:, 0])]


@pytest.mark.parametrize("name", ["auroc", "auprc", "f1_score"])
def test_host_metric_functions_match_jax(name):
    rng = np.random.default_rng(3)
    for case in host_cases(rng):
        got, ref = getattr(metrics, name)(**case), getattr(jax_metrics, name)(**case)
        assert (np.isnan(got) and np.isnan(ref)) or got == ref, (case, got, ref)
    if name == "f1_score":
        case = host_cases(rng)[0]
        assert metrics.f1_score(**case, threshold=0.3) == jax_metrics.f1_score(**case, threshold=0.3)


@pytest.mark.parametrize("name", ["AUROC", "AUPRC", "F1"])
def test_host_metric_classes_match_jax(name):
    rng = np.random.default_rng(4)
    case = host_cases(rng)[0]
    assert getattr(metrics, name)()(**case) == getattr(jax_metrics, name)()(**case)
    empty = dict(preds=np.zeros((3, 2)), targets=np.zeros((3, 2)), mask=np.zeros((3, 2), bool))
    assert np.isnan(getattr(metrics, name)()(**empty)) and np.isnan(getattr(jax_metrics, name)()(**empty))


# -- task transforms ----------------------------------------------------------

HEAD = {"regression": (), "classification": (), "multiclass": (K,), "mve": (2,), "evidential": (4,),
        "dirichlet": (K,)}


@pytest.mark.parametrize("task", list(HEAD))
def test_task_transforms_build_apply_and_serialize_as_jax(task):
    """``build`` on training targets with NaNs gives the same transforms;
    each side's JSON record is JAX's byte for byte and reads back in both
    packages; the forward values agree on the head's shape."""
    rng = np.random.default_rng(5)
    values = f32(rng, 20, T, scale=2.0, shift=1.0)
    values[rng.random(values.shape) > 0.8] = np.nan
    values[:, 2] = 3.0  # a constant column: std 1
    ours, ref = task_transforms.build(task, values), jax_transforms.build(task, values)
    x = f32(rng, 6, T, *HEAD[task])
    for side in ("preds", "targets"):
        rec = task_transforms.serialize(ours[side])
        assert json.dumps(rec) == json.dumps(jax_transforms.serialize(ref[side]))
        if ours[side] is None:
            assert ref[side] is None
            continue
        assert type(ours[side]).__name__ == type(ref[side]).__name__
        back = task_transforms.deserialize(json.loads(json.dumps(rec)))
        assert back == ours[side]
        assert jax_transforms.deserialize(rec) == ref[side]
        arg = x if side == "preds" else f32(rng, 6, T)
        np.testing.assert_allclose(back(torch.from_numpy(arg)).numpy(), np.asarray(ref[side](jnp.asarray(arg))),
                                   **TOL)


def test_build_without_a_task_and_with_an_unknown_one():
    assert task_transforms.build(None, np.zeros((2, 1))) == {"preds": None, "targets": None}
    with pytest.raises(ValueError, match="invalid task type"):
        task_transforms.build("ranking", np.zeros((2, 1)))
    with pytest.raises(TypeError, match="cannot serialize"):
        task_transforms.serialize(lambda x: x)
    with pytest.raises(ValueError, match="unknown task transform"):
        task_transforms.deserialize({"kind": "Tanh"})
