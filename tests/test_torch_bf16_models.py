"""Model-wide ``dtype: bfloat16`` for the D-MPNN and attention families,
port against the JAX package on the CPU, from the same carried weights
(which are float32 at every dtype in both packages).

- ``build_dmpnn(dtype="bfloat16")`` (``layout: auto`` resolves to the plain
  ``dense`` layout in both; and on ``flat``, the gather block and the
  ``impl: csr`` block on packed batches, whose every E->V sum is TPU kernel
  row 9b, the JAX side in interpret mode), the GAT recipe (``build_gat`` GATv2 on the
  auto ``dense_packed`` layout, and on ``flat``), the graph-transformer
  recipe (``build_gat`` sdp, the einsum core: ``impl: auto`` picks ``jnp``
  below f32), and the declarative graph transformer on the kernel path
  (``DenseGATBlock(impl: fused, fwd_impl: pallas, dtype: bfloat16)``: TPU
  kernel rows 12b and 13b with bf16 inputs, the JAX side in interpret
  mode): predictions over every batch, then one train step's loss and
  every parameter gradient.
- The converters carry the JAX parameters into the bf16 models unchanged
  (f32 both ways).

Tolerances. Both sides round at the same points (flax's ``Dense``: the
product, then the bias add; the bf16 segment sums and the gathers' VJPs in
order, rounding each add), and the two sum the products of a dot in other
orders, so a value near a bf16 rounding boundary can land on the other
side. Measured over these models (hidden 16, depth 2, 96 lipo molecules,
at 1 and 8 threads alike): predictions within 1.01e-7 of the largest and
the first step's loss within 3.6e-7 (no rounding flipped); a bf16 flip
ahead of the head moves a prediction by up to one bf16 ulp (2^-8
relative), so both are held at PRED_RTOL = 4e-3, under the 1.7e-2 to
3.9e-2 by which a port weight scaled by 1.03 moves them
(``test_a_scaled_weight_fails_the_gate``). Weight gradients agree within
8.9e-3 of each tensor's largest magnitude (GATv2's score weights), held at
GRAD_RTOL = 3e-2. The gradients summed over every row (SUMMED) are held at
the scale of the model's largest gradient: JAX forms a bias's as the VJP of
a broadcast add, an XLA reduce with a bf16 accumulator over every row,
whose order on the CPU is neither sequential, pairwise nor k-way (probed),
while the port sums in f32 and rounds once; an embedding table's is a chain
of bf16 adds in both packages, and a flip upstream changes every later
rounding. They differ by up to 6.95e-2 of that scale (the D-MPNN block's
stacked bias, summed over 3,072 edge lanes), held at BIAS_GRAD_RTOL = 2e-1.
"""

import jax
import numpy as np
import pytest
import torch

from notorch_tpu.cli.train import build_model as jax_build_model
from notorch_tpu.data.batching import DataLoader as JaxDataLoader
from notorch_tpu.models import gat as jax_gat
from notorch_tpu.models.dmpnn import build_dmpnn as jax_build_dmpnn
from notorch_tpu.training.loop import predict as jax_predict
from notorch_tpu_torch.cli.train import build_model
from notorch_tpu_torch.data.batching import DataLoader
from notorch_tpu_torch.model.convert import params_from_jax, params_to_jax
from notorch_tpu_torch.models import gat
from notorch_tpu_torch.models.dmpnn import build_dmpnn
from notorch_tpu_torch.training.loop import predict, to_device

from .test_torch_gat import BATCH, D, H, declarative_attention_cfg, datasets, lipo_csv  # noqa: F401 (fixtures)

BF16 = "bfloat16"
PRED_RTOL, GRAD_RTOL, BIAS_GRAD_RTOL = 4e-3, 3e-2, 2e-1
# the gradients summed over every row of a batch, held at the model's
# gradient scale: the biases, and the embedding tables (in both packages a
# chain of bf16 adds over every slot of a type, where a flipped term
# upstream changes the rounding of every later add)
SUMMED = ("bias", "embedding.weight")


def declarative_bf16_cfg():
    cfg = declarative_attention_cfg()
    for name in ("embed", "mp", "ffn"):
        cfg["modules"][name]["args"]["dtype"] = BF16
    return cfg


def models(kind, ds, jds):
    """(JAX model, port model, loader kwargs) of a bf16 model kind, each
    with its package's task transforms."""
    transforms, port_transforms = jds.build_task_transform_configs(), ds.build_task_transform_configs()
    if kind in ("dmpnn", "dmpnn_flat", "dmpnn_csr"):
        layout = "auto" if kind == "dmpnn" else "flat"
        csr = kind == "dmpnn_csr"
        kw = dict(hidden_dim=D, depth=2, dtype=BF16, layout=layout, impl="csr" if csr else "gather")
        return (jax_build_dmpnn(transforms=transforms, **kw), build_dmpnn(transforms=port_transforms, **kw),
                {"layout": "dense" if kind == "dmpnn" else "flat", "csr_pack": csr})
    if kind == "declarative":
        cfg = declarative_bf16_cfg()
        return (jax_build_model(cfg, transforms, None), build_model(cfg, port_transforms), {"layout": "dense"})
    attention, layout = {"gat": ("gatv2", "dense_packed"), "gat_flat": ("gatv2", "flat"),
                         "transformer": ("sdp", "dense_packed")}[kind]
    kw = dict(hidden_dim=D, depth=2, num_heads=H, attention=attention, layout=layout, dtype=BF16)
    return (jax_gat.build_gat(transforms=transforms, **kw), gat.build_gat(transforms=port_transforms, **kw),
            {"layout": layout, **gat.gat_loader_kwargs(layout)})


def drift(kind, ds, jds, scale=None):
    """(prediction drift relative to the largest prediction, {name: gradient
    drift relative to the tensor's largest magnitude}, loss drift) of a
    model kind, port against JAX from JAX's initial weights; ``scale``
    multiplies the port's first weight matrix before the comparison."""
    jmodel, model, data = models(kind, ds, jds)
    jbatches = list(JaxDataLoader(jds, batch_size=BATCH, **data))
    batches = list(DataLoader(ds, batch_size=BATCH, **data))
    params = jmodel.init(jax.random.PRNGKey(0), jbatches[0]).params
    model.network.load_state_dict(params_from_jax(jax.device_get(params)))
    if scale is not None:
        with torch.no_grad():
            next(p for p in model.network.parameters() if p.dim() == 2).mul_(scale)
    preds = predict(model, batches, keys=["ffn.preds"])["ffn.preds"]
    ref = np.asarray(jax_predict(jmodel, params, jbatches, keys=["ffn.preds"])["ffn.preds"], np.float32)
    pred_drift = float(np.abs(preds - ref).max() / np.abs(ref).max())

    def loss_fn(params):
        out = jmodel.network.apply({"params": params}, dict(jbatches[0]), training=True,
                                   rngs={"dropout": jax.random.PRNGKey(1)})
        terms = jmodel._loss_terms(jmodel._apply_transforms(out, "targets"))
        return sum(jmodel.train_loss_weights[k] * v for k, v in terms.items())

    loss, grads = jax.value_and_grad(loss_fn)(params)
    logs = model.train_step(to_device(batches[0], "cpu"))
    ref_grads = params_from_jax(jax.device_get(grads))
    got = {name: p.grad for name, p in model.network.named_parameters()}
    assert sorted(got) == sorted(ref_grads)
    scale_all = max(float(r.abs().max()) for r in ref_grads.values())
    grad_drift = {name: float((got[name] - r).abs().max()) / (scale_all if name.endswith(SUMMED) else
                                                               float(r.abs().max()))
                  for name, r in ref_grads.items()}
    return pred_drift, grad_drift, abs(float(logs["train/loss"]) - float(loss)) / abs(float(loss))


KINDS = ["dmpnn", "dmpnn_flat", "dmpnn_csr", "gat", "gat_flat", "transformer", "declarative"]


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_model_matches_jax(datasets, kind):  # noqa: F811
    """Predictions over every batch, the first train step's loss and every
    parameter gradient, port against JAX from JAX's initial weights."""
    ds, jds = datasets
    pred, grads, loss = drift(kind, ds, jds)
    assert pred <= PRED_RTOL and loss <= PRED_RTOL, (pred, loss)
    for name, err in grads.items():
        assert err <= (BIAS_GRAD_RTOL if name.endswith(SUMMED) else GRAD_RTOL), (name, err)


@pytest.mark.parametrize("kind", ["declarative", "dmpnn_csr"])
def test_a_scaled_weight_fails_the_gate(datasets, kind):  # noqa: F811
    """The port's first weight matrix scaled by 1.03 moves the predictions
    past PRED_RTOL: the gate catches a fault of a few percent."""
    ds, jds = datasets
    assert drift(kind, ds, jds, scale=1.03)[0] > PRED_RTOL


@pytest.mark.parametrize("kind", ["dmpnn", "declarative"])
def test_the_converters_carry_bf16_models_unchanged(datasets, kind):  # noqa: F811
    """A bf16 model's parameters are float32 in both packages:
    ``params_from_jax`` carries JAX's tree into the port unchanged, and
    ``params_to_jax`` gives it back with JAX's structure, dtypes and bits."""
    ds, jds = datasets
    jmodel, model, data = models(kind, ds, jds)
    params = jmodel.init(jax.random.PRNGKey(0), next(iter(JaxDataLoader(jds, batch_size=BATCH, **data)))).params
    model.network.load_state_dict(params_from_jax(jax.device_get(params)))
    assert all(p.dtype == torch.float32 for p in model.network.parameters())
    back = params_to_jax(model.network.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(jax.device_get(params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax.device_get(params))):
        assert a.dtype == np.float32 and b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
