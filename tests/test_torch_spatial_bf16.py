"""The spatial stacks at ``dtype: bfloat16`` (ROADMAP item 5c), port against
the JAX package on the CPU, from the same carried weights (float32 in both
packages at every dtype).

- The declarative SchNet and GVP models (``chip_smoke.
  declarative_spatial_bf16_cfg``: ``PointwiseEmbed`` -> ``SchnetBlock`` or
  ``GvpGNNBlock(impl: auto)`` -> ``SpatialGated`` -> ``MLP``, every module
  at bf16): predictions over every batch, then one train step's loss and
  every parameter gradient.
- PaiNN's gated equivariant block at bf16: outputs and gradients.
- ``GvpConv(impl: fused)`` at bf16 raises ``ValueError`` in both packages:
  the fused conv (TPU kernel rows 14-15) is f32 only.
- A SchNet run of a few Adam steps in each package stays in lockstep.

Tolerances are the bf16 model gates (``tests/test_torch_bf16_models.
py``, PERF.md section 2): predictions and losses at PRED_RTOL = 4e-3 of the
largest, weight gradients at GRAD_RTOL = 3e-2 of each tensor's largest, the
gradients summed over every row (biases, embedding tables) at
BIAS_GRAD_RTOL = 2e-1 of the model's largest. Both packages round where
flax's ``Dense`` rounds and sum the products of a dot in other orders, so a
value near a bf16 rounding boundary can land on the other side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from notorch_tpu.cli.train import build_model as jax_build_model
from notorch_tpu.nn.spatial import gvp as jax_gvp
from notorch_tpu.nn.spatial import painn as jax_painn
from notorch_tpu.training.loop import predict as jax_predict
from notorch_tpu_torch.cli.train import build_model
from notorch_tpu_torch.data.point_cloud import cloud_batches, coordination_targets, make_clouds
from notorch_tpu_torch.model.convert import params_from_jax
from notorch_tpu_torch.nn.spatial.gvp import GvpConv
from notorch_tpu_torch.nn.spatial.painn import GatedEquivariantBlock
from notorch_tpu_torch.training.loop import predict, to_device
from notorch_tpu_torch.training.optim import OptimizerSpec

from .test_torch_schnet import clouds_with_feats, module_weights
from .test_torch_spatial import jax_batch

BF16 = "bfloat16"
PRED_RTOL, GRAD_RTOL, BIAS_GRAD_RTOL = 4e-3, 3e-2, 2e-1
# predictions against JAX's jitted predict, whose fusions keep excess f32
# precision through bf16 roundings
JIT_PRED_RTOL = 1e-1
SUMMED = ("bias", "embedding.weight")
D, DV, DEPTH, BATCH = 16, 4, 2, 8
LR, STEPS = 1e-3, 4
# the per-step loss of the few-step SchNet run, port against JAX
LOCKSTEP_RTOL = 4e-3


@pytest.fixture(scope="module")
def batches():
    clouds = make_clouds(16, seed=0)
    return cloud_batches(clouds, coordination_targets(clouds), batch_size=BATCH)


def models(backbone):
    cfg = chip_smoke.declarative_spatial_bf16_cfg(backbone, d=D, dv=DV, depth=DEPTH)
    return (jax_build_model(cfg, None, optax.adam(LR)),
            build_model(cfg, None, generator=torch.Generator().manual_seed(0), optimizer=OptimizerSpec("adam", LR)))


def init_params(jmodel, batch, seed: int) -> dict:
    """The JAX model's initial parameters (float32), its init jitted."""
    variables = jax.jit(lambda key: jmodel.network.init(key, dict(batch), training=False))(jax.random.PRNGKey(seed))
    return jax.device_get(variables["params"])


def jax_loss_fn(jmodel, batch):
    def loss(params):
        out = jmodel.network.apply({"params": params}, dict(batch), training=True)
        terms = jmodel._loss_terms(jmodel._apply_transforms(out, "targets"))
        return sum(jmodel.train_loss_weights[k] * v for k, v in terms.items())

    return loss


@pytest.mark.parametrize("backbone", ["schnet", "gvp"])
def test_bf16_spatial_model_matches_jax(batches, backbone):
    jmodel, model = models(backbone)
    assert model.network["backbone"].__class__.__name__ == ("SchnetBlock" if backbone == "schnet" else "GvpGNNBlock")
    jbatches = [jax_batch(b) for b in batches]
    params = init_params(jmodel, jbatches[0], 0)
    model.network.load_state_dict(params_from_jax(params))
    preds = predict(model, batches, keys=["ffn.preds"])["ffn.preds"]
    # JAX op by op: under jit XLA keeps f32 values through the bf16 roundings
    # of a fusion (excess precision), so its predictions sit further off
    ref = np.concatenate([np.asarray(jmodel.network.apply({"params": params}, dict(b))["ffn.preds"], np.float32)
                          for b in jbatches])
    np.testing.assert_allclose(preds, ref, rtol=PRED_RTOL, atol=PRED_RTOL * float(np.abs(ref).max()))
    jit_ref = np.asarray(jax_predict(jmodel, params, jbatches, keys=["ffn.preds"])["ffn.preds"], np.float32)
    np.testing.assert_allclose(preds, jit_ref, rtol=0, atol=JIT_PRED_RTOL * float(np.abs(jit_ref).max()))

    loss, grads = jax.value_and_grad(jax_loss_fn(jmodel, jbatches[0]))(params)  # op by op: no excess precision
    logs = model.train_step(to_device(batches[0], "cpu"))
    np.testing.assert_allclose(float(logs["train/loss"]), float(loss), rtol=PRED_RTOL)
    ref_grads = params_from_jax(jax.device_get(grads))
    got = {name: p.grad for name, p in model.network.named_parameters()}
    assert sorted(got) == sorted(ref_grads)
    scale = max(float(r.abs().max()) for r in ref_grads.values())
    for name, r in ref_grads.items():
        g = torch.zeros_like(r) if got[name] is None else got[name]
        summed = name.endswith(SUMMED)
        atol = (BIAS_GRAD_RTOL * scale) if summed else GRAD_RTOL * float(r.abs().max())
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=atol, err_msg=name)


def test_bf16_gated_equivariant_block_matches_jax():
    P, jP, feats = clouds_with_feats(d=D)
    rng = np.random.default_rng(5)
    v = rng.standard_normal((len(feats), 3, DV)).astype(np.float32)
    jmod = jax_painn.GatedEquivariantBlock(D, DV, dtype=jnp.bfloat16)
    mod = GatedEquivariantBlock(D, DV, dtype=BF16)
    variables = jmod.init(jax.random.PRNGKey(2), (jnp.asarray(feats), jnp.asarray(v)))
    mod.load_state_dict(module_weights(variables))
    gs = rng.standard_normal((len(feats), D)).astype(np.float32)
    gv = rng.standard_normal((len(feats), 3, DV)).astype(np.float32)

    def jax_loss(params, s, vv):
        s_out, v_out = jmod.apply({"params": params}, (s, vv))
        return (s_out.astype(jnp.float32) * gs).sum() + (v_out.astype(jnp.float32) * gv).sum()

    jouts = jmod.apply(variables, (jnp.asarray(feats), jnp.asarray(v)))
    jg = jax.grad(jax_loss, argnums=(0, 1, 2))(variables["params"], jnp.asarray(feats), jnp.asarray(v))
    s, vt = torch.from_numpy(feats).requires_grad_(True), torch.from_numpy(v).requires_grad_(True)
    s_out, v_out = mod((s, vt))
    assert s_out.dtype == v_out.dtype == torch.bfloat16 and jouts[0].dtype == jnp.bfloat16
    ((s_out.float() * torch.from_numpy(gs)).sum() + (v_out.float() * torch.from_numpy(gv)).sum()).backward()
    for got, ref in ((s_out, jouts[0]), (v_out, jouts[1])):
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=0, atol=PRED_RTOL * np.abs(ref).max())
    for got, ref in ((s.grad, jg[1]), (vt.grad, jg[2])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=GRAD_RTOL * np.abs(ref).max())
    for name, ref in module_weights({"params": jg[0]}).items():
        got = dict(mod.named_parameters())[name].grad
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=GRAD_RTOL * float(ref.abs().max()),
                                   err_msg=name)


def test_fused_gvp_conv_at_bf16_raises_as_in_jax(batches):
    """The fused conv is f32 only: at bf16 both packages raise ValueError
    when the conv runs, naming f32; ``impl: auto`` builds at bf16."""
    P = batches[0]["inputs.P"].to("cpu")
    N = P.coords.shape[0]
    s, v = torch.zeros(N, D), torch.zeros(N, 3, DV)
    conv = GvpConv(D, DV, neighbor_window=24, dtype=BF16, impl="fused")
    with pytest.raises(ValueError, match="f32"):
        conv((s, v), P)
    jP = jax_batch(batches[0])["inputs.P"]
    jconv = jax_gvp.GvpConv(D, DV, neighbor_window=24, dtype=jnp.bfloat16, impl="fused")
    with pytest.raises(ValueError, match="f32"):
        jconv.init(jax.random.PRNGKey(0), (jnp.zeros((N, D)), jnp.zeros((N, 3, DV))), jP)
    assert GvpConv(D, DV, dtype=BF16).dtype == torch.bfloat16


def test_bf16_schnet_steps_stay_in_lockstep(batches):
    """STEPS Adam steps in each package from the same weights, each on its
    own: every step's loss agrees within LOCKSTEP_RTOL."""
    jmodel, model = models("schnet")
    jbatches = [jax_batch(b) for b in batches]
    state = jmodel.init(jax.random.PRNGKey(1), jbatches[0])
    model.network.load_state_dict(params_from_jax(jax.device_get(state.params)))
    for step in range(STEPS):
        state, jlogs = jmodel.train_step(state, jbatches[step % len(jbatches)])
        logs = model.train_step(to_device(batches[step % len(batches)], "cpu"))
        np.testing.assert_allclose(float(logs["train/loss"]), float(jlogs["train/loss"]), rtol=LOCKSTEP_RTOL,
                                   err_msg=f"step {step}")
