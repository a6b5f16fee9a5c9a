"""The port's Mixture-of-Experts against the JAX package's on the CPU:

- the helpers (``cv_squared``, ``kth_excluding``, ``keep_top_k``) on inputs
  with ties, equal: a tie at the k-th value keeps every entry ``>=`` it;
- both routers and ``MixtureOfExperts`` on JAX's weights (``params_from_jax``
  maps the ``experts`` subtree with its leading axis, and ``W_g`` and
  ``W_noise``): in eval, and in training with the same noise ``eps`` given
  to both sides (``jax.random.normal`` patched in JAX, ``draw_noise`` in the
  port; the two generators cannot agree), outputs, aux loss and gradients;
- one train step of ``configs/moe_regression.yaml``'s model at hidden 32 on
  a flat lipo batch, the same noise on both sides: loss and every gradient;
- the sparse router's noise is a pure function of its generator, which the
  training state carries: a run killed and resumed ends with the
  uninterrupted run's bits.

Tolerance: rtol = atol = 1e-4; gradients at 1e-4 times the tensor's largest
magnitude.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from notorch_tpu.cli.train import build_dataset as jax_build_dataset
from notorch_tpu.cli.train import build_model as jax_build_model
from notorch_tpu.data.batching import DataLoader as JaxDataLoader
from notorch_tpu.nn import moe as jax_moe
from notorch_tpu_torch.cli.train import build_dataset, build_model, load_config, run
from notorch_tpu_torch.data.batching import DataLoader
from notorch_tpu_torch.model.convert import params_from_jax, params_to_jax
from notorch_tpu_torch.nn import moe
from notorch_tpu_torch.training.loop import to_device
from tests.test_torch_glue import close_grad

TOL = dict(rtol=1e-4, atol=1e-4)
TIES = np.array([[1.0, 3.0, 3.0, 2.0, 0.5], [5.0, 5.0, 5.0, 1.0, 5.0], [0.0, 1.0, 2.0, 3.0, 4.0],
                 [2.0, 2.0, 2.0, 2.0, 2.0], [-1.0, 7.0, -1.0, -1.0, 7.0]], dtype=np.float32)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_helpers_keep_ties_as_jax_does(k):
    np.testing.assert_array_equal(moe.keep_top_k(torch.tensor(TIES), k).numpy(),
                                  np.asarray(jax_moe.keep_top_k(jnp.asarray(TIES), k)))
    np.testing.assert_array_equal(moe.kth_excluding(torch.tensor(TIES), k).numpy(),
                                  np.asarray(jax_moe.kth_excluding(jnp.asarray(TIES), k)))
    # every entry tied at the k-th value stays
    kept = np.isfinite(moe.keep_top_k(torch.tensor(TIES), k).numpy()).sum(axis=1)
    assert (kept >= k).all() and kept[3] == 5
    for x in (TIES.sum(axis=0), TIES[0], np.ones(1, np.float32)):
        np.testing.assert_allclose(float(moe.cv_squared(torch.tensor(x))), float(jax_moe.cv_squared(jnp.asarray(x))),
                                   **TOL)


def moe_pair(router_kind: str, rng, d: int = 8, hidden: int = 16, experts: int = 4, k: int = 2):
    """A JAX MoEMLP and the port's on its weights, and an input."""
    x = rng.standard_normal((12, d)).astype(np.float32)
    jm = jax_moe.MoEMLP(input_dim=d, output_size=3, hidden_dim=hidden, num_experts=experts,
                        router_kind=router_kind, k=k)
    params = jax.device_get(jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                                    jnp.asarray(x), training=True)["params"])
    m = moe.MoEMLP(input_dim=d, output_size=3, hidden_dim=hidden, num_experts=experts, router_kind=router_kind, k=k)
    sd = {key.removeprefix("f."): v for key, v in params_from_jax({"modules__f": params}).items()}
    m.load_state_dict(sd)
    assert sd["experts.dense_0.weight"].shape == (experts, hidden, d)
    assert params_to_jax({f"f.{key}": v for key, v in m.state_dict().items()})["modules__f"].keys() == params.keys()
    return jm, params, m, x


@pytest.mark.parametrize("router_kind", ["dense", "sparse"])
@pytest.mark.parametrize("training", [False, True])
def test_mixture_of_experts_matches_jax(router_kind, training, monkeypatch):
    """Routing weights' effect (the output), the aux loss and the
    gradients of every parameter and of the input."""
    rng = np.random.default_rng(3)
    jm, params, m, x = moe_pair(router_kind, rng)
    eps = rng.standard_normal((12, 4)).astype(np.float32)
    cot = rng.standard_normal((12, 3)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(eps, dtype))

    def loss(p, xin):
        out, aux = jm.apply({"params": p}, xin, training=training, rngs={"dropout": jax.random.PRNGKey(2)})
        return (out * cot).sum() + aux, (out, aux)

    (_, (ref, ref_aux)), (g_p, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    if router_kind == "sparse":
        m.sparse_router.draw_noise = lambda like: torch.tensor(eps)
    m.train(training)
    t = torch.tensor(x, requires_grad=True)
    out, aux = m(t)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(ref_aux), **TOL)
    ((out * torch.tensor(cot)).sum() + aux).backward()
    close_grad(t.grad, g_x, "input")
    grads = {key.removeprefix("f."): v for key, v in params_from_jax({"modules__f": g_p}).items()}
    for name, p in m.named_parameters():
        close_grad(p.grad, grads[name].numpy(), name)


def test_sparse_router_noise_comes_from_its_generator():
    """Training draws the noise from the router's generator on the CPU (the
    same numbers on any device), eval draws none; reset_parameters seeds it
    from the parameter generator."""
    a, b = (moe.SparseRouter(8, 4) for _ in range(2))
    for r in (a, b):
        r.reset_parameters(torch.Generator().manual_seed(5))
    x = torch.randn(6, 8)
    assert torch.equal(a.draw_noise(x), b.draw_noise(x))
    assert not torch.equal(a.draw_noise(x), a.draw_noise(x))
    state = b.generator.get_state()
    a.train(), b.train()
    w1, _ = b(x)
    b.generator.set_state(state)
    assert torch.equal(b(x)[0], w1)
    b.eval()
    before = b.generator.get_state()
    b(x)
    assert torch.equal(b.generator.get_state(), before)


def moe_cfg(d: int = 32) -> dict:
    """configs/moe_regression.yaml's model at hidden ``d``."""
    cfg = copy.deepcopy(load_config(chip_smoke.ROOT / "configs" / "moe_regression.yaml")["model"])
    m = cfg["modules"]
    m["embed"]["args"]["hidden_dim"] = m["mp"]["args"]["hidden_dim"] = d
    m["ffn"]["args"].update(input_dim=d, hidden_dim=d)
    return cfg


def test_moe_config_train_step_matches_jax(tmp_path, monkeypatch):
    """One step of the shipped MoE config's model at hidden 32 on JAX's
    weights: the loss terms and every gradient, the same noise on both
    sides."""
    csv_path = chip_smoke.lipo_csv(tmp_path, 64)
    ds = build_dataset({"csv": str(csv_path), "targets": {"y": {"columns": ["lipo"]}}})
    jds = jax_build_dataset({"csv": str(csv_path), "targets": {"y": {"columns": ["lipo"]}}})
    batch = next(iter(DataLoader(ds, batch_size=64, layout="flat")))
    jbatch = next(iter(JaxDataLoader(jds, batch_size=64, layout="flat")))
    cfg = moe_cfg()
    jmodel = jax_build_model(cfg, jds.build_task_transform_configs(), optax.adam(1e-3))
    model = build_model(cfg, ds.build_task_transform_configs())
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jbatch).params)
    model.network.load_state_dict(params_from_jax(params))
    eps = np.random.default_rng(4).standard_normal((64, 4)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(eps, dtype))
    model.network["ffn"].sparse_router.draw_noise = lambda like: torch.tensor(eps)

    def loss_fn(p):
        out = jmodel.network.apply({"params": p}, dict(jbatch), training=True, rngs={"dropout": jax.random.PRNGKey(2)})
        terms = jmodel._loss_terms(jmodel._apply_transforms(out, "targets"))
        return sum(jmodel.train_loss_weights[k] * v for k, v in terms.items())

    loss, grads = jax.value_and_grad(loss_fn)(params)
    ref = params_from_jax(jax.device_get(grads))
    logs = model.train_step(to_device(batch, "cpu"))
    np.testing.assert_allclose(float(logs["train/loss"]), loss, **TOL)
    assert set(logs) == {"train/mse", "train/aux", "train/loss"}
    for name, p in model.network.named_parameters():
        close_grad(p.grad, ref[name].numpy(), name)


def test_moe_run_resumes_to_the_same_bits(tmp_path):
    """The MoE config at hidden 16 for 2 epochs, and the same run killed
    after its first epoch and resumed: the same parameters, bit for bit
    (the router's noise generator rides in the training state)."""
    csv_path = chip_smoke.lipo_csv(tmp_path, 96)

    def cfg(ckpt, epochs, resume=False):
        c = load_config(chip_smoke.ROOT / "configs" / "moe_regression.yaml")
        c["model"] = moe_cfg(16)
        c["data"]["csv"] = str(csv_path)
        c["trainer"].update(epochs=epochs, batch_size=32, checkpoint_dir=str(ckpt), resume=resume)
        return c

    whole = run(cfg(tmp_path / "whole", 2), device="cpu")
    run(cfg(tmp_path / "cut", 1), device="cpu")
    resumed = run(cfg(tmp_path / "cut", 2, resume=True), device="cpu")
    assert len(resumed["history"]) == 1
    a = torch.load(sorted((tmp_path / "whole").glob("state_*.pt"))[-1], weights_only=True)
    b = torch.load(sorted((tmp_path / "cut").glob("state_*.pt"))[-1], weights_only=True)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert whole["history"][-1]["train/loss"] == resumed["history"][-1]["train/loss"]
