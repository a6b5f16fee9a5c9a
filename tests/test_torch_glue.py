"""The port's glue modules, ``MIP`` and ``BatchNorm`` against the JAX
package's on the CPU: each op's output and its inputs' gradients from the
same seeded numpy inputs (rtol = atol = 1e-4; gradients at 1e-4 times the
tensor's largest magnitude), and ``BatchNorm`` over three training steps and
then in eval mode against flax (outputs, gradients and the running
statistics, on rows where the last ones are padded molecules' zeros), with
the statistics carried both ways by ``params_from_jax`` and
``batch_stats_to_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from notorch_tpu.nn import glue as jax_glue
from notorch_tpu.nn.functional import MIP as jax_MIP
from notorch_tpu.nn.mlp import MLP as JaxMLP
from notorch_tpu_torch.model.convert import batch_stats_to_jax, params_from_jax
from notorch_tpu_torch.nn import glue
from notorch_tpu_torch.nn.functional import MIP, multilinear_inner_product
from notorch_tpu_torch.nn.mlp import MLP

TOL = dict(rtol=1e-4, atol=1e-4)


def close_grad(got: torch.Tensor, ref, name: str) -> None:
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()),
                               err_msg=name)


def ops(rng):
    """name -> (JAX module and variables, port module, input shapes)."""
    x = rng.standard_normal((6, 8)).astype(np.float32)
    jmlp = jax_glue.Residual(module=JaxMLP(input_dim=8, output_size=8, hidden_dim=4))
    variables = jmlp.init(jax.random.PRNGKey(0), jnp.asarray(x))
    res = glue.Residual(MLP(input_dim=8, output_size=8, hidden_dim=4))
    res.load_state_dict({k.removeprefix("r."): v for k, v in params_from_jax({"modules__r": variables["params"]}).items()})
    return {
        "Add": (jax_glue.Add(), {}, glue.Add(), [(6, 8)] * 3),
        "Mul": (jax_glue.Mul(), {}, glue.Mul(), [(6, 8)] * 3),
        "Cat": (jax_glue.Cat(axis=-1), {}, glue.Cat(axis=-1), [(6, 8), (6, 3), (6, 5)]),
        "Split": (jax_glue.Split(sizes=(2, 5, 1)), {}, glue.Split(sizes=(2, 5, 1)), [(6, 8)]),
        "MatMul": (jax_glue.MatMul(), {}, glue.MatMul(), [(6, 8), (8, 3)]),
        "Einsum": (jax_glue.Einsum(equation="bi,bj->ij"), {}, glue.Einsum(equation="bi,bj->ij"), [(6, 8), (6, 3)]),
        "Identity": (jax_glue.Identity(), {}, glue.Identity(), [(6, 8)]),
        "Residual": (jmlp, variables, res, [(6, 8)]),
    }


@pytest.mark.parametrize("name", ["Add", "Mul", "Cat", "Split", "MatMul", "Einsum", "Identity", "Residual"])
def test_glue_op_matches_jax(name):
    rng = np.random.default_rng(1)
    jmod, variables, mod, shapes = ops(np.random.default_rng(0))[name]
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ref = jmod.apply(variables or {}, *map(jnp.asarray, xs))
    ts = [torch.tensor(x, requires_grad=True) for x in xs]
    got = mod(*ts)
    refs, gots = (ref, got) if isinstance(ref, tuple) else ((ref,), (got,))
    assert len(refs) == len(gots)
    cots = [rng.standard_normal(r.shape).astype(np.float32) for r in refs]
    for g, r in zip(gots, refs):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), **TOL, err_msg=name)

    def scalar(*args):
        out = jmod.apply(variables or {}, *args)
        out = out if isinstance(out, tuple) else (out,)
        return sum((o * c).sum() for o, c in zip(out, cots))

    jgrads = jax.grad(scalar, argnums=tuple(range(len(xs))))(*map(jnp.asarray, xs))
    sum((g * torch.tensor(c)).sum() for g, c in zip(gots, cots)).backward()
    for i, (t, r) in enumerate(zip(ts, jgrads)):
        close_grad(t.grad, r, f"{name} input {i}")


def test_mip_matches_jax():
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((5, 7)).astype(np.float32) for _ in range(3)]
    ref = jax_MIP(*map(jnp.asarray, xs))
    assert MIP is multilinear_inner_product
    np.testing.assert_allclose(MIP(*map(torch.tensor, xs)).numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(MIP(*map(torch.tensor, xs), axis=0).numpy(),
                               np.asarray(jax_MIP(*map(jnp.asarray, xs), axis=0)), **TOL)


def test_batchnorm_three_steps_then_eval_match_flax():
    """Three training calls (batch statistics, the running averages moved
    with momentum 0.9 and the biased variance) and then eval (the running
    averages), from the same random scale and bias: outputs, the gradients
    of the input, scale and bias, and the running statistics after each
    step; the last rows of each batch are zeros, as a short batch's padded
    molecules are in a readout."""
    rng = np.random.default_rng(2)
    d = 6
    xs = [(rng.standard_normal((10, d)) * (1 + i) + i).astype(np.float32) for i in range(3)]
    for x in xs:
        x[-3:] = 0.0  # padded molecule slots
    jbn = jax_glue.BatchNorm()
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), training=True)
    params = {"BatchNorm_0": {"scale": rng.standard_normal(d).astype(np.float32) + 1.0,
                              "bias": rng.standard_normal(d).astype(np.float32)}}
    stats = jax.device_get(variables["batch_stats"])
    bn = torch.nn.ModuleDict({"bn": glue.BatchNorm(d)})
    bn.load_state_dict(params_from_jax({"modules__bn": params}, {"modules__bn": stats}))
    bn.train()
    for step, x in enumerate(xs):
        cot = rng.standard_normal(x.shape).astype(np.float32)

        def loss(p, xin):
            y, upd = jbn.apply({"params": p, "batch_stats": stats}, xin, training=True, mutable=["batch_stats"])
            return (y * cot).sum(), (y, upd)

        (_, (ref, upd)), (g_p, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
        stats = jax.device_get(upd["batch_stats"])
        t = torch.tensor(x, requires_grad=True)
        y = bn["bn"](t)
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), **TOL, err_msg=f"step {step}")
        (y * torch.tensor(cot)).sum().backward()
        close_grad(t.grad, g_x, f"step {step} input")
        inner = bn["bn"].batch_norm
        close_grad(inner.weight.grad, g_p["BatchNorm_0"]["scale"], f"step {step} scale")
        close_grad(inner.bias.grad, g_p["BatchNorm_0"]["bias"], f"step {step} bias")
        inner.weight.grad = inner.bias.grad = None
        ours = batch_stats_to_jax(bn.state_dict())["modules__bn"]["BatchNorm_0"]
        for key in ("mean", "var"):
            np.testing.assert_allclose(ours[key], stats["BatchNorm_0"][key], **TOL, err_msg=f"step {step} {key}")
    assert not np.allclose(stats["BatchNorm_0"]["var"], 1.0)
    bn.eval()
    x = rng.standard_normal((4, d)).astype(np.float32)
    ref = jbn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), training=False)
    np.testing.assert_allclose(bn["bn"](torch.tensor(x)).detach().numpy(), np.asarray(ref), **TOL)
    # eval leaves the running statistics alone
    np.testing.assert_allclose(bn["bn"].batch_norm.running_var.numpy(), stats["BatchNorm_0"]["var"], **TOL)
