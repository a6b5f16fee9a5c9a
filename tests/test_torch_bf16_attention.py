"""The bf16 modes of TPU kernel rows 7 and 10-13 and the glue's ordered bf16
sums on the CPU, against the JAX package.

- Rows 10b-13b: the port's four attention entries (which take their plain
  versions on CPU tensors) against the JAX entries run in Pallas interpret
  mode, with bf16 inputs (``dt = mm = bfloat16``, a bf16 model's path) and
  with ``matmul_dtype="bfloat16"`` on f32 inputs, edge bias on and off, on
  bin-packed molecules, hub bins (a row of more than a warp's lanes, a pair
  of three edges, out-of-range lanes, a bin with no live edge) and odd bins
  (V = 47, a bond-less bin); ``FusedDenseAttentionFn`` at bf16 against
  ``jax.vjp`` of ``fused_dense_attention``, both forward implementations.
- Row 7b: ``fused_dense_mpnn_block_dbuf(matmul_dtype="bfloat16")`` against
  the JAX kernel in interpret mode, sum and mean.
- Row 8b's plain version: ``nn/ops.py`` ``segment_sum`` of bf16 data and
  the gradient of a bf16 ``take`` against ``jax.ops.segment_sum`` and the
  VJP of a bf16 gather, bit for bit: XLA adds bf16 rows in index order,
  rounding each add, and so does the port.

Tolerances: the plain versions round the operands the JAX kernels round, at
the same points, and sum in f32, so they differ from JAX only in the order
of f32 sums, which can flip a bf16 rounding (2^-8 relative). Over these
cases they agree bit for bit but for f32 ulps of the ``matmul_dtype``
mode's f32 outputs (2.9e-8 of a tensor's largest magnitude at most), so
each tensor is held at 1e-4 of its largest magnitude elementwise, as rows
1b-6b are (``tests/test_torch_bf16_block.py``): far below the 1e-3 to 1e-2
by which the bf16 modes differ from the exact f32 one
(``test_the_bf16_modes_round``), so a rounding point left out fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from notorch_tpu.kernels import dense_attention as J
from notorch_tpu.kernels.dense_mpnn import fused_dense_mpnn_block_dbuf as jax_dbuf
from notorch_tpu_torch.kernels import dense_attention as P
from notorch_tpu_torch.kernels.dense_mpnn import fused_dense_mpnn_block_dbuf
from notorch_tpu_torch.nn import ops

from .test_torch_attention import batches
from .test_torch_encoder import _dbuf_inputs, _idx, _t
from .test_torch_gpu import hub_bins, odd_bins

D, H = 16, 2
BF16 = "bfloat16"
MODES = ["bf16_inputs", "matmul_dtype"]


def hold(got, ref, what):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else jnp.asarray(got, jnp.float32), np.float32)
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * max(float(np.abs(ref).max()), 1e-30), err_msg=what)


def core(kind, seed=0):
    """(q, k, v, eb, g) f32 numpy and the index arrays of a kind of bins."""
    if kind == "hub":
        src, dst, mask, V = hub_bins()
    elif kind == "odd":
        (src, dst, mask), V = odd_bins(47), 47
    else:
        G = batches("packed")[0]
        src, dst, mask, V = G.src, G.dst, G.edge_mask, G.node_mask.shape[1]
    rng = np.random.default_rng(seed)
    B, E = src.shape
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return [f(B, V, D), f(B, V, D), f(B, V, D), f(B, H, E), f(B, V, D)], [src, dst, mask]


def both(floats, index, mode, edge_bias):
    """The operands in each package: (torch list, jax list, matmul_dtype).
    With bf16 inputs both sides get the same bf16 values."""
    if mode == "bf16_inputs":
        jx = [jnp.asarray(x).astype(jnp.bfloat16) for x in floats]
        tx = [_t(np.asarray(x.astype(jnp.float32))).bfloat16() for x in jx]
        mm = None
    else:
        jx, tx, mm = [jnp.asarray(x) for x in floats], [_t(x) for x in floats], BF16
    if not edge_bias:
        jx[3] = tx[3] = None
    return tx + [_t(x) for x in index], jx + [jnp.asarray(x) for x in index], mm


ENTRIES = [("fused_dense_attention_fwd", "fused_dense_attention_bwd"),
           ("fused_dense_attention_fwd_v2", "fused_dense_attention_bwd_v2")]


@pytest.mark.parametrize("kind", ["packed", "hub", "odd"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("edge_bias", [True, False])
def test_bf16_attention_entries_match_jax(kind, mode, edge_bias):
    """Rows 10b-13b: every output and gradient of the four entries, in the
    inputs' dtype, against the JAX kernels in interpret mode; rows with no
    live pair zero."""
    floats, index = core(kind)
    t, j, mm = both(floats, index, mode, edge_bias)
    (tq, tk, tv, teb, tg, *tidx), (jq, jk, jv, jeb, jg, *jidx) = t, j
    for fwd, bwd in ENTRIES:
        out = getattr(P, fwd)(tq, tk, tv, teb, *tidx, num_heads=H, matmul_dtype=mm)
        ref = getattr(J, fwd)(jq, jk, jv, jeb, *jidx, num_heads=H, interpret=True, matmul_dtype=mm)
        assert out.dtype == tq.dtype
        hold(out, ref, f"{fwd} ({kind}, {mode})")
        grads = getattr(P, bwd)(tq, tk, tv, teb, *tidx, tg, num_heads=H, matmul_dtype=mm)
        refs = getattr(J, bwd)(jq, jk, jv, jeb, *jidx, jg, num_heads=H, interpret=True, matmul_dtype=mm)
        for name, a, r in zip(("g_q", "g_k", "g_v", "g_eb"), grads, refs):
            assert a.dtype == tq.dtype
            hold(a, r, f"{bwd} {name} ({kind}, {mode})")
    live = (P.dense_attention_reference(torch.ones_like(tq.float()), tk.float(), tv.float(), None, *tidx, H) != 0)
    assert not out[~live.any(-1)].any()


@pytest.mark.parametrize("mode", MODES)
def test_the_bf16_modes_round(mode):
    """The bf16 modes differ from the exact f32 path by bf16's scale, far
    over the 1e-4 the entries are held at: a rounding point left out would
    show."""
    floats, index = core("packed", seed=1)
    t, _, mm = both(floats, index, mode, True)
    exact = P.dense_attention_reference(*[x.float() for x in t[:4]], *t[5:], H)
    got = P.fused_dense_attention_fwd_v2(*t[:4], *t[5:], num_heads=H, matmul_dtype=mm).float()
    diff = float((got - exact).abs().max() / exact.abs().max())
    assert 1e-3 < diff < 5e-2, diff


@pytest.mark.parametrize("fwd_impl", ["pallas", "jnp"])
def test_fused_attention_fn_at_bf16_matches_jax_vjp(fwd_impl):
    """``FusedDenseAttentionFn`` on bf16 leaves (a bf16 model's core) against
    ``jax.vjp`` of ``fused_dense_attention`` on the same bf16 values: the
    output and the gradients of q, k, v and eb (the JAX forward in interpret
    mode for ``pallas``, its einsum core for ``jnp``; the backward row 13b
    on both sides)."""
    floats, index = core("packed", seed=2)
    t, j, _ = both(floats, index, "bf16_inputs", True)
    leaves = [x.clone().requires_grad_() for x in t[:4]]
    out = P.fused_dense_attention(*leaves, *t[5:], H, 8, False, None, fwd_impl)
    out.backward(t[4])
    ref, vjp = jax.vjp(lambda q, k, v, eb: J.fused_dense_attention(q, k, v, eb, *j[5:], H, 8, True, None, fwd_impl),
                       *j[:4])
    hold(out.detach(), ref, "output")
    for name, leaf, r in zip("qkv", leaves, vjp(j[4])):
        hold(leaf.grad, r, f"g_{name}")
    hold(leaves[3].grad, vjp(j[4])[3], "g_eb")


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_dbuf_bf16_matches_jax(reduce):
    """Row 7b's plain version (the wrapper on CPU tensors) against the JAX
    depth-fused kernel with matmul_dtype="bfloat16" in interpret mode."""
    x = _dbuf_inputs(32)
    kw = dict(depth=3, n_nodes=24, residual=True, reduce=reduce, mols_per_tile=8, matmul_dtype=BF16)
    out = fused_dense_mpnn_block_dbuf(_t(x["h0"]), *_idx(x, "torch"), _t(x["W"]), _t(x["b"]), **kw)
    ref = jax_dbuf(jnp.asarray(x["h0"]), *_idx(x, "jax"), jnp.asarray(x["W"]), jnp.asarray(x["b"]),
                   interpret=True, **kw)
    hold(out, ref, f"row 7b ({reduce})")


@pytest.mark.parametrize("case", ["random", "zeros", "hub"])
def test_bf16_segment_sum_and_take_give_jax_bits(case):
    """``segment_sum`` of bf16 data and the gradient of a bf16 ``take``:
    XLA's bits (``jax.ops.segment_sum`` and the VJP of ``x[idx]`` under
    ``jit``), including rows of zeros among the terms and a hub of 3,000."""
    rng = np.random.default_rng(0)
    ids = {"random": rng.integers(0, 9, 500), "zeros": rng.integers(0, 9, 500),
           "hub": rng.permutation(np.concatenate([np.full(3000, 4), rng.integers(0, 9, 100)]))}[case]
    data = rng.standard_normal((len(ids), 12)).astype(np.float32)
    if case == "zeros":
        data[::3] = 0.0
    jd = jnp.asarray(data).astype(jnp.bfloat16)
    td = _t(np.asarray(jd.astype(jnp.float32))).bfloat16()
    ref = jax.jit(lambda x, i: jax.ops.segment_sum(x, i, 10))(jd, jnp.asarray(ids))
    got = ops.segment_sum(td, torch.from_numpy(ids), 10)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    table = rng.standard_normal((10, 12)).astype(np.float32)
    jgrad = jax.jit(jax.grad(lambda w, i, g: (w.astype(jnp.bfloat16)[i].astype(jnp.float32) * g).sum()))(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(jd.astype(jnp.float32)))
    leaf = _t(table).requires_grad_()
    (ops.take(leaf.bfloat16(), torch.from_numpy(ids)).float() * td.float()).sum().backward()
    np.testing.assert_array_equal(leaf.grad.numpy(), np.asarray(jgrad))


def test_the_bf16_modes_refuse_what_they_do_not_take():
    floats, index = core("packed")
    t, _, _ = both(floats, index, "bf16_inputs", True)
    with pytest.raises(NotImplementedError, match="matmul_dtype"):
        P.fused_dense_attention_fwd_v2(*t[:4], *t[5:], num_heads=H, matmul_dtype="float32")
    with pytest.raises(ValueError, match="matmul_dtype"):
        P.fused_dense_attention_bwd(*t[:4], *t[5:], t[4], num_heads=H, matmul_dtype="float16")
