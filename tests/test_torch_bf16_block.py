"""The fused D-MPNN rows 1-6 with ``matmul_dtype="bfloat16"`` (and
``stash_dtype="bfloat16"``) on the CPU: each wrapper takes its plain
version there, compared with the JAX Pallas kernel run in interpret mode on
the same seeded numpy inputs, on every lane; ``FusedDenseChempropBlock``
against JAX's block; the stash's dtype and values; and ``matmul_dtype=None``
giving the f32 path's bits.

Tolerances: the plain versions round the operands the JAX kernels round, at
the same points, and multiply and sum in f32, so they differ from JAX only
in the order of f32 sums. An f32 ulp of a sum can flip the bf16 rounding of
the next operand (2^-8 relative); over these cases (B <= 8, d <= 32, depth
<= 3) the largest difference measured was 7.8e-7 of the tensor's largest
magnitude, so each tensor is held at 1e-4 of its largest magnitude
elementwise: far below the 4.5e-3 by which the bf16 path differs from the
f32 one (measured on the card), so a rounding point left out fails. The
CUDA kernels are compared with the plain versions on the card in
test_torch_gpu.py.
"""

import jax.numpy as jnp
import jax
import numpy as np
import pytest
import torch

from notorch_tpu.kernels import dense_mpnn as J
from notorch_tpu.nn.chemprop_dense import FusedDenseChempropBlock as JaxFusedBlock
from notorch_tpu_torch.kernels import dense_mpnn as P
from notorch_tpu_torch.model.convert import params_from_jax
from notorch_tpu_torch.nn.chemprop_dense import FusedDenseChempropBlock
from tests.test_torch_encoder import D, _idx, _inputs, _t

BF16 = "bfloat16"


def hold(got, ref, what):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, dtype=np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()), err_msg=what)


def _j(x, *keys):
    return [jnp.asarray(x[k]) for k in keys]


CASES = [(depth, reduce, residual) for depth in (1, 3) for reduce in ("sum", "mean") for residual in (True, False)]


@pytest.mark.parametrize("depth, reduce, residual", CASES)
@pytest.mark.parametrize("stash_dtype", [None, BF16])
def test_block_rows_match_jax(depth, reduce, residual, stash_dtype):
    """Rows 1-4 (forward, stash forward, stash backward, recompute
    backward) with bf16 operands against the JAX kernels in interpret mode;
    the stash is bf16 where asked, and JAX's bits."""
    x = _inputs(depth, seed=2)
    V = x["nf"].shape[1]
    kw = dict(depth=depth, residual=residual, reduce=reduce, n_nodes=V, matmul_dtype=BF16)
    tw = (_t(x["ef"]), *_idx(x, "torch"), _t(x["W"]), _t(x["b"]))
    jw = (jnp.asarray(x["ef"]), *_idx(x, "jax"), jnp.asarray(x["W"]), jnp.asarray(x["b"]))
    hold(P.fused_dense_mpnn_block(*tw, **kw), J.fused_dense_mpnn_block(*jw, interpret=True, **kw), "row 1")
    out, hs = P.fused_dense_mpnn_block_stash(*tw, stash_dtype=stash_dtype, **kw)
    jout, jhs = J.fused_dense_mpnn_block_stash(*jw, interpret=True, stash_dtype=stash_dtype, **kw)
    hold(out, jout, "row 2")
    if depth > 1:
        assert hs.dtype == (torch.bfloat16 if stash_dtype else torch.float32)
        np.testing.assert_array_equal(hs.float().numpy(), np.asarray(jhs, dtype=np.float32))
    else:
        assert hs is None and jhs is None
    g = (_t(x["ge"]),)
    bwd = P.fused_dense_mpnn_block_bwd_stash(tw[0], hs, *tw[1:5], *g, **kw)
    jbwd = J.fused_dense_mpnn_block_bwd_stash(jw[0], jhs, *jw[1:5], jnp.asarray(x["ge"]), interpret=True, **kw)
    for name, a, b in zip(("g_h0", "g_W", "g_b"), bwd, jbwd):
        hold(a, b, f"row 3 {name}")
    rec = P.fused_dense_mpnn_block_bwd(*tw, *g, **kw)
    jrec = J.fused_dense_mpnn_block_bwd(*jw, jnp.asarray(x["ge"]), interpret=True, **kw)
    for name, a, b in zip(("g_h0", "g_W", "g_b"), rec, jrec):
        hold(a, b, f"row 4 {name}")


@pytest.mark.parametrize("depth, reduce, residual", CASES)
@pytest.mark.parametrize("stash_dtype", [None, BF16])
def test_encoder_rows_match_jax(depth, reduce, residual, stash_dtype):
    """Rows 5 and 6 (the whole encoder) with bf16 operands: node and edge
    hiddens, the stash, and all four gradients, the backward fed each
    package's own stash."""
    x = _inputs(depth, seed=3)
    kw = dict(depth=depth, residual=residual, reduce=reduce, matmul_dtype=BF16)
    nh, eh, hs = P.fused_dense_encoder_fwd(_t(x["nf"]), _t(x["ef"]), *_idx(x, "torch"), _t(x["W"]), _t(x["b"]),
                                           stash=True, stash_dtype=stash_dtype, **kw)
    ref = J.fused_dense_encoder_fwd(*_j(x, "nf", "ef"), *_idx(x, "jax"), *_j(x, "W", "b"), interpret=True,
                                    stash=True, stash_dtype=stash_dtype, **kw)
    hold(nh, ref[0], "row 5 node_hiddens")
    hold(eh, ref[1], "row 5 edge_hiddens")
    if depth > 1:
        np.testing.assert_array_equal(hs.float().numpy(), np.asarray(ref[2], dtype=np.float32))
    got = P.fused_dense_encoder_bwd(_t(x["nf"]), _t(x["ef"]), hs, *_idx(x, "torch"), _t(x["W"]), _t(x["gn"]),
                                    _t(x["ge"]), **kw)
    jgot = J.fused_dense_encoder_bwd(*_j(x, "nf", "ef"), ref[2], *_idx(x, "jax"), jnp.asarray(x["W"]),
                                     *_j(x, "gn", "ge"), interpret=True, **kw)
    for name, a, b in zip(("g_nf", "g_ef", "g_W", "g_b"), got, jgot):
        hold(a, b, f"row 6 {name}")


def test_stash_dtype_and_values():
    """A bf16 stash holds the f32 stash's values rounded to bf16 (the state
    itself stays f32, so the outputs match the f32-stash forward's), and
    the backward reads those rounded values."""
    x = _inputs(3, seed=4)
    args = (_t(x["ef"]), *_idx(x, "torch"), _t(x["W"]), _t(x["b"]))
    kw = dict(depth=3, n_nodes=x["nf"].shape[1], matmul_dtype=BF16)
    out32, hs32 = P.fused_dense_mpnn_block_stash(*args, **kw)
    out16, hs16 = P.fused_dense_mpnn_block_stash(*args, stash_dtype=BF16, **kw)
    assert hs32.dtype == torch.float32 and hs16.dtype == torch.bfloat16 and hs16.shape == hs32.shape
    assert torch.equal(out16, out32) and torch.equal(hs16, hs32.to(torch.bfloat16))
    g = _t(x["ge"])
    via16 = P.fused_dense_mpnn_block_bwd_stash(args[0], hs16, *args[1:5], g, **kw)
    via32 = P.fused_dense_mpnn_block_bwd_stash(args[0], hs16.float(), *args[1:5], g, **kw)
    assert all(torch.equal(a, b) for a, b in zip(via16, via32))
    with pytest.raises(ValueError, match="stash_dtype"):
        P.fused_dense_mpnn_block_stash(*args, stash_dtype="float16", **kw)
    with pytest.raises(ValueError, match="matmul_dtype"):
        P.fused_dense_mpnn_block(*args, depth=3, n_nodes=1, matmul_dtype="int8")


def test_f32_path_keeps_its_bits():
    """matmul_dtype None, "float32" or left out give the same bits on every
    row (the f32 path as before the option), and bf16 moves them."""
    x = _inputs(3, seed=5)
    args = (_t(x["ef"]), *_idx(x, "torch"), _t(x["W"]), _t(x["b"]))
    kw = dict(depth=3, n_nodes=x["nf"].shape[1], reduce="mean")
    base = P.fused_dense_mpnn_block(*args, **kw)
    for mm in (None, "float32", torch.float32):
        assert torch.equal(P.fused_dense_mpnn_block(*args, matmul_dtype=mm, **kw), base)
    assert not torch.equal(P.fused_dense_mpnn_block(*args, matmul_dtype=BF16, **kw), base)
    enc = dict(depth=3, reduce="mean")
    ea = (_t(x["nf"]), _t(x["ef"]), *_idx(x, "torch"), _t(x["W"]), _t(x["b"]))
    nh, eh, hs = P.fused_dense_encoder_fwd(*ea, stash=True, **enc)
    nh2, eh2, hs2 = P.fused_dense_encoder_fwd(*ea, stash=True, matmul_dtype=None, stash_dtype=None, **enc)
    assert torch.equal(nh, nh2) and torch.equal(eh, eh2) and torch.equal(hs, hs2)
    grads = P.fused_dense_encoder_bwd(*ea[:2], hs, *ea[2:6], _t(x["gn"]), _t(x["ge"]), **enc)
    again = P.fused_dense_encoder_bwd(*ea[:2], hs, *ea[2:6], _t(x["gn"]), _t(x["ge"]), matmul_dtype=None, **enc)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("kw", [dict(fuse_ends=True), dict(), dict(backward="recompute"),
                                dict(fuse_ends=True, reduce="mean")])
@pytest.mark.parametrize("stash_dtype", [None, BF16])
def test_fused_block_matches_jax(kw, stash_dtype):
    """FusedDenseChempropBlock(matmul_dtype="bfloat16", stash_dtype) against
    JAX's block on the same weights: node hiddens, real edge lanes, and the
    gradients of the weights and both feature inputs under a cotangent of
    the node hiddens (the padded-lane contract: real lanes only)."""
    from notorch_tpu.data.dense import pad_graphs_dense as jax_pad
    from notorch_tpu_torch.data.dense import pad_graphs_dense
    from tests.test_torch_encoder import JAX_PIPE, PIPE, SMIS, V, E

    opts = dict(hidden_dim=D, depth=3, matmul_dtype=BF16, stash_dtype=stash_dtype, **kw)
    G = pad_graphs_dense([PIPE(s) for s in SMIS], V, E, np_out=True)
    jG = jax_pad([JAX_PIPE(s) for s in SMIS], V, E, np_out=True)
    rng = np.random.default_rng(6)
    B = G.src.shape[0]
    nf, ef = rng.standard_normal((B, V, D)).astype(np.float32), rng.standard_normal((B, E, D)).astype(np.float32)
    gout = rng.standard_normal((B, V, D)).astype(np.float32)
    jG = jax.tree.map(jnp.asarray, jG.update(node_feats=nf, edge_feats=ef))
    jm = JaxFusedBlock(**opts)
    params = jm.init(jax.random.PRNGKey(0), jG)["params"]

    def f(params, nf, ef):
        out = jm.apply({"params": params}, jG.update(node_feats=nf, edge_feats=ef))
        return (out.node_feats * gout).sum(), out

    (_, ref), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(params, jG.node_feats, jG.edge_feats)
    block = FusedDenseChempropBlock(**opts)
    sd = params_from_jax({"modules__m": jax.device_get(params)})
    block.load_state_dict({k.removeprefix("m."): v for k, v in sd.items()})
    Gt = G.to("cpu")
    nft, eft = _t(nf).requires_grad_(), _t(ef).requires_grad_()
    out = block(Gt.update(node_feats=nft, edge_feats=eft))
    (out.node_feats * _t(gout)).sum().backward()
    mask = G.edge_mask
    hold(out.node_feats.detach(), ref.node_feats, "node_hiddens")
    hold(out.edge_feats.detach()[mask], np.asarray(ref.edge_feats)[mask], "edge_hiddens (real lanes)")
    gref = params_from_jax({"modules__m": jax.device_get(grads[0])})
    for name, p in block.named_parameters():
        hold(p.grad, gref[f"m.{name}"], name)
    hold(nft.grad, grads[1], "node_feats")
    hold(eft.grad, grads[2], "edge_feats")
