"""The fused D-MPNN encoder (forward with and without the stash, backward),
``FusedDenseChempropBlock(fuse_ends=True)`` and the double-buffered block
forward, on the CPU: each wrapper takes its plain version there, compared
with the JAX Pallas kernel run in interpret mode on the same seeded numpy
inputs, on every lane.

Tolerances: the forwards at rtol = atol = 1e-5 (f32 on both sides, summed
in another order over at most depth 3 at d <= 32); gradients at rtol = 1e-4
and atol 1e-4 times the tensor's largest magnitude (g_W and g_b sum B * E
products each, so an element's rounding follows the size of the terms it
sums, not its own). The CUDA kernels are compared with the plain versions
on the card in test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from notorch_tpu.data.dense import pad_graphs_dense as jax_pad
from notorch_tpu.kernels.dense_mpnn import fused_dense_encoder_bwd as jax_enc_bwd
from notorch_tpu.kernels.dense_mpnn import fused_dense_encoder_fwd as jax_enc_fwd
from notorch_tpu.kernels.dense_mpnn import fused_dense_mpnn_block_dbuf as jax_dbuf
from notorch_tpu.nn.chemprop_dense import FusedDenseChempropBlock as JaxFusedBlock
from notorch_tpu.transforms import MolToGraph as JaxMolToGraph
from notorch_tpu.transforms import Pipeline as JaxPipeline
from notorch_tpu.transforms import SmiToMol as JaxSmiToMol
from notorch_tpu_torch.data.dense import pad_graphs_dense
from notorch_tpu_torch.kernels.dense_mpnn import (
    FusedDenseEncoderFn,
    dense_encoder_reference,
    fused_dense_encoder_bwd,
    fused_dense_encoder_fwd,
    fused_dense_mpnn_block_dbuf,
)
from notorch_tpu_torch.model.convert import params_from_jax
from notorch_tpu_torch.nn.chemprop_dense import FusedDenseChempropBlock
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol

PIPE = Pipeline(SmiToMol(), MolToGraph())
JAX_PIPE = JaxPipeline(JaxSmiToMol(), JaxMolToGraph())
SMIS = ["CCO", "c1ccccc1C(=O)O", "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "NC(=O)c1ccccc1", "O",
        "CC(=O)Nc1ccc(O)cc1", "C1CCNCC1", "FC(F)(F)c1ccccc1"]
V, E, D = 32, 64, 16
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
COUNTERS = (fused_dense_encoder_fwd, fused_dense_encoder_bwd, fused_dense_mpnn_block_dbuf)


def _close_grad(got, ref, name):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()),
                               err_msg=name)


def _inputs(depth, seed=0, d=D):
    """Seeded numpy inputs on the per-molecule dense layout of real
    molecules (padded lanes point at the sink node slot), nonzero biases,
    and cotangents of both outputs that are nonzero on every lane, padded
    ones included."""
    G = pad_graphs_dense([PIPE(s) for s in SMIS], V, E, np_out=True)
    B = G.src.shape[0]
    rng = np.random.default_rng(seed)
    f32 = lambda *shape, scale=1.0: (scale * rng.standard_normal(shape)).astype(np.float32)
    return dict(
        nf=f32(B, V, d), ef=f32(B, E, d), src=G.src, dst=G.dst, edge_mask=G.edge_mask,
        W=f32(depth, d, d, scale=1 / np.sqrt(d)), b=f32(depth, d, scale=0.1),
        gn=f32(B, V, d), ge=f32(B, E, d),
    )


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _idx(x, framework):
    conv = _t if framework == "torch" else jnp.asarray
    return [conv(x[k]) for k in ("src", "dst", "edge_mask")]


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("residual", [True, False])
def test_plain_encoder_forward_matches_jax(depth, reduce, residual):
    """node_hiddens, edge_hiddens (every lane) and the stash of the plain
    encoder forward equal the JAX Pallas kernel's, with and without the
    stash; the CPU path counts no launch."""
    x = _inputs(depth)
    before = [fn.launches for fn in COUNTERS]
    kw = dict(depth=depth, residual=residual, reduce=reduce)
    for stash in (False, True):
        nh, eh, hs = fused_dense_encoder_fwd(_t(x["nf"]), _t(x["ef"]), *_idx(x, "torch"), _t(x["W"]),
                                             _t(x["b"]), stash=stash, **kw)
        ref = jax_enc_fwd(jnp.asarray(x["nf"]), jnp.asarray(x["ef"]), *_idx(x, "jax"),
                          jnp.asarray(x["W"]), jnp.asarray(x["b"]), interpret=True, stash=stash, **kw)
        np.testing.assert_allclose(nh.numpy(), np.asarray(ref[0]), **FWD_TOL)
        np.testing.assert_allclose(eh.numpy(), np.asarray(ref[1]), **FWD_TOL)
        if stash and depth > 1:
            np.testing.assert_allclose(hs.numpy(), np.asarray(ref[2]), **FWD_TOL)
        else:
            assert hs is None and ref[2] is None
    assert [fn.launches for fn in COUNTERS] == before


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("residual", [True, False])
def test_plain_encoder_backward_matches_jax(depth, reduce, residual):
    """g_nf, g_ef, g_W and g_b of the plain encoder backward equal the JAX
    Pallas kernel's for cotangents that are nonzero on padded edge lanes
    and on the sink node slot, which the scatter's VJP must drop."""
    x = _inputs(depth, seed=1)
    kw = dict(depth=depth, residual=residual, reduce=reduce)
    _, _, hs = fused_dense_encoder_fwd(_t(x["nf"]), _t(x["ef"]), *_idx(x, "torch"), _t(x["W"]),
                                       _t(x["b"]), stash=True, **kw)
    got = fused_dense_encoder_bwd(_t(x["nf"]), _t(x["ef"]), hs, *_idx(x, "torch"), _t(x["W"]),
                                  _t(x["gn"]), _t(x["ge"]), **kw)
    _, _, jhs = jax_enc_fwd(jnp.asarray(x["nf"]), jnp.asarray(x["ef"]), *_idx(x, "jax"),
                            jnp.asarray(x["W"]), jnp.asarray(x["b"]), interpret=True, stash=True, **kw)
    ref = jax_enc_bwd(jnp.asarray(x["nf"]), jnp.asarray(x["ef"]), jhs, *_idx(x, "jax"),
                      jnp.asarray(x["W"]), jnp.asarray(x["gn"]), jnp.asarray(x["ge"]),
                      interpret=True, **kw)
    for name, a, r in zip(("g_nf", "g_ef", "g_W", "g_b"), got, ref):
        _close_grad(a.numpy(), r, name)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_encoder_autograd_node_is_the_plain_forwards_gradient(reduce):
    """FusedDenseEncoderFn's backward equals autograd through the plain
    forward, for every input that takes a gradient; an output left out of
    the loss gives a zero cotangent."""
    x = _inputs(3, seed=2)
    leaves = [_t(x[k]).requires_grad_() for k in ("nf", "ef", "W", "b")]
    nf, ef, W, b = leaves
    nh, eh = FusedDenseEncoderFn.apply(nf, ef, *_idx(x, "torch"), W, b, 3, True, reduce)
    got = torch.autograd.grad((nh * _t(x["gn"])).sum(), leaves)
    ref_nh, _, _ = dense_encoder_reference(nf, ef, *_idx(x, "torch"), W, b, depth=3, reduce=reduce)
    ref = torch.autograd.grad((ref_nh * _t(x["gn"])).sum(), leaves)
    for name, a, r in zip(("g_nf", "g_ef", "g_W", "g_b"), got, ref):
        _close_grad(a.numpy(), r.numpy(), name)
    assert torch.equal(eh.detach(), dense_encoder_reference(
        nf.detach(), ef.detach(), *_idx(x, "torch"), W.detach(), b.detach(), depth=3, reduce=reduce)[1])


def _jax_graph(x):
    G = jax_pad([JAX_PIPE(s) for s in SMIS], V, E)
    return G.update(node_feats=jnp.asarray(x["nf"]), edge_feats=jnp.asarray(x["ef"]))


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_fuse_ends_module_matches_jax(reduce):
    """FusedDenseChempropBlock(fuse_ends=True): outputs, parameter gradients
    and input gradients against the JAX module's, on the JAX module's
    parameters carried over by params_from_jax."""
    depth = 3
    x = _inputs(depth, seed=3)
    jG = _jax_graph(x)
    jblock = JaxFusedBlock(hidden_dim=D, depth=depth, mols_per_tile=8, fuse_ends=True, reduce=reduce)
    params = jblock.init(jax.random.PRNGKey(0), jG)
    gn, ge = jnp.asarray(x["gn"]), jnp.asarray(x["ge"])
    emask = jG.edge_mask[..., None].astype(jnp.float32)

    def jloss(p, nf, ef):
        out = jblock.apply(p, jG.update(node_feats=nf, edge_feats=ef))
        return (out.node_feats * gn).sum() + (out.edge_feats * emask * ge).sum()

    jout = jblock.apply(params, jG)
    jv, (jg_p, jg_nf, jg_ef) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        params, jG.node_feats, jG.edge_feats)

    block = FusedDenseChempropBlock(hidden_dim=D, depth=depth, fuse_ends=True, reduce=reduce)
    sd = params_from_jax({"modules__mp": jax.device_get(params["params"])})
    block.load_state_dict({k.removeprefix("mp."): v for k, v in sd.items()})
    G = pad_graphs_dense([PIPE(s) for s in SMIS], V, E)
    nf, ef = _t(x["nf"]).requires_grad_(), _t(x["ef"]).requires_grad_()
    out = block(G.update(node_feats=nf, edge_feats=ef))
    mask = G.edge_mask[..., None].float()
    loss = (out.node_feats * _t(x["gn"])).sum() + (out.edge_feats * mask * _t(x["ge"])).sum()
    loss.backward()

    np.testing.assert_allclose(out.node_feats.detach().numpy(), np.asarray(jout.node_feats), **FWD_TOL)
    np.testing.assert_allclose(out.edge_feats.detach().numpy(), np.asarray(jout.edge_feats), **FWD_TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-5)
    ref_p = params_from_jax({"modules__mp": jax.device_get(jg_p["params"])})
    _close_grad(block.weight.grad.numpy(), ref_p["mp.weight"].numpy(), "g_W")
    _close_grad(block.bias.grad.numpy(), ref_p["mp.bias"].numpy(), "g_b")
    _close_grad(nf.grad.numpy(), jg_nf, "g_nf")
    _close_grad(ef.grad.numpy(), jg_ef, "g_ef")
    # without autograd the block runs the forward alone, to the same values
    with torch.no_grad():
        again = block(G.update(node_feats=nf.detach(), edge_feats=ef.detach()))
    assert torch.equal(again.node_feats, out.node_feats.detach())


def test_fuse_ends_refusals():
    with pytest.raises(ValueError, match="fuse_ends requires backward='stash'"):
        FusedDenseChempropBlock(hidden_dim=D, fuse_ends=True, backward="recompute")
    with pytest.raises(NotImplementedError):
        FusedDenseChempropBlock(hidden_dim=D, fuse_ends=True, reduce="max")


def _dbuf_inputs(B, seed=0, d=D, depth=3):
    """The JAX test's synthetic bins: random src, dst paired so that
    rev(e) = e ^ 1, 80% real lanes."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 24, size=(B, 32)).astype(np.int32)
    dst = np.empty_like(src)
    dst[:, 0::2], dst[:, 1::2] = src[:, 1::2], src[:, 0::2]
    return dict(h0=rng.standard_normal((B, 32, d)).astype(np.float32), src=src, dst=dst,
                edge_mask=rng.random((B, 32)) < 0.8,
                W=(0.1 * rng.standard_normal((depth, d, d))).astype(np.float32),
                b=(0.1 * rng.standard_normal((depth, d))).astype(np.float32))


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("residual", [True, False])
def test_plain_dbuf_matches_jax(reduce, residual):
    x = _dbuf_inputs(32)
    kw = dict(depth=3, n_nodes=24, residual=residual, reduce=reduce, mols_per_tile=8)
    out = fused_dense_mpnn_block_dbuf(_t(x["h0"]), *_idx(x, "torch"), _t(x["W"]), _t(x["b"]), **kw)
    ref = jax_dbuf(jnp.asarray(x["h0"]), *_idx(x, "jax"), jnp.asarray(x["W"]), jnp.asarray(x["b"]),
                   interpret=True, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)


@pytest.mark.parametrize("B,tile", [(24, 8), (32, 4), (8, 8)])
def test_dbuf_refuses_what_the_jax_kernel_refuses(B, tile):
    """An odd count of tiles, or a tile that is not a multiple of 8, raises
    the same ValueError in both packages."""
    x = _dbuf_inputs(B)
    kw = dict(depth=3, n_nodes=24, mols_per_tile=tile)
    with pytest.raises(ValueError, match="dbuf"):
        fused_dense_mpnn_block_dbuf(_t(x["h0"]), *_idx(x, "torch"), _t(x["W"]), _t(x["b"]), **kw)
    with pytest.raises(ValueError, match="dbuf"):
        jax_dbuf(jnp.asarray(x["h0"]), *_idx(x, "jax"), jnp.asarray(x["W"]), jnp.asarray(x["b"]),
                 interpret=True, **kw)
