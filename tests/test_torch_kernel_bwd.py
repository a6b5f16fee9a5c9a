"""The training kernels of the fused D-MPNN block (stash forward, stash
backward, recompute backward) and their autograd glue.

On the CPU each wrapper takes its plain version, which is compared with the
JAX Pallas kernel run in interpret mode, on every edge lane. Tolerances:
rtol = atol = 1e-4 for the forward (f32 on both sides, another summation
order, as in test_pallas_kernels.py); rtol = 2e-3, atol = 1e-4 for the
gradients, the tolerance of test_pallas_kernels.py's stash-gradient check
(the weight gradient sums B * E products, so its rounding grows with the
batch). The CUDA kernels are compared with the plain versions on the card
in test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

from notorch_tpu.kernels.dense_mpnn import fused_dense_mpnn_block_bwd as jax_bwd
from notorch_tpu.kernels.dense_mpnn import fused_dense_mpnn_block_bwd_stash as jax_bwd_stash
from notorch_tpu.kernels.dense_mpnn import fused_dense_mpnn_block_stash as jax_stash
from notorch_tpu_torch.data.dense import pack_graphs_dense
from notorch_tpu_torch.kernels.dense_mpnn import (
    FusedDenseMpnnBlockFn,
    dense_mpnn_block_bwd_reference,
    dense_mpnn_block_reference,
    dense_mpnn_block_stash_reference,
    fused_dense_mpnn_block,
    fused_dense_mpnn_block_bwd,
    fused_dense_mpnn_block_bwd_stash,
    fused_dense_mpnn_block_stash,
)
from notorch_tpu_torch.nn.chemprop_dense import DenseGraphEmbedding, FusedDenseChempropBlock
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol

PIPE = Pipeline(SmiToMol(), MolToGraph())
SMIS = ["CCO", "c1ccccc1C(=O)O", "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "NC(=O)c1ccccc1", "O",
        "CC(=O)Nc1ccc(O)cc1", "C1CCNCC1", "FC(F)(F)c1ccccc1"]
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=2e-3, atol=1e-4)
COUNTERS = (fused_dense_mpnn_block, fused_dense_mpnn_block_stash,
            fused_dense_mpnn_block_bwd_stash, fused_dense_mpnn_block_bwd)


def _inputs(depth, d=32, seed=0, E=64, V=40):
    """Seeded numpy inputs on bins packed from real molecules (real edge
    lanes, padded lanes and an all-padding bin), nonzero biases, and a
    cotangent that is zero on padded lanes, as the masked scatter gives."""
    G = pack_graphs_dense([PIPE(s) for s in SMIS], V, E, bin_cap=4, np_out=True)
    rng = np.random.default_rng(seed)
    B = G.src.shape[0]
    g = rng.standard_normal((B, E, d)).astype(np.float32) * G.edge_mask[..., None]
    return dict(
        h0=rng.standard_normal((B, E, d)).astype(np.float32),
        src=G.src, dst=G.dst, edge_mask=G.edge_mask,
        W=(rng.standard_normal((depth, d, d)) / np.sqrt(d)).astype(np.float32),
        b=(0.1 * rng.standard_normal((depth, d))).astype(np.float32),
        g=g.astype(np.float32), n_nodes=V,
    )


def _t(x):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in x.items()}


CASES = [(reduce, residual, depth)
         for reduce in ("sum", "mean") for residual in (True, False) for depth in (1, 3)]


@pytest.mark.parametrize("reduce,residual,depth", CASES)
def test_plain_stash_forward_matches_jax(reduce, residual, depth):
    x = _inputs(depth)
    out_j, hs_j = jax_stash(
        x["h0"], x["src"], x["dst"], x["edge_mask"], x["W"], x["b"], depth=depth,
        n_nodes=x["n_nodes"], residual=residual, mols_per_tile=2, interpret=True, reduce=reduce,
    )
    t = _t(x)
    out, hs = fused_dense_mpnn_block_stash(
        t["h0"], t["src"], t["dst"], t["edge_mask"], t["W"], t["b"], depth=depth,
        n_nodes=x["n_nodes"], residual=residual, reduce=reduce,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **FWD_TOL)
    if depth == 1:
        assert hs is None and hs_j is None
    else:
        assert hs.shape == (depth - 1,) + x["h0"].shape
        np.testing.assert_allclose(hs.numpy(), np.asarray(hs_j), **FWD_TOL)


@pytest.mark.parametrize("reduce,residual,depth", CASES)
def test_plain_stash_backward_matches_jax(reduce, residual, depth):
    x = _inputs(depth, seed=1)
    t = _t(x)
    kw = dict(depth=depth, residual=residual, reduce=reduce)
    _, hs = dense_mpnn_block_stash_reference(
        t["h0"], t["src"], t["dst"], t["edge_mask"], t["W"], t["b"], **kw
    )
    ref = jax_bwd_stash(
        x["h0"], None if hs is None else hs.numpy(), x["src"], x["dst"], x["edge_mask"], x["W"],
        x["g"], n_nodes=x["n_nodes"], mols_per_tile=2, interpret=True, **kw,
    )
    got = fused_dense_mpnn_block_bwd_stash(
        t["h0"], hs, t["src"], t["dst"], t["edge_mask"], t["W"], t["g"],
        n_nodes=x["n_nodes"], **kw,
    )
    for a, b in zip(got, ref):  # g_h0 on every lane, g_W, g_b
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("reduce,residual,depth", CASES)
def test_plain_recompute_backward_matches_jax(reduce, residual, depth):
    x = _inputs(depth, seed=2)
    t = _t(x)
    kw = dict(depth=depth, residual=residual, reduce=reduce)
    ref = jax_bwd(
        x["h0"], x["src"], x["dst"], x["edge_mask"], x["W"], x["b"], x["g"],
        n_nodes=x["n_nodes"], mols_per_tile=2, interpret=True, **kw,
    )
    got = fused_dense_mpnn_block_bwd(
        t["h0"], t["src"], t["dst"], t["edge_mask"], t["W"], t["b"], t["g"],
        n_nodes=x["n_nodes"], **kw,
    )
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("backward", ["stash", "recompute"])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("depth", [1, 3])
def test_autograd_function_matches_torch_autograd(backward, reduce, depth):
    """The Function's hand-written backward equals torch autograd through
    the plain forward, on every lane (it is the exact VJP of the folded
    block) and so on the real lanes the model reads."""
    x = _t(_inputs(depth, seed=3))
    idx = (x["src"], x["dst"], x["edge_mask"])
    leaves = [x[k].clone().requires_grad_(True) for k in ("h0", "W", "b")]
    out = FusedDenseMpnnBlockFn.apply(leaves[0], *idx, leaves[1], leaves[2], depth,
                                      x["n_nodes"], True, reduce, backward)
    (out * x["g"]).sum().backward()
    ref_leaves = [x[k].clone().requires_grad_(True) for k in ("h0", "W", "b")]
    ref = dense_mpnn_block_reference(ref_leaves[0], *idx, ref_leaves[1], ref_leaves[2],
                                     depth=depth, reduce=reduce)
    (ref * x["g"]).sum().backward()
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    for a, b in zip(leaves, ref_leaves):
        torch.testing.assert_close(a.grad, b.grad, **GRAD_TOL)


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    x = _t(_inputs(3))
    for fn in COUNTERS:
        fn.launches = 0
    kw = dict(depth=3, n_nodes=x["n_nodes"])
    idx = (x["src"], x["dst"], x["edge_mask"])
    out, hs = fused_dense_mpnn_block_stash(x["h0"], *idx, x["W"], x["b"], **kw)
    assert torch.equal(out, dense_mpnn_block_reference(x["h0"], *idx, x["W"], x["b"], depth=3))
    got = fused_dense_mpnn_block_bwd_stash(x["h0"], hs, *idx, x["W"], x["g"], **kw)
    ref = dense_mpnn_block_bwd_reference(x["h0"], hs, *idx, x["W"], x["g"], depth=3)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    again = fused_dense_mpnn_block_bwd(x["h0"], *idx, x["W"], x["b"], x["g"], **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, ref))
    assert all(fn.launches == 0 for fn in COUNTERS)


@pytest.mark.parametrize(
    "field,bad,err",
    [
        ("hs", lambda x: x[:1], ValueError),
        ("hs", lambda x: x.double(), TypeError),
        ("hs", lambda x: None, ValueError),
        ("hs", lambda x: x.transpose(1, 2).contiguous().transpose(1, 2), ValueError),
        ("g", lambda x: x[:, :, :16], ValueError),
        ("g", lambda x: x.double(), TypeError),
    ],
)
def test_backward_wrapper_rejects_bad_stash_and_cotangent(field, bad, err):
    x = _t(_inputs(3))
    idx = (x["src"], x["dst"], x["edge_mask"])
    _, hs = dense_mpnn_block_stash_reference(x["h0"], *idx, x["W"], x["b"], depth=3)
    args = {"hs": hs, "g": x["g"]}
    args[field] = bad(args[field])
    with pytest.raises(err):
        fused_dense_mpnn_block_bwd_stash(x["h0"], args["hs"], *idx, x["W"], args["g"],
                                         depth=3, n_nodes=x["n_nodes"])


def test_block_cotangent_is_zero_on_padded_lanes():
    """The contract the backward relies on: the block's masked scatter gives
    its edge output a cotangent that is zero on every padded lane."""
    G = pack_graphs_dense([PIPE(s) for s in SMIS], 40, 64, mol_cap=10, bin_cap=4)
    embed = DenseGraphEmbedding(60, 20, hidden_dim=32)
    embed.reset_parameters(torch.Generator().manual_seed(0))
    block = FusedDenseChempropBlock(hidden_dim=32, depth=3)
    block.reset_parameters(torch.Generator().manual_seed(1))
    out = block(embed(G))
    out.edge_feats.retain_grad()
    torch.randn(out.node_feats.shape, generator=torch.Generator().manual_seed(2)).mul(
        out.node_feats).sum().backward()
    grad = out.edge_feats.grad
    assert grad[~G.edge_mask].abs().max() == 0
    assert grad[G.edge_mask].abs().max() > 0
    assert block.weight.grad is not None and block.weight.grad.abs().max() > 0
