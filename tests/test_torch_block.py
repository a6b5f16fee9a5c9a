"""The port's D-MPNN modules: the fused block against its plain oracle
through ``edge_mask``, and each module against its JAX counterpart on
shared weights. Tolerances rtol=atol=1e-4: f32 with a different summation
order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from notorch_tpu.data.dense import pack_graphs_dense as jax_pack
from notorch_tpu.nn.chemprop_dense import DenseChempropBlock as JaxDenseBlock
from notorch_tpu.nn.chemprop_dense import DenseGraphEmbedding as JaxEmbedding
from notorch_tpu.nn.chemprop_dense import PackedMean as JaxPackedMean
from notorch_tpu.nn.mlp import MLP as JaxMLP
from notorch_tpu_torch.data.dense import pack_graphs_dense
from notorch_tpu_torch.nn.chemprop_dense import (
    DenseChempropBlock,
    DenseGraphEmbedding,
    DenseMean,
    FusedDenseChempropBlock,
    PackedMean,
)
from notorch_tpu_torch.nn.mlp import MLP
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol

PIPE = Pipeline(SmiToMol(), MolToGraph())
SMIS = ["CCO", "c1ccccc1C(=O)O", "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "NC(=O)c1ccccc1", "O",
        "CC(=O)Nc1ccc(O)cc1", "C1CCNCC1", "FC(F)(F)c1ccccc1"]
D = 32
TOL = dict(rtol=1e-4, atol=1e-4)


def _batch(bin_cap=4):
    return pack_graphs_dense([PIPE(s) for s in SMIS], 40, 64, mol_cap=10, bin_cap=bin_cap)


def _embedded(seed=0):
    G = _batch()
    embed = DenseGraphEmbedding(60, 20, hidden_dim=D)
    embed.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        return embed(G)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("residual", [True, False])
def test_fused_block_matches_plain_block_through_edge_mask(reduce, residual):
    G = _embedded()
    plain = DenseChempropBlock(hidden_dim=D, depth=3, residual=residual, reduce=reduce)
    plain.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        plain.bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(2))
    fused = FusedDenseChempropBlock(hidden_dim=D, depth=3, residual=residual, reduce=reduce)
    fused.load_state_dict(plain.state_dict())
    with torch.inference_mode():
        ref, out = plain(G), fused(G)
    mask = G.edge_mask
    torch.testing.assert_close(out.edge_feats[mask], ref.edge_feats[mask], **TOL)
    torch.testing.assert_close(out.node_feats, ref.node_feats, **TOL)


def test_fused_block_refuses_unported_options_and_autograd():
    """Unknown options raise (bf16 operands and stash, refused until the
    plain dense slice, now build, and another dtype raises; the debug
    backward "jnp", refused until the utilities slice, builds); autograd
    through the block runs the training kernels' plain versions on the CPU
    and gives the plain block's gradients on every parameter."""
    block = FusedDenseChempropBlock(hidden_dim=D, matmul_dtype="bfloat16", stash_dtype="bfloat16")
    assert (block.matmul_dtype, block.stash_dtype) == ("bfloat16", "bfloat16")
    with pytest.raises(ValueError, match="matmul_dtype"):
        FusedDenseChempropBlock(hidden_dim=D, matmul_dtype="float16")
    with pytest.raises(ValueError, match="stash_dtype"):
        FusedDenseChempropBlock(hidden_dim=D, stash_dtype="float16")
    with pytest.raises(ValueError, match="fuse_ends requires backward='stash'"):
        FusedDenseChempropBlock(hidden_dim=D, fuse_ends=True, backward="recompute")
    assert FusedDenseChempropBlock(hidden_dim=D, backward="jnp").backward == "jnp"
    with pytest.raises(ValueError, match="backward"):
        FusedDenseChempropBlock(hidden_dim=D, backward="replay")
    with pytest.raises(NotImplementedError):
        FusedDenseChempropBlock(hidden_dim=D, reduce="max")
    G = _embedded()
    plain = DenseChempropBlock(hidden_dim=D, depth=3)
    plain.reset_parameters(torch.Generator().manual_seed(1))
    cot = torch.randn(G.node_feats.shape, generator=torch.Generator().manual_seed(3))
    (plain(G).node_feats * cot).sum().backward()
    for backward in ("stash", "recompute"):
        block = FusedDenseChempropBlock(hidden_dim=D, depth=3, backward=backward)
        block.load_state_dict(plain.state_dict())
        (block(G).node_feats * cot).sum().backward()
        torch.testing.assert_close(block.weight.grad, plain.weight.grad, rtol=2e-3, atol=1e-5)
        torch.testing.assert_close(block.bias.grad, plain.bias.grad, rtol=2e-3, atol=1e-5)


def _jax_graph(G):
    """The same batch as a JAX DenseBatchedGraph with float features."""
    ref = jax_pack([PIPE(s) for s in SMIS], 40, 64, mol_cap=10, bin_cap=4)
    return ref.update(node_feats=jnp.asarray(G.node_feats.numpy()),
                      edge_feats=jnp.asarray(G.edge_feats.numpy()))


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_plain_block_matches_jax_dense_block(reduce):
    G = _embedded()
    jG = _jax_graph(G)
    jblock = JaxDenseBlock(hidden_dim=D, depth=3, reduce=reduce)
    params = jblock.init(jax.random.PRNGKey(0), jG)
    ref = jblock.apply(params, jG)
    block = DenseChempropBlock(hidden_dim=D, depth=3, reduce=reduce)
    p = params["params"]
    block.load_state_dict({
        "weight": torch.from_numpy(np.stack([np.asarray(p[f"layer_{i}"]["update"]["kernel"]) for i in range(3)])),
        "bias": torch.from_numpy(np.stack([np.asarray(p[f"layer_{i}"]["update"]["bias"]) for i in range(3)])),
    })
    with torch.no_grad():
        out = block(G)
    np.testing.assert_allclose(out.edge_feats.numpy(), np.asarray(ref.edge_feats), **TOL)
    np.testing.assert_allclose(out.node_feats.numpy(), np.asarray(ref.node_feats), **TOL)


def test_embedding_readout_and_mlp_match_jax():
    G = _batch()
    ref_G = jax_pack([PIPE(s) for s in SMIS], 40, 64, mol_cap=10, bin_cap=4)
    jembed = JaxEmbedding(60, 20, hidden_dim=D)
    ep = jembed.init(jax.random.PRNGKey(0), ref_G)
    jE = jembed.apply(ep, ref_G)
    embed = DenseGraphEmbedding(60, 20, hidden_dim=D)
    embed.load_state_dict({
        f"{part}.embedding.weight": torch.from_numpy(np.array(ep["params"][part]["embedding"]["embedding"]))
        for part in ("node", "edge")
    })
    with torch.no_grad():
        E = embed(G)
    np.testing.assert_allclose(E.node_feats.numpy(), np.asarray(jE.node_feats), **TOL)
    np.testing.assert_allclose(E.edge_feats.numpy(), np.asarray(jE.edge_feats), **TOL)

    H = PackedMean()(E)
    jH = JaxPackedMean().apply({}, jE)
    assert H.shape == (10, D)
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), **TOL)

    jmlp = JaxMLP(input_dim=D, output_size=3, hidden_dim=D, num_layers=2)
    mp = jmlp.init(jax.random.PRNGKey(1), jH)
    mlp = MLP(input_dim=D, output_size=3, hidden_dim=D, num_layers=2)
    sd = {}
    for i in range(3):
        sd[f"dense_{i}.weight"] = torch.from_numpy(np.array(mp["params"][f"dense_{i}"]["kernel"]).T.copy())
        sd[f"dense_{i}.bias"] = torch.from_numpy(np.array(mp["params"][f"dense_{i}"]["bias"]))
    mlp.load_state_dict(sd)
    mlp.eval()
    with torch.no_grad():
        np.testing.assert_allclose(mlp(H).numpy(), np.asarray(jmlp.apply(mp, jH)), **TOL)


def test_packed_mean_falls_back_and_refuses_shards():
    E = _embedded()
    per_mol = E.update(node_graph=None)
    torch.testing.assert_close(PackedMean()(per_mol), DenseMean()(per_mol))
    with pytest.raises(ValueError, match="shards"):
        PackedMean()(E.update(n_shards=2))


def test_initializers_follow_flax_families():
    g = torch.Generator().manual_seed(0)
    embed = DenseGraphEmbedding(60, 20, hidden_dim=256)
    embed.reset_parameters(g)
    w = embed.node.embedding.weight.detach()
    assert abs(float(w.std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    block = FusedDenseChempropBlock(hidden_dim=256, depth=3)
    block.reset_parameters(g)
    bound = 2 * 256 ** -0.5 / 0.87962566103423978
    W = block.weight.detach()
    assert float(W.abs().max()) <= bound + 1e-6
    assert abs(float(W.std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    assert not block.bias.any()
