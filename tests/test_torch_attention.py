"""The attention core and the attention modules against the JAX package, on
the same numpy inputs and carried weights.

- The plain versions of the four kernel entries (and the port's wrappers,
  which take them on CPU tensors) against the four JAX entries, run in
  Pallas interpret mode, on bin-packed and per-molecule batches, edge bias
  on and off; rows with no live pair (padding slots, the sink, the
  bond-less "O") come out zero; ``attention_core`` against
  ``_jnp_attention_core``; ``fit_attn_tile``.
- ``FusedDenseAttentionFn`` against ``jax.vjp`` of
  ``fused_dense_attention``, both forward implementations.
- ``EdgeBiasScatterFn`` and ``MaskedSoftmaxFn`` against the JAX custom VJPs.
- ``DenseGraphSelfAttention`` (every ``impl`` and ``bias_impl``),
  ``DenseGATv2Layer``, ``DenseGATBlock`` (sdp and gatv2), the flat
  ``GATv2Layer``, ``GraphSelfAttention`` and ``GATBlock``, and the six
  dense and packed readouts: outputs and every gradient.
- ``params_from_jax``/``params_to_jax`` round trips of every group.

Tolerances: rtol = atol = 1e-5 (f32 on both sides, summed in other orders,
hidden 16); gradients at rtol = 1e-5 and atol 1e-5 times the tensor's
largest magnitude, since a weight gradient sums over every lane. The
gradients of the biases of ``W_k``, ``W_bias`` and GATv2's score ``a`` are
zero in exact arithmetic (a shift along a softmax row moves nothing), so
they are held at the scale of the other gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from notorch_tpu.data import dense as jax_dense
from notorch_tpu.data import graph as jax_graph
from notorch_tpu.kernels import dense_attention as jax_attn
from notorch_tpu.nn import attention as jax_flat
from notorch_tpu.nn import attention_dense as jax_dense_attn
from notorch_tpu.nn import chemprop_dense as jax_readouts
from notorch_tpu.transforms import MolToGraph as JaxMolToGraph
from notorch_tpu.transforms import Pipeline as JaxPipeline
from notorch_tpu.transforms import SmiToMol as JaxSmiToMol
from notorch_tpu_torch.data import dense, graph
from notorch_tpu_torch.kernels import dense_attention as attn
from notorch_tpu_torch.model.convert import params_from_jax, params_to_jax
from notorch_tpu_torch.nn import attention as flat
from notorch_tpu_torch.nn import attention_dense as dense_attn
from notorch_tpu_torch.nn import chemprop_dense as readouts
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol

from .test_torch_gpu import hub_bins, odd_bins

D, H = 16, 2
TOL = dict(rtol=1e-5, atol=1e-5)
PIPE, JAX_PIPE = Pipeline(SmiToMol(), MolToGraph()), JaxPipeline(JaxSmiToMol(), JaxMolToGraph())
SMIS = ["CCO", "c1ccccc1C(=O)O", "CC(C)CC(N)C(=O)O", "O", "CCN(CC)CC", "c1ccc2c(c1)cccc2",
        "CC(=O)Nc1ccc(O)cc1", "[Na+].[Cl-]", "NC(=O)c1ccccc1", "OCC(O)CO"]
ZERO_GRADS = ("W_k.bias", "W_bias.bias", "a.bias")


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def batches(layout: str):
    """The molecules as one batch in both packages (numpy arrays): packed
    into bins of 32 node slots and 64 edge lanes, an even bin count (the v1
    grid then takes two bins a step), or one molecule per 24-slot block."""
    graphs, jgraphs = [PIPE(s) for s in SMIS], [JAX_PIPE(s) for s in SMIS]
    if layout == "packed":
        n_bins = len(dense.plan_bins(graphs, 32, 64))
        n_bins += n_bins % 2
        return (dense.pack_graphs_dense(graphs, 32, 64, bin_cap=n_bins, np_out=True),
                jax_dense.pack_graphs_dense(jgraphs, 32, 64, bin_cap=n_bins, np_out=True))
    return (dense.pad_graphs_dense(graphs, 24, 48, np_out=True),
            jax_dense.pad_graphs_dense(jgraphs, 24, 48, np_out=True))


@pytest.fixture(scope="module", params=["packed", "dense"])
def case(request):
    """A batch in both packages with random float node and edge features,
    q/k/v, an edge bias and a cotangent, all drawn from one numpy seed."""
    G, jG = batches(request.param)
    for f in dense.DenseBatchedGraph._ARRAYS:
        if getattr(G, f) is not None:
            assert np.array_equal(getattr(G, f), np.asarray(getattr(jG, f))), f
    rng = np.random.default_rng(0)
    B, V = G.node_mask.shape
    E = G.src.shape[1]
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    x = {"q": f(B, V, D), "k": f(B, V, D), "v": f(B, V, D), "eb": f(B, H, E), "g": f(B, V, D),
         "nf": f(B, V, D), "ef": f(B, E, D), "gout": f(B, V, D)}
    jGf = jax.tree.map(jnp.asarray, jG.update(node_feats=x["nf"], edge_feats=x["ef"]))
    return {"layout": request.param, "G": G, "jG": jG, "jGf": jGf,
            "Gf": G.to("cpu").update(node_feats=t(x["nf"]), edge_feats=t(x["ef"])), **x}


@pytest.fixture(scope="module", params=["packed", "dense", "hub", "odd"])
def core_case(request):
    """The attention core's operands in numpy: the index arrays of
    ``batches(layout)`` with the ``case`` fixture's q/k/v, edge bias and
    cotangent (the same draws), or :func:`hub_bins` or :func:`odd_bins` at
    V = 47 (an odd row count, a hub and a bin with no live edge) with their
    own."""
    if request.param == "hub":
        src, dst, edge_mask, V = hub_bins()
    elif request.param == "odd":
        (src, dst, edge_mask), V = odd_bins(47), 47
    else:
        G = batches(request.param)[0]
        src, dst, edge_mask, V = G.src, G.dst, G.edge_mask, G.node_mask.shape[1]
    rng = np.random.default_rng(0)
    (B, E), f = src.shape, lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return {"q": f(B, V, D), "k": f(B, V, D), "v": f(B, V, D), "eb": f(B, H, E), "g": f(B, V, D),
            "src": src, "dst": dst, "edge_mask": edge_mask}


def core_args(case, edge_bias, lib):
    conv = t if lib == "torch" else jnp.asarray
    index = [case[n] for n in ("src", "dst", "edge_mask")] if "src" in case else [
        case["G"].src, case["G"].dst, case["G"].edge_mask]
    return [conv(case["q"]), conv(case["k"]), conv(case["v"]), conv(case["eb"]) if edge_bias else None,
            *(conv(x) for x in index)]


def close_grad(got, ref, name="", scale=None):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max()) if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5, atol=1e-5 * scale, err_msg=name)


# -- the core -------------------------------------------------------------------------------


@pytest.mark.parametrize("edge_bias", [True, False])
def test_plain_versions_match_the_four_jax_entries(core_case, edge_bias):
    """dense_attention_reference against rows 10 and 12, the backward plain
    version against rows 11 and 13 (all four in interpret mode), and the
    port's four wrappers on CPU tensors; attention_core against the JAX jnp
    core. A row with no live pair is zero in the output and g_q. The hub
    bins hold a row of 40 live lanes, a pair of three edges, unmasked lanes
    outside [0, V) and a bin with no live edge; the odd bins 47 node slots."""
    case = core_case
    args, jargs = core_args(case, edge_bias, "torch"), core_args(case, edge_bias, "jax")
    g, jg = t(case["g"]), jnp.asarray(case["g"])
    kw = dict(num_heads=H, bins_per_tile=2, interpret=True)
    out = attn.dense_attention_reference(*args, H)
    grads = attn.dense_attention_bwd_reference(*args, g, H)
    for jfwd, jbwd, fwd, bwd in ((jax_attn.fused_dense_attention_fwd, jax_attn.fused_dense_attention_bwd,
                                  attn.fused_dense_attention_fwd, attn.fused_dense_attention_bwd),
                                 (jax_attn.fused_dense_attention_fwd_v2, jax_attn.fused_dense_attention_bwd_v2,
                                  attn.fused_dense_attention_fwd_v2, attn.fused_dense_attention_bwd_v2)):
        np.testing.assert_allclose(out.numpy(), np.asarray(jfwd(*jargs, **kw)), **TOL)
        ref = jbwd(*jargs, jg, **kw)
        for name, a, r in zip(("g_q", "g_k", "g_v", "g_eb"), grads, ref):
            close_grad(a.numpy(), r, name)
        before = fwd.launches, bwd.launches
        torch.testing.assert_close(fwd(*args, **kw), out, rtol=0, atol=0)
        for a, b in zip(bwd(*args, g, **kw), grads):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert (fwd.launches, bwd.launches) == before  # the plain versions launch nothing
    np.testing.assert_allclose(attn.attention_core(*args, H).numpy(),
                               np.asarray(jax_attn._jnp_attention_core(*jargs, H)), **TOL)
    if not edge_bias:
        assert not grads[3].any()
    src, dst, edge_mask = (case[n] for n in ("src", "dst", "edge_mask"))
    V = case["q"].shape[1]
    real = edge_mask & (src >= 0) & (src < V) & (dst >= 0) & (dst < V)
    live = np.zeros(case["q"].shape[:2], bool)
    np.logical_or.at(live, (np.arange(len(dst))[:, None].repeat(dst.shape[1], 1)[real], dst[real]), True)
    assert (~live).any() and not out.numpy()[~live].any() and not grads[0].numpy()[~live].any()


def test_fit_attn_tile_matches_jax():
    for tile, v, e, b in [(8, 128, 256, 16), (8, 48, 128, 64), (8, 32, 64, 6), (4, 256, 512, 3), (1, 8, 8, 1)]:
        assert attn.fit_attn_tile(tile, v, e, b) == jax_attn.fit_attn_tile(tile, v, e, b)


@pytest.mark.parametrize("fwd_impl", ["jnp", "pallas"])
def test_fused_fn_gradients_match_jax_vjp(case, fwd_impl):
    args, jargs = core_args(case, True, "torch"), core_args(case, True, "jax")
    out, vjp = jax.vjp(lambda q, k, v, eb: jax_attn.fused_dense_attention(
        q, k, v, eb, *jargs[4:], H, 2, True, None, fwd_impl), *jargs[:4])
    ref = vjp(jnp.asarray(case["g"]))
    leaves = [x.clone().requires_grad_() for x in args[:4]]
    got = attn.FusedDenseAttentionFn.apply(*leaves, *args[4:], H, 2, True, None, fwd_impl)
    (got * t(case["g"])).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    for name, leaf, r in zip("qkv", leaves, ref):
        close_grad(leaf.grad.numpy(), r, name)
    close_grad(leaves[3].grad.numpy(), ref[3], "eb")


def test_core_refusals(case):
    args = core_args(case, True, "torch")
    with pytest.raises(ValueError, match="fwd_impl"):
        attn.fused_dense_attention(*args, H, fwd_impl="xla")
    with pytest.raises(ValueError, match="matmul_dtype"):  # bfloat16 is ported (rows 10b-13b)
        attn.fused_dense_attention_fwd(*args, num_heads=H, matmul_dtype="float16")
    with pytest.raises(ValueError, match="divisible"):
        attn.fused_dense_attention_fwd_v2(*args, num_heads=3)
    with pytest.raises(ValueError, match="eb"):
        attn.fused_dense_attention_fwd_v2(args[0], args[1], args[2], args[3][:, :1], *args[4:], num_heads=H)


def test_custom_vjps_match_jax(case):
    """EdgeBiasScatterFn and MaskedSoftmaxFn: values and input gradients."""
    G = case["Gf"]
    S, Gm = G.scatter_matrix(), G.gather_matrix()
    rng = np.random.default_rng(1)
    B, V = G.node_mask.shape
    eb = rng.standard_normal((B, G.src.shape[1], H)).astype(np.float32)
    g = rng.standard_normal((B, H, V, V)).astype(np.float32)
    out, vjp = jax.vjp(lambda e: jax_dense_attn._edge_bias_scatter(jnp.asarray(S.numpy()), e, jnp.asarray(Gm.numpy())),
                       jnp.asarray(eb))
    leaf = t(eb).requires_grad_()
    got = dense_attn.EdgeBiasScatterFn.apply(S, leaf, Gm)
    (got * t(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    close_grad(leaf.grad.numpy(), vjp(jnp.asarray(g))[0])

    mask = (torch.bmm(S, Gm) > 0)[:, None]
    scores = rng.standard_normal((B, H, V, V)).astype(np.float32)
    out, vjp = jax.vjp(lambda s: jax_dense_attn._masked_softmax(s, jnp.asarray(mask.numpy())), jnp.asarray(scores))
    leaf = t(scores).requires_grad_()
    got = dense_attn.MaskedSoftmaxFn.apply(leaf, mask)
    (got * t(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    close_grad(leaf.grad.numpy(), vjp(jnp.asarray(g))[0])
    assert not got.detach().numpy()[~np.broadcast_to(mask.numpy(), got.shape)].any()


# -- the modules ----------------------------------------------------------------------------


def check_module(jmodule, module, jG, G, gout):
    """Run ``jmodule`` (params from its init) and ``module`` (carrying those
    params) on the batch ``jG``/``G``; compare the node hiddens and the
    gradients of every parameter and both feature inputs under ``gout``."""
    params = jmodule.init(jax.random.PRNGKey(0), jG)["params"]

    def f(params, nf, ef):
        out = jmodule.apply({"params": params}, jG.update(node_feats=nf, edge_feats=ef)).node_feats
        return (out * gout).sum(), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(params, jG.node_feats, jG.edge_feats)
    sd = params_from_jax({"modules__m": jax.device_get(params)})
    module.load_state_dict({k.removeprefix("m."): v for k, v in sd.items()})
    nf, ef = G.node_feats.clone().requires_grad_(), G.edge_feats.clone().requires_grad_()
    got = module(G.update(node_feats=nf, edge_feats=ef)).node_feats
    (got * t(gout)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    ref = params_from_jax({"modules__m": jax.device_get(grads[0])})
    scale = max(float(r.abs().max()) for r in ref.values())
    named = dict(module.named_parameters())
    assert sorted(named) == sorted(k.removeprefix("m.") for k in ref)
    for name, p in named.items():
        close_grad(p.grad.numpy(), ref[f"m.{name}"].numpy(), name, scale if name.endswith(ZERO_GRADS) else None)
    close_grad(nf.grad.numpy(), grads[1], "node_feats")
    # a module that reads no edge feature leaves them no gradient (JAX: zeros)
    close_grad(np.zeros(ef.shape, np.float32) if ef.grad is None else ef.grad.numpy(), grads[2], "edge_feats")


SELF_ATTENTION = [("jnp", b, "jnp", True) for b in ("two_step", "factored_vjp", "einsum3", "auto")] + [
    ("fused", "auto", "jnp", True), ("fused", "auto", "pallas", True), ("auto", "auto", "pallas", False),
    ("jnp", "auto", "jnp", False)]


@pytest.mark.parametrize("impl, bias_impl, fwd_impl, edge_bias", SELF_ATTENTION)
def test_dense_self_attention_matches_jax(case, impl, bias_impl, fwd_impl, edge_bias):
    kw = dict(hidden_dim=D, num_heads=H, impl=impl, bias_impl=bias_impl, fwd_impl=fwd_impl, edge_bias=edge_bias,
              bins_per_tile=2)
    check_module(jax_dense_attn.DenseGraphSelfAttention(**kw, interpret=True),
                 dense_attn.DenseGraphSelfAttention(**kw), case["jGf"], case["Gf"], case["gout"])


def test_dense_gatv2_layer_matches_jax(case):
    check_module(jax_dense_attn.DenseGATv2Layer(hidden_dim=D, num_heads=H),
                 dense_attn.DenseGATv2Layer(hidden_dim=D, num_heads=H), case["jGf"], case["Gf"], case["gout"])


@pytest.mark.parametrize("kw", [{"attention": "sdp"}, {"attention": "sdp", "impl": "fused", "fwd_impl": "pallas"},
                                {"attention": "gatv2"}, {"attention": "sdp", "residual": False, "ffn_mult": 1}])
def test_dense_gat_block_matches_jax(case, kw):
    kw = dict(hidden_dim=D, depth=2, num_heads=H, **kw)
    check_module(jax_dense_attn.DenseGATBlock(**kw, interpret=True, bins_per_tile=2),
                 dense_attn.DenseGATBlock(**kw, bins_per_tile=2), case["jGf"], case["Gf"], case["gout"])


@pytest.fixture(scope="module")
def flat_batch():
    """The molecules as one flat padded batch in both packages, random
    float features on every lane, and a cotangent."""
    bg = graph.pad_graphs([PIPE(s) for s in SMIS], 128, 256, graph_cap=12, np_out=True)
    jbg = jax_graph.pad_graphs([JAX_PIPE(s) for s in SMIS], 128, 256, graph_cap=12, np_out=True)
    rng = np.random.default_rng(2)
    nf, ef, g = (rng.standard_normal(s).astype(np.float32) for s in ((128, D), (256, D), (128, D)))
    jG = jax.tree.map(jnp.asarray, jbg.update(node_feats=nf, edge_feats=ef))
    return jG, bg.to("cpu").update(node_feats=t(nf), edge_feats=t(ef)), g


@pytest.mark.parametrize("name", ["GATv2Layer", "GraphSelfAttention", "GATBlock-gatv2", "GATBlock-sdp"])
def test_flat_attention_matches_jax(flat_batch, name):
    cls, _, attention = name.partition("-")
    kw = dict(hidden_dim=D, num_heads=H, **({"depth": 2, "attention": attention} if attention else {}))
    check_module(getattr(jax_flat, cls)(**kw), getattr(flat, cls)(**kw), *flat_batch)


READOUTS = ["PackedSum", "PackedMean", "PackedMax", "PackedGated", "PackedSDPAttention", "DenseGated",
            "DenseSDPAttention"]


@pytest.mark.parametrize("name", READOUTS)
def test_readouts_match_jax(case, name):
    """Each readout on the case's batch (the packed ones fall back to the
    per-molecule form on the dense layout): outputs and the gradients of its
    parameters and of the node hiddens."""
    jG, G = case["jGf"], case["Gf"]
    key_dim = {"key_dim": D} if name.endswith("SDPAttention") else {}
    jmod = getattr(jax_readouts, name)(**key_dim)
    mod = getattr(readouts, name)(**key_dim, **({"input_dim": D} if name.endswith("Gated") else {}))
    params = jmod.init(jax.random.PRNGKey(3), jG).get("params", {})
    rng = np.random.default_rng(4)
    n = G.n_mols if (case["layout"] == "packed" and name.startswith("Packed")) else G.n_graphs
    g = rng.standard_normal((n, D)).astype(np.float32)

    def f(params, nf):
        out = jmod.apply({"params": params}, jG.update(node_feats=nf))
        return (out * g).sum(), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, jG.node_feats)
    if params:
        sd = params_from_jax({"modules__m": jax.device_get(params)})
        mod.load_state_dict({k.removeprefix("m."): v for k, v in sd.items()})
    nf = G.node_feats.clone().requires_grad_()
    got = mod(G.update(node_feats=nf))
    (got * t(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    close_grad(nf.grad.numpy(), grads[1], "node_feats")
    if params:
        ref = params_from_jax({"modules__m": jax.device_get(grads[0])})
        scale = max(float(r.abs().max()) for r in ref.values())
        for pname, p in mod.named_parameters():
            # the gated score's bias moves no softmax: zero in exact arithmetic
            close_grad(p.grad.numpy(), ref[f"m.{pname}"].numpy(), pname, scale if pname == "a.bias" else None)


@pytest.mark.parametrize("spec", [
    {"class": "DenseGATBlock", "args": {"hidden_dim": D, "depth": 2, "num_heads": H}},
    {"class": "DenseGATBlock", "args": {"hidden_dim": D, "depth": 1, "num_heads": H, "attention": "gatv2"}},
    {"class": "DenseGraphSelfAttention", "args": {"hidden_dim": D, "num_heads": H, "edge_bias": False}},
    {"class": "GATBlock", "args": {"hidden_dim": D, "depth": 2, "num_heads": H, "attention": "sdp"}},
    {"class": "GATv2Layer", "args": {"hidden_dim": D, "num_heads": H, "use_edge_feats": False}},
])
def test_attention_params_round_trip(case, flat_batch, spec):
    """params_from_jax maps every attention group onto the port module's
    state_dict, shapes and names, and params_to_jax gives the tree back
    leaf for leaf."""
    from notorch_tpu.cli import registry as jax_registry
    from notorch_tpu_torch.cli import registry

    jG = case["jGf"] if spec["class"].startswith("Dense") else flat_batch[0]
    params = jax_registry.build(spec).init(jax.random.PRNGKey(0), jG)["params"]
    tree = {"modules__mp": jax.device_get(params)}
    sd = params_from_jax(tree)
    module = registry.build(spec)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        f"mp.{k}": tuple(v.shape) for k, v in module.state_dict().items()}
    back = dict(jax.tree_util.tree_flatten_with_path(params_to_jax(sd))[0])
    flat_tree = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat_tree) == len(back)
    for path, leaf in flat_tree:
        np.testing.assert_array_equal(np.asarray(leaf), back[path])


def test_module_refusals():
    assert dense_attn.DenseGATBlock(hidden_dim=D, dropout=0.1).dropout.rate == 0.1  # dropout is ported
    with pytest.raises(ValueError, match="dtype"):  # bfloat16 is ported
        flat.GATBlock(hidden_dim=D, dtype="float16")
    with pytest.raises(ValueError, match="attention"):
        dense_attn.DenseGATBlock(hidden_dim=D, attention="linear")
    with pytest.raises(ValueError, match="bias_impl"):
        dense_attn.DenseGraphSelfAttention(hidden_dim=D, bias_impl="einsum4")
    with pytest.raises(ValueError, match="divisible"):
        dense_attn.DenseGATv2Layer(hidden_dim=D, num_heads=3)
