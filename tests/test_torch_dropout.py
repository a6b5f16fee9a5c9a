"""The port's one dropout (``nn/dropout.py``) and every site that uses it,
against the JAX package on the CPU.

- :class:`Dropout`'s semantics: the identity at rate 0 and out of training,
  zeros at rate 1, ``where(mask, x / keep, 0)`` otherwise (flax's division,
  bit for bit); the keep share within binomial bounds over 10^6 elements;
  masks that differ call to call; masks that a resumed run draws as an
  uninterrupted one does.
- Each dropout site against its JAX module at ``training=True``, forward
  and gradients, with the same masks in both: ``jax.random.bernoulli``
  (which flax's ``Dropout`` and ``DualRankDropout`` call) and the port's
  ``Dropout.mask`` are both replaced by draws from one seeded numpy stream,
  in call order, and the shapes each side asks for must agree.

Tolerances: rtol = atol = 1e-5 on values (f32 on both sides, the same masks,
sums in other orders over at most depth 2); gradients atol 1e-5 times the
tensor's largest magnitude (weight gradients sum over every row); the GVP
block at tests/test_torch_gvp.py's 1e-4. The
dropout itself is held bit for bit against flax's: the same mask gives
JAX's bits, forward and backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import notorch_tpu.nn.attention as jax_flat
import notorch_tpu.nn.attention_dense as jax_dense_attn
from notorch_tpu.data import dense as jax_dense
from notorch_tpu.data import graph as jax_graph
from notorch_tpu.nn.chemprop import ChempropBlock as JaxChempropBlock
from notorch_tpu.nn.mlp import MLP as JaxMLP
from notorch_tpu.nn.spatial import gvp as jax_gvp
from notorch_tpu.transforms import MolToGraph as JaxMolToGraph
from notorch_tpu.transforms import Pipeline as JaxPipeline
from notorch_tpu.transforms import SmiToMol as JaxSmiToMol
from notorch_tpu_torch.data import dense, graph
from notorch_tpu_torch.model.convert import params_from_jax
from notorch_tpu_torch.models.dmpnn import build_dmpnn
from notorch_tpu_torch.nn import attention as flat
from notorch_tpu_torch.nn import attention_dense as dense_attn
from notorch_tpu_torch.nn.chemprop import ChempropBlock
from notorch_tpu_torch.nn.dropout import Dropout, keep_mask
from notorch_tpu_torch.nn.mlp import MLP
from notorch_tpu_torch.nn.spatial import gvp
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol

PIPE = Pipeline(SmiToMol(), MolToGraph())
JAX_PIPE = JaxPipeline(JaxSmiToMol(), JaxMolToGraph())
SMIS = ["CCO", "c1ccccc1C(=O)O", "CC(C)CC(N)C(=O)O", "O", "CCN(CC)CC", "NC(=O)c1ccccc1", "OCC(O)CO"]
D, H, RATE = 16, 4, 0.25
TOL = dict(rtol=1e-5, atol=1e-5)
ZERO_GRADS = ("W_k.bias", "W_bias.bias", "a.bias")


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def close_grad(got, ref, name="", tol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=tol, atol=tol * float(np.abs(ref).max()),
                               err_msg=name)


# -- the module -----------------------------------------------------------------------


def test_dropout_semantics():
    """Rate 0 and eval mode are the identity, rate 1 gives zeros, and
    otherwise the output is where(mask, x / keep, 0) with the module's own
    mask, bit for bit what flax computes for that mask."""
    x = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
    drop = Dropout(0.0).train()
    assert drop(x) is x and drop.generator is None
    drop = Dropout(0.3)
    drop.reset_parameters(torch.Generator().manual_seed(1))
    assert drop.eval()(x) is x
    assert torch.equal(Dropout(1.0).train()(x), torch.zeros_like(x))
    drop.train()
    state = drop.generator.get_state()
    out = drop(x)
    drop.generator.set_state(state)
    mask = drop.mask(x.shape, x.device)
    assert torch.equal(out, torch.where(mask, x / torch.tensor(0.7), 0.0))
    ref = jax.lax.select(jnp.asarray(mask.numpy()), jnp.asarray(x.numpy()) / 0.7, jnp.zeros(x.shape))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="rate"):
        Dropout(1.5)


def test_keep_share_is_binomial_and_masks_differ_call_to_call():
    """10^6 elements at keep 0.9 keep a share within 5 standard deviations of
    0.9, in each of two calls, whose masks differ where two independent masks
    would (2 p (1 - p) of the elements, within 5 deviations)."""
    n, keep = 10**6, 0.9
    drop = Dropout(1 - keep)
    drop.reset_parameters(torch.Generator().manual_seed(3))
    a, b = drop.mask((1000, 1000), "cpu"), drop.mask((1000, 1000), "cpu")
    sd = np.sqrt(n * keep * (1 - keep))
    for m in (a, b):
        assert abs(int(m.sum()) - n * keep) < 5 * sd
    p_diff = 2 * keep * (1 - keep)
    assert abs(int((a != b).sum()) - n * p_diff) < 5 * np.sqrt(n * p_diff * (1 - p_diff))
    # the mask is a pure function of the seed
    assert torch.equal(keep_mask(7, (50, 20), keep, "cpu"), keep_mask(7, (50, 20), keep, "cpu"))
    assert not torch.equal(keep_mask(7, (50, 20), keep, "cpu"), keep_mask(8, (50, 20), keep, "cpu"))


def test_masks_after_a_resume_are_the_uninterrupted_runs(tmp_path):
    """Three train steps of a D-MPNN with edge dropout (the plain dense
    block and the FFN), and the same run stopped after one step, its
    parameters and training state saved and loaded into a model built from
    another seed: the resumed run ends with the uninterrupted run's bits,
    so it drew the same masks."""
    from notorch_tpu_torch.cli.train import build_dataset
    from notorch_tpu_torch.data.batching import DataLoader
    from notorch_tpu_torch.training.loop import to_device

    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    csv_path = tmp_path / "lipo.csv"
    with open(os.path.join(root, "tests", "data", "lipo.csv")) as f:
        csv_path.write_text("".join(f.readlines()[:25]))
    ds = build_dataset({"csv": str(csv_path), "targets": {"y": {"columns": ["lipo"]}}})
    batches = [to_device(b, "cpu") for b in list(DataLoader(ds, batch_size=8, layout="dense"))[:3]]

    def model(seed):
        return build_dmpnn(hidden_dim=D, depth=2, dropout=0.2, generator=torch.Generator().manual_seed(seed))

    whole = model(0)
    for batch in batches:
        whole.train_step(batch)
    first = model(0)
    first.train_step(batches[0])
    torch.save({"params": first.network.state_dict(), "train": first.train_state_dict()}, tmp_path / "ck.pt")
    resumed = model(1)
    saved = torch.load(tmp_path / "ck.pt", weights_only=False)
    resumed.network.load_state_dict(saved["params"])
    resumed.load_train_state_dict(saved["train"])
    assert set(resumed.generators()) == {"mp.dropout", "ffn.dropout"}
    for batch in batches[1:]:
        resumed.train_step(batch)
    for (name, a), b in zip(whole.network.state_dict().items(), resumed.network.state_dict().values()):
        assert torch.equal(a, b), name


# -- the sites against JAX, with injected masks ------------------------------------------


class MaskStream:
    """Bernoulli masks from one seeded numpy stream, in call order; the
    shapes asked for are recorded."""

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)
        self.shapes = []

    def __call__(self, shape, keep):
        self.shapes.append(tuple(int(s) for s in shape))
        return self.rng.random(self.shapes[-1]) < keep


@pytest.fixture
def masks(monkeypatch):
    """Patch both packages to draw their masks from two identical streams;
    yields (jax_stream, port_stream)."""
    js, ps = MaskStream(), MaskStream()
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p=0.5, shape=None: jnp.asarray(js(shape, p)))
    monkeypatch.setattr(Dropout, "mask",
                        lambda self, shape, device: torch.from_numpy(ps(shape, 1.0 - self.rate)).to(device))
    yield js, ps
    assert js.shapes == ps.shapes and js.shapes, (js.shapes, ps.shapes)


def load(module, params):
    sd = params_from_jax({"modules__m": jax.device_get(params)})
    module.load_state_dict({k.removeprefix("m."): v for k, v in sd.items()}, strict=False)
    return module.train()


def check_grads(module, grads, inputs, jgrads, tol=1e-5):
    """Every parameter's and input's gradient; those that are zero in exact
    arithmetic (ZERO_GRADS: a bias the softmax cancels) against the largest
    gradient of all, as rounding leaves them."""
    ref = params_from_jax({"modules__m": jax.device_get(grads)})
    named = dict(module.named_parameters())
    assert sorted(named) == sorted(k.removeprefix("m.") for k in ref)
    scale = max(float(r.abs().max()) for r in ref.values())
    for name, p in named.items():
        r = ref[f"m.{name}"].numpy()
        got = np.zeros_like(r) if p.grad is None else p.grad.numpy()  # unused here (JAX: zeros)
        if name.endswith(ZERO_GRADS):
            np.testing.assert_allclose(got, r, rtol=tol, atol=tol * scale, err_msg=name)
        else:
            close_grad(got, r, name, tol)
    for i, (x, g) in enumerate(zip(inputs, jgrads)):
        close_grad(x.grad.numpy(), g, f"input {i}", tol)


def test_mlp_dropout_matches_jax(masks):
    """The MLP head (dropout after every hidden activation), the same masks
    in both: outputs and gradients agree at the stated tolerance (on the
    parent, whose MLP drew its own masks, they do not)."""
    rng = np.random.default_rng(1)
    x, g = rng.standard_normal((12, D)).astype(np.float32), rng.standard_normal((12, 3)).astype(np.float32)
    jm = JaxMLP(input_dim=D, output_size=3, hidden_dim=D, num_layers=3, dropout=RATE)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def f(params, x):
        out = jm.apply({"params": params}, x, training=True, rngs={"dropout": jax.random.PRNGKey(1)})
        return (out * g).sum(), out

    (_, ref), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    module = load(MLP(input_dim=D, output_size=3, hidden_dim=D, num_layers=3, dropout=RATE), params)
    xt = t(x).requires_grad_()
    out = module(xt)
    (out * t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    check_grads(module, grads[0], [xt], [grads[1]])


def test_dropout_gives_flax_bits(masks):
    """The same mask through flax's Dropout and the port's gives the same
    bits, forward and gradient (the MLP's nn.Dropout multiplied by 1 / keep
    and drew from torch's global generator)."""
    import flax.linen as fnn

    rng = np.random.default_rng(6)
    x, g = rng.standard_normal((40, 24)).astype(np.float32), rng.standard_normal((40, 24)).astype(np.float32)
    for rate in (0.1, RATE, 0.5):
        def f(x):
            out = fnn.Dropout(rate, deterministic=False).apply({}, x, rngs={"dropout": jax.random.PRNGKey(0)})
            return (out * g).sum(), out

        (_, ref), jg = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
        xt = t(x).requires_grad_()
        out = Dropout(rate).train()(xt)
        (out * t(g)).sum().backward()
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))


def _flat_case():
    bg = graph.pad_graphs([PIPE(s) for s in SMIS], 96, 192, graph_cap=8, np_out=True)
    jbg = jax_graph.pad_graphs([JAX_PIPE(s) for s in SMIS], 96, 192, graph_cap=8, np_out=True)
    rng = np.random.default_rng(2)
    nf, ef = (rng.standard_normal(s).astype(np.float32) for s in ((96, D), (192, D)))
    jG = jax.tree.map(jnp.asarray, jbg.update(node_feats=nf, edge_feats=ef))
    return jG, bg.to("cpu").update(node_feats=t(nf), edge_feats=t(ef)), rng


def _dense_case():
    graphs, jgraphs = [PIPE(s) for s in SMIS], [JAX_PIPE(s) for s in SMIS]
    n_bins = len(dense.plan_bins(graphs, 32, 64))
    n_bins += n_bins % 2
    G = dense.pack_graphs_dense(graphs, 32, 64, bin_cap=n_bins, np_out=True)
    jG = jax_dense.pack_graphs_dense(jgraphs, 32, 64, bin_cap=n_bins, np_out=True)
    rng = np.random.default_rng(3)
    B, V = G.node_mask.shape
    nf, ef = rng.standard_normal((B, V, D)).astype(np.float32), rng.standard_normal((B, 64, D)).astype(np.float32)
    jGf = jax.tree.map(jnp.asarray, jG.update(node_feats=nf, edge_feats=ef))
    return jGf, G.to("cpu").update(node_feats=t(nf), edge_feats=t(ef)), rng


def check_graph_module(jmodule, module, jG, G, rng, out_field="node_feats"):
    """Run both modules in training mode on the batch, compare ``out_field``
    and the gradients of every parameter and both feature inputs."""
    params = jmodule.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jG)["params"]
    gout = rng.standard_normal(getattr(G, out_field).shape).astype(np.float32)

    def f(params, nf, ef):
        out = jmodule.apply({"params": params}, jG.update(node_feats=nf, edge_feats=ef), training=True,
                            rngs={"dropout": jax.random.PRNGKey(2)})
        out = getattr(out, out_field)
        return (out * gout).sum(), out

    (_, ref), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(params, jG.node_feats, jG.edge_feats)
    module = load(module, params)
    nf, ef = G.node_feats.clone().requires_grad_(), G.edge_feats.clone().requires_grad_()
    out = getattr(module(G.update(node_feats=nf, edge_feats=ef)), out_field)
    (out * t(gout)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    if ef.grad is None:
        ef.grad = torch.zeros_like(ef)
    check_grads(module, grads[0], [nf, ef], grads[1:])


@pytest.mark.parametrize("kw", [{}, {"shared": True}, {"reduce": "max", "residual": False}])
def test_flat_block_dropout_matches_jax(masks, kw):
    """The flat block drops each layer's update before the residual add (one
    mask a layer, in layer order)."""
    jG, G, rng = _flat_case()
    check_graph_module(JaxChempropBlock(hidden_dim=D, depth=2, dropout=RATE, **kw),
                       ChempropBlock(hidden_dim=D, depth=2, dropout=RATE, **kw), jG, G, rng, "edge_feats")


@pytest.mark.parametrize("kw", [{"attention": "sdp"}, {"attention": "gatv2"},
                                {"attention": "sdp", "impl": "fused", "fwd_impl": "pallas"}])
def test_dense_gat_block_dropout_matches_jax(masks, kw):
    """DenseGATBlock: one dropout twice a layer, on the attention output
    and on the FFN output (with impl fused, rows 12-13 run in every layer)."""
    jG, G, rng = _dense_case()
    kw = dict(hidden_dim=D, depth=2, num_heads=H, dropout=RATE, bins_per_tile=2, **kw)
    check_graph_module(jax_dense_attn.DenseGATBlock(**kw, interpret=True), dense_attn.DenseGATBlock(**kw),
                       jG, G, rng)


@pytest.mark.parametrize("attention", ["gatv2", "sdp"])
def test_flat_gat_block_dropout_matches_jax(masks, attention):
    jG, G, rng = _flat_case()
    kw = dict(hidden_dim=D, depth=2, num_heads=H, attention=attention, dropout=RATE)
    check_graph_module(jax_flat.GATBlock(**kw), flat.GATBlock(**kw), jG, G, rng)


def test_dual_rank_dropout_matches_jax(masks):
    """Scalars element-wise, vectors channel-wise: the vector mask is
    [..., 1, channels], so a dropped channel zeroes all 3 components."""
    rng = np.random.default_rng(4)
    s, v = rng.standard_normal((20, 6, 8)).astype(np.float32), rng.standard_normal((20, 6, 3, 4)).astype(np.float32)
    js, jv = jax_gvp.DualRankDropout(RATE).apply({}, (jnp.asarray(s), jnp.asarray(v)), training=True,
                                                 rngs={"dropout": jax.random.PRNGKey(0)})
    ps, pv = gvp.DualRankDropout(RATE).train()((t(s), t(v)))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    assert masks[1].shapes == [(20, 6, 8), (20, 6, 1, 4)]
    dropped = (pv == 0).all(dim=2)  # a dropped channel: every component zero
    assert dropped.any() and torch.equal(dropped, (pv == 0).any(dim=2))


def test_gvp_layers_dropout_match_jax(masks):
    """GvpGNNBlock at dropout > 0: the conv's message dropout and the
    layer's update dropout, forward and gradients, at tests/test_torch_gvp.py's
    tolerances (1e-4: the layers' norms and gates round more than the other
    sites' products; 1.7e-5 of the largest weight gradient measured here)."""
    from notorch_tpu.data.point_cloud import PointCloud as JaxPointCloud
    from notorch_tpu.data.point_cloud import pad_point_clouds as jax_pad_clouds
    from notorch_tpu_torch.data.point_cloud import make_clouds, pad_point_clouds

    clouds = make_clouds(4, seed=0)
    rng = np.random.default_rng(5)
    nf = rng.standard_normal((128, 8)).astype(np.float32)
    P = pad_point_clouds(clouds, 128).update(node_feats=nf).to("cpu")
    jP = jax_pad_clouds([JaxPointCloud(c.node_types, c.coords) for c in clouds], 128).replace(
        node_feats=jnp.asarray(nf))
    kw = dict(scalar_dim=8, vector_dim=4, depth=2, max_neighbors=8, dropout=RATE)
    jm = jax_gvp.GvpGNNBlock(**kw)
    params = jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jP)["params"]
    gout = rng.standard_normal((128, 8)).astype(np.float32)

    def f(params, x):
        out = jm.apply({"params": params}, jP.replace(node_feats=x), training=True,
                       rngs={"dropout": jax.random.PRNGKey(2)}).node_feats
        return (out * gout).sum(), out

    (_, ref), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, jP.node_feats)
    module = load(gvp.GvpGNNBlock(**kw, input_dim=8), params)
    x = P.node_feats.clone().requires_grad_()
    out = module(P.update(node_feats=x)).node_feats
    (out * t(gout)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    check_grads(module, grads[0], [x], [grads[1]], tol=1e-4)
