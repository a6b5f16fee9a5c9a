"""The fused GVP message convolution (TPU kernel rows 14-15) and the GVP
stack against the JAX package.

The plain versions of the kernels against JAX's ``fused_gvp_conv_fwd`` and
``fused_gvp_conv_bwd`` in interpret mode at a tiny shape (N = 128, K = 8,
ds = 16, dv = 4, window 24) and two tiles; :class:`GvpConv` and
:class:`GvpGNNBlock` with ``impl`` fused and jnp against JAX's jnp path
(which ``tests/test_spatial.py`` holds equal to its fused path), outputs and
the gradients of every parameter and of the coordinates, on shared
weights. Tolerances: forward rtol = atol = 1e-4; each gradient rtol = 1e-4
and atol 1e-4 times its largest magnitude (a weight gradient sums N K
products, so an element's rounding follows the size of its terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from notorch_tpu.data.point_cloud import PointCloud as JaxPointCloud
from notorch_tpu.data.point_cloud import pad_point_clouds as jax_pad_point_clouds
from notorch_tpu.kernels import gvp_conv as jax_gvp_conv
from notorch_tpu.nn.spatial.gvp import GvpGNNBlock as JaxGvpGNNBlock
from notorch_tpu_torch.data.point_cloud import PointCloud, make_clouds, pad_point_clouds
from notorch_tpu_torch.kernels import gvp_conv
from notorch_tpu_torch.model.convert import params_from_jax, params_to_jax
from notorch_tpu_torch.nn.spatial.gvp import GvpConv, GvpGNNBlock
from notorch_tpu_torch.nn.spatial.neighbors import radius_neighbors

TOL = dict(rtol=1e-4, atol=1e-4)
N, K, DS, DV, NB, WINDOW = 128, 8, 16, 4, 16, 24


def close_grad(got, ref, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()), err_msg=name)


def kernel_inputs(seed=0):
    """Kernel operands on clouds of 10-25 atoms padded to N: the banded
    neighbour lists of radius 5, seeded features, edge features and split
    weights (numpy)."""
    rng = np.random.default_rng(seed)
    clouds = make_clouds(6, seed=seed)
    P = pad_point_clouds(clouds, N)
    nbrs, mask, _ = radius_neighbors(torch.from_numpy(P.coords), torch.from_numpy(P.batch_index), 5.0, K,
                                     window=WINDOW)
    f = lambda *shape, scale=1.0: (scale * rng.standard_normal(shape)).astype(np.float32)  # noqa: E731
    u = f(N * K, 3)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    ws = [f(*shape, scale=0.4 if len(shape) == 2 else 0.1) for shape in gvp_conv.weight_shapes(DS, DV, NB)]
    return dict(s=f(N, DS), v=[f(N, DV) for _ in range(3)], nbrs=nbrs.numpy(), mask=mask.numpy(),
                rbf=np.exp(-f(N * K, NB) ** 2), u=[u[:, i: i + 1].copy() for i in range(3)], w=ws,
                g_s=f(N, DS), g_v=[f(N, DV) for _ in range(3)])


def test_split_and_merge_round_trip_equal_jax():
    x = kernel_inputs(1)
    rng = np.random.default_rng(2)
    h0 = 2 * DV + 1
    shapes = {"message_0": {"W_h": (h0, h0), "W_mu": (h0, DV), "W_m": (2 * DS + NB + h0, DS), "W_g": (DS, DV)},
              "message_1": {"W_h": (DV, DV), "W_mu": (DV, DV), "W_m": (DS + DV, DS), "W_g": (DS, DV)}}
    shapes["message_2"] = shapes["message_1"]
    tree = {m: {k: {"kernel": rng.standard_normal(s).astype(np.float32),
                    **({"bias": rng.standard_normal(s[1]).astype(np.float32)} if k in ("W_m", "W_g") else {})}
                for k, s in layers.items()} for m, layers in shapes.items()}
    ours = gvp_conv.split_gvp_weights(jax.tree.map(torch.from_numpy, tree), DS, DV, NB)
    theirs = jax_gvp_conv.split_gvp_weights(jax.tree.map(jnp.asarray, tree), DS, DV, NB)
    assert len(ours) == gvp_conv.N_W == len(theirs)
    assert [tuple(w.shape) for w in ours] == gvp_conv.weight_shapes(DS, DV, NB)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    merged = gvp_conv.merge_gvp_weight_grads(ours)
    for leaf, ref in zip(jax.tree.leaves(merged), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(leaf.numpy(), ref)
    assert x["w"][0].shape == (DV, h0)


@pytest.mark.parametrize("tile", [64, 32])
def test_plain_versions_equal_jax_interpret(tile):
    """gvp_conv_reference and gvp_conv_bwd_reference (what CPU tensors run
    in fused_gvp_conv_fwd/bwd) against the JAX kernels in interpret mode at
    two tiles: the four outputs, then every cotangent (features, rbf2d,
    unit vectors and all 25 weights)."""
    x = kernel_inputs()
    jargs = [jnp.asarray(a) for a in (x["s"], *x["v"], x["nbrs"], x["mask"], x["rbf"], *x["u"])]
    targs = [torch.from_numpy(a) for a in (x["s"], *x["v"], x["nbrs"], x["mask"], x["rbf"], *x["u"])]
    jw, tw = tuple(jnp.asarray(w) for w in x["w"]), [torch.from_numpy(w) for w in x["w"]]
    ref = jax_gvp_conv.fused_gvp_conv_fwd(*jargs, jw, window=WINDOW, tile=tile, interpret=True)
    before = gvp_conv.fused_gvp_conv_fwd.launches
    out = gvp_conv.fused_gvp_conv_fwd(*targs, tw, window=WINDOW, tile=tile)
    assert gvp_conv.fused_gvp_conv_fwd.launches == before  # the CPU runs no kernel
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    cot = [x["g_s"], *x["g_v"]]
    ref = jax_gvp_conv.fused_gvp_conv_bwd(*jargs, jw, *(jnp.asarray(c) for c in cot), window=WINDOW, tile=tile,
                                          interpret=True)
    got = gvp_conv.fused_gvp_conv_bwd(*targs, tw, *(torch.from_numpy(c) for c in cot), window=WINDOW, tile=tile)
    names = ["g_s", "g_vx", "g_vy", "g_vz", "g_rbf2d", "g_ux", "g_uy", "g_uz"]
    for name, a, b in zip(names, got[:8], ref[:8]):
        close_grad(a, b, name)
    assert len(got[8]) == len(ref[8]) == 25
    for i, (a, b) in enumerate(zip(got[8], ref[8])):
        close_grad(a, b, f"weight {i}")


def test_kernel_entries_refuse_as_jax():
    x = kernel_inputs()
    args = [torch.from_numpy(a) for a in (x["s"], *x["v"], x["nbrs"], x["mask"], x["rbf"], *x["u"])]
    w = [torch.from_numpy(a) for a in x["w"]]
    with pytest.raises(ValueError, match="multiple of 8"):
        gvp_conv.fused_gvp_conv_fwd(*args, w, window=25)
    with pytest.raises(ValueError, match="multiple of 8"):
        jax_gvp_conv._prep(jnp.asarray(x["s"]), None, jnp.asarray(x["nbrs"]), None, 25, 64)
    odd = [a[:100] for a in args[:6]] + [a[:800] for a in args[6:]]  # N = 100: the tile falls to 4
    with pytest.raises(ValueError, match="not tileable"):
        gvp_conv.fused_gvp_conv_fwd(*odd, w, window=WINDOW)
    with pytest.raises(ValueError, match="25 split weights"):
        gvp_conv.fused_gvp_conv_fwd(*args, w[:24], window=WINDOW)
    with pytest.raises(ValueError, match="split weight 4"):
        gvp_conv.fused_gvp_conv_fwd(*args, w[:4] + [w[4][:, :8]] + w[5:], window=WINDOW)


def clouds_case(case):
    """Clouds padded to N = 128 slots: ``random`` (make_clouds), ``isolated``
    (one atom 100 A from the rest of its cloud: an empty neighbourhood) or
    ``edge`` (a 25-atom cloud packed tight enough that each atom sees its
    K nearest, the whole cloud spanning the band of window 24)."""
    rng = np.random.default_rng(11)
    clouds = make_clouds(5, seed=3)
    if case == "isolated":
        c = clouds[0]
        coords = c.coords.copy()
        coords[4] += 100.0
        clouds[0] = PointCloud(c.node_types, coords)
    if case == "edge":
        coords = rng.uniform(0, 2.5, size=(25, 3)).astype(np.float32)
        clouds = [PointCloud(rng.integers(0, 9, (25, 1)).astype(np.int32), coords)] + clouds[:3]
    return clouds


def both_clouds(clouds, feats):
    P = pad_point_clouds(clouds, N)
    jP = jax_pad_point_clouds([JaxPointCloud(c.node_types, c.coords) for c in clouds], N)
    return P.update(node_feats=feats).to("cpu"), jP.replace(node_feats=jnp.asarray(feats))


def port_weights(params):
    return {k[len("b."):]: v for k, v in params_from_jax({"modules__b": jax.device_get(params)}).items()}


@pytest.mark.parametrize("impl, window, case", [("fused", 24, "random"), ("jnp", 24, "random"),
                                                ("fused", 25, "random"), ("fused", 24, "isolated"),
                                                ("jnp", 24, "isolated"), ("fused", 24, "edge")])
def test_gvp_block_equals_jax(impl, window, case):
    """GvpGNNBlock (depth 2) with impl fused or jnp against JAX's jnp block
    on the same weights: node outputs, the loss sum(sin(out)), every
    parameter's gradient and the real atoms' coordinate gradients. Window 25
    builds its neighbours banded at 25 and runs the kernels' band at 32."""
    clouds = clouds_case(case)
    feats = np.random.default_rng(5).standard_normal((N, DS)).astype(np.float32)
    P, jP = both_clouds(clouds, feats)
    kw = dict(scalar_dim=DS, vector_dim=DV, depth=2, radius=5.0, max_neighbors=K, neighbor_window=window)
    jblock = JaxGvpGNNBlock(**kw, impl="jnp")
    params = jblock.init(jax.random.PRNGKey(0), jP)["params"]

    def jloss(p, coords):
        return jnp.sum(jnp.sin(jblock.apply({"params": p}, jP.replace(coords=coords)).node_feats))

    ref_out = np.asarray(jax.jit(jblock.apply)({"params": params}, jP).node_feats)
    ref_loss, (ref_gp, ref_gc) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(params, jP.coords)
    block = GvpGNNBlock(**kw, impl=impl, input_dim=DS)
    block.load_state_dict(port_weights(params))
    coords = P.coords.clone().requires_grad_()
    out = block(P.update(coords=coords)).node_feats
    np.testing.assert_allclose(out.detach().numpy(), ref_out, **TOL)
    loss = torch.sin(out).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-4)
    ref_grads = port_weights(ref_gp)
    # the last update GVP's vector path reaches no output: JAX's zeros, autograd's None
    got = {name: torch.zeros_like(p) if p.grad is None else p.grad for name, p in block.named_parameters()}
    assert sorted(got) == sorted(ref_grads)
    for name, g in got.items():
        close_grad(g.numpy(), ref_grads[name].numpy(), name)
    real = P.node_mask.numpy()
    close_grad(coords.grad.numpy()[real], np.asarray(ref_gc)[real], "coords")
    assert np.isfinite(coords.grad.numpy()[real]).all()
    if case == "isolated":
        nbrs, mask, _ = radius_neighbors(P.coords, P.batch_index, 5.0, K, window=window)
        assert not mask[4].any()


def test_gvp_conv_refusals():
    P = pad_point_clouds(make_clouds(4, seed=0), 96).to("cpu")
    s, v = torch.zeros(96, DS), torch.zeros(96, 3, DV)
    with pytest.raises(ValueError, match="divisible by 64"):  # N = 96
        GvpConv(DS, DV, neighbor_window=24, impl="fused")((s, v), P)
    with pytest.raises(ValueError, match="neighbor_window set"):
        GvpConv(DS, DV, impl="fused")((s[:64], v[:64]), P)
    with pytest.raises(ValueError, match="num_message_gvps=3"):
        GvpConv(DS, DV, neighbor_window=24, num_message_gvps=2, impl="fused")((s[:64], v[:64]), P)
    with pytest.raises(ValueError, match="dropout=0"):  # dropout is ported, but not in the kernels
        GvpConv(DS, DV, neighbor_window=24, dropout=0.1, impl="fused")((s[:64], v[:64]), P)
    with pytest.raises(ValueError, match="f32"):  # the fused conv is f32 only, as in JAX; the plain conv takes bf16
        GvpConv(DS, DV, neighbor_window=24, dtype="bfloat16", impl="fused")((s[:64], v[:64]), P)
    with pytest.raises(ValueError, match="impl"):
        GvpConv(DS, DV, impl="pallas")


def test_gvp_weights_round_trip_through_jax():
    block = GvpGNNBlock(scalar_dim=DS, vector_dim=DV, depth=2, impl="fused", neighbor_window=24, input_dim=8)
    block.reset_parameters(torch.Generator().manual_seed(0))
    sd = block.state_dict()
    tree = params_to_jax({f"b.{k}": v for k, v in sd.items()})["modules__b"]
    assert tree["in_proj"]["kernel"].shape == (8, DS)
    assert sorted(tree["layer_0"]) == ["conv", "ln", "update_0", "update_1"]
    assert tree["layer_1"]["conv"]["ln"]["scalar_ln"]["scale"].shape == (DS,)
    back = port_weights(tree)
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
