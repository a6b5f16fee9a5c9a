"""The CUDA kernels of the fused D-MPNN block, the fused encoder, the
double-buffered forward, the two CSR segment sums and the attention core
against their plain versions, on the card; the flat block through the
packed sum, the dense attention block through the attention kernels and
the GVP block through the GVP kernels, card against CPU. Skips
where there is no CUDA device. This file imports no JAX, so that it also
runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: rtol=atol=1e-4 for the forward kernels, both sides exact f32
(no TF32) summed in a different order over depth 3. Gradients: rtol=1e-4
and atol 1e-4 times the tensor's largest magnitude, because g_W and g_b sum
B * E products each, so the rounding of an element follows the size of
the terms it sums, not its own size, which cancellation can make small.
The segment sums: bit for bit the plain version on the CPU, which adds
each row's terms in the kernel's order; against the plain version on the
card (atomic adds, in no fixed order) within 1e-5 times the sum of the
absolute values of each element's terms, since the rounding of a sum taken
in another order grows with its terms, not with the sum (a node of the
padding sink or an over-full node sums thousands of terms).
"""

import numpy as np
import pytest
import torch

from notorch_tpu_torch.data.dense import pack_graphs_dense, pad_graphs_dense
from notorch_tpu_torch.data.graph import csr_row_ptr, pad_graphs, sort_edges_by_dst, with_csr_packing
from notorch_tpu_torch.kernels.csr_segment import (
    csr_segment_sum,
    csr_segment_sum_packed,
    csr_segment_sum_packed_reference,
    csr_segment_sum_reference,
    pack_edges_by_tile,
)
from notorch_tpu_torch.kernels.dense_mpnn import (
    dense_encoder_bwd_reference,
    dense_encoder_reference,
    dense_mpnn_block_bwd_reference,
    dense_mpnn_block_reference,
    dense_mpnn_block_stash_reference,
    fused_dense_encoder_bwd,
    fused_dense_encoder_fwd,
    fused_dense_mpnn_block,
    fused_dense_mpnn_block_bwd,
    fused_dense_mpnn_block_bwd_stash,
    fused_dense_mpnn_block_dbuf,
    fused_dense_mpnn_block_stash,
)
from notorch_tpu_torch.kernels.dense_attention import (
    dense_attention_bwd_reference,
    dense_attention_reference,
    fused_dense_attention,
    fused_dense_attention_bwd,
    fused_dense_attention_bwd_v2,
    fused_dense_attention_fwd,
    fused_dense_attention_fwd_v2,
)
from notorch_tpu_torch.data.point_cloud import make_clouds, pad_point_clouds
from notorch_tpu_torch.kernels.gvp_conv import (
    fused_gvp_conv_bwd,
    fused_gvp_conv_fwd,
    gvp_conv_bwd_reference,
    gvp_conv_preactivations,
    gvp_conv_reference,
    weight_shapes,
)
from notorch_tpu_torch.nn.attention_dense import DenseGATBlock
from notorch_tpu_torch.nn.spatial.gvp import GvpGNNBlock
from notorch_tpu_torch.nn.spatial.neighbors import radius_neighbors
from notorch_tpu_torch.nn.chemprop import ChempropBlock
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol

PIPE = Pipeline(SmiToMol(), MolToGraph())
SMIS = ["CCO", "c1ccccc1C(=O)O", "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "NC(=O)c1ccccc1", "O",
        "CC(=O)Nc1ccc(O)cc1", "C1CCNCC1", "FC(F)(F)c1ccccc1"] * 4


@pytest.mark.gpu
@pytest.mark.parametrize("E", [128, 256])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("residual", [True, False])
def test_cuda_kernel_matches_plain_version(E, reduce, residual):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    d, depth = 256, 3
    G = pack_graphs_dense([PIPE(s) for s in SMIS], E // 2 + 8, E, np_out=True)
    B = G.src.shape[0]
    rng = np.random.default_rng(0)
    h0 = rng.standard_normal((B, E, d)).astype(np.float32)
    W = (rng.standard_normal((depth, d, d)) / np.sqrt(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal((depth, d))).astype(np.float32)
    args = [torch.from_numpy(x).cuda() for x in (h0, G.src, G.dst, G.edge_mask, W, b)]
    before = fused_dense_mpnn_block.launches
    out = fused_dense_mpnn_block(*args, depth=depth, n_nodes=E // 2 + 8, residual=residual, reduce=reduce)
    torch.cuda.synchronize()
    assert fused_dense_mpnn_block.launches == before + depth
    ref = dense_mpnn_block_reference(*args, depth=depth, residual=residual, reduce=reduce)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_kernel_rejects_misaligned_state():
    """The kernel reads h in 16-byte vectors: a view that starts 4 bytes into
    its storage is refused before launch, not read wrongly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    d, E = 64, 128
    G = pack_graphs_dense([PIPE(s) for s in SMIS[:8]], E // 2 + 8, E, np_out=True)
    B = G.src.shape[0]
    h0 = torch.zeros(B * E * d + 1, device="cuda")[1:].view(B, E, d)
    args = [h0] + [torch.from_numpy(x).cuda() for x in (G.src, G.dst, G.edge_mask)]
    args += [torch.zeros(1, d, d, device="cuda"), torch.zeros(1, d, device="cuda")]
    with pytest.raises(ValueError, match="16-byte"):
        fused_dense_mpnn_block(*args, depth=1, n_nodes=E // 2 + 8)


def _train_inputs(E, depth, seed=0, d=256):
    """Seeded inputs on the card: nonzero biases, and a cotangent that is
    zero on padded lanes, as the block's masked scatter gives."""
    G = pack_graphs_dense([PIPE(s) for s in SMIS], E // 2 + 8, E, np_out=True)
    B = G.src.shape[0]
    rng = np.random.default_rng(seed)
    h0 = rng.standard_normal((B, E, d)).astype(np.float32)
    W = (rng.standard_normal((depth, d, d)) / np.sqrt(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal((depth, d))).astype(np.float32)
    g = (rng.standard_normal((B, E, d)) * G.edge_mask[..., None]).astype(np.float32)
    return [torch.from_numpy(x).cuda() for x in (h0, G.src, G.dst, G.edge_mask, W, b, g)]


def _close_grads(got, ref):
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("E", [128, 256])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("depth", [1, 3])
def test_cuda_training_kernels_match_plain_versions(E, reduce, residual, depth):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    h0, src, dst, mask, W, b, g = _train_inputs(E, depth)
    idx = (src, dst, mask)
    kw = dict(depth=depth, n_nodes=E // 2 + 8, residual=residual, reduce=reduce)
    ref_kw = dict(depth=depth, residual=residual, reduce=reduce)
    counts = [fn.launches for fn in (fused_dense_mpnn_block_stash, fused_dense_mpnn_block_bwd_stash,
                                     fused_dense_mpnn_block_bwd)]

    out, hs = fused_dense_mpnn_block_stash(h0, *idx, W, b, **kw)
    ref_out, ref_hs = dense_mpnn_block_stash_reference(h0, *idx, W, b, **ref_kw)
    torch.testing.assert_close(out, ref_out, rtol=1e-4, atol=1e-4)
    if depth > 1:
        torch.testing.assert_close(hs, ref_hs, rtol=1e-4, atol=1e-4)
    else:
        assert hs is None

    ref = dense_mpnn_block_bwd_reference(h0, ref_hs, *idx, W, g, **ref_kw)
    first = fused_dense_mpnn_block_bwd_stash(h0, hs, *idx, W, g, **kw)
    second = fused_dense_mpnn_block_bwd_stash(h0, hs, *idx, W, g, **kw)
    _close_grads(first, ref)
    assert all(torch.equal(x, y) for x, y in zip(first, second)), "the stash backward is not repeatable"
    _close_grads(fused_dense_mpnn_block_bwd(h0, *idx, W, b, g, **kw), ref)
    torch.cuda.synchronize()

    stash_fwd, stash_bwd, recompute = (depth, 2, 1) if depth > 1 else (0, 0, 3)
    assert fused_dense_mpnn_block_stash.launches == counts[0] + stash_fwd
    assert fused_dense_mpnn_block_bwd_stash.launches == counts[1] + stash_bwd
    assert fused_dense_mpnn_block_bwd.launches == counts[2] + recompute


@pytest.mark.gpu
def test_cuda_backward_rejects_misaligned_cotangent():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    h0, src, dst, mask, W, b, g = _train_inputs(128, 3, d=64)
    _, hs = fused_dense_mpnn_block_stash(h0, src, dst, mask, W, b, depth=3, n_nodes=72)
    bad = torch.zeros(g.numel() + 1, device="cuda")[1:].view(g.shape)
    with pytest.raises(ValueError, match="16-byte"):
        fused_dense_mpnn_block_bwd_stash(h0, hs, src, dst, mask, W, bad, depth=3, n_nodes=72)


def _encoder_inputs(V, E, depth, seed=0, d=256):
    """Seeded inputs of the fused encoder on the card, on the per-molecule
    dense layout: node and edge features, the index arrays, nonzero biases,
    and cotangents of both outputs that are nonzero on every lane, padded
    ones included (the backward must be exact for any cotangent)."""
    G = pad_graphs_dense([PIPE(s) for s in SMIS], V, E, np_out=True)
    B = G.src.shape[0]
    rng = np.random.default_rng(seed)
    nf = rng.standard_normal((B, V, d)).astype(np.float32)
    ef = rng.standard_normal((B, E, d)).astype(np.float32)
    W = (rng.standard_normal((depth, d, d)) / np.sqrt(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal((depth, d))).astype(np.float32)
    gn = rng.standard_normal((B, V, d)).astype(np.float32)
    ge = rng.standard_normal((B, E, d)).astype(np.float32)
    return [torch.from_numpy(x).cuda() for x in (nf, ef, G.src, G.dst, G.edge_mask, W, b, gn, ge)]


@pytest.mark.gpu
@pytest.mark.parametrize("VE", [(32, 64), (128, 256)])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("depth", [1, 3])
def test_cuda_encoder_kernels_match_plain_versions(VE, reduce, residual, depth):
    """Rows 5 and 6 against their plain versions on every lane (forward
    rtol = atol = 1e-4; gradients atol 1e-4 x the tensor's largest
    magnitude), the backward twice with equal bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    V, E = VE
    nf, ef, src, dst, mask, W, b, gn, ge = _encoder_inputs(V, E, depth)
    idx = (src, dst, mask)
    kw = dict(depth=depth, residual=residual, reduce=reduce)
    fwd0, bwd0 = fused_dense_encoder_fwd.launches, fused_dense_encoder_bwd.launches

    for stash in (False, True):
        nh, eh, hs = fused_dense_encoder_fwd(nf, ef, *idx, W, b, stash=stash, **kw)
        ref_nh, ref_eh, ref_hs = dense_encoder_reference(nf, ef, *idx, W, b, stash=stash, **kw)
        torch.testing.assert_close(nh, ref_nh, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(eh, ref_eh, rtol=1e-4, atol=1e-4)
        if stash and depth > 1:
            torch.testing.assert_close(hs, ref_hs, rtol=1e-4, atol=1e-4)
        else:
            assert hs is None

    ref = dense_encoder_bwd_reference(nf, ef, ref_hs, *idx, W, gn, ge, **kw)
    first = fused_dense_encoder_bwd(nf, ef, hs, *idx, W, gn, ge, **kw)
    second = fused_dense_encoder_bwd(nf, ef, hs, *idx, W, gn, ge, **kw)
    torch.cuda.synchronize()
    _close_grads(first, ref)
    assert all(torch.equal(x, y) for x, y in zip(first, second)), "the encoder backward is not repeatable"
    assert fused_dense_encoder_fwd.launches == fwd0 + 2 * depth
    assert fused_dense_encoder_bwd.launches == bwd0 + 2


@pytest.mark.gpu
def test_cuda_encoder_rejects_oversized_bins():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    nf, ef, src, dst, mask, W, b, _, _ = _encoder_inputs(32, 64, 1, d=64)
    big = torch.zeros(nf.shape[0], 512, 64, device="cuda")
    with pytest.raises(ValueError, match="at most"):
        fused_dense_encoder_fwd(big, ef, src, dst, mask, W, b, depth=1)


@pytest.mark.gpu
@pytest.mark.parametrize("E", [128, 256])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("residual", [True, False])
def test_cuda_dbuf_matches_plain_version_and_row_1(E, reduce, residual):
    """Row 7 against its plain version (rtol = atol = 1e-4) and against row
    1's kernel, bit for bit: the same FMAs in the same order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    # one molecule per row: 32 rows, an even count of 8-row tiles
    G = pad_graphs_dense([PIPE(s) for s in SMIS], E // 2 + 8, E, np_out=True)
    rng = np.random.default_rng(0)
    h0 = rng.standard_normal((len(SMIS), E, 256)).astype(np.float32)
    W = (rng.standard_normal((3, 256, 256)) / 16).astype(np.float32)
    b = (0.1 * rng.standard_normal((3, 256))).astype(np.float32)
    args = tuple(torch.from_numpy(x).cuda() for x in (h0, G.src, G.dst, G.edge_mask, W, b))
    kw = dict(depth=3, n_nodes=E // 2 + 8, residual=residual, reduce=reduce)
    before = fused_dense_mpnn_block_dbuf.launches
    out = fused_dense_mpnn_block_dbuf(*args, mols_per_tile=8, **kw)
    row1 = fused_dense_mpnn_block(*args, **kw)
    torch.cuda.synchronize()
    assert fused_dense_mpnn_block_dbuf.launches == before + 3
    ref = dense_mpnn_block_reference(*args, depth=3, residual=residual, reduce=reduce)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(out, row1), f"dbuf differs from row 1 by {float((out - row1).abs().max())}"


def _hold_sum(out, plain, data, *index):
    """``out`` (the kernel) against ``plain`` (a plain version, called on
    ``data`` and ``index``): bitwise against its CPU run, and within 1e-5 of
    the sum of |terms| against its run on the card."""
    on_cpu = plain(data.cpu(), *(i.cpu() if isinstance(i, torch.Tensor) else i for i in index))
    assert torch.equal(out.cpu(), on_cpu), f"differs from the CPU plain version by {(out.cpu() - on_cpu).abs().max()}"
    mass = plain(data.abs(), *index)
    assert ((out - plain(data, *index)).abs() <= 1e-5 * mass).all()


def _packed_case(kind, d, seed=0):
    """(data, perm, packed_dst, dst, edge_mask, V) on the card: a flat batch
    of molecules (only real edges packed), or random ids over 256 nodes with
    node 3 holding 12,500 edges, so that the budget (13,056 slots) takes
    more than 48 KiB of shared memory."""
    rng = np.random.default_rng(seed)
    if kind == "molecules":
        bg = with_csr_packing(pad_graphs([PIPE(s) for s in SMIS], 1024, 2048, np_out=True))
        dst, mask, perm, pdst, V = bg.dst, bg.edge_mask, bg.csr_perm, bg.csr_dst, 1024
    else:
        V = 256
        dst = np.concatenate([rng.integers(0, V, size=1000), np.full(12500, 3)]).astype(np.int32)
        dst = dst[rng.permutation(len(dst))]
        mask = np.ones(len(dst), bool)
        perm, pdst, _ = pack_edges_by_tile(dst, num_nodes=V)
    data = rng.standard_normal((len(dst), d)).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in (data, perm, pdst, dst, mask)] + [V]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["molecules", "random"])
@pytest.mark.parametrize("d", [256, 36])
def test_cuda_csr_packed_matches_plain_version(kind, d):
    """Row 9 against its plain version, one launch a call, and two calls
    give the same bits (a fixed summation order, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    data, perm, pdst, _, _, V = _packed_case(kind, d)
    before = csr_segment_sum_packed.launches
    out = csr_segment_sum_packed(data, perm, pdst, V)
    again = csr_segment_sum_packed(data, perm, pdst, V)
    torch.cuda.synchronize()
    assert csr_segment_sum_packed.launches == before + 2
    _hold_sum(out, csr_segment_sum_packed_reference, data, perm, pdst, V)
    assert torch.equal(out, again), "the packed sum is not repeatable"


@pytest.mark.gpu
def test_cuda_csr_packed_gradient():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    data, perm, pdst, dst, mask, V = _packed_case("molecules", 64)
    x = data.clone().requires_grad_()
    g = torch.randn(V, 64, device="cuda")
    csr_segment_sum_packed(x, perm, pdst, V, dst=dst, edge_mask=mask).backward(g)
    assert torch.equal(x.grad, torch.where(mask[:, None], g[dst.long()], 0.0))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["molecules", "random"])
@pytest.mark.parametrize("d", [256, 36])
def test_cuda_csr_rowptr_matches_plain_version(kind, d):
    """Row 8 on dst-sorted edges: a sorted flat batch (padding at the sink),
    or random sorted ids with empty nodes and one node of 3,000 edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    if kind == "molecules":
        bg, _ = sort_edges_by_dst(pad_graphs([PIPE(s) for s in SMIS], 1024, 2048, np_out=True))
        dst, V = bg.dst, 1024
    else:
        rng = np.random.default_rng(1)
        V = 256
        ids = rng.integers(0, V, size=1096)
        dst = np.sort(np.concatenate([ids[(ids < 10) | (ids > 20)], np.full(3000, 3)])).astype(np.int32)
        dst = np.concatenate([dst, np.full(4096 - len(dst), V - 1, np.int32)])
    data = torch.from_numpy(np.random.default_rng(2).standard_normal((len(dst), d)).astype(np.float32)).cuda()
    dst_t, row_ptr = torch.from_numpy(dst).cuda(), torch.from_numpy(csr_row_ptr(dst, V)).cuda()
    before = csr_segment_sum.launches
    out = csr_segment_sum(data, dst_t, row_ptr, V)
    again = csr_segment_sum(data, dst_t, row_ptr, V)
    torch.cuda.synchronize()
    assert csr_segment_sum.launches == before + 2
    _hold_sum(out, csr_segment_sum_reference, data, row_ptr, V)
    assert torch.equal(out, again)


@pytest.mark.gpu
def test_cuda_csr_kernels_reject_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    data, perm, pdst, dst, _, V = _packed_case("molecules", 64)
    with pytest.raises(ValueError, match="16-byte"):
        csr_segment_sum_packed(torch.zeros(data.numel() + 1, device="cuda")[1:].view_as(data), perm, pdst, V)
    with pytest.raises(TypeError, match="float32"):
        csr_segment_sum_packed(data.double(), perm, pdst, V)
    with pytest.raises(ValueError, match="multiple of 4"):
        csr_segment_sum_packed(data[:, :30].contiguous(), perm, pdst, V)
    big = torch.full((128 * 65536,), -1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="slots"):
        csr_segment_sum_packed(data, big, big, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_cuda_flat_csr_block_matches_cpu(reduce):
    """ChempropBlock(impl="csr") on the card against the same block on the
    CPU: node and edge hiddens and every gradient; with sum, every layer's
    reduce and the final one launch the packed kernel (forward only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    bg = with_csr_packing(pad_graphs([PIPE(s) for s in SMIS], 1024, 2048, np_out=True))
    rng = np.random.default_rng(3)
    nf, ef = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for shape in ((1024, 64), (2048, 64)))
    block = ChempropBlock(hidden_dim=64, depth=3, impl="csr", reduce=reduce)
    block.reset_parameters(torch.Generator().manual_seed(0))
    outs, grads = [], []
    for device in ("cpu", "cuda"):
        block.to(device).zero_grad()
        x_n, x_e = nf.to(device, copy=True).requires_grad_(), ef.to(device, copy=True).requires_grad_()
        before = csr_segment_sum_packed.launches
        out = block(bg.to(device).update(node_feats=x_n, edge_feats=x_e))
        (out.node_feats.square().sum() + out.edge_feats.sum()).backward()
        if device == "cuda":
            torch.cuda.synchronize()
            assert csr_segment_sum_packed.launches - before == (4 if reduce == "sum" else 0)
        outs.append([out.node_feats.detach().cpu(), out.edge_feats.detach().cpu()])
        # copies: moving the block moves its parameters' .grad with them
        grads.append([g.to("cpu", copy=True) for g in (x_n.grad, x_e.grad, block.weight.grad, block.bias.grad)])
    for a, r in zip(outs[1], outs[0]):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)
    _close_grads(grads[1], grads[0])


# -- the attention core (rows 10-13) ---------------------------------------------------------

ATTENTION_ENTRIES = (fused_dense_attention_fwd, fused_dense_attention_bwd, fused_dense_attention_fwd_v2,
                     fused_dense_attention_bwd_v2)


def hub_bins(seed=0):
    """Two bins of V = 48 node slots and E = 128 edge lanes (numpy ``src``,
    ``dst``, ``edge_mask`` and V), the lanes rows 10-11 must get right. Bin 0:
    node 0 is a hub with 40 live in-lanes (more than a warp's 32) and 36 live
    out-lanes; the pair 5 -> 7 has three edges; five lanes with the mask set
    have a src or dst outside [0, V); eight lanes are masked; the rest are
    random edges among nodes 1-43, so nodes 44-47 have none. Bin 1 has no
    live edge: its masked lanes lie in range, its unmasked ones outside. The
    lanes of bin 0 are shuffled, so a row's edges are spread over the bin."""
    rng = np.random.default_rng(seed)
    V, E = 48, 128
    lanes = [(j, 0, True) for j in range(1, 41)] + [(0, j, True) for j in range(5, 41)]
    lanes += [(5, 7, True)] * 3
    lanes += [(V, 3, True), (-1, 3, True), (3, V, True), (4, -7, True), (V + 5, 60, True)]
    lanes += [(int(a), int(b), False) for a, b in rng.integers(1, 44, (8, 2))]
    while len(lanes) < E:
        a, b = (int(x) for x in rng.integers(1, 44, 2))
        if (a, b) != (5, 7):
            lanes.append((a, b, True))
    src, dst = np.zeros((2, E), np.int32), np.zeros((2, E), np.int32)
    mask = np.zeros((2, E), bool)
    for lane, (a, b, m) in zip(rng.permutation(E), lanes):
        src[0, lane], dst[0, lane], mask[0, lane] = a, b, m
    mask[1] = rng.random(E) < 0.5
    src[1], dst[1] = rng.integers(0, V, E), np.where(mask[1], V + rng.integers(0, 5, E), rng.integers(0, V, E))
    return src, dst, mask, V


def attention_case(kind, d, H, edge_bias, seed=0):
    """(q, k, v, eb, src, dst, edge_mask, g) on the card. ``packed``: the
    molecules (a bond-less "O" and "[Na+].[Cl-]" among them) in bins of 128
    node slots and 256 edge lanes; ``dense``: one molecule a block; ``random``:
    V = 256, E = 512, random edges over the first 200 node slots (the rest
    are padding), a fifth of the lanes masked, duplicated pairs; ``hub``:
    :func:`hub_bins`."""
    rng = np.random.default_rng(seed)
    graphs = [PIPE(s) for s in SMIS + ["[Na+].[Cl-]"]]
    if kind == "packed":
        G = pack_graphs_dense(graphs, 128, 256, np_out=True)
        src, dst, mask = G.src, G.dst, G.edge_mask
    elif kind == "dense":
        G = pad_graphs_dense(graphs, 48, 128, np_out=True)
        src, dst, mask = G.src, G.dst, G.edge_mask
    elif kind == "hub":
        src, dst, mask, _ = hub_bins()
    else:
        src = rng.integers(0, 200, (3, 512)).astype(np.int32)
        dst = rng.integers(0, 200, (3, 512)).astype(np.int32)
        src[:, 1::7], dst[:, 1::7] = src[:, :-1:7], dst[:, :-1:7]  # lane 7m + 1 repeats lane 7m
        mask = rng.random((3, 512)) < 0.8
    B, E = src.shape
    V = {"packed": 128, "dense": 48, "random": 256, "hub": 48}[kind]
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    arrays = [f(B, V, d), f(B, V, d), f(B, V, d), f(B, H, E) if edge_bias else None, src, dst, mask, f(B, V, d)]
    return [None if x is None else torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in arrays]


def _hold_attention_entries(kind, d, H, edge_bias):
    """All four entries against the plain versions on every lane (padding
    rows, the sink and bond-less molecules give zeros in the output and in
    g_q, key rows with no live lane zeros in g_k and g_v); each backward
    twice, bit for bit; one launch a call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, eb, src, dst, mask, g = attention_case(kind, d, H, edge_bias)
    ref = dense_attention_reference(q, k, v, eb, src, dst, mask, H)
    ref_grads = dense_attention_bwd_reference(q, k, v, eb, src, dst, mask, g, H)
    live = (dense_attention_reference(torch.ones_like(q), k, v, eb, src, dst, mask, H) != 0).any(-1)
    keyed = (ref_grads[2] != 0).any(-1)  # key rows with a live lane
    before = [fn.launches for fn in ATTENTION_ENTRIES]
    for fwd, bwd in ((fused_dense_attention_fwd, fused_dense_attention_bwd),
                     (fused_dense_attention_fwd_v2, fused_dense_attention_bwd_v2)):
        out = fwd(q, k, v, eb, src, dst, mask, num_heads=H)
        first = bwd(q, k, v, eb, src, dst, mask, g, num_heads=H)
        second = bwd(q, k, v, eb, src, dst, mask, g, num_heads=H)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
        _close_grads(first[:3], ref_grads[:3])
        if edge_bias:
            _close_grads(first[3:], ref_grads[3:])
        else:
            assert not first[3].any()
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        assert not out[~live].any() and not first[0][~live].any()  # rows with no live pair are zero
        assert not first[1][~keyed].any() and not first[2][~keyed].any()
    assert [fn.launches - n for fn, n in zip(ATTENTION_ENTRIES, before)] == [1, 2, 1, 2]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["packed", "dense", "random"])
@pytest.mark.parametrize("edge_bias", [True, False])
@pytest.mark.parametrize("d, H", [(256, 4), (16, 2)])
def test_cuda_attention_kernels_match_plain_versions(kind, edge_bias, d, H):
    """The four entries on molecules and random bins (:func:`_hold_attention_entries`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _hold_attention_entries(kind, d, H, edge_bias)


@pytest.mark.gpu
@pytest.mark.parametrize("edge_bias", [True, False])
@pytest.mark.parametrize("d, H", [(256, 4), (16, 2), (512, 1), (256, 8)])
def test_cuda_attention_kernels_match_plain_versions_on_hub_bins(edge_bias, d, H):
    """The four entries on :func:`hub_bins`: a row and a key row of more
    than a warp's lanes, a pair of three edges, out-of-range padding lanes
    and a bin with no live edge (:func:`_hold_attention_entries`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _hold_attention_entries("hub", d, H, edge_bias)


@pytest.mark.gpu
def test_cuda_attention_autograd_matches_cpu():
    """FusedDenseAttentionFn with the kernel forward on the card against the
    same function on the CPU: output and the gradients of q, k, v and eb."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    case = attention_case("packed", 64, 4, True, seed=1)
    results = []
    for device in ("cpu", "cuda"):
        q, k, v, eb, src, dst, mask, g = (x.to(device) for x in case)
        leaves = [x.clone().requires_grad_() for x in (q, k, v, eb)]
        out = fused_dense_attention(*leaves, src, dst, mask, 4, fwd_impl="pallas")
        (out * g).sum().backward()
        results.append([out.detach().cpu()] + [x.grad.cpu() for x in leaves])
    torch.testing.assert_close(results[1][0], results[0][0], rtol=1e-4, atol=1e-4)
    _close_grads(results[1][1:], results[0][1:])


@pytest.mark.gpu
def test_cuda_attention_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    q, k, v, eb, src, dst, mask, g = attention_case("packed", 24, 4, True)
    with pytest.raises(ValueError, match="multiple of 4"):  # dh = 6
        fused_dense_attention_fwd_v2(q, k, v, eb, src, dst, mask, num_heads=4)
    q, k, v, eb, src, dst, mask, g = attention_case("packed", 64, 4, True)
    with pytest.raises(ValueError, match="interpret"):
        fused_dense_attention_bwd(q, k, v, eb, src, dst, mask, g, num_heads=4, interpret=True)
    with pytest.raises(TypeError, match="float32"):
        fused_dense_attention_fwd(q.double(), k.double(), v.double(), eb.double(), src, dst, mask, num_heads=4)
    big = torch.zeros(1, 2048, 64, device="cuda")
    ids = torch.zeros(1, 4096, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        fused_dense_attention_fwd_v2(big, big, big, None, ids, ids, ids.bool(), num_heads=1)
    small, lanes = torch.zeros(1, 8, 64, device="cuda"), torch.zeros(1, 10_000, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="E=10000 edge lanes need"):  # rows 10-11 hold a bin's edge list
        fused_dense_attention_fwd(small, small, small, None, lanes, lanes, lanes.bool(), num_heads=1)


@pytest.mark.gpu
@pytest.mark.parametrize("fwd_impl", ["jnp", "pallas"])
def test_cuda_dense_gat_block_matches_cpu(fwd_impl):
    """DenseGATBlock(impl="fused") on the card against the same block on the
    CPU: node hiddens and every gradient; each layer launches row 13 on the
    backward, and row 12 on the forward with fwd_impl="pallas"."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    G = pack_graphs_dense([PIPE(s) for s in SMIS], 128, 256, np_out=True)
    rng = np.random.default_rng(4)
    B, E = G.src.shape
    nf, ef = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for shape in ((B, 128, 32), (B, E, 32)))
    block = DenseGATBlock(hidden_dim=32, depth=2, num_heads=4, impl="fused", fwd_impl=fwd_impl)
    block.reset_parameters(torch.Generator().manual_seed(0))
    outs, grads = [], []
    for device in ("cpu", "cuda"):
        block.to(device).zero_grad()
        before = fused_dense_attention_fwd_v2.launches, fused_dense_attention_bwd_v2.launches
        out = block(G.to(device).update(node_feats=nf.to(device), edge_feats=ef.to(device)))
        out.node_feats.square().sum().backward()
        if device == "cuda":
            torch.cuda.synchronize()
            assert (fused_dense_attention_fwd_v2.launches - before[0],
                    fused_dense_attention_bwd_v2.launches - before[1]) == (2 if fwd_impl == "pallas" else 0, 2)
        outs.append(out.node_feats.detach().cpu())
        grads.append({name: p.grad.to("cpu", copy=True) for name, p in block.named_parameters()})
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-4)
    # the biases of W_k and W_bias move no softmax (a shift along a row):
    # their gradients are zero in exact arithmetic, rounding only, so they
    # are held at the scale of the other gradients
    scale = max(float(g.abs().max()) for g in grads[0].values())
    for name, ref in grads[0].items():
        atol = 1e-4 * (scale if name.endswith(("W_k.bias", "W_bias.bias")) else float(ref.abs().max()))
        torch.testing.assert_close(grads[1][name], ref, rtol=1e-4, atol=atol, msg=name)


def gvp_case(d, dv, seed=0, n_clouds=12, K=16, nb=16, window=24, quantum=64, nodes=None):
    """The GVP kernels' operands on the card over real banded neighbour
    lists of synthetic clouds: seeded features, RBF-like edge features, unit
    vectors, split weights and cotangents. The node count is ``nodes``, or
    the clouds' atoms rounded up to a multiple of ``quantum`` (an odd one
    below 64)."""
    clouds = make_clouds(n_clouds, seed=seed)
    blocks = -(-sum(c.num_nodes for c in clouds) // quantum)
    cap = nodes or quantum * (blocks if quantum >= 64 else blocks | 1)
    P = pad_point_clouds(clouds, cap).to("cuda")
    nbrs, mask, dists = radius_neighbors(P.coords, P.batch_index, 5.0, K, window=window)
    rng = np.random.default_rng(seed)
    f = lambda *shape, scale=1.0: torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).cuda()  # noqa: E731
    u = f(cap * K, 3)
    u = u / u.norm(dim=1, keepdim=True)
    ws = [f(*shape, scale=1 / np.sqrt(shape[0]) if len(shape) == 2 else 0.1) for shape in weight_shapes(d, dv, nb)]
    args = [f(cap, d), f(cap, dv), f(cap, dv), f(cap, dv), nbrs, mask, torch.exp(-f(cap * K, nb) ** 2),
            *(u[:, i: i + 1].contiguous() for i in range(3)), ws]
    return args, [f(cap, d), f(cap, dv), f(cap, dv), f(cap, dv)]


def gvp_kink_free(args, window=24, tol=1e-5):
    """``args`` with the slots masked whose ReLU pre-activation lies within
    ``tol`` of its layer's largest |pre-activation| of zero: there the
    gradient jumps, and two computations that round differently may land on
    either side (chip_smoke.py KINK_TOL)."""
    wide = [a.double() if a.is_floating_point() else a for a in args[:10]] + [[w.double() for w in args[10]]]
    near = torch.zeros(args[5].numel(), dtype=torch.bool, device=args[5].device)
    for mid in gvp_conv_preactivations(*wide, window):
        near |= (mid.abs() < tol * mid.abs().max()).any(1)
    return args[:5] + [(args[5] & ~near.reshape(args[5].shape)).contiguous()] + args[6:]


@pytest.mark.gpu
@pytest.mark.parametrize("d, dv, K, quantum, dead, clouds, nodes", [
    pytest.param(32, 8, 16, 64, 0, 12, None, id="32-8"),
    pytest.param(256, 32, 16, 64, 0, 12, None, id="256-32"),
    pytest.param(48, 6, 16, 64, 0, 12, None, id="48-6"),
    # other K: a 64-row tile holds 8 nodes (K 8) or cuts across nodes (K 24)
    pytest.param(256, 32, 8, 64, 0, 12, None, id="K8"),
    pytest.param(256, 32, 24, 64, 0, 12, None, id="K24"),
    # N K a multiple of neither a row tile nor a 1,024-row weight-gradient chunk
    pytest.param(64, 8, 5, 8, 0, 12, None, id="ragged-rows"),
    # nodes whose every slot is masked
    pytest.param(256, 32, 16, 64, 9, 12, None, id="dead-nodes"),
    # a serving-sized batch: 65,536 rows, the forward's activations (about
    # 0.5 GB) far past the 50 MB L2
    pytest.param(256, 32, 16, 64, 0, 210, 4096, id="serving-4096"),
])
def test_cuda_gvp_kernels_match_plain_versions(d, dv, K, quantum, dead, clouds, nodes):
    """Rows 14-15 against their plain versions: the outputs; every cotangent
    on the inputs with the slots near a ReLU kink masked; each entry twice,
    bit for bit; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    args, cot = gvp_case(d, dv, n_clouds=clouds, K=K, quantum=quantum, nodes=nodes)
    assert nodes is None or args[0].shape[0] == nodes
    args = gvp_kink_free(args)
    if dead:
        mask = args[5].clone()
        mask[torch.linspace(0, mask.shape[0] - 1, dead).long()] = False
        args[5] = mask
    before = fused_gvp_conv_fwd.launches, fused_gvp_conv_bwd.launches
    out = fused_gvp_conv_fwd(*args, window=24)
    again = fused_gvp_conv_fwd(*args, window=24)
    first = fused_gvp_conv_bwd(*args, *cot, window=24)
    second = fused_gvp_conv_bwd(*args, *cot, window=24)
    torch.cuda.synchronize()
    assert (fused_gvp_conv_fwd.launches - before[0], fused_gvp_conv_bwd.launches - before[1]) == (2, 2)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    for a, r in zip(out, gvp_conv_reference(*args, 24)):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)
    ref = gvp_conv_bwd_reference(*args, *cot, 24)
    _close_grads(list(first[:8]) + list(first[8]), list(ref[:8]) + list(ref[8]))
    flat = lambda g: list(g[:8]) + list(g[8])  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(flat(first), flat(second)))


@pytest.mark.gpu
def test_cuda_gvp_block_matches_cpu():
    """GvpGNNBlock(impl="fused") on the card against the same block on the
    CPU: node outputs, and every gradient within 1e-2 in relative L2 (a
    ReLU pre-activation within rounding of zero moves a gradient by a whole
    term: chip_smoke.py KINK_GRAD_L2); rows 14 and 15 once per layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    clouds = make_clouds(12, seed=3)
    P = pad_point_clouds(clouds, 256)
    feats = torch.from_numpy(np.random.default_rng(1).standard_normal((256, 32)).astype(np.float32))
    block = GvpGNNBlock(scalar_dim=32, vector_dim=8, depth=2, neighbor_window=24, impl="fused")
    block.reset_parameters(torch.Generator().manual_seed(0))
    outs, grads = [], []
    for device in ("cpu", "cuda"):
        block.to(device).zero_grad()
        before = fused_gvp_conv_fwd.launches, fused_gvp_conv_bwd.launches
        out = block(P.to(device).update(node_feats=feats.to(device)))
        torch.sin(out.node_feats).sum().backward()
        if device == "cuda":
            torch.cuda.synchronize()
            assert (fused_gvp_conv_fwd.launches - before[0], fused_gvp_conv_bwd.launches - before[1]) == (2, 2)
        outs.append(out.node_feats.detach().cpu())
        grads.append({n: p.grad.to("cpu", copy=True) for n, p in block.named_parameters() if p.grad is not None})
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-4)
    assert sorted(grads[1]) == sorted(grads[0])
    for name, ref in grads[0].items():
        assert float((grads[1][name] - ref).norm() / ref.norm()) <= 1e-2, name


@pytest.mark.gpu
def test_cuda_gvp_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    args, cot = gvp_case(32, 8)
    with pytest.raises(ValueError, match="interpret"):
        fused_gvp_conv_fwd(*args, window=24, interpret=True)
    with pytest.raises(TypeError, match="float32"):
        fused_gvp_conv_fwd(args[0].double(), *args[1:], window=24)
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_gvp_conv_bwd(*args, *cot, window=20)
    N = args[0].shape[0]
    wide_k = [torch.zeros(N, 2048, dtype=torch.int32, device="cuda"), torch.zeros(N, 2048, dtype=torch.bool, device="cuda"),
              torch.zeros(N * 2048, 16, device="cuda")] + [torch.zeros(N * 2048, 1, device="cuda")] * 3
    with pytest.raises(ValueError, match="shared memory"):
        fused_gvp_conv_fwd(*args[:4], *wide_k, args[10], window=24)
