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

from pathlib import Path

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


def _encoder_inputs(V, E, depth, seed=0, d=256, graphs=None):
    """Seeded inputs of the fused encoder on the card, on the per-molecule
    dense layout (of ``graphs``, default SMIS's): node and edge features,
    the index arrays, nonzero biases, and cotangents of both outputs that
    are nonzero on every lane, padded ones included (the backward must be
    exact for any cotangent)."""
    G = pad_graphs_dense([PIPE(s) for s in SMIS] if graphs is None else graphs, V, E, np_out=True)
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


# matmul_dtype="bfloat16" (rows 1-6): kernel and plain version round the same
# operands to bf16 and sum in f32 in other orders, so an f32 ulp of a sum
# can flip the bf16 rounding of the next layer's operand (2^-8 relative) and
# the flip carries on: elementwise against the tensor's largest magnitude,
# and in relative L2 over the tensor, which such flips barely move. Measured
# over these cases on an H100 (700 W): at most 1.25e-3 elementwise and
# 1.8e-4 in L2 (rows 1-2; the backward rows 7.8e-4 and 9.6e-5), while the
# bf16 rows differ from the f32 rows by 4.5e-3 in L2, so the L2 limit also
# tells a bf16 kernel from an f32 one.
BF16_ELEMENT_TOL = 1e-2
BF16_L2_TOL = 1e-3


def _hold_bf16(got, ref, what):
    got, ref = got.float(), ref.float()
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max()) / max(scale, 1e-30)
    l2 = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref).clamp_min(1e-30))
    assert err <= BF16_ELEMENT_TOL and l2 <= BF16_L2_TOL, f"{what}: max {err:.2e}, L2 {l2:.2e}"


@pytest.mark.gpu
@pytest.mark.parametrize("E", [128, 256])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("stash_dtype", [None, "bfloat16"])
def test_cuda_bf16_block_kernels_match_plain_versions(E, reduce, residual, depth, stash_dtype):
    """Rows 1-4 with bf16 operands (and a bf16 stash) against their plain
    versions at BF16_*_TOL, the backward fed the kernel's own stash; each
    twice with equal bits, each counted as a bf16 launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    h0, src, dst, mask, W, b, g = _train_inputs(E, depth)
    idx = (src, dst, mask)
    mm = dict(matmul_dtype="bfloat16")
    kw = dict(depth=depth, n_nodes=E // 2 + 8, residual=residual, reduce=reduce, **mm)
    ref_kw = dict(depth=depth, residual=residual, reduce=reduce, **mm)
    rows = (fused_dense_mpnn_block, fused_dense_mpnn_block_stash, fused_dense_mpnn_block_bwd_stash,
            fused_dense_mpnn_block_bwd)
    counts = [(fn.launches, fn.launches_bf16) for fn in rows]

    out = fused_dense_mpnn_block(h0, *idx, W, b, **kw)
    assert torch.equal(out, fused_dense_mpnn_block(h0, *idx, W, b, **kw))
    _hold_bf16(out, dense_mpnn_block_reference(h0, *idx, W, b, **ref_kw), "row 1")
    out, hs = fused_dense_mpnn_block_stash(h0, *idx, W, b, stash_dtype=stash_dtype, **kw)
    again = fused_dense_mpnn_block_stash(h0, *idx, W, b, stash_dtype=stash_dtype, **kw)
    ref_out, ref_hs = dense_mpnn_block_stash_reference(h0, *idx, W, b, stash_dtype=stash_dtype, **ref_kw)
    _hold_bf16(out, ref_out, "row 2")
    if depth > 1:
        assert hs.dtype == (torch.bfloat16 if stash_dtype else torch.float32)
        assert torch.equal(out, again[0]) and torch.equal(hs, again[1])
        _hold_bf16(hs, ref_hs, "row 2's stash")
    ref = dense_mpnn_block_bwd_reference(h0, hs, *idx, W, g, **ref_kw)
    first = fused_dense_mpnn_block_bwd_stash(h0, hs, *idx, W, g, **kw)
    second = fused_dense_mpnn_block_bwd_stash(h0, hs, *idx, W, g, **kw)
    for name, a, r in zip(("g_h0", "g_W", "g_b"), first, ref):
        _hold_bf16(a, r, f"row 3 {name}")
    assert all(torch.equal(x, y) for x, y in zip(first, second)), "row 3 bf16 is not repeatable"
    _, ref_hs32 = dense_mpnn_block_stash_reference(h0, *idx, W, b, **ref_kw)
    ref4 = dense_mpnn_block_bwd_reference(h0, ref_hs32, *idx, W, g, **ref_kw)
    got4 = fused_dense_mpnn_block_bwd(h0, *idx, W, b, g, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got4, fused_dense_mpnn_block_bwd(h0, *idx, W, b, g, **kw)))
    for name, a, r in zip(("g_h0", "g_W", "g_b"), got4, ref4):
        _hold_bf16(a, r, f"row 4 {name}")
    torch.cuda.synchronize()
    stash_fwd, stash_bwd, recompute = (2 * depth, 2, 2) if depth > 1 else (0, 0, 4)
    # at depth 1 the stash forward is row 1 and the stash backward row 4
    expect = [2 * depth + (2 if depth == 1 else 0), stash_fwd, stash_bwd, recompute]
    assert [(fn.launches, fn.launches_bf16) for fn in rows] == [
        (f32, bf + n) for (f32, bf), n in zip(counts, expect)]


@pytest.mark.gpu
@pytest.mark.parametrize("VE", [(32, 64), (128, 256)])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("stash_dtype", [None, "bfloat16"])
def test_cuda_bf16_encoder_kernels_match_plain_versions(VE, reduce, residual, depth, stash_dtype):
    """Rows 5 and 6 with bf16 operands (and a bf16 stash) against their
    plain versions at BF16_*_TOL, the backward fed the kernel's stash; each
    twice with equal bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    V, E = VE
    nf, ef, src, dst, mask, W, b, gn, ge = _encoder_inputs(V, E, depth)
    idx = (src, dst, mask)
    kw = dict(depth=depth, residual=residual, reduce=reduce, matmul_dtype="bfloat16")
    fwd0, bwd0 = fused_dense_encoder_fwd.launches_bf16, fused_dense_encoder_bwd.launches_bf16
    nh, eh, hs = fused_dense_encoder_fwd(nf, ef, *idx, W, b, stash=True, stash_dtype=stash_dtype, **kw)
    again = fused_dense_encoder_fwd(nf, ef, *idx, W, b, stash=True, stash_dtype=stash_dtype, **kw)
    ref_nh, ref_eh, ref_hs = dense_encoder_reference(nf, ef, *idx, W, b, stash=True, stash_dtype=stash_dtype,
                                                     **kw)
    _hold_bf16(nh, ref_nh, "row 5 node_hiddens")
    _hold_bf16(eh, ref_eh, "row 5 edge_hiddens")
    assert torch.equal(nh, again[0]) and torch.equal(eh, again[1])
    if depth > 1:
        assert hs.dtype == (torch.bfloat16 if stash_dtype else torch.float32) and torch.equal(hs, again[2])
        _hold_bf16(hs, ref_hs, "row 5 stash")
    ref = dense_encoder_bwd_reference(nf, ef, hs, *idx, W, gn, ge, **kw)
    first = fused_dense_encoder_bwd(nf, ef, hs, *idx, W, gn, ge, **kw)
    second = fused_dense_encoder_bwd(nf, ef, hs, *idx, W, gn, ge, **kw)
    torch.cuda.synchronize()
    for name, a, r in zip(("g_nf", "g_ef", "g_W", "g_b"), first, ref):
        _hold_bf16(a, r, f"row 6 {name}")
    assert all(torch.equal(x, y) for x, y in zip(first, second)), "row 6 bf16 is not repeatable"
    assert fused_dense_encoder_fwd.launches_bf16 == fwd0 + 2 * depth
    assert fused_dense_encoder_bwd.launches_bf16 == bwd0 + 2


@pytest.mark.gpu
def test_cuda_encoder_rejects_oversized_bins():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    nf, ef, src, dst, mask, W, b, _, _ = _encoder_inputs(32, 64, 1, d=64)
    big = torch.zeros(nf.shape[0], 512, 64, device="cuda")
    with pytest.raises(ValueError, match="at most"):
        fused_dense_encoder_fwd(big, ef, src, dst, mask, W, b, depth=1)


# The reverse sweep's edge cases (rows 3, 4 and 6): its products run as
# 64 x 64 tiles over all B * E rows and its weight gradient in chunks of
# 1,024 rows, so widths of one tile (64) and of an odd count of tiles (320),
# row counts that fill no tile, slab or chunk (3 bins of 120 lanes: 360 rows;
# 96 molecules in bins of 120 lanes), the widest bins with mean, and the
# encoder's widest node slots. Each: (d, block bins' E, block bins kept
# (None: all), molecules, reduce, residual, encoder V, encoder E).
SWEEP_CASES = {
    "d64": (64, 128, None, 32, "sum", True, 32, 64),
    "d320": (320, 128, None, 32, "mean", False, 32, 64),
    "three_bins": (256, 120, 3, 32, "sum", True, 40, 60),
    "ragged_chunks": (256, 120, None, 96, "sum", True, 40, 60),
    "E256_mean": (256, 256, None, 32, "mean", True, 128, 256),
    "V256": (256, 256, None, 32, "sum", True, 256, 256),
}


def _edge_case(case, depth=3):
    """An edge case of SWEEP_CASES on the card: the block's seeded inputs
    (h0, src, dst, mask, W, b) with a cotangent that is zero on padded
    lanes, its keyword arguments, and the encoder's inputs
    (_encoder_inputs) on the same molecules."""
    d, E, bins, mols, reduce, residual, enc_V, enc_E = SWEEP_CASES[case]
    graphs = [PIPE(s) for s in (SMIS * 3)[:mols]]
    G = pack_graphs_dense(graphs, E // 2 + 8, E, np_out=True)
    keep = slice(None, bins)
    rng = np.random.default_rng(7)
    B = G.src[keep].shape[0]
    h0 = rng.standard_normal((B, E, d)).astype(np.float32)
    W = (rng.standard_normal((depth, d, d)) / np.sqrt(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal((depth, d))).astype(np.float32)
    g = (rng.standard_normal((B, E, d)) * G.edge_mask[keep][..., None]).astype(np.float32)
    block = [torch.from_numpy(np.ascontiguousarray(x)).cuda()
             for x in (h0, G.src[keep], G.dst[keep], G.edge_mask[keep], W, b, g)]
    assert bins is None or (B == bins and B * E % 64 != 0)
    kw = dict(depth=depth, n_nodes=E // 2 + 8, residual=residual, reduce=reduce)
    enc_mols = bins if bins is not None else mols
    enc = _encoder_inputs(enc_V, enc_E, depth, seed=8, d=d, graphs=graphs[:enc_mols])
    return block, kw, enc


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_cuda_sweep_edge_cases_match_plain_versions(case):
    """Rows 3, 4 and 6 against their plain versions on every lane
    (gradients atol 1e-4 x the tensor's largest magnitude, rtol 1e-4), and
    rows 3 and 6 twice with equal bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    (h0, src, dst, mask, W, b, g), kw, enc = _edge_case(case)
    ref_kw = {k: kw[k] for k in ("depth", "residual", "reduce")}
    _, hs = fused_dense_mpnn_block_stash(h0, src, dst, mask, W, b, **kw)
    _, ref_hs = dense_mpnn_block_stash_reference(h0, src, dst, mask, W, b, **ref_kw)
    ref = dense_mpnn_block_bwd_reference(h0, ref_hs, src, dst, mask, W, g, **ref_kw)
    first = fused_dense_mpnn_block_bwd_stash(h0, hs, src, dst, mask, W, g, **kw)
    second = fused_dense_mpnn_block_bwd_stash(h0, hs, src, dst, mask, W, g, **kw)
    recompute = fused_dense_mpnn_block_bwd(h0, src, dst, mask, W, b, g, **kw)
    torch.cuda.synchronize()
    _close_grads(first, ref)
    _close_grads(recompute, ref)
    assert all(torch.equal(x, y) for x, y in zip(first, second)), "the stash backward is not repeatable"

    nf, ef, esrc, edst, emask, eW, eb, gn, ge = enc
    enc_kw = ref_kw
    _, _, enc_hs = fused_dense_encoder_fwd(nf, ef, esrc, edst, emask, eW, eb, stash=True, **enc_kw)
    _, _, ref_enc_hs = dense_encoder_reference(nf, ef, esrc, edst, emask, eW, eb, stash=True, **enc_kw)
    enc_ref = dense_encoder_bwd_reference(nf, ef, ref_enc_hs, esrc, edst, emask, eW, gn, ge, **enc_kw)
    enc_first = fused_dense_encoder_bwd(nf, ef, enc_hs, esrc, edst, emask, eW, gn, ge, **enc_kw)
    enc_second = fused_dense_encoder_bwd(nf, ef, enc_hs, esrc, edst, emask, eW, gn, ge, **enc_kw)
    torch.cuda.synchronize()
    _close_grads(enc_first, enc_ref)
    assert all(torch.equal(x, y) for x, y in zip(enc_first, enc_second)), "the encoder backward is not repeatable"


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SWEEP_CASES))
@pytest.mark.parametrize("stash_dtype", [None, "bfloat16"])
def test_cuda_bf16_sweep_edge_cases_match_plain_versions(case, stash_dtype):
    """Rows 3b, 4b and 6b (matmul_dtype="bfloat16": both products on the
    tensor cores) at the sweep's edge cases, with an f32 and a bf16 stash,
    each against its plain version at BF16_*_TOL (defined below), fed the
    kernel's own stash; rows 3b and 6b twice with equal bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    (h0, src, dst, mask, W, b, g), kw, enc = _edge_case(case)
    mm = dict(matmul_dtype="bfloat16")
    ref_kw = {**{k: kw[k] for k in ("depth", "residual", "reduce")}, **mm}
    kw = {**kw, **mm}
    _, hs = fused_dense_mpnn_block_stash(h0, src, dst, mask, W, b, stash_dtype=stash_dtype, **kw)
    ref = dense_mpnn_block_bwd_reference(h0, hs, src, dst, mask, W, g, **ref_kw)
    first = fused_dense_mpnn_block_bwd_stash(h0, hs, src, dst, mask, W, g, **kw)
    second = fused_dense_mpnn_block_bwd_stash(h0, hs, src, dst, mask, W, g, **kw)
    for name, got, want in zip(("g_h0", "g_W", "g_b"), first, ref):
        _hold_bf16(got, want, f"row 3b {name} ({case})")
    assert all(torch.equal(x, y) for x, y in zip(first, second)), "row 3b is not repeatable"
    if stash_dtype is None:
        _, ref_hs = dense_mpnn_block_stash_reference(h0, src, dst, mask, W, b, **ref_kw)
        ref4 = dense_mpnn_block_bwd_reference(h0, ref_hs, src, dst, mask, W, g, **ref_kw)
        for name, got, want in zip(("g_h0", "g_W", "g_b"), fused_dense_mpnn_block_bwd(h0, src, dst, mask, W, b, g,
                                                                                       **kw), ref4):
            _hold_bf16(got, want, f"row 4b {name} ({case})")

    nf, ef, esrc, edst, emask, eW, eb, gn, ge = enc
    _, _, enc_hs = fused_dense_encoder_fwd(nf, ef, esrc, edst, emask, eW, eb, stash=True, stash_dtype=stash_dtype,
                                           **ref_kw)
    enc_ref = dense_encoder_bwd_reference(nf, ef, enc_hs, esrc, edst, emask, eW, gn, ge, **ref_kw)
    enc_first = fused_dense_encoder_bwd(nf, ef, enc_hs, esrc, edst, emask, eW, gn, ge, **ref_kw)
    enc_second = fused_dense_encoder_bwd(nf, ef, enc_hs, esrc, edst, emask, eW, gn, ge, **ref_kw)
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(zip(enc_first, enc_ref)):
        _hold_bf16(got, want, f"row 6b output {i} ({case})")
    assert all(torch.equal(x, y) for x, y in zip(enc_first, enc_second)), "row 6b is not repeatable"


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_cuda_fwd_edge_cases_match_plain_versions(case):
    """Rows 1, 2 and 5 at the same edge cases (the forward's products run
    as the sweep's do, in 64 x 64 tiles over all B * E rows): each against
    its plain version on every lane (rtol = atol = 1e-4), each twice with
    equal bits, and each counter adding depth a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    (h0, src, dst, mask, W, b, _), kw, (nf, ef, esrc, edst, emask, eW, eb, _, _) = _edge_case(case)
    ref_kw = {k: kw[k] for k in ("depth", "residual", "reduce")}
    counters = (fused_dense_mpnn_block, fused_dense_mpnn_block_stash, fused_dense_encoder_fwd)
    before = [fn.launches for fn in counters]
    runs = [
        (lambda: [fused_dense_mpnn_block(h0, src, dst, mask, W, b, **kw)],
         [dense_mpnn_block_reference(h0, src, dst, mask, W, b, **ref_kw)]),
        (lambda: list(fused_dense_mpnn_block_stash(h0, src, dst, mask, W, b, **kw)),
         list(dense_mpnn_block_stash_reference(h0, src, dst, mask, W, b, **ref_kw))),
        (lambda: list(fused_dense_encoder_fwd(nf, ef, esrc, edst, emask, eW, eb, stash=True, **ref_kw)),
         list(dense_encoder_reference(nf, ef, esrc, edst, emask, eW, eb, stash=True, **ref_kw))),
    ]
    for row, (kernel, ref) in zip((1, 2, 5), runs):
        first, second = kernel(), kernel()
        torch.cuda.synchronize()
        for got, want in zip(first, ref):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4, msg=lambda m: f"row {row}: {m}")
        assert all(torch.equal(x, y) for x, y in zip(first, second)), f"row {row} is not repeatable"
    assert [fn.launches for fn in counters] == [n + 2 * kw["depth"] for n in before]


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SWEEP_CASES))
@pytest.mark.parametrize("stash_dtype", [None, "bfloat16"])
def test_cuda_bf16_fwd_edge_cases_match_plain_versions(case, stash_dtype):
    """Rows 1b, 2b and 5b (matmul_dtype="bfloat16": the product relu(h) W
    on the tensor cores, in 64 x 128 tiles where the width allows, else 64 x
    64, over all B * E rows) at the forward's edge cases, with an f32 and a
    bf16 stash: each against its plain version at BF16_*_TOL, each twice
    with equal bits, each counter adding depth a call to its bf16 count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    (h0, src, dst, mask, W, b, _), kw, (nf, ef, esrc, edst, emask, eW, eb, _, _) = _edge_case(case)
    mm = dict(matmul_dtype="bfloat16")
    ref_kw = {**{k: kw[k] for k in ("depth", "residual", "reduce")}, **mm}
    kw = {**kw, **mm}
    half = dict(stash_dtype=stash_dtype)
    counters = (fused_dense_mpnn_block, fused_dense_mpnn_block_stash, fused_dense_encoder_fwd)
    before = [fn.launches_bf16 for fn in counters]
    runs = [
        (lambda: [fused_dense_mpnn_block(h0, src, dst, mask, W, b, **kw)],
         [dense_mpnn_block_reference(h0, src, dst, mask, W, b, **ref_kw)]),
        (lambda: list(fused_dense_mpnn_block_stash(h0, src, dst, mask, W, b, **kw, **half)),
         list(dense_mpnn_block_stash_reference(h0, src, dst, mask, W, b, **ref_kw, **half))),
        (lambda: list(fused_dense_encoder_fwd(nf, ef, esrc, edst, emask, eW, eb, stash=True, **ref_kw, **half)),
         list(dense_encoder_reference(nf, ef, esrc, edst, emask, eW, eb, stash=True, **ref_kw, **half))),
    ]
    for row, (kernel, ref) in zip(("1b", "2b", "5b"), runs):
        first, second = kernel(), kernel()
        torch.cuda.synchronize()
        for i, (got, want) in enumerate(zip(first, ref)):
            assert got.dtype == want.dtype, f"row {row} output {i} ({case})"
            _hold_bf16(got, want, f"row {row} output {i} ({case}, stash {stash_dtype})")
        assert all(torch.equal(x, y) for x, y in zip(first, second)), f"row {row} is not repeatable"
    assert [fn.launches_bf16 for fn in counters] == [n + 2 * kw["depth"] for n in before]


def _dbuf_case(E, bins, d=256, seed=0):
    """Row 7's inputs on the card: one molecule a bin (``bins`` of SMIS),
    seeded h0, W and b at width ``d``; and the block's n_nodes."""
    G = pad_graphs_dense([PIPE(s) for s in SMIS[:bins]], E // 2 + 8, E, np_out=True)
    rng = np.random.default_rng(seed)
    h0 = rng.standard_normal((bins, E, d)).astype(np.float32)
    W = (rng.standard_normal((3, d, d)) / np.sqrt(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal((3, d))).astype(np.float32)
    return tuple(torch.from_numpy(x).cuda() for x in (h0, G.src, G.dst, G.edge_mask, W, b)), E // 2 + 8


@pytest.mark.gpu
@pytest.mark.parametrize("E", [128, 256])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("bins", [32, 16])
def test_cuda_dbuf_matches_plain_version_and_row_1(E, reduce, residual, bins):
    """Row 7 against its plain version (rtol = atol = 1e-4) and against row
    1's kernel, bit for bit: the same FMAs in the same order. One launch a
    call, at 32 bins (four tiles of 8) and at 16 (two tiles of 8: half the
    groups)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args, n_nodes = _dbuf_case(E, bins)
    kw = dict(depth=3, n_nodes=n_nodes, residual=residual, reduce=reduce)
    before = fused_dense_mpnn_block_dbuf.launches
    out = fused_dense_mpnn_block_dbuf(*args, mols_per_tile=8, **kw)
    again = fused_dense_mpnn_block_dbuf(*args, mols_per_tile=8, **kw)
    row1 = fused_dense_mpnn_block(*args, **kw)
    torch.cuda.synchronize()
    assert fused_dense_mpnn_block_dbuf.launches == before + 2
    ref = dense_mpnn_block_reference(*args, depth=3, residual=residual, reduce=reduce)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(out, row1), f"dbuf differs from row 1 by {float((out - row1).abs().max())}"
    assert torch.equal(out, again), "row 7 is not repeatable"


@pytest.mark.gpu
@pytest.mark.parametrize("E", [128, 256])
@pytest.mark.parametrize("d", [64, 128, 512, 1024])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_cuda_dbuf_group_sizes_match_row_1(E, d, reduce):
    """Row 7 at group sizes of 1, 2, 8 and 16 blocks a bin (d / 64; at 16
    the card holds fewer groups than the 16 bins at once, so a group takes
    bins in turn) and both thread tiles (E <= 128 and E <= 256), bit for
    bit row 1's and within 1e-4 of its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args, n_nodes = _dbuf_case(E, 16, d, seed=1)
    kw = dict(depth=3, n_nodes=n_nodes, residual=True, reduce=reduce)
    out = fused_dense_mpnn_block_dbuf(*args, mols_per_tile=8, **kw)
    row1 = fused_dense_mpnn_block(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, dense_mpnn_block_reference(*args, depth=3, residual=True, reduce=reduce),
                               rtol=1e-4, atol=1e-4)
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
    """(data, perm, packed_dst, dst, edge_mask, V, tile_v) on the card: a
    flat batch of molecules (only real edges packed); the same with slots
    whose packed_dst names a node of another tile and slots of perm = -1
    between real ones (``messy``); random ids over 288 nodes in tiles of 48
    (``tile48``); or random ids over 256 nodes with node 3 holding 12,500
    edges, so that the budget (13,056 slots) takes more than 48 KiB of
    shared memory."""
    rng = np.random.default_rng(seed)
    tile_v = 128
    if kind in ("molecules", "messy"):
        bg = with_csr_packing(pad_graphs([PIPE(s) for s in SMIS], 1024, 2048, np_out=True))
        dst, mask, perm, pdst, V = bg.dst, bg.edge_mask, bg.csr_perm.copy(), bg.csr_dst.copy(), 1024
        if kind == "messy":
            real = np.nonzero(perm >= 0)[0]
            gone = rng.choice(real, size=len(real) // 8, replace=False)  # gaps between real slots
            perm[gone] = -1
            moved = rng.choice(np.setdiff1d(real, gone), size=len(real) // 8, replace=False)
            pdst[moved] = (pdst[moved] + 128 * rng.integers(1, V // 128, size=len(moved))) % V  # another tile
    elif kind == "tile48":
        V, tile_v = 288, 48
        dst = rng.integers(0, V, size=1500).astype(np.int32)
        mask = np.ones(len(dst), bool)
        perm, pdst, _ = pack_edges_by_tile(dst, num_nodes=V, tile_v=tile_v)
    else:
        V = 256
        dst = np.concatenate([rng.integers(0, V, size=1000), np.full(12500, 3)]).astype(np.int32)
        dst = dst[rng.permutation(len(dst))]
        mask = np.ones(len(dst), bool)
        perm, pdst, _ = pack_edges_by_tile(dst, num_nodes=V)
    data = rng.standard_normal((len(dst), d)).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in (data, perm, pdst, dst, mask)] + [V, tile_v]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["molecules", "random", "messy", "tile48"])
@pytest.mark.parametrize("d", [256, 36])
def test_cuda_csr_packed_matches_plain_version(kind, d):
    """Row 9 against its plain version, bit for bit its CPU run, one launch a
    call, and two calls give the same bits (a fixed summation order, no
    atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    data, perm, pdst, _, _, V, tile_v = _packed_case(kind, d)
    before = csr_segment_sum_packed.launches
    out = csr_segment_sum_packed(data, perm, pdst, V, tile_v=tile_v)
    again = csr_segment_sum_packed(data, perm, pdst, V, tile_v=tile_v)
    torch.cuda.synchronize()
    assert csr_segment_sum_packed.launches == before + 2
    _hold_sum(out, csr_segment_sum_packed_reference, data, perm, pdst, V, tile_v)
    assert torch.equal(out, again), "the packed sum is not repeatable"


@pytest.mark.gpu
def test_cuda_csr_packed_gradient():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    data, perm, pdst, dst, mask, V, _ = _packed_case("molecules", 64)
    x = data.clone().requires_grad_()
    g = torch.randn(V, 64, device="cuda")
    csr_segment_sum_packed(x, perm, pdst, V, dst=dst, edge_mask=mask).backward(g)
    assert torch.equal(x.grad, torch.where(mask[:, None], g[dst.long()], 0.0))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["molecules", "random"])
@pytest.mark.parametrize("d", [256, 36, 3, 1])
def test_cuda_csr_rowptr_matches_plain_version(kind, d):
    """Row 8 on dst-sorted edges: a sorted flat batch (padding at the sink),
    or random sorted ids with empty nodes and one node of 3,000 edges; any
    width (4-byte copies where d is not a multiple of 4)."""
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


def _glue_case(case, d, seed=0):
    """``(data, ids, num_segments)`` on the card, as tests/test_torch_csr.py's
    glue cases: 1-D data at d = 1, int64 ids over 40 segments with segment 7
    empty, none (E = 0), or a hub of 3,000 of 3,100 ids."""
    rng = np.random.default_rng(seed)
    if case == "empty_segment":
        V, ids = 40, rng.choice(np.setdiff1d(np.arange(40), [7]), size=300)
    elif case == "no_rows":
        V, ids = 16, np.zeros(0, np.int64)
    else:
        V, ids = 64, rng.permutation(np.concatenate([np.full(3000, 5), rng.integers(0, 64, size=100)]))
    shape = (len(ids),) if d == 1 else (len(ids), d)
    data = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
    return data, torch.from_numpy(ids.astype(np.int64)).cuda(), V


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["empty_segment", "no_rows", "hub"])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 96, 256])
def test_cuda_segment_sum_and_take_give_the_cpu_bits(case, d):
    """``ops.segment_sum`` and ``ops.take``'s backward on the card: one
    launch of row 8 each, the bits of the CPU (``index_add`` and
    ``index_select``'s backward), the same bits twice; the gradients of the
    sum a gather."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from notorch_tpu_torch.nn import ops

    data, ids, V = _glue_case(case, d)
    x = data.clone().requires_grad_()
    before = csr_segment_sum.launches
    out, again = ops.segment_sum(x, ids, V), ops.segment_sum(data, ids, V)
    g = torch.randn_like(out)
    out.backward(g)
    torch.cuda.synchronize()
    assert csr_segment_sum.launches == before + 2
    assert torch.equal(out, again)
    assert torch.equal(out.cpu(), torch.zeros_like(out.cpu()).index_add(0, ids.cpu(), data.cpu()))
    assert torch.equal(x.grad, g.index_select(0, ids))

    table = torch.randn((V,) + tuple(data.shape[1:]), device="cuda").requires_grad_()
    twice = []
    for _ in range(2):
        table.grad = None
        ops.take(table, ids).backward(data)
        twice.append(table.grad)
    torch.cuda.synchronize()
    assert csr_segment_sum.launches == before + 4
    assert torch.equal(twice[0], twice[1])
    plain = table.detach().cpu().requires_grad_()
    plain.index_select(0, ids.cpu()).backward(data.cpu())
    assert torch.equal(twice[0].cpu(), plain.grad)


@pytest.mark.gpu
def test_cuda_rowptr_takes_any_width_and_alignment_and_refuses_other_dtypes():
    """Row 8 on a view that starts 4 bytes into its storage (4-byte copies)
    gives the CPU plain version's bits; f64 data raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from notorch_tpu_torch.nn import ops

    data, ids, V = _glue_case("hub", 64)
    shifted = torch.zeros(data.numel() + 1, device="cuda")[1:].view_as(data)
    shifted.copy_(data)
    assert shifted.data_ptr() % 16
    got = ops.segment_sum(shifted, ids, V)
    assert torch.equal(got.cpu(), torch.zeros_like(got.cpu()).index_add(0, ids.cpu(), data.cpu()))
    with pytest.raises(TypeError, match="float32"):
        ops.segment_sum(data.double(), ids, V)


@pytest.mark.gpu
def test_cuda_csr_kernels_reject_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    data, perm, pdst, dst, _, V, _ = _packed_case("molecules", 64)
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


def star_bins(seed=0):
    """Two bins of V = 160 node slots and E = 128 edge lanes, every lane
    live (numpy ``src``, ``dst``, ``edge_mask``), whose one query row takes
    every edge: in bin 0 node 5 is the dst of all 128 lanes, their srcs
    random over the bin (pairs of several edges among them); in bin 1 node
    V - 1 is, each lane from another src. A block's list is then the whole
    bin, as long as any list a bin can give."""
    rng = np.random.default_rng(seed)
    V, E = 160, 128
    src = np.stack([rng.integers(0, V, E), rng.permutation(V)[:E]]).astype(np.int32)
    dst = np.stack([np.full(E, 5), np.full(E, V - 1)]).astype(np.int32)
    return src, dst, np.ones((2, E), bool)


def odd_bins(V, seed=0):
    """Three bins of V node slots and E = 96 edge lanes (numpy ``src``,
    ``dst``, ``edge_mask``), for row counts that no run of (row, head) slots
    divides. Bin 0: random edges among the first V - 2 nodes (the last two
    have none), a fifth of the lanes masked, every seventh lane repeating the
    pair before it. Bin 1: node V - 3 is a hub, the dst of 30 lanes and the
    src of 30, the rest random. Bin 2 has no live edge."""
    rng = np.random.default_rng(seed)
    E = 96
    src, dst = rng.integers(0, V - 2, (2, 3, E)).astype(np.int32)
    src[0, 1::7], dst[0, 1::7] = src[0, :-1:7], dst[0, :-1:7]
    dst[1, :30], src[1, 30:60] = V - 3, V - 3
    mask = rng.random((3, E)) < 0.8
    mask[1, :60], mask[2] = True, False
    return src, dst, mask


def attention_case(kind, d, H, edge_bias, seed=0):
    """(q, k, v, eb, src, dst, edge_mask, g) on the card. ``packed``: the
    molecules (a bond-less "O" and "[Na+].[Cl-]" among them) in bins of 128
    node slots and 256 edge lanes; ``dense``: one molecule a block; ``random``:
    V = 256, E = 512, random edges over the first 200 node slots (the rest
    are padding), a fifth of the lanes masked, duplicated pairs; ``hub``:
    :func:`hub_bins`; ``odd47``, ``odd49``: :func:`odd_bins` at V = 47, 49;
    ``star``: :func:`star_bins`."""
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
    elif kind.startswith("odd"):
        src, dst, mask = odd_bins(int(kind[3:]))
    elif kind == "star":
        src, dst, mask = star_bins()
    else:
        src = rng.integers(0, 200, (3, 512)).astype(np.int32)
        dst = rng.integers(0, 200, (3, 512)).astype(np.int32)
        src[:, 1::7], dst[:, 1::7] = src[:, :-1:7], dst[:, :-1:7]  # lane 7m + 1 repeats lane 7m
        mask = rng.random((3, 512)) < 0.8
    B, E = src.shape
    V = {"packed": 128, "dense": 48, "random": 256, "hub": 48, "odd47": 47, "odd49": 49, "star": 160}[kind]
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
@pytest.mark.parametrize("kind", ["odd47", "odd49"])
@pytest.mark.parametrize("edge_bias", [True, False])
@pytest.mark.parametrize("d, H", [(256, 4), (64, 1), (256, 8), (512, 1), (192, 3)])
def test_cuda_attention_kernels_match_plain_versions_on_odd_bins(kind, edge_bias, d, H):
    """The four entries on :func:`odd_bins` (:func:`_hold_attention_entries`):
    row counts that leave a run of slots or a cluster's last block part full,
    three heads whose rows straddle runs, a hub and a bin with no live edge,
    one head at dh = 64 and 512, eight heads. Row 12 gives the bits of row
    10, whose arithmetic it runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _hold_attention_entries(kind, d, H, edge_bias)
    q, k, v, eb, src, dst, mask, g = attention_case(kind, d, H, edge_bias)
    assert torch.equal(fused_dense_attention_fwd_v2(q, k, v, eb, src, dst, mask, num_heads=H),
                       fused_dense_attention_fwd(q, k, v, eb, src, dst, mask, num_heads=H))


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
    # rows 10-12 hold a block's edge list, row 13 two and each pair's values
    # for every head: E = 4,096 lanes at one head fit row 13, at four not
    wide = torch.zeros(1, 2048, 256, device="cuda")
    ids = torch.zeros(1, 4096, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="E=4096 edge lanes at H=4 heads"):
        fused_dense_attention_bwd_v2(wide, wide, wide, None, ids, ids, ids.bool(), wide, num_heads=4)
    small, lanes = torch.zeros(1, 8, 64, device="cuda"), torch.zeros(1, 10_000, dtype=torch.int32, device="cuda")
    for fwd in (fused_dense_attention_fwd, fused_dense_attention_fwd_v2):
        with pytest.raises(ValueError, match="E=10000 edge lanes need"):
            fwd(small, small, small, None, lanes, lanes, lanes.bool(), num_heads=1)
    tall, pair = torch.zeros(1, 46_341, 4, device="cuda"), torch.zeros(1, 2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="V=46341 node slots"):  # a list's keys row * V + other fit an int32
        fused_dense_attention_bwd_v2(tall, tall, tall, None, pair, pair, pair.bool(), tall, num_heads=1)


@pytest.mark.gpu
def test_cuda_attention_runs_bins_of_4096_lanes():
    """Rows 12-13 at V = 2048, E = 4096, one head of 64, a shape the block
    per (bin, head) design refused (its two staged [V, dh] head slices): 2,048
    random edges over 2,000 nodes, against the plain versions on every lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    V, E, d = 2048, 4096, 64
    src, dst = rng.integers(0, 2000, (2, 1, E)).astype(np.int32)
    mask = np.arange(E)[None] < 2048
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()  # noqa: E731
    q, k, v, eb, g = f(1, V, d), f(1, V, d), f(1, V, d), f(1, 1, E), f(1, V, d)
    src, dst, mask = (torch.from_numpy(x).cuda() for x in (src, dst, mask))
    out = fused_dense_attention_fwd_v2(q, k, v, eb, src, dst, mask, num_heads=1)
    grads = fused_dense_attention_bwd_v2(q, k, v, eb, src, dst, mask, g, num_heads=1)
    torch.testing.assert_close(out, dense_attention_reference(q, k, v, eb, src, dst, mask, 1), rtol=1e-4, atol=1e-4)
    _close_grads(grads, dense_attention_bwd_reference(q, k, v, eb, src, dst, mask, g, 1))


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


@pytest.mark.gpu
def test_cuda_prefetch_groups_are_aligned_views():
    """PrefetchLoader on the card: every item the loader's batches in
    order, each group one device buffer whose every step's arrays are
    contiguous views starting 256-byte aligned (the kernels take them
    without a copy), and ``stage`` the same on the current stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the staging copies to the card")
    from notorch_tpu_torch.data.batching import (DataLoader, PrefetchLoader, StackedBatch, stage, to_device,
                                                 unstack_tree)
    from notorch_tpu_torch.data.dataset import MolecularDataset, TargetSpec, TransformManager
    from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol

    smis = ["CCO", "c1ccccc1C(=O)O", "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "NC(=O)c1ccccc1", "O",
            "CC(=O)Nc1ccc(O)cc1", "C1CCNCC1", "FC(F)(F)c1ccccc1"] * 8
    ds = MolecularDataset({"smiles": smis, "y": [float(i) for i in range(len(smis))]},
                          {"g": TransformManager(Pipeline(SmiToMol(), MolToGraph()), "smiles", "G")},
                          targets={"y": TargetSpec(["y"])})

    def arrays(batch):
        out = {}
        for k, v in batch.items():
            if hasattr(v, "_ARRAYS"):
                out.update({f"{k}.{f}": getattr(v, f) for f in v._ARRAYS if getattr(v, f) is not None})
            else:
                out[k] = v
        return out

    plain = list(DataLoader(ds, batch_size=4))
    at, grouped = 0, 0
    for item in PrefetchLoader(DataLoader(ds, batch_size=4), buffer_size=2, stack=4):
        steps = [unstack_tree(item.tree, i) for i in range(item.n)] if isinstance(item, StackedBatch) else [item]
        grouped += isinstance(item, StackedBatch)
        for step in steps:
            for name, t in arrays(step).items():
                assert t.is_cuda and t.is_contiguous() and t.data_ptr() % 256 == 0, name
                np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(arrays(plain[at])[name]), err_msg=name)
            at += 1
    assert at == len(plain) and grouped > 0
    on_card = [to_device(b, "cuda") for b in plain[:4]]
    for batches in (plain[:4], on_card):  # from the host, and copied into place on the card
        tree, buffer = stage(batches, "cuda")
        assert buffer.is_cuda
        for i in range(4):
            for name, t in arrays(unstack_tree(tree, i)).items():
                assert t.data_ptr() % 256 == 0
                np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(arrays(plain[i])[name]), err_msg=name)


@pytest.mark.gpu
def test_cuda_pretraining_groups_batches_already_on_the_card(tmp_path):
    """Masked-atom pretraining with steps_per_dispatch 4 on the card, the
    batches grouped by ``fit`` after the prefetcher moved them to the card
    (the JAX ``run_pretrain``'s route) and by the prefetcher itself
    (``run_pretrain``): both end with the bits, in every parameter and Adam
    state, of one step at a time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pretrainer trains on the card")
    import csv

    from notorch_tpu_torch.cli.train import prepare_pretrain, run_pretrain
    from notorch_tpu_torch.data.batching import PrefetchLoader, group_batches
    from notorch_tpu_torch.training.loop import fit

    with open(Path(__file__).parent / "data" / "lipo.csv", newline="") as f:
        smiles = [row["smiles"] for row in csv.DictReader(f)][:192]
    path = tmp_path / "mols.csv"
    path.write_text("smiles\n" + "\n".join(smiles) + "\n")

    def cfg(**trainer):
        return {"data": {"csv": str(path), "smiles_col": "smiles"},
                "model": {"kind": "pretrain", "hidden_dim": 64, "depth": 2, "mask_rate": 0.15},
                "optimizer": {"name": "adam", "lr": 1e-3},
                "trainer": {"epochs": 2, "batch_size": 16, "seed": 0, **trainer}}

    def bits(model) -> list:
        state = model.train_state_dict()
        return [*model.network.state_dict().values(), *torch.utils._pytree.tree_leaves(state["optimizer"])]

    run_ = prepare_pretrain(cfg())
    run_["train_loader"].set_epoch(0)
    assert 4 in [len(g) for g in group_batches(run_["train_loader"], 4)]
    fit(run_["model"], run_["train_loader"], epochs=2)
    want = bits(run_["model"])
    run_ = prepare_pretrain(cfg())
    fit(run_["model"], PrefetchLoader(run_["train_loader"]), epochs=2, steps_per_dispatch=4)
    pretrained = run_pretrain(cfg(steps_per_dispatch=4))["model"]
    for model in (run_["model"], pretrained):
        got = bits(model)
        assert len(got) == len(want)
        assert all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b for a, b in zip(got, want))
