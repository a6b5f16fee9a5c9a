"""The CUDA kernels of the fused D-MPNN block, the fused encoder and the
double-buffered forward against their plain versions, on the card. Skips
where there is no CUDA device. This file imports no JAX, so that it also
runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: rtol=atol=1e-4 for the forward kernels, both sides exact f32
(no TF32) summed in a different order over depth 3. Gradients: rtol=1e-4
and atol 1e-4 times the tensor's largest magnitude, because g_W and g_b sum
B * E products each, so the rounding of an element follows the size of
the terms it sums, not its own size, which cancellation can make small.
"""

import numpy as np
import pytest
import torch

from notorch_tpu_torch.data.dense import pack_graphs_dense, pad_graphs_dense
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
