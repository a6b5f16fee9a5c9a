"""The CUDA kernels of the fused D-MPNN block against their plain versions,
on the card. Skips where there is no CUDA device. This file imports no JAX,
so that it also runs where JAX is not installed:

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

from notorch_tpu_torch.data.dense import pack_graphs_dense
from notorch_tpu_torch.kernels.dense_mpnn import (
    dense_mpnn_block_bwd_reference,
    dense_mpnn_block_reference,
    dense_mpnn_block_stash_reference,
    fused_dense_mpnn_block,
    fused_dense_mpnn_block_bwd,
    fused_dense_mpnn_block_bwd_stash,
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
