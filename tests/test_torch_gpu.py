"""The CUDA kernel of the fused D-MPNN block against its plain version, on
the card. Skips where there is no CUDA device. This file imports no JAX, so
that it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerance rtol=atol=1e-4: both sides are exact f32 (no TF32), summed in a
different order over depth 3.
"""

import numpy as np
import pytest
import torch

from notorch_tpu_torch.data.dense import pack_graphs_dense
from notorch_tpu_torch.kernels.dense_mpnn import dense_mpnn_block_reference, fused_dense_mpnn_block
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
