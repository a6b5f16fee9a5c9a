"""The D-MPNN forward's edge cases on the CPU: the plain block, stash and
encoder forwards (what each wrapper takes for a CPU tensor, and what the
card's kernels are held to in test_torch_gpu.py) against the JAX Pallas
kernels run in interpret mode, on every lane.

The cases are test_torch_gpu.py's ``SWEEP_CASES`` cut to a few bins: a
width of one 64-column tile (64) and of an odd count of them (320), bins of
120 lanes whose rows fill no 64-row tile, the widest bins (256 lanes) with
mean, and the encoder's widest node slots (256). Tolerance: rtol = atol =
1e-4, f32 on both sides summed in another order over depth 3 at d <= 320 (as
test_torch_kernel.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from notorch_tpu.kernels.dense_mpnn import fused_dense_encoder_fwd as jax_enc_fwd
from notorch_tpu.kernels.dense_mpnn import fused_dense_mpnn_block as jax_block
from notorch_tpu.kernels.dense_mpnn import fused_dense_mpnn_block_stash as jax_stash
from notorch_tpu_torch.data.dense import pack_graphs_dense, pad_graphs_dense
from notorch_tpu_torch.kernels.dense_mpnn import (
    fused_dense_encoder_fwd,
    fused_dense_mpnn_block,
    fused_dense_mpnn_block_stash,
)
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol

PIPE = Pipeline(SmiToMol(), MolToGraph())
SMIS = ["CCO", "c1ccccc1C(=O)O", "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "NC(=O)c1ccccc1", "O",
        "CC(=O)Nc1ccc(O)cc1", "C1CCNCC1", "FC(F)(F)c1ccccc1"]
TOL = dict(rtol=1e-4, atol=1e-4)
DEPTH = 3
# (d, block bins' E, block bins kept, molecules, reduce, residual, encoder V,
# encoder E, encoder molecules)
CASES = {
    "d64": (64, 128, 2, 32, "sum", True, 32, 64, 2),
    "d320": (320, 128, 2, 32, "mean", False, 32, 64, 2),
    "three_bins": (256, 120, 3, 32, "sum", True, 40, 60, 3),
    "ragged_rows": (256, 120, 5, 96, "sum", True, 40, 60, 5),
    "E256_mean": (256, 256, 2, 32, "mean", True, 128, 256, 2),
    "V256": (256, 256, 2, 32, "sum", True, 256, 256, 2),
}
COUNTERS = (fused_dense_mpnn_block, fused_dense_mpnn_block_stash, fused_dense_encoder_fwd)


def _block_inputs(case):
    d, E, bins, mols, *_ = CASES[case]
    G = pack_graphs_dense([PIPE(s) for s in (SMIS * 12)[:mols]], E // 2 + 8, E, np_out=True)
    rng = np.random.default_rng(7)
    B = min(bins, G.src.shape[0])
    return dict(
        h0=rng.standard_normal((B, E, d)).astype(np.float32),
        src=G.src[:B], dst=G.dst[:B], edge_mask=G.edge_mask[:B],
        W=(rng.standard_normal((DEPTH, d, d)) / np.sqrt(d)).astype(np.float32),
        b=(0.1 * rng.standard_normal((DEPTH, d))).astype(np.float32),
    )


def _encoder_inputs(case):
    d, *_, V, E, mols = CASES[case]
    G = pad_graphs_dense([PIPE(s) for s in (SMIS * 2)[:mols]], V, E, np_out=True)
    rng = np.random.default_rng(8)
    B = G.src.shape[0]
    f32 = lambda *shape, scale=1.0: (scale * rng.standard_normal(shape)).astype(np.float32)
    return dict(nf=f32(B, V, d), ef=f32(B, E, d), src=G.src, dst=G.dst, edge_mask=G.edge_mask,
                W=f32(DEPTH, d, d, scale=1 / np.sqrt(d)), b=f32(DEPTH, d, scale=0.1))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_block_and_stash_forwards_match_jax(case):
    """Row 1's and row 2's plain versions (the output, and the stash of the
    layer inputs) equal the JAX kernels' on every lane; the CPU path counts
    no launch."""
    *_, reduce, residual, _, _, _ = CASES[case]
    x = _block_inputs(case)
    B, E, d = x["h0"].shape
    assert case not in ("three_bins", "ragged_rows") or B * E % 64 != 0
    args = [x[k] for k in ("h0", "src", "dst", "edge_mask", "W", "b")]
    kw = dict(depth=DEPTH, n_nodes=E // 2 + 8, residual=residual, reduce=reduce)
    before = [fn.launches for fn in COUNTERS]
    out = fused_dense_mpnn_block(*map(_t, args), **kw)
    s_out, s_hs = fused_dense_mpnn_block_stash(*map(_t, args), **kw)
    jargs = [jnp.asarray(a) for a in args]
    ref = jax_block(*jargs, mols_per_tile=B, interpret=True, **kw)
    ref_out, ref_hs = jax_stash(*jargs, mols_per_tile=B, interpret=True, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(s_out.numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(s_hs.numpy(), np.asarray(ref_hs), **TOL)
    assert [fn.launches for fn in COUNTERS] == before


@pytest.mark.parametrize("case", list(CASES))
def test_plain_encoder_forward_matches_jax(case):
    """Row 5's plain version (node and edge hiddens, with and without the
    stash, and the stash) equals the JAX kernel's on every lane; the CPU
    path counts no launch."""
    *_, reduce, residual, _, _, _ = CASES[case]
    x = _encoder_inputs(case)
    args = [x[k] for k in ("nf", "ef", "src", "dst", "edge_mask", "W", "b")]
    kw = dict(depth=DEPTH, residual=residual, reduce=reduce)
    before = [fn.launches for fn in COUNTERS]
    for stash in (False, True):
        nh, eh, hs = fused_dense_encoder_fwd(*map(_t, args), stash=stash, **kw)
        ref = jax_enc_fwd(*map(jnp.asarray, args), mols_per_tile=x["nf"].shape[0], interpret=True,
                          stash=stash, **kw)
        np.testing.assert_allclose(nh.numpy(), np.asarray(ref[0]), **TOL)
        np.testing.assert_allclose(eh.numpy(), np.asarray(ref[1]), **TOL)
        if stash:
            np.testing.assert_allclose(hs.numpy(), np.asarray(ref[2]), **TOL)
        else:
            assert hs is None and ref[2] is None
    assert [fn.launches for fn in COUNTERS] == before
