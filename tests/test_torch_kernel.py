"""The fused D-MPNN block of the port against the JAX Pallas kernel.

On the CPU the port's wrapper takes its plain version, which is compared
with ``notorch_tpu.kernels.dense_mpnn.fused_dense_mpnn_block`` run in
interpret mode, on every edge lane. Tolerance rtol=atol=1e-4: f32 on both
sides with a different summation order (as in test_pallas_kernels.py). The
CUDA kernel itself is compared with the plain version on the card in
test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

from notorch_tpu.kernels.dense_mpnn import fused_dense_mpnn_block as jax_block
from notorch_tpu_torch.data.dense import pack_graphs_dense
from notorch_tpu_torch.kernels.dense_mpnn import (
    dense_mpnn_block_reference,
    edge_adjacency,
    fused_dense_mpnn_block,
)
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol

PIPE = Pipeline(SmiToMol(), MolToGraph())
SMIS = ["CCO", "c1ccccc1C(=O)O", "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "NC(=O)c1ccccc1", "O",
        "CC(=O)Nc1ccc(O)cc1", "C1CCNCC1", "FC(F)(F)c1ccccc1"]


def _inputs(d=32, depth=3, seed=0, E=64, V=40):
    """Seeded numpy inputs on bins packed from real molecules: real edge
    lanes, padded lanes and an all-padding bin."""
    G = pack_graphs_dense([PIPE(s) for s in SMIS], V, E, bin_cap=4, np_out=True)
    rng = np.random.default_rng(seed)
    B = G.src.shape[0]
    return dict(
        h0=rng.standard_normal((B, E, d)).astype(np.float32),
        src=G.src, dst=G.dst, edge_mask=G.edge_mask,
        W=(rng.standard_normal((depth, d, d)) / np.sqrt(d)).astype(np.float32),
        b=(0.1 * rng.standard_normal((depth, d))).astype(np.float32),
        n_nodes=V,
    )


def _torch(x):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in x.items()}


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("residual", [True, False])
def test_reference_matches_jax_kernel_all_lanes(reduce, residual):
    x = _inputs()
    depth = x["W"].shape[0]
    ref = jax_block(
        x["h0"], x["src"], x["dst"], x["edge_mask"], x["W"], x["b"],
        depth=depth, n_nodes=x["n_nodes"], residual=residual, mols_per_tile=2,
        interpret=True, reduce=reduce,
    )
    t = _torch(x)
    out = dense_mpnn_block_reference(
        t["h0"], t["src"], t["dst"], t["edge_mask"], t["W"], t["b"],
        depth=depth, residual=residual, reduce=reduce,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_cpu_wrapper_takes_plain_version(reduce):
    t = _torch(_inputs())
    fused_dense_mpnn_block.launches = 0
    out = fused_dense_mpnn_block(
        t["h0"], t["src"], t["dst"], t["edge_mask"], t["W"], t["b"],
        depth=3, n_nodes=t["n_nodes"], reduce=reduce,
    )
    ref = dense_mpnn_block_reference(
        t["h0"], t["src"], t["dst"], t["edge_mask"], t["W"], t["b"], depth=3, reduce=reduce
    )
    assert torch.equal(out, ref)
    assert fused_dense_mpnn_block.launches == 0


def test_edge_adjacency_fold():
    """A has the rev diagonal removed on real pairs (sum) and the rows of
    mean sum to 1 - 1 on real edges."""
    t = _torch(_inputs())
    A = edge_adjacency(t["src"], t["dst"], t["edge_mask"])
    E = A.shape[1]
    idx = torch.arange(E)
    assert not A[:, idx, idx ^ 1].any()
    Am = edge_adjacency(t["src"], t["dst"], t["edge_mask"], mean=True)
    real = t["edge_mask"]
    rows = Am.sum(-1)[real]
    keep_rows = A.sum(-1)[real] + 1  # in-degree of src(e), rev included
    assert torch.allclose(rows[keep_rows > 0], torch.zeros_like(rows[keep_rows > 0]), atol=1e-6)


@pytest.mark.parametrize(
    "field,bad,err",
    [
        ("h0", lambda x: x.double(), TypeError),
        ("src", lambda x: x.long(), TypeError),
        ("edge_mask", lambda x: x.int(), TypeError),
        ("W", lambda x: x[:2], ValueError),
        ("b", lambda x: x[:, :16], ValueError),
        ("h0", lambda x: x[:, :63], ValueError),
        ("h0", lambda x: x.transpose(0, 1).contiguous().transpose(0, 1), ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(field, bad, err):
    t = _torch(_inputs())
    t[field] = bad(t[field])
    with pytest.raises(err):
        fused_dense_mpnn_block(
            t["h0"], t["src"], t["dst"], t["edge_mask"], t["W"], t["b"],
            depth=3, n_nodes=t["n_nodes"],
        )


def test_wrapper_rejects_unknown_reduce():
    t = _torch(_inputs())
    with pytest.raises(ValueError, match="reduce"):
        fused_dense_mpnn_block(
            t["h0"], t["src"], t["dst"], t["edge_mask"], t["W"], t["b"],
            depth=3, n_nodes=t["n_nodes"], reduce="max",
        )


def test_library_hash_covers_sources_headers_and_flags(tmp_path, monkeypatch):
    """A library's name changes with its source, with a header beside it
    and with the flags, so a stale build is never loaded; other sources do
    not change it. No nvcc is needed to name a library."""
    from notorch_tpu_torch.kernels import build

    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "b.cu").write_text("// other\n")
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.library_path("a")
    assert first == build.library_path("a") and first.name.startswith("liba-")
    (tmp_path / "b.cu").write_text("// other, edited\n")
    assert build.library_path("a") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = build.library_path("a")
    assert second != first
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n// edited\n')
    assert build.library_path("a") not in (first, second)
    monkeypatch.setattr(build, "NVCC_FLAGS", (*build.NVCC_FLAGS, "-lineinfo"))
    assert build.library_path("a") not in (first, second)
    assert build.sources() == ["a", "b"]
