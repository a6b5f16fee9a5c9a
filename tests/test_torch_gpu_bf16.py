"""The kernels' bf16 modes against their plain versions, on the card: the
attention core's rows 10b-13b with bf16 inputs (a bf16 model's path) and
with ``matmul_dtype="bfloat16"`` on f32 inputs, the depth-fused D-MPNN
forward's row 7b, row 8b (the ordered bf16 segment sum of the glue), row 9b
(the packed segment sum on bf16 data) and its gradient, the bf16
graph-transformer and ``impl: csr`` D-MPNN blocks card against CPU, and
the kernel of the bf16 forward's products (rows 1b, 2b, 4b, 5b: the
tensor cores') by profiler. Skips
where there is no CUDA device; imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_bf16.py -q

Tolerances: the kernels and their plain versions round the same operands at
the same points and sum in f32 in other orders, so an f32 ulp of a sum can
flip the next bf16 rounding (2^-8 relative): each tensor is held
elementwise within BF16_ELEMENT_TOL of its largest magnitude and in
relative L2 within BF16_L2_TOL, as rows 1b-6b are (``chip_smoke.py``). Row
8b adds each segment's terms in the CPU plain version's order with the same
roundings: bit for bit; so does row 9b (each chunk's terms in slot order in
f32, the same roundings at the same chunk boundaries). Row 7b is held to
row 1b bit for bit besides (both sum each product k16 by k16 in ascending k
on the tensor cores). Every kernel is called twice for the same bits.
The bf16 graph-transformer block, card against CPU, adds the dense layers
(cuBLAS against the CPU's bf16 products) and two layers for a flipped
rounding to grow through: its output and gradients held at BLOCK_ELEMENT_TOL
and BLOCK_L2_TOL (measured at hidden 64, depth 2, on an H100 80GB HBM3 at
700 W: 4.9e-3 of a tensor's largest magnitude and 2.48e-3 in relative L2 at
most), the biases whose gradient is zero in exact arithmetic (ZERO_GRADS: a
shift along a softmax row moves nothing) at the scale of the largest
gradient.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from notorch_tpu_torch.kernels.csr_segment import (
    bf16_chain_sum_reference,
    csr_segment_sum,
    csr_segment_sum_packed,
    csr_segment_sum_packed_bf16_reference,
)
from notorch_tpu_torch.kernels.dense_attention import (
    dense_attention_bwd_reference,
    dense_attention_reference,
    fused_dense_attention_bwd,
    fused_dense_attention_bwd_v2,
    fused_dense_attention_fwd,
    fused_dense_attention_fwd_v2,
)
from notorch_tpu_torch.kernels.dense_mpnn import (
    dense_mpnn_block_reference,
    fused_dense_encoder_fwd,
    fused_dense_mpnn_block,
    fused_dense_mpnn_block_bwd,
    fused_dense_mpnn_block_dbuf,
    fused_dense_mpnn_block_stash,
)
from notorch_tpu_torch.nn.attention_dense import DenseGATBlock

from notorch_tpu_torch.nn.chemprop import ChempropBlock

from .test_torch_gpu import _dbuf_case, _glue_case, _packed_case, attention_case

BF16_ELEMENT_TOL, BF16_L2_TOL = 1e-2, 1e-3
BLOCK_ELEMENT_TOL, BLOCK_L2_TOL = 2e-2, 8e-3
ZERO_GRADS = ("W_k.bias", "W_bias.bias")
ENTRIES = ((fused_dense_attention_fwd, fused_dense_attention_bwd),
           (fused_dense_attention_fwd_v2, fused_dense_attention_bwd_v2))


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def held(got: torch.Tensor, ref: torch.Tensor, what: str, element_tol: float = BF16_ELEMENT_TOL,
         l2_tol: float = BF16_L2_TOL) -> None:
    got, ref = got.float(), ref.float()
    assert bool(torch.isfinite(got).all()), what
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    l2 = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref).clamp_min(1e-30))
    assert err <= element_tol * scale and l2 <= l2_tol, (what, err, scale, l2)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["packed", "dense", "random", "hub", "odd47", "odd49", "star"])
@pytest.mark.parametrize("edge_bias", [True, False])
@pytest.mark.parametrize("mode", ["bf16_inputs", "matmul_dtype"])
@pytest.mark.parametrize("d, H", [(256, 4), (16, 2), (256, 8), (512, 1), (192, 3), (64, 1)])
def test_cuda_bf16_attention_kernels_match_plain_versions(kind, edge_bias, mode, d, H):
    """Rows 10b-13b: the four entries in either bf16 mode against the plain
    versions on every lane, outputs in the inputs' dtype; rows with no live
    pair are zero in the output and in g_q, key rows with none in g_k and
    g_v; each backward twice bit for bit; each launch counted in its mode's
    count. The kinds include hub rows (more pairs than a warp, a pair of
    three edges), bins whose rows no run of slots divides, a bin with no
    live lane and bins whose one row takes every edge (``star``: the
    forward keeps a score for every pair and head of its block's list in
    shared memory); the widths heads of 1-4 vectors a lane (each pass of the
    query walk fetches each pair once, whatever a lane holds)."""
    needs_card()
    case = attention_case(kind, d, H, edge_bias)
    q, k, v, eb, src, dst, mask, g = case
    if mode == "bf16_inputs":
        q, k, v, eb, g = (None if x is None else x.bfloat16() for x in (q, k, v, eb, g))
        kw, count = {}, "launches_bf16"
    else:
        kw, count = {"matmul_dtype": "bfloat16"}, "launches_mm"
    ref = dense_attention_reference(q, k, v, eb, src, dst, mask, H, **kw)
    ref_grads = dense_attention_bwd_reference(q, k, v, eb, src, dst, mask, g, H, **kw)
    live = (ref != 0).any(-1) | (dense_attention_reference(torch.ones_like(q), k, v, eb, src, dst, mask, H) != 0).any(-1)
    keyed = (dense_attention_bwd_reference(q.float(), k.float(), v.float(), None, src, dst, mask,
                                           torch.ones_like(g).float(), H)[2] != 0).any(-1)
    for fwd, bwd in ENTRIES:
        before = (getattr(fwd, count), getattr(bwd, count))
        out = fwd(q, k, v, eb, src, dst, mask, num_heads=H, **kw)
        first = bwd(q, k, v, eb, src, dst, mask, g, num_heads=H, **kw)
        second = bwd(q, k, v, eb, src, dst, mask, g, num_heads=H, **kw)
        again = fwd(q, k, v, eb, src, dst, mask, num_heads=H, **kw)
        torch.cuda.synchronize()
        assert (getattr(fwd, count) - before[0], getattr(bwd, count) - before[1]) == (2, 2)
        assert out.dtype == q.dtype and all(x.dtype == q.dtype for x in first)
        held(out, ref, f"{fwd.__name__} output")
        for name, x, r in zip(("g_q", "g_k", "g_v", "g_eb"), first, ref_grads):
            if name != "g_eb" or edge_bias:
                held(x, r, f"{bwd.__name__} {name}")
        if not edge_bias:
            assert not first[3].any()
        assert torch.equal(out, again) and all(torch.equal(a, b) for a, b in zip(first, second))
        assert not out[~live].any() and not first[0][~live].any()
        assert not first[1][~keyed].any() and not first[2][~keyed].any()


@pytest.mark.gpu
@pytest.mark.parametrize("E", [128, 256])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("d", [256, 192])
@pytest.mark.parametrize("bins", [32, 16])
def test_cuda_dbuf_bf16_matches_plain_version_and_row_1b(E, reduce, residual, d, bins):
    """Row 7b against its plain version at the bf16 holds (the same
    roundings, sums in other orders) and against row 1b's kernel bit for bit
    (both sum each product k16 by k16 in ascending k on the tensor cores);
    twice with equal bits; one launch a call, counted in ``launches_bf16``;
    after row 7's f32 instantiation in the same process (each instantiation
    opts in to its shared memory). E = 128 and 256 are the two product tiles
    (128 and 256 rows), d = 192 row 1b's 64-column tiles and three blocks a
    bin, 16 bins half the groups."""
    needs_card()
    args, n_nodes = _dbuf_case(E, bins, d)
    kw = dict(depth=3, n_nodes=n_nodes, residual=residual, reduce=reduce, matmul_dtype="bfloat16")
    fused_dense_mpnn_block_dbuf(*args, mols_per_tile=8, **{**kw, "matmul_dtype": None})
    before = fused_dense_mpnn_block_dbuf.launches_bf16
    out = fused_dense_mpnn_block_dbuf(*args, mols_per_tile=8, **kw)
    again = fused_dense_mpnn_block_dbuf(*args, mols_per_tile=8, **kw)
    row1b = fused_dense_mpnn_block(*args, **kw)
    torch.cuda.synchronize()
    assert fused_dense_mpnn_block_dbuf.launches_bf16 == before + 2
    held(out, dense_mpnn_block_reference(*args, depth=3, residual=residual, reduce=reduce,
                                         matmul_dtype="bfloat16"), "row 7b")
    assert torch.equal(out, row1b), f"row 7b differs from row 1b by {float((out - row1b).abs().max())}"
    assert torch.equal(out, again), "row 7b is not repeatable"


@pytest.mark.gpu
@pytest.mark.parametrize("E", [128, 256])
@pytest.mark.parametrize("d", [64, 128, 512, 1024])
@pytest.mark.parametrize("depth", [1, 2])
def test_cuda_dbuf_bf16_group_sizes_and_depths_match_row_1b(E, d, depth):
    """Row 7b at group sizes of 1, 2, 8 and 16 blocks a bin (at 16 the card
    holds fewer groups than the 16 bins at once, so a group takes bins in
    turn), at depth 1 (no exchange: no scratch) and 2 (one exchange half),
    bit for bit row 1b's and at the bf16 holds of its plain version."""
    needs_card()
    args, n_nodes = _dbuf_case(E, 16, d, seed=1)
    args = (*args[:4], args[4][:depth], args[5][:depth])
    kw = dict(depth=depth, n_nodes=n_nodes, residual=True, reduce="mean", matmul_dtype="bfloat16")
    out = fused_dense_mpnn_block_dbuf(*args, mols_per_tile=8, **kw)
    row1b = fused_dense_mpnn_block(*args, **kw)
    torch.cuda.synchronize()
    held(out, dense_mpnn_block_reference(*args, depth=depth, residual=True, reduce="mean",
                                         matmul_dtype="bfloat16"), "row 7b")
    assert torch.equal(out, row1b), f"row 7b differs from row 1b by {float((out - row1b).abs().max())}"


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["empty_segment", "no_rows", "hub"])
@pytest.mark.parametrize("d", [1, 3, 4, 96, 256])
def test_cuda_bf16_segment_sum_and_take_give_the_cpu_bits(case, d):
    """Row 8b through ``ops.segment_sum`` and ``ops.take``'s backward on bf16
    data: one launch each (``launches_bf16``), the bits of the CPU's ordered
    bf16 chain, twice the same."""
    needs_card()
    from notorch_tpu_torch.nn import ops

    data, ids, V = _glue_case(case, d)
    data = data.bfloat16()
    before = csr_segment_sum.launches_bf16
    out, again = ops.segment_sum(data, ids, V), ops.segment_sum(data, ids, V)
    torch.cuda.synchronize()
    assert csr_segment_sum.launches_bf16 == before + 2 and out.dtype == torch.bfloat16
    assert torch.equal(out, again)
    assert torch.equal(out.cpu(), ops.segment_sum(data.cpu(), ids.cpu(), V))
    table = torch.randn((V,) + tuple(data.shape[1:]), device="cuda").requires_grad_()
    grads = []
    for device in ("cuda", "cuda", "cpu"):
        leaf = table.detach().to(device).requires_grad_()
        ops.take(leaf.bfloat16(), ids.to(device)).backward(data.to(device))
        grads.append(leaf.grad.cpu())
    assert csr_segment_sum.launches_bf16 == before + 4
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0], grads[2])


@pytest.mark.gpu
def test_cuda_bf16_chain_sum_reference_is_the_kernel():
    """Row 8b's plain version on the card's own rows: the kernel's bits."""
    needs_card()
    data, ids, V = _glue_case("hub", 64, seed=3)
    order = torch.sort(ids, stable=True)[1]
    rows = data.bfloat16().index_select(0, order)
    row_ptr = torch.searchsorted(ids[order], torch.arange(V + 1, device="cuda"), out_int32=True)
    from notorch_tpu_torch.kernels.csr_segment import segment_sum_in_order

    got = segment_sum_in_order(data.bfloat16(), order, row_ptr, V)
    assert torch.equal(got.cpu(), bf16_chain_sum_reference(rows.cpu(), row_ptr.cpu(), V))


def _chain_bits(data, ids, V):
    """Row 8b on the card twice over the stable sort of ``ids`` (CPU
    tensors), and its plain version on the CPU."""
    from notorch_tpu_torch.kernels.csr_segment import segment_sum_in_order, sorted_segments

    order, row_ptr = sorted_segments(ids, V)
    x, o, rp = data.cuda(), order.cuda(), row_ptr.cuda()
    first, second = segment_sum_in_order(x, o, rp, V), segment_sum_in_order(x, o, rp, V)
    torch.cuda.synchronize()
    rows = data.index_select(0, order).reshape(order.shape[0], -1)
    return first.cpu(), second.cpu(), bf16_chain_sum_reference(rows, row_ptr, V).reshape(first.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", chip_smoke.BF16_PAIR_CLASSES)
@pytest.mark.parametrize("d", [8, 3])
def test_cuda_bf16_chain_add_on_pair_classes(kind, d):
    """Row 8b's step (one packed bf16 add) on each class of bf16 pairs
    (subnormals, signed zeros, infinities, ties, exponent gaps): each segment
    a pair, the plain version's bits (the f32 add rounded), twice the same."""
    needs_card()
    data, ids, V = chip_smoke.bf16_pair_rows(*chip_smoke.bf16_pairs(kind, 8192, seed=21), d)
    first, second, plain = _chain_bits(data, ids, V)
    assert torch.equal(first.view(torch.int16), plain.view(torch.int16)), kind
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


@pytest.mark.gpu
def test_cuda_bf16_chain_add_on_random_bit_patterns():
    """Row 8b's step on 2^20 pairs of random bf16 bit patterns (every finite
    value, both infinities; no NaN, never +inf with -inf): the plain
    version's bits."""
    needs_card()
    rng = np.random.default_rng(22)
    a, b = (rng.integers(0, 1 << 16, size=1 << 20, dtype=np.uint32).astype(np.uint16) for _ in range(2))
    finite = lambda x: (x & 0x7F80) != 0x7F80  # noqa: E731
    inf = lambda x: (x & 0x7FFF) == 0x7F80  # noqa: E731
    keep = (finite(a) | inf(a)) & (finite(b) | inf(b)) & ~(inf(a) & inf(b) & (a != b))
    data, ids, V = chip_smoke.bf16_pair_rows(a[keep], b[keep], 8)
    first, _, plain = _chain_bits(data, ids, V)
    assert torch.equal(first.view(torch.int16), plain.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 3, 4, 96, 256, 258])
def test_cuda_bf16_chain_widths_and_windows(d):
    """Row 8b at every width class (1 column, odd, even, multiples of 8, a
    ragged last slice) on a run of 3,000 rows, which crosses twelve windows
    of the kernel's ring, beside short and empty segments: the plain
    version's bits, twice the same."""
    needs_card()
    rng = np.random.default_rng(23)
    V = 300
    ids = rng.permutation(np.concatenate([np.full(3000, 17), rng.integers(0, V, size=1200)]))
    ids = ids[ids != 99]  # segment 99 empty
    data = torch.from_numpy(rng.standard_normal((ids.size, d)).astype(np.float32)).bfloat16()
    first, second, plain = _chain_bits(data, torch.from_numpy(ids), V)
    assert torch.equal(first.view(torch.int16), plain.view(torch.int16))
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


@pytest.mark.gpu
def test_cuda_bf16_chain_table_gradient_and_one_launch():
    """Row 8b at the embedding table's gradient that ``chip_smoke.py`` times
    (the dense first lipo batch: 21,504 ids, a run of 9,513): the plain
    version's bits, twice the same; and each call one kernel launch, no
    conversion or copy kernel around it (``torch.profiler``)."""
    needs_card()
    import tempfile
    from pathlib import Path

    from notorch_tpu_torch.kernels.csr_segment import segment_sum_in_order, sorted_segments

    with tempfile.TemporaryDirectory(prefix="bf16_chain_") as tmp:
        ds = chip_smoke.build_dataset({"csv": str(chip_smoke.lipo_csv(Path(tmp), chip_smoke.BATCH)),
                                       "targets": {"y": {"columns": ["lipo"]}}})
        G = next(iter(chip_smoke.DataLoader(ds, batch_size=chip_smoke.BATCH, layout="dense")))["inputs.G"]
    data, ids, V = chip_smoke.table_gradient(G, 256)
    assert int(torch.bincount(ids).max()) == 9513
    first, second, plain = _chain_bits(data, ids, V)
    assert torch.equal(first.view(torch.int16), plain.view(torch.int16))
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))
    order, row_ptr = (t.cuda() for t in sorted_segments(ids, V))
    x = data.cuda()
    segment_sum_in_order(x, order, row_ptr, V)
    torch.cuda.synchronize()
    before = csr_segment_sum.launches_bf16
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            segment_sum_in_order(x, order, row_ptr, V)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert csr_segment_sum.launches_bf16 == before + 3
    assert len(names) == 3 and all("rowptr_kernel_bf16" in n for n in names), names


@pytest.mark.gpu
def test_cuda_bf16_graph_transformer_block_matches_cpu():
    """DenseGATBlock(impl: fused, fwd_impl: pallas, dtype: bfloat16) on the
    card (rows 12b-13b) against the same block on the CPU: output and every
    parameter gradient at the block's hold."""
    needs_card()
    from notorch_tpu_torch.data.dense import pad_graphs_dense
    from .test_torch_gpu import PIPE, SMIS

    G = pad_graphs_dense([PIPE(s) for s in SMIS], 48, 128)
    rng = np.random.default_rng(4)
    B, V = G.node_mask.shape
    nf = torch.from_numpy(rng.standard_normal((B, V, 64)).astype(np.float32))
    ef = torch.from_numpy(rng.standard_normal((B, G.src.shape[1], 64)).astype(np.float32))
    results = []
    for device in ("cpu", "cuda"):
        torch.manual_seed(0)
        block = DenseGATBlock(hidden_dim=64, depth=2, num_heads=4, impl="fused", fwd_impl="pallas",
                              dtype="bfloat16")
        block.reset_parameters(torch.Generator().manual_seed(0))
        block.to(device)
        Gd = G.to(device).update(node_feats=nf.to(device).bfloat16(), edge_feats=ef.to(device).bfloat16())
        out = block(Gd).node_feats
        out.float().square().sum().backward()
        results.append({"output": out.detach().cpu(), **{n: p.grad.cpu() for n, p in block.named_parameters()}})
    scale = max(float(g.abs().max()) for n, g in results[0].items() if n != "output")
    for name, ref in results[0].items():
        got = results[1][name]
        if name.endswith(ZERO_GRADS):
            assert float((got - ref).abs().max()) <= BLOCK_ELEMENT_TOL * scale, name
        else:
            held(got, ref, f"the bf16 block's {name}", BLOCK_ELEMENT_TOL, BLOCK_L2_TOL)


def _chunk_case(kind, d, seed=0):
    """``_packed_case``'s cases, or ``chip_smoke.py``'s whose runs cross
    128-slot chunks (``chunk_case_ids``), in ``_packed_case``'s form."""
    if kind not in chip_smoke.CHUNK_CASES:
        return _packed_case(kind, d, seed)
    x = chip_smoke.chunk_flat_inputs(kind, d, seed)
    return [x[k] for k in ("data", "perm", "packed_dst", "dst", "edge_mask")] + [chip_smoke.CHUNK_NODES, 128]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["molecules", "random", "messy", "tile48", *chip_smoke.CHUNK_CASES])
@pytest.mark.parametrize("d", [256, 36, 40])
@pytest.mark.parametrize("tile_e", [128, 32])
def test_cuda_bf16_packed_sum_gives_the_plain_versions_bits(kind, d, tile_e):
    """Row 9b: one launch a call (``launches_bf16``), bf16 out, the bits of
    its plain version on the card and on the CPU, twice the same; ``tile_e``
    moves the chunk boundaries, and with them the result. The widths: 256
    and 40 are read in 16-byte vectors of 8 values (40 with lanes past the
    row), 36 in 8-byte vectors of 4."""
    needs_card()
    data, perm, pdst, _, _, V, tile_v = _chunk_case(kind, d)
    data = data.bfloat16()
    before = (csr_segment_sum_packed.launches, csr_segment_sum_packed.launches_bf16)
    out = csr_segment_sum_packed(data, perm, pdst, V, tile_v=tile_v, tile_e=tile_e)
    again = csr_segment_sum_packed(data, perm, pdst, V, tile_v=tile_v, tile_e=tile_e)
    plain = csr_segment_sum_packed_bf16_reference(data, perm, pdst, V, tile_v, tile_e)
    torch.cuda.synchronize()
    assert (csr_segment_sum_packed.launches, csr_segment_sum_packed.launches_bf16) == (before[0], before[1] + 2)
    assert out.dtype == torch.bfloat16 and torch.equal(out, again)
    assert torch.equal(out, plain), f"off its plain version by {float((out.float() - plain.float()).abs().max())}"
    cpu = csr_segment_sum_packed_bf16_reference(data.cpu(), perm.cpu(), pdst.cpu(), V, tile_v, tile_e)
    assert torch.equal(out.cpu(), cpu)


@pytest.mark.gpu
def test_cuda_bf16_packed_sum_gradient_and_refusals():
    """Row 9b's gradient is the masked gather of the bf16 cotangent; the
    wrapper refuses a budget that tile_e does not divide and rows whose
    width is not a multiple of 4."""
    needs_card()
    data, perm, pdst, dst, mask, V, _ = _packed_case("molecules", 64)
    x = data.bfloat16().requires_grad_()
    g = torch.randn(V, 64, device="cuda").bfloat16()
    csr_segment_sum_packed(x, perm, pdst, V, dst=dst, edge_mask=mask).backward(g)
    assert x.grad.dtype == torch.bfloat16 and torch.equal(x.grad, torch.where(mask[:, None], g[dst.long()], 0.0))
    with pytest.raises(ValueError, match="multiple of tile_e"):
        csr_segment_sum_packed(data.bfloat16(), perm, pdst, V, tile_e=96)
    with pytest.raises(ValueError, match="multiple of 4"):
        csr_segment_sum_packed(data[:, :30].bfloat16().contiguous(), perm, pdst, V)


@pytest.mark.gpu
def test_cuda_bf16_csr_block_matches_cpu():
    """ChempropBlock(impl="csr", dtype="bfloat16") on the card (row 9b in
    every reduce: 4 launches a forward) against the same block on the CPU:
    output and every gradient at the bf16 block's hold (the dense layers'
    products are summed in other orders; the reduces give the same bits)."""
    needs_card()
    from notorch_tpu_torch.data.graph import pad_graphs, with_csr_packing
    from .test_torch_gpu import PIPE, SMIS

    torch.backends.cuda.matmul.allow_tf32 = False
    bg = with_csr_packing(pad_graphs([PIPE(s) for s in SMIS], 1024, 2048, np_out=True))
    rng = np.random.default_rng(3)
    nf, ef = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for shape in ((1024, 64), (2048, 64)))
    results = []
    for device in ("cpu", "cuda"):
        block = ChempropBlock(hidden_dim=64, depth=3, impl="csr", dtype="bfloat16")
        block.reset_parameters(torch.Generator().manual_seed(0))
        block.to(device)
        x_n = nf.to(device).bfloat16().requires_grad_()
        x_e = ef.to(device).bfloat16().requires_grad_()
        before = csr_segment_sum_packed.launches_bf16
        out = block(bg.to(device).update(node_feats=x_n, edge_feats=x_e))
        (out.node_feats.float().square().sum() + out.edge_feats.float().sum()).backward()
        if device == "cuda":
            torch.cuda.synchronize()
            assert csr_segment_sum_packed.launches_bf16 - before == 4
        results.append({"node_feats": out.node_feats.detach().cpu(), "edge_feats": out.edge_feats.detach().cpu(),
                        "g_node_feats": x_n.grad.cpu(), "g_edge_feats": x_e.grad.cpu(),
                        **{n: p.grad.cpu() for n, p in block.named_parameters()}})
    for name, ref in results[0].items():
        held(results[1][name], ref, f"the bf16 csr block's {name}", BLOCK_ELEMENT_TOL, BLOCK_L2_TOL)


@pytest.mark.gpu
def test_cuda_bf16_forward_products_run_on_the_tensor_cores():
    """Rows 1b, 2b, 4b (its replay) and 5b launch the tensor-core product
    ``mpnn_fwd_gemm_mma_kernel`` once a layer and no other product kernel,
    and row 1 in f32 keeps the FMA product: one profile of a call of each
    (3 + 3 + 2 + 3 launches of the one, 3 of the other), 120-lane bins (a
    row count no tile divides) and the encoder at V = 128, E = 256. (Kept
    last in the file and to one profiler session: after several sessions in
    a process the profiler has dropped kernel records on this machine.)"""
    needs_card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .test_torch_gpu import _encoder_inputs, _train_inputs

    depth = 3
    h0, src, dst, mask, W, b, g = _train_inputs(120, depth)
    nf, ef, esrc, edst, emask, eW, eb, _, _ = _encoder_inputs(128, 256, depth)
    kw = dict(depth=depth, n_nodes=68, residual=True, reduce="sum")
    mm = dict(matmul_dtype="bfloat16")
    calls = [
        lambda: fused_dense_mpnn_block(h0, src, dst, mask, W, b, **kw, **mm),
        lambda: fused_dense_mpnn_block_stash(h0, src, dst, mask, W, b, stash_dtype="bfloat16", **kw, **mm),
        lambda: fused_dense_mpnn_block_bwd(h0, src, dst, mask, W, b, g, **kw, **mm),
        lambda: fused_dense_encoder_fwd(nf, ef, esrc, edst, emask, eW, eb, stash=True, stash_dtype="bfloat16",
                                        depth=depth, residual=True, reduce="sum", **mm),
        lambda: fused_dense_mpnn_block(h0, src, dst, mask, W, b, **kw),
    ]
    for call in calls:
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
        torch.cuda.synchronize()
    products = {e.key: e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "mpnn_fwd_gemm_" in e.key}
    on_tensor_cores = sum(n for k, n in products.items() if "mpnn_fwd_gemm_mma_kernel" in k)
    assert (on_tensor_cores, sum(products.values())) == (3 + 3 + 2 + 3, 3 + 3 + 2 + 3 + 3), products
