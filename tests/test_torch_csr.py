"""The CSR segment sums and the segment ops against the JAX package.

The plain versions of both kernels (what CPU tensors take) against the JAX
Pallas kernels run with ``interpret=True``, at rtol = atol = 1e-5 (f32,
another summation order): on real molecule batches, on random sorted ids
with empty and over-full nodes (row pointers) and on random unsorted ids
(packed); the packed sum's gradient against the JAX custom VJP. The JAX
row-pointer kernel visits a bounded number of edge chunks per node tile and
drops the edges past them; the port sums exactly, so the two agree on the
tiles inside that bound and differ on a tile past it. The segment ops
(``index_add``/``scatter_reduce``) against ``jax.ops.segment_*``, with max
and min gradients on inputs without ties (the two frameworks split a tied
gradient differently). ``ops.segment_sum`` and ``ops.take``, through which
every sum and gather of the port's glue goes, against ``jax.ops.segment_sum``
and ``jnp.take``, and the order the card sums them in against ``index_add``'s
bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from notorch_tpu.kernels import csr_segment as jax_csr
from notorch_tpu.nn import ops as jax_ops
from notorch_tpu_torch.data.graph import csr_row_ptr, pad_graphs, sort_edges_by_dst, with_csr_packing
from notorch_tpu_torch.kernels.csr_segment import (
    csr_segment_sum,
    csr_segment_sum_packed,
    csr_segment_sum_packed_reference,
    csr_segment_sum_reference,
    pack_edges_by_tile,
    segment_sum_in_order,
    sorted_segments,
)
from notorch_tpu_torch.nn import ops
from notorch_tpu_torch.transforms import MolToGraph, Pipeline, SmiToMol

TOL = dict(rtol=1e-5, atol=1e-5)
PIPE = Pipeline(SmiToMol(), MolToGraph())
SMIS = ["CCO", "c1ccccc1C(=O)O", "NC(=O)c1ccccc1", "CCCCCCCC", "CC(=O)Nc1ccc(O)cc1", "O"]


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _molecules(node_cap=128, edge_cap=256):
    return pad_graphs([PIPE(s) for s in SMIS], node_cap, edge_cap, graph_cap=len(SMIS), np_out=True)


# -- row 8: the sum over row pointers --------------------------------------------------


def _rowptr_case(kind, rng):
    if kind == "molecules":  # dst-sorted real batch, padding edges at the sink
        bg, _ = sort_edges_by_dst(_molecules())
        return np.asarray(bg.dst), 128, dict(tile_v=32, tile_e=64)
    # random sorted ids: nodes 3..9 empty, node 20 holds 60 edges
    V, E = 64, 512
    ids = rng.integers(0, V, size=E - 60)
    ids = np.where((ids >= 3) & (ids < 10), 11, ids)
    dst = np.sort(np.concatenate([ids, np.full(60, 20)])).astype(np.int32)
    return dst, V, dict(tile_v=16, tile_e=64)


@pytest.mark.parametrize("kind", ["molecules", "random_sorted"])
def test_rowptr_plain_matches_jax_kernel(kind, rng):
    dst, V, tiles = _rowptr_case(kind, rng)
    d = 32
    data = rng.normal(size=(len(dst), d)).astype(np.float32)
    row_ptr = csr_row_ptr(dst, V)
    ref = jax_csr.csr_segment_sum(jnp.asarray(data), jnp.asarray(dst), jnp.asarray(row_ptr), num_nodes=V,
                                  max_degree=64, interpret=True, **tiles)
    before = csr_segment_sum.launches
    got = csr_segment_sum(t(data), t(dst), t(row_ptr), V, max_degree=64, **tiles)
    assert csr_segment_sum.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(csr_segment_sum_reference(t(data), t(row_ptr), V).numpy(),
                               np.asarray(jax.ops.segment_sum(data, dst, num_segments=V)), **TOL)
    if kind == "random_sorted":
        counts = np.bincount(dst, minlength=V)
        assert counts[3:10].sum() == 0 and counts.max() >= 60
        assert not got.numpy()[3:10].any()


def test_rowptr_sums_past_the_jax_chunk_cap(rng):
    """With max_degree=2 the JAX grid visits (16 * 2) // 64 + 2 = 2 chunks of
    64 edges per 16-node tile: the tiles whose edges fit in them agree, and
    a tile whose edges run past them loses those edges there, not here."""
    V, E, d, tile_v, tile_e = 64, 512, 16, 16, 64
    dst = np.sort(rng.integers(0, V, size=E)).astype(np.int32)
    data = rng.normal(size=(E, d)).astype(np.float32)
    row_ptr = csr_row_ptr(dst, V)
    ref = np.asarray(jax_csr.csr_segment_sum(jnp.asarray(data), jnp.asarray(dst), jnp.asarray(row_ptr),
                                             num_nodes=V, tile_v=tile_v, tile_e=tile_e, max_degree=2,
                                             interpret=True))
    got = csr_segment_sum(t(data), t(dst), t(row_ptr), V, tile_v=tile_v, tile_e=tile_e, max_degree=2).numpy()
    exact = np.asarray(jax.ops.segment_sum(data, dst, num_segments=V))
    np.testing.assert_allclose(got, exact, **TOL)
    max_chunks = (tile_v * 2) // tile_e + 2
    inside = []
    for tile in range(V // tile_v):
        lo, hi = row_ptr[tile * tile_v], row_ptr[(tile + 1) * tile_v]
        inside.append(hi <= (lo // tile_e + max_chunks) * tile_e)
        rows = slice(tile * tile_v, (tile + 1) * tile_v)
        if inside[-1]:
            np.testing.assert_allclose(got[rows], ref[rows], **TOL)
        else:
            assert np.abs(got[rows] - ref[rows]).max() > 1e-2
    assert any(inside) and not all(inside)


def test_rowptr_checks_and_has_no_gradient():
    data = torch.zeros(256, 8)
    dst, row_ptr = torch.zeros(256, dtype=torch.int32), torch.zeros(129, dtype=torch.int32)
    with pytest.raises(ValueError, match="tile_v"):
        csr_segment_sum(data, dst, row_ptr[:101], 100)
    with pytest.raises(ValueError, match="tile_e"):
        csr_segment_sum(data[:200], dst[:200], row_ptr, 128)
    with pytest.raises(ValueError, match="row_ptr"):
        csr_segment_sum(data, dst, row_ptr[:128], 128)
    with pytest.raises(TypeError, match="row_ptr"):
        csr_segment_sum(data, dst, row_ptr.long(), 128)
    with pytest.raises(RuntimeError, match="no gradient"):
        csr_segment_sum(data.requires_grad_(), dst, row_ptr, 128)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        csr_segment_sum(torch.zeros(256, 8, device="meta"), dst.to("meta"), row_ptr.to("meta"), 128)


# -- row 9: the packed sum ---------------------------------------------------------------


def _packed_case(kind, rng):
    if kind == "molecules":  # real batch: only real edges packed
        bg = with_csr_packing(_molecules())
        return (np.asarray(bg.dst), np.asarray(bg.edge_mask), np.asarray(bg.csr_perm),
                np.asarray(bg.csr_dst), 128)
    V, E = 256, 1024  # random unsorted ids, every edge real
    dst = rng.integers(0, V, size=E).astype(np.int32)
    perm, packed_dst, _ = pack_edges_by_tile(dst, num_nodes=V)
    return dst, np.ones(E, bool), perm, packed_dst, V


@pytest.mark.parametrize("kind", ["molecules", "random_unsorted"])
def test_packed_plain_matches_jax_kernel(kind, rng):
    dst, mask, perm, packed_dst, V = _packed_case(kind, rng)
    data = rng.normal(size=(len(dst), 32)).astype(np.float32)
    ref = jax_csr.csr_segment_sum_packed(jnp.asarray(data), jnp.asarray(perm), jnp.asarray(packed_dst),
                                         num_nodes=V, interpret=True)
    before = csr_segment_sum_packed.launches
    got = csr_segment_sum_packed(t(data), t(perm), t(packed_dst), V)
    assert csr_segment_sum_packed.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    exact = np.asarray(jax.ops.segment_sum(data * mask[:, None], dst, num_segments=V))
    np.testing.assert_allclose(csr_segment_sum_packed_reference(t(data), t(perm), t(packed_dst), V).numpy(),
                               exact, **TOL)


@pytest.mark.parametrize("with_dst", [True, False])
def test_packed_gradient_matches_jax_vjp(with_dst, rng):
    """d_data = where(edge_mask, g[dst], 0); without dst the JAX VJP gives
    zero, and so does the port."""
    dst, mask, perm, packed_dst, V = _packed_case("molecules", rng)
    data = rng.normal(size=(len(dst), 16)).astype(np.float32)
    g = rng.normal(size=(V, 16)).astype(np.float32)
    kw = dict(dst=dst, edge_mask=mask) if with_dst else {}

    def f(x):
        return jax_csr.csr_segment_sum_packed(x, jnp.asarray(perm), jnp.asarray(packed_dst), num_nodes=V,
                                              interpret=True, **{k: jnp.asarray(v) for k, v in kw.items()})

    out, vjp = jax.vjp(f, jnp.asarray(data))
    (ref,) = vjp(jnp.asarray(g))
    x = t(data).requires_grad_()
    got = csr_segment_sum_packed(x, t(perm), t(packed_dst), V, **{k: t(v) for k, v in kw.items()})
    got.backward(t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(ref))
    assert x.grad.abs().sum() > 0 if with_dst else not x.grad.any()


def test_packed_checks():
    data = torch.zeros(64, 8)
    perm, pdst = torch.full((256,), -1, dtype=torch.int32), torch.full((256,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="tile_v"):
        csr_segment_sum_packed(data, perm, pdst, 100)
    with pytest.raises(ValueError, match="tile_e"):
        csr_segment_sum_packed(data, perm, pdst, 256, tile_e=96)  # budget 128
    with pytest.raises(ValueError, match="do not split"):
        csr_segment_sum_packed(data, perm[:255], pdst[:255], 256)
    with pytest.raises(ValueError, match="packed_dst"):
        csr_segment_sum_packed(data, perm, pdst[:128], 256)
    with pytest.raises(ValueError, match="edge_mask"):
        csr_segment_sum_packed(data, perm, pdst, 256, dst=torch.zeros(64, dtype=torch.int32),
                               edge_mask=torch.ones(32, dtype=torch.bool))
    for other in (pack_edges_by_tile, jax_csr.pack_edges_by_tile):
        with pytest.raises(ValueError, match="exceeds budget"):
            other(np.zeros(300, np.int32), num_nodes=256, budget=256)
    assert not csr_segment_sum_packed(data, perm, pdst, 256).any()  # padding slots add nothing


# -- the segment ops -----------------------------------------------------------------------


@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
def test_segment_reduce_matches_jax(reduce, rng):
    """Values and gradients on 3-D data with empty segments (ids 5 and 7
    are never used); the data are distinct, so max and min have no ties."""
    n, num = 60, 9
    ids = rng.choice([0, 1, 2, 3, 4, 6, 8], size=n).astype(np.int32)
    data = rng.permutation(n * 4 * 2).reshape(n, 4, 2).astype(np.float32) / 10 - 20
    g = rng.normal(size=(num, 4, 2)).astype(np.float32)
    out, vjp = jax.vjp(lambda x: jax_ops.segment_reduce(x, jnp.asarray(ids), num, reduce), jnp.asarray(data))
    x = t(data).requires_grad_()
    got = ops.segment_reduce(x, t(ids), num, reduce)
    got.backward(t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), **TOL)
    assert not got[[5, 7]].any()  # empty segments read 0
    with pytest.raises(ValueError, match="unknown reduction"):
        ops.segment_reduce(x, t(ids), num, "median")


@pytest.mark.parametrize("masked", [True, False])
def test_segment_softmax_matches_jax(masked, rng):
    n, num = 50, 6
    ids = rng.integers(0, num - 1, size=n).astype(np.int32)  # the last segment is empty
    scores = rng.normal(size=n).astype(np.float32) * 3
    mask = rng.random(n) > 0.3 if masked else None
    g = rng.normal(size=n).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(lambda s: jax_ops.segment_softmax(s, jnp.asarray(ids), num, mask=jmask), jnp.asarray(scores))
    x = t(scores).requires_grad_()
    got = ops.segment_softmax(x, t(ids), num, mask=None if mask is None else t(mask))
    got.backward(t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), **TOL)


# -- segment_sum and take: every sum and gather of the port's glue -------------------------


def _glue_case(case, d, rng):
    """``(data, ids, num_segments)``: 1-D data at d = 1, else ``[E, d]``;
    int64 ids over 40 segments of which segment 7 is empty, none at all
    (E = 0), or over 64 segments with 3,000 of 3,100 ids on segment 5 (a
    hub), in random order."""
    if case == "empty_segment":
        V, ids = 40, rng.choice(np.setdiff1d(np.arange(40), [7]), size=300)
    elif case == "no_rows":
        V, ids = 16, np.zeros(0, np.int64)
    else:
        V, ids = 64, rng.permutation(np.concatenate([np.full(3000, 5), rng.integers(0, 64, size=100)]))
    shape = (len(ids),) if d == 1 else (len(ids), d)
    return rng.standard_normal(shape).astype(np.float32), ids.astype(np.int64), V


GLUE_CASES = ["empty_segment", "no_rows", "hub"]
GLUE_WIDTHS = [1, 2, 3, 4, 96, 256]


@pytest.mark.parametrize("case", GLUE_CASES)
@pytest.mark.parametrize("d", GLUE_WIDTHS)
def test_segment_sum_and_take_match_jax_with_the_index_add_bits(case, d, rng):
    """``ops.segment_sum`` and ``ops.take`` on the CPU against
    ``jax.ops.segment_sum`` and ``jnp.take``, values and gradients (against
    ``jax.vjp``); the order the card sums in (the stable sort of the ids,
    row 8's plain version over it) gives ``index_add``'s bits, and the
    gather's gradient ``index_select``'s."""
    data, ids, V = _glue_case(case, d, rng)
    g_sum = rng.standard_normal((V,) + data.shape[1:]).astype(np.float32)
    x = t(data).requires_grad_()
    got = ops.segment_sum(x, t(ids), V)
    got.backward(t(g_sum))
    out, vjp = jax.vjp(lambda a: jax.ops.segment_sum(a, jnp.asarray(ids), V), jnp.asarray(data))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(g_sum))[0]), **TOL)
    index_add = torch.zeros_like(got).index_add(0, t(ids), t(data))
    in_order = segment_sum_in_order(t(data), *sorted_segments(t(ids), V), V)
    assert torch.equal(got, index_add) and torch.equal(in_order, index_add)

    table = t(rng.standard_normal((V,) + data.shape[1:]).astype(np.float32)).requires_grad_()
    g_take = t(rng.standard_normal(data.shape).astype(np.float32))
    taken = ops.take(table, t(ids))
    taken.backward(g_take)
    out, vjp = jax.vjp(lambda a: jnp.take(a, jnp.asarray(ids), axis=0), jnp.asarray(table.detach().numpy()))
    np.testing.assert_allclose(taken.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(table.grad.numpy(), np.asarray(vjp(g_take.numpy())[0]), **TOL)
    plain = table.detach().clone().requires_grad_()
    plain.index_select(0, t(ids)).backward(g_take)
    assert torch.equal(table.grad, plain.grad)
    assert torch.equal(table.grad, segment_sum_in_order(g_take, *sorted_segments(t(ids), V), V))
