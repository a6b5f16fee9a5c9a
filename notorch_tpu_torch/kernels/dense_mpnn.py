"""The fused dense D-MPNN block and the whole fused encoder: hand-written
Hopper kernels for their forwards and backwards, their plain PyTorch
versions, the wrappers that pick between them by device, and the
``autograd.Function``s that train through them.

Replaces the Pallas kernels of ``notorch_tpu/kernels/dense_mpnn.py``:

================================  =========================================
TPU entry (kernel)                here
================================  =========================================
``fused_dense_mpnn_block``        :func:`fused_dense_mpnn_block`, the
(``_block_kernel``)               ``mpnn_fwd_`` kernels of
                                  ``csrc/dense_mpnn.cu``
``fused_dense_mpnn_block_stash``  :func:`fused_dense_mpnn_block_stash`, the
(``_block_kernel_stash``)         same forward writing into the stash
``fused_dense_mpnn_block_bwd_``   :func:`fused_dense_mpnn_block_bwd_stash`,
``stash`` (``_bwd_kernel_stash``) ``csrc/dense_mpnn_bwd.cu``
``fused_dense_mpnn_block_bwd``    :func:`fused_dense_mpnn_block_bwd`: replay
(``_bwd_kernel``)                 by the forward, then the sweep of
                                  ``csrc/dense_mpnn_bwd.cu``
``fused_dense_encoder_fwd``       :func:`fused_dense_encoder_fwd`: the same
(``_encoder_kernel(_stash)``)     forward with the gather in its prep and
                                  the scatter in its last layer
``fused_dense_encoder_bwd``       :func:`fused_dense_encoder_bwd`: the sweep
(``_encoder_bwd_kernel(_d1)``)    of ``csrc/dense_mpnn_bwd.cu`` with the
                                  scatter's VJP in its first launches and
                                  ``h0``'s recompute and the gather's VJP in
                                  its last
``fused_dense_mpnn_block_dbuf``   :func:`fused_dense_mpnn_block_dbuf`, the
(``_dbuf_kernel``)                depth-fused kernel of
                                  ``csrc/dense_mpnn.cu`` (one launch a
                                  call, a group of blocks a bin)
================================  =========================================

The encoder is ``h0 = node_feats[src] + edge_feats`` (unmasked; a ``src``
outside ``[0, V)`` gathers zero, as the JAX one-hot does), the block, then
``node_hiddens[v] = sum_e [dst e == v] * edge_mask e * h[e]`` (divided by
the real in-degree floored at 1 for ``mean``); ``h0`` is neither returned
nor stashed (the forward writes it once into scratch), and the backward
recomputes it as the TPU kernel does.

The CUDA sources are built by ``nvcc`` for ``sm_90a`` at first use and
bound with ``ctypes`` (:mod:`notorch_tpu_torch.kernels.build`). Tensors on
the CPU take the plain versions; tensors on a CUDA device launch the
kernels or raise — there is no fallback. Each wrapper counts in
``<wrapper>.launches``: rows 1, 2 and 5's forwards the layers they run, the
depth-fused forward and the backwards their calls.

What the block computes, per bin ``b`` with ``rev(e) = e XOR 1``:

- ``A[e,e'] = [src[e] == dst[e']] * emask[e'] * [e' != rev(e)]`` for
  ``reduce="sum"``; for ``reduce="mean"``, ``keep / max(indeg, 1) - [e' ==
  rev(e)]`` with ``keep`` the first two factors and ``indeg`` its row sum;
- for each layer ``l``: ``h <- (h +) b_l + A @ (relu(h) @ W_l)``.

The reverse-message subtraction is folded into ``A``, so on PADDED edge
lanes the result differs from the unfolded form of
:class:`~notorch_tpu_torch.nn.chemprop_dense.DenseChempropBlock`; kernels,
plain versions and the JAX kernels agree on every lane. The backward is
the exact VJP of the folded block for any cotangent; it is the gradient of
the unfolded block too when the cotangent is zero on padded lanes, which
the masked scatter after the block guarantees.

What bounds the kernels on the card: the work is exact f32, so the floor
is the CUDA-core f32 rate (67 TFLOP/s on an H100 SXM). Forward: ``depth *
(2 * B * E * d**2 + 2 * nnz(A) * d)`` operations; backward: ``depth * (4 *
B * E * d**2 + 2 * nnz(A) * d)``, plus the forward's for the replay of the
recompute backward. Their bytes (each input read once, each output written
once) take a fifth to a tenth as long, so all are bound by operations,
nearly all of them in the W-sized products. The forward is one C call a
block call (``dense_mpnn_forward``): a prep kernel builds the bit rows of
``A`` of every bin once (and, for the encoder, writes the gathered ``h0``
and the scatter's node bit rows), then each layer runs ``relu(h) @ W`` as
one tiled exact-f32 product over all ``B * E`` rows (64 x 64 tiles, so the
card gets many more blocks than bins) and ``A @ mW`` as a row-sparse walk
over the bit rows in 1,024-thread blocks, one per (bin, 64 columns), so
``A`` costs operations only where it is nonzero and is never stored; the
encoder's last layer writes the masked scatter from the same blocks. The
depth-fused forward (row 7) runs a whole call in one launch, a group of
blocks per bin keeping the bin's ``h`` in shared memory through every
layer. Every sum runs in a fixed order, row 7's too, so two calls give the
same bits and row 7 gives row 1's (``csrc/dense_mpnn.cu`` says how).
Because each layer's output already goes to device memory, the stash forward is that same forward writing layer ``l
< depth - 1`` into ``hs[l]``: the stash costs no bytes beyond what the
serving forward moves (the TPU kernel, which keeps the state in VMEM for the
whole depth, pays ``depth - 1`` extra writes for it). The backward sweep is described in ``csrc/dense_mpnn_bwd.cu``; its
weight and bias gradients are summed in a fixed order, so two calls on the
same inputs give the same bits. ``fit_tile`` and ``mols_per_tile`` (the
TPU's VMEM tiling policy) are dropped: a block of the operator pass always
holds one bin (the depth-fused forward keeps ``mols_per_tile`` for its
argument check).
The encoder's kernels take bins of at most 256 edge lanes and 256 node
slots; the wrappers raise on larger ones.

``matmul_dtype="bfloat16"`` and ``stash_dtype="bfloat16"`` are the JAX
kernels' options, on rows 1-6. With ``matmul_dtype`` every operand the JAX
kernel casts with ``.astype(bfloat16)`` is rounded to bf16 at the same point
and products and sums stay f32: ``relu(h)`` and ``W`` into the layer
product, the product ``mW`` again into the operator, the operator's
coefficients (exact for sum; ``bf16(1/indeg)`` and ``bf16(1/indeg - 1)``
for mean), in the backward ``g`` into ``Aᵀg``, ``relu(h_in)`` and ``g_mW``
into the weight gradient, ``g_mW`` and ``W`` into the input gradient, and in
the encoder ``node_feats`` into the gather, ``h`` (and the mean's ``1 /
count``) into the scatter, ``g_node`` into the scatter's VJP and ``g_h0``
into the gather's. The layer state stays f32. With ``stash_dtype`` the stash
is a bf16 tensor written rounded, and the backward reads it back as its
layer inputs (ReLU mask and weight-gradient operand alike). On the card
these are the ``bf16`` instantiations of the same kernels (``csrc/
dense_mpnn.cu`` and ``csrc/dense_mpnn_bwd.cu``), counted apart in
``<wrapper>.launches_bf16``; the plain versions round at the same points.
The forward's product ``relu(h) @ W`` (rows 1b, 2b, 4b's replay and 5b)
and the backward's two products (rows 3b, 4b and 6b) multiply those bf16
operands on the tensor cores (``csrc/bf16_mma.cuh``: ``mma.sync``, f32
accumulate), so their sums run in another order than the plain versions'
and agree with them at the bf16 tolerances, not bit for bit; the
depth-fused forward (row 7b) multiplies on the tensor cores in row 1b's
order, so it gives row 1b's bits.
``None`` (or ``"float32"``) is the exact f32 path, bit for bit as before.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from notorch_tpu_torch.kernels import build
from notorch_tpu_torch.kernels.checks import check_aligned, check_tensors, on_card

REDUCES = ("sum", "mean")
BACKWARDS = ("stash", "recompute", "jnp")
OPERAND_DTYPES = (None, "float32", "bfloat16")


def operand_dtype(dtype, what: str = "matmul_dtype") -> torch.dtype | None:
    """``torch.bfloat16`` for ``"bfloat16"``, ``None`` (exact f32) for
    ``None`` or float32; anything else raises."""
    name = None if dtype is None else str(dtype).removeprefix("torch.")
    if name in (None, "float32"):
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"{what} must be one of {OPERAND_DTYPES}, got {dtype!r}")


def _round(t: torch.Tensor, mm: torch.dtype | None) -> torch.Tensor:
    """``t`` rounded to ``mm`` and back to f32 (a JAX ``.astype(mm)``
    operand); ``t`` itself when ``mm`` is ``None``."""
    return t if mm is None else t.to(mm).to(torch.float32)


def edge_adjacency(
    src: torch.Tensor, dst: torch.Tensor, edge_mask: torch.Tensor, mean: bool = False
) -> torch.Tensor:
    """The folded edge-to-edge operator ``A`` as a dense ``[B, E, E]`` f32
    tensor (see the module docstring)."""
    E = src.shape[1]
    idx = torch.arange(E, device=src.device)
    is_rev = idx[None, :] == (idx ^ 1)[:, None]  # [E, E]: column is rev(row)
    keep = (src[:, :, None] == dst[:, None, :]) & edge_mask[:, None, :]
    if mean:
        keep_f = keep.to(torch.float32)
        indeg = keep_f.sum(dim=2, keepdim=True)
        return keep_f / indeg.clamp_min(1.0) - is_rev.to(torch.float32)
    return (keep & ~is_rev).to(torch.float32)


def _exact_f32(t: torch.Tensor) -> None:
    if t.is_cuda:
        # the comparison with the kernels is in exact f32: no TF32 anywhere
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def dense_mpnn_block_stash_reference(
    edge_hiddens: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    edge_mask: torch.Tensor,
    weights: torch.Tensor,
    biases: torch.Tensor,
    *,
    depth: int,
    residual: bool = True,
    reduce: str = "sum",
    matmul_dtype=None,
    stash_dtype=None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version of the stash forward: builds ``A`` densely and
    runs the layers as ``matmul`` and ``bmm`` in f32, the operands rounded
    to ``matmul_dtype`` where the JAX kernel rounds them. Returns ``(out,
    hs)``, ``hs = [h1, ..., h_{depth-1}]`` stacked in ``stash_dtype``
    (``None`` at depth 1)."""
    _exact_f32(edge_hiddens)
    mm = operand_dtype(matmul_dtype)
    sd = operand_dtype(stash_dtype, "stash_dtype")
    A = _round(edge_adjacency(src, dst, edge_mask, mean=reduce == "mean"), mm)
    h = edge_hiddens
    hs = []
    for layer in range(depth):
        if layer > 0:
            hs.append(h if sd is None else h.to(sd))
        mW = torch.matmul(_round(torch.relu(h), mm), _round(weights[layer], mm))
        out = biases[layer] + torch.bmm(A, _round(mW, mm))
        h = h + out if residual else out
    return h, torch.stack(hs) if hs else None


def dense_mpnn_block_reference(
    edge_hiddens: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    edge_mask: torch.Tensor,
    weights: torch.Tensor,
    biases: torch.Tensor,
    *,
    depth: int,
    residual: bool = True,
    reduce: str = "sum",
    matmul_dtype=None,
) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel (the stash forward's
    output alone)."""
    return dense_mpnn_block_stash_reference(
        edge_hiddens, src, dst, edge_mask, weights, biases,
        depth=depth, residual=residual, reduce=reduce, matmul_dtype=matmul_dtype,
    )[0]


def dense_mpnn_block_bwd_reference(
    h0: torch.Tensor,
    hs: torch.Tensor | None,
    src: torch.Tensor,
    dst: torch.Tensor,
    edge_mask: torch.Tensor,
    weights: torch.Tensor,
    cotangent: torch.Tensor,
    *,
    depth: int,
    residual: bool = True,
    reduce: str = "sum",
    matmul_dtype=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the reverse sweep: dense ``A``, ``bmm`` and
    ``matmul`` in f32, the operands rounded to ``matmul_dtype`` where the
    JAX kernel rounds them. ``hs`` holds the layer inputs h1..h_{depth-1}
    (f32, or the bf16 stash, read back as f32). Returns ``(g_h0, g_W,
    g_b)``."""
    _exact_f32(h0)
    mm = operand_dtype(matmul_dtype)
    A_t = _round(edge_adjacency(src, dst, edge_mask, mean=reduce == "mean"), mm).transpose(1, 2)
    d = h0.shape[-1]
    g_W = torch.zeros_like(weights)
    g_b = torch.zeros(depth, d, dtype=weights.dtype, device=weights.device)
    g = cotangent
    for layer in reversed(range(depth)):
        h_in = h0 if layer == 0 else hs[layer - 1].to(torch.float32)
        g_mW = torch.bmm(A_t, _round(g, mm))
        g_W[layer] = torch.matmul(_round(torch.relu(h_in), mm).reshape(-1, d).T,
                                  _round(g_mW, mm).reshape(-1, d))
        g_b[layer] = g.reshape(-1, d).sum(dim=0)
        g_h = torch.matmul(_round(g_mW, mm), _round(weights[layer], mm).T) * (h_in > 0).to(g.dtype)
        g = g_h + g if residual else g_h
    return g, g_W, g_b


def gather_nodes(node_values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``node_values[b, index[b, e]]`` for every edge lane, ``[B, E, d]``; an
    index outside ``[0, V)`` gathers zero, as a one-hot product does."""
    V, d = node_values.shape[1:]
    valid = (index >= 0) & (index < V)
    idx = torch.where(valid, index, 0).long()[..., None].expand(-1, -1, d)
    return torch.where(valid[..., None], torch.gather(node_values, 1, idx), 0.0)


def _one_hot(index: torch.Tensor, n_nodes: int, mask: torch.Tensor | None = None) -> torch.Tensor:
    """``[B, V, E]`` f32 with 1 where ``index[b, e] == v`` (and ``mask``)."""
    hot = index[:, None, :] == torch.arange(n_nodes, device=index.device)[None, :, None]
    if mask is not None:
        hot = hot & mask[:, None, :]
    return hot.to(torch.float32)


def dense_encoder_reference(
    node_feats: torch.Tensor,
    edge_feats: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    edge_mask: torch.Tensor,
    weights: torch.Tensor,
    biases: torch.Tensor,
    *,
    depth: int,
    residual: bool = True,
    reduce: str = "sum",
    stash: bool = False,
    matmul_dtype=None,
    stash_dtype=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version of the encoder forward: the gather, the plain
    block, and the masked scatter as a one-hot ``bmm`` (divided by the
    in-degree floored at 1 for mean). Returns ``(node_hiddens,
    edge_hiddens, hs)``, ``hs`` as :func:`dense_mpnn_block_stash_reference`
    gives it when ``stash`` (else ``None``). With ``matmul_dtype`` the
    gather reads ``node_feats`` rounded, and the scatter is the JAX kernel's
    product of the rounded operator (the mean's ``1 / count`` folded in)
    and the rounded edge hiddens."""
    _exact_f32(edge_feats)
    mm = operand_dtype(matmul_dtype)
    h0 = gather_nodes(_round(node_feats, mm), src) + edge_feats
    eh, hs = dense_mpnn_block_stash_reference(
        h0, src, dst, edge_mask, weights, biases, depth=depth, residual=residual, reduce=reduce,
        matmul_dtype=matmul_dtype, stash_dtype=stash_dtype,
    )
    S = _one_hot(dst, node_feats.shape[1], edge_mask)
    if mm is None:
        nh = torch.bmm(S, eh)
        if reduce == "mean":
            nh = nh / S.sum(dim=2, keepdim=True).clamp_min(1.0)
    else:
        if reduce == "mean":
            S = S / S.sum(dim=2, keepdim=True).clamp_min(1.0)
        nh = torch.bmm(_round(S, mm), _round(eh, mm))
    return nh, eh, hs if stash else None


def dense_encoder_bwd_reference(
    node_feats: torch.Tensor,
    edge_feats: torch.Tensor,
    hs: torch.Tensor | None,
    src: torch.Tensor,
    dst: torch.Tensor,
    edge_mask: torch.Tensor,
    weights: torch.Tensor,
    g_node: torch.Tensor,
    g_edge: torch.Tensor,
    *,
    depth: int,
    residual: bool = True,
    reduce: str = "sum",
    matmul_dtype=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the encoder backward: the scatter's VJP
    ``g = g_edge + Sᵀ g_node`` (with the forward's ``1 / indeg`` for mean),
    ``h0`` recomputed, the plain reverse sweep, and the gather's VJP
    ``g_nf = Gᵀ g_h0`` (unmasked), the operands rounded to ``matmul_dtype``
    where the JAX kernel rounds them. Returns ``(g_nf, g_ef, g_W, g_b)``."""
    _exact_f32(edge_feats)
    mm = operand_dtype(matmul_dtype)
    V = node_feats.shape[1]
    h0 = gather_nodes(_round(node_feats, mm), src) + edge_feats
    valid = edge_mask & (dst >= 0) & (dst < V)
    g_scatter = torch.where(valid[..., None], gather_nodes(_round(g_node, mm), dst), 0.0)
    if reduce == "mean":
        inv = 1.0 / _one_hot(dst, V, edge_mask).sum(dim=2).clamp_min(1.0)  # [B, V]
        g_scatter = g_scatter * gather_nodes(_round(inv, mm)[..., None], dst)
    g = g_edge + g_scatter
    g_h0, g_W, g_b = dense_mpnn_block_bwd_reference(
        h0, hs, src, dst, edge_mask, weights, g, depth=depth, residual=residual, reduce=reduce,
        matmul_dtype=matmul_dtype,
    )
    g_nf = torch.bmm(_one_hot(src, V), _round(g_h0, mm))
    return g_nf, g_h0, g_W, g_b


def _check(edge_hiddens, src, dst, edge_mask, weights, biases, depth, reduce, n_nodes=1) -> None:
    if reduce not in REDUCES:
        raise ValueError(f"reduce must be one of {REDUCES}, got {reduce!r}")
    if edge_hiddens.dim() != 3:
        raise ValueError(f"edge_hiddens must be [B, E, d], got {tuple(edge_hiddens.shape)}")
    B, E, d = edge_hiddens.shape
    if E % 2 != 0:
        raise ValueError(f"edge lanes per bin must be even (reverse pairs), got {E}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if n_nodes < 1:
        raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
    expect = {
        "edge_hiddens": (edge_hiddens, torch.float32, (B, E, d)),
        "src": (src, torch.int32, (B, E)),
        "dst": (dst, torch.int32, (B, E)),
        "edge_mask": (edge_mask, torch.bool, (B, E)),
        "weights": (weights, torch.float32, (depth, d, d)),
    }
    if biases is not None:
        expect["biases"] = (biases, torch.float32, (depth, d))
    check_tensors(expect, edge_hiddens.device)


def _check_bwd(h0, hs, cotangent, depth) -> None:
    B, E, d = h0.shape
    expect = {"cotangent": (cotangent, torch.float32, (B, E, d))}
    if depth > 1:
        if hs is None:
            raise ValueError(f"hs (the stash h1..h_{{depth-1}}) is required at depth {depth}")
        # the stash is f32, or bf16 (stash_dtype="bfloat16")
        stash = torch.bfloat16 if hs.dtype == torch.bfloat16 else torch.float32
        expect["hs"] = (hs, stash, (depth - 1, B, E, d))
    check_tensors(expect, h0.device)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


@functools.cache
def _layer_fns():
    """The forward library: its whole-forward entry, row 7's depth-fused
    entry."""
    lib = build.load("dense_mpnn")
    fwd, dbuf = lib.dense_mpnn_forward, lib.dense_mpnn_dbuf_forward
    fwd.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    dbuf.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fwd.restype = dbuf.restype = ctypes.c_int
    lib.dense_mpnn_dbuf_groups.argtypes = [ctypes.c_int] * 3
    lib.dense_mpnn_error_string.argtypes = [ctypes.c_int]
    lib.dense_mpnn_error_string.restype = ctypes.c_char_p
    for name in ("dense_mpnn_max_edges", "dense_mpnn_max_nodes", "dense_mpnn_cols",
                 "dense_mpnn_dbuf_max_slices", "dense_mpnn_dbuf_groups"):
        getattr(lib, name).restype = ctypes.c_int
    return lib, fwd, dbuf


@functools.cache
def _sweep_fn():
    lib = build.load("dense_mpnn_bwd")
    prep, fn = lib.dense_mpnn_bwd_prep, lib.dense_mpnn_bwd_layer
    prep.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    prep.restype = fn.restype = ctypes.c_int
    lib.dense_mpnn_bwd_error_string.argtypes = [ctypes.c_int]
    lib.dense_mpnn_bwd_error_string.restype = ctypes.c_char_p
    for name in ("dense_mpnn_bwd_max_edges", "dense_mpnn_bwd_max_nodes", "dense_mpnn_bwd_cols",
                 "dense_mpnn_bwd_chunk_rows"):
        getattr(lib, name).restype = ctypes.c_int
    return lib, prep, fn


def _check_shape_for(max_edges: int, max_nodes: int, cols: int, E: int, V: int, d: int) -> None:
    if E > max_edges or V > max_nodes or d % cols != 0:
        raise ValueError(
            f"the CUDA kernels take bins of at most {max_edges} edge lanes (and, for the "
            f"encoder's ends, {max_nodes} node slots) and a width that is a multiple of "
            f"{cols}; got E={E}, V={V}, d={d}"
        )


def _launch_layers(h0, src, dst, edge_mask, weights, biases, outs, residual, mean, *,
                   node_feats=None, node_out=None, mm=None, stash=None) -> int:
    """Run layers ``0..len(outs)-1``, layer ``l`` reading the previous
    output (``h0`` first) and writing ``outs[l]``: one call of
    ``dense_mpnn_forward``, which launches the prep and every layer. With
    ``node_feats`` layer 0's input is ``node_feats[src] + h0`` (``h0`` is
    then the edge features); with ``node_out`` the last layer also writes
    the masked scatter of its output there. ``mm`` (``torch.bfloat16``)
    launches the bf16 instantiations; ``stash`` (a bf16 tensor or ``None``
    for each layer) takes each layer's output rounded to bf16. Returns the
    number of layers run."""
    B, E, d = h0.shape
    ends = node_feats if node_feats is not None else node_out
    V = 1 if ends is None else ends.shape[1]
    lib, fwd_fn, _ = _layer_fns()
    _check_shape_for(lib.dense_mpnn_max_edges(), lib.dense_mpnn_max_nodes(), lib.dense_mpnn_cols(),
                     E, V, d)
    check_aligned(edge_hiddens=h0, weights=weights, node_feats=node_feats,
                   **{f"output {i}": o for i, o in enumerate(outs)})
    idx = (src.data_ptr(), dst.data_ptr(), edge_mask.data_ptr())

    def check(err: int) -> None:
        if err != 0:
            raise RuntimeError(f"dense_mpnn launch failed: {lib.dense_mpnn_error_string(err).decode()}")

    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream().cuda_stream
        # scratch: A's bit rows, the scatter's node bit rows, layer 0's
        # gathered input, and each layer's product relu(h) @ W (bf16 with
        # mm: the operand the operator pass takes)
        words = -(-E // 32)
        adj = torch.empty(B, E, words, dtype=torch.int32, device=h0.device)
        node_bits = torch.empty(B, V, words, dtype=torch.int32, device=h0.device) if node_out is not None else None
        h0_full = torch.empty_like(h0) if node_feats is not None else None
        mw = torch.empty_like(h0, dtype=torch.float32 if mm is None else torch.bfloat16)
        out_ptrs = (ctypes.c_void_p * len(outs))(*(o.data_ptr() for o in outs))
        stash_ptrs = None if stash is None else (ctypes.c_void_p * len(outs))(*(_ptr(t) for t in stash))
        check(fwd_fn(
            h0.data_ptr(), out_ptrs, stash_ptrs, _ptr(node_feats), _ptr(node_out), *idx,
            weights.data_ptr(), biases.data_ptr(), adj.data_ptr(), _ptr(node_bits), _ptr(h0_full),
            mw.data_ptr(), B, V, E, d, len(outs), int(residual), int(mean),
            int(node_feats is not None), int(node_out is not None), int(mm is not None), stream,
        ))
    return len(outs)


def _launch_sweep(h0, hs, src, dst, edge_mask, weights, cotangent, residual, mean, *,
                  node_feats=None, g_node=None, mm=None):
    """The reverse sweep of ``csrc/dense_mpnn_bwd.cu``: its prep (``A``'s
    bit rows and ``W``'s transposes) once, then the layers, last layer
    first; ``hs[l - 1]`` is the input of layer ``l > 0``. Returns ``(g_h0,
    g_W, g_b, g_nf)``.

    The encoder's backward passes ``node_feats`` and ``g_node``: ``h0`` is
    then the edge features, layer 0's input is ``node_feats[src] + h0``
    (recomputed into scratch by layer 0's launch, and its gather's VJP is
    ``g_nf``), and the
    last layer's cotangent is ``cotangent`` (the edge hiddens') plus the
    scatter's VJP of ``g_node``. Otherwise ``g_nf`` is ``None``. ``mm``
    (``torch.bfloat16``) launches the bf16 instantiations; a bf16 ``hs`` is
    read as such (the stash instantiation of the products)."""
    B, E, d = h0.shape
    depth = weights.shape[0]
    encoder = node_feats is not None
    V = node_feats.shape[1] if encoder else 1
    lib, prep_fn, fn = _sweep_fn()
    cols = lib.dense_mpnn_bwd_cols()
    _check_shape_for(lib.dense_mpnn_bwd_max_edges(), lib.dense_mpnn_bwd_max_nodes(), cols, E, V, d)
    check_aligned(edge_hiddens=h0, hs=hs, cotangent=cotangent, weights=weights,
                   node_feats=node_feats, g_node=g_node)
    half_in = hs is not None and hs.dtype == torch.bfloat16
    chunks = -(-B * E // lib.dense_mpnn_bwd_chunk_rows())

    def check(err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(f"{what} launch failed: {lib.dense_mpnn_bwd_error_string(err).decode()}")

    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream().cuda_stream
        f32 = dict(dtype=torch.float32, device=h0.device)
        w_t = torch.empty_like(weights)
        words = -(-E // 32)
        adj = torch.empty(B, E, words, dtype=torch.int32, device=h0.device)
        inv = torch.empty(B, E, **f32)
        # the encoder's ends: the scatter's scales, the gather's node bit
        # rows, and layer 0's input nf[src] + ef, recomputed
        scat = torch.empty(B, E, **f32) if encoder else None
        node_bits = torch.empty(B, V, words, dtype=torch.int32, device=h0.device) if encoder else None
        h0_full = torch.empty_like(h0) if encoder else None
        g_mw = torch.empty_like(h0)
        gw_part = torch.empty(chunks, d, d, **f32)
        gb_part = torch.empty(B, d, **f32)
        counts = torch.empty((d // cols) ** 2, dtype=torch.int32, device=h0.device)
        g_W = torch.empty_like(weights)
        g_b = torch.empty(depth, d, **f32)
        g_h0 = torch.empty_like(h0)
        g_nf = torch.empty_like(node_feats) if encoder else None
        # the prologue writes the last layer's full cotangent here
        g_full = torch.empty_like(h0) if encoder else None
        # ping-pong so that layer 0 writes g_h0 and no layer writes its own input
        bufs = [g_h0, torch.empty_like(h0) if depth > 1 else g_h0]
        check(prep_fn(weights.data_ptr(), w_t.data_ptr(), src.data_ptr(), dst.data_ptr(),
                      edge_mask.data_ptr(), adj.data_ptr(), inv.data_ptr(), _ptr(scat), _ptr(node_bits),
                      B, V, E, d, depth, int(mean), stream), "dense_mpnn_bwd_prep")
        g = g_full if encoder else cotangent
        for layer in reversed(range(depth)):
            h_in = h0 if layer == 0 else hs[layer - 1]
            g_in = bufs[layer % 2]
            prologue = encoder and layer == depth - 1
            gather = encoder and layer == 0
            check(fn(
                h_in.data_ptr(), g.data_ptr(), g_in.data_ptr(), g_mw.data_ptr(),
                gw_part.data_ptr(), gb_part.data_ptr(), counts.data_ptr(), g_W[layer].data_ptr(),
                g_b[layer].data_ptr(), src.data_ptr(), dst.data_ptr(), w_t[layer].data_ptr(),
                adj.data_ptr(), _ptr(node_bits), inv.data_ptr(), _ptr(scat), _ptr(node_feats),
                _ptr(cotangent) if prologue else None, _ptr(g_node) if prologue else None,
                _ptr(g_full), _ptr(h0_full), _ptr(g_nf), B, V, E, d, int(residual), int(mean),
                int(prologue), int(gather), int(mm is not None), int(half_in and layer > 0), stream,
            ), "dense_mpnn_bwd_layer")
            g = g_in
    return g_h0, g_W, g_b, g_nf


def _ping_pong(out: torch.Tensor, depth: int) -> list[torch.Tensor]:
    """Each layer's output buffer, two in turn, so that the last layer
    writes ``out`` and no layer writes its own input."""
    bufs = [out, torch.empty_like(out) if depth > 1 else out]
    return [bufs[(depth - 1 - layer) % 2] for layer in range(depth)]


def _stash_buffers(like: torch.Tensor, depth: int, stash_dtype):
    """``(out, hs, outs, stash)`` of a stash forward at ``depth > 1``: an f32
    stash is the layers' own outputs (``outs = [*hs, out]``, ``stash``
    ``None``); a bf16 one is a second output of each hidden layer, the
    layers' f32 outputs going to two buffers in turn."""
    B, E, d = like.shape
    out = torch.empty_like(like)
    hs = torch.empty(depth - 1, B, E, d, dtype=stash_dtype or torch.float32, device=like.device)
    if stash_dtype is None:
        return out, hs, [*hs, out], None
    return out, hs, _ping_pong(out, depth), [*hs, None]


def _count(wrapper, mm, n: int) -> None:
    """Add ``n`` launches to ``wrapper``'s count of its f32 or bf16
    instantiation."""
    if mm is None:
        wrapper.launches += n
    else:
        wrapper.launches_bf16 += n


def fused_dense_mpnn_block(
    edge_hiddens: torch.Tensor,  # [B, E, d] f32 initial edge hiddens
    src: torch.Tensor,  # [B, E] int32
    dst: torch.Tensor,  # [B, E] int32
    edge_mask: torch.Tensor,  # [B, E] bool
    weights: torch.Tensor,  # [depth, d, d] f32, [in, out]
    biases: torch.Tensor,  # [depth, d] f32
    *,
    depth: int,
    n_nodes: int,
    residual: bool = True,
    reduce: str = "sum",
    matmul_dtype=None,
) -> torch.Tensor:
    """Run the whole D-MPNN block; returns the final edge hiddens [B, E, d].

    Tensors on the CPU take :func:`dense_mpnn_block_reference`; tensors on a
    CUDA device launch the forward's kernels (a prep, then a product and an
    operator pass a layer) or raise. ``fused_dense_mpnn_block.launches``
    counts the layers run (``depth`` a call), ``launches_bf16`` those of the
    ``matmul_dtype="bfloat16"`` instantiation. ``n_nodes`` (node slots per
    bin) is kept for the JAX signature; the operator needs only
    ``src``/``dst``.
    """
    _check(edge_hiddens, src, dst, edge_mask, weights, biases, depth, reduce, n_nodes)
    mm = operand_dtype(matmul_dtype)
    if not on_card(edge_hiddens):
        return dense_mpnn_block_reference(
            edge_hiddens, src, dst, edge_mask, weights, biases,
            depth=depth, residual=residual, reduce=reduce, matmul_dtype=mm,
        )
    out = torch.empty_like(edge_hiddens)
    n = _launch_layers(edge_hiddens, src, dst, edge_mask, weights, biases, _ping_pong(out, depth),
                       residual, reduce == "mean", mm=mm)
    _count(fused_dense_mpnn_block, mm, n)
    return out


def fused_dense_mpnn_block_stash(
    edge_hiddens: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    edge_mask: torch.Tensor,
    weights: torch.Tensor,
    biases: torch.Tensor,
    *,
    depth: int,
    n_nodes: int,
    residual: bool = True,
    reduce: str = "sum",
    matmul_dtype=None,
    stash_dtype=None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The training forward: returns ``(out, hs)``, ``hs`` ``[depth-1, B, E,
    d]`` (f32, or bf16 with ``stash_dtype="bfloat16"``) holding the hidden
    layer inputs h1..h_{depth-1} (``h0`` is the caller's input and is never
    stashed; ``hs`` is ``None`` at depth 1, where this is
    :func:`fused_dense_mpnn_block`, as in the JAX package).

    On a CUDA device the forward writes layer ``l < depth-1`` into
    ``hs[l]`` (an f32 stash doubles as the next layer's input; a bf16 one is
    a second, rounded output) and the last layer into ``out``;
    ``fused_dense_mpnn_block_stash.launches`` (``launches_bf16`` with
    ``matmul_dtype="bfloat16"``) counts the layers run (``depth`` a call).
    CPU tensors take :func:`dense_mpnn_block_stash_reference`.
    """
    if depth == 1:
        return fused_dense_mpnn_block(
            edge_hiddens, src, dst, edge_mask, weights, biases,
            depth=depth, n_nodes=n_nodes, residual=residual, reduce=reduce, matmul_dtype=matmul_dtype,
        ), None
    _check(edge_hiddens, src, dst, edge_mask, weights, biases, depth, reduce, n_nodes)
    mm, sd = operand_dtype(matmul_dtype), operand_dtype(stash_dtype, "stash_dtype")
    if not on_card(edge_hiddens):
        return dense_mpnn_block_stash_reference(
            edge_hiddens, src, dst, edge_mask, weights, biases,
            depth=depth, residual=residual, reduce=reduce, matmul_dtype=mm, stash_dtype=sd,
        )
    out, hs, outs, stash = _stash_buffers(edge_hiddens, depth, sd)
    n = _launch_layers(edge_hiddens, src, dst, edge_mask, weights, biases, outs, residual,
                       reduce == "mean", mm=mm, stash=stash)
    _count(fused_dense_mpnn_block_stash, mm, n)
    return out, hs


def fused_dense_mpnn_block_bwd_stash(
    h0: torch.Tensor,  # [B, E, d] the forward's input
    hs: torch.Tensor | None,  # [depth-1, B, E, d] stashed layer inputs (None iff depth == 1)
    src: torch.Tensor,
    dst: torch.Tensor,
    edge_mask: torch.Tensor,
    weights: torch.Tensor,
    cotangent: torch.Tensor,  # [B, E, d], zero on padded lanes
    *,
    depth: int,
    n_nodes: int,
    residual: bool = True,
    reduce: str = "sum",
    matmul_dtype=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The training backward: returns ``(g_h0, g_W, g_b)`` from the stash
    of :func:`fused_dense_mpnn_block_stash` (f32 or bf16), with no
    recompute.

    On a CUDA device one call runs the reverse sweep of
    ``csrc/dense_mpnn_bwd.cu`` (a prep launch, then two a layer) and adds one to
    ``fused_dense_mpnn_block_bwd_stash.launches`` (``launches_bf16`` with
    ``matmul_dtype="bfloat16"``). At depth 1 there is no stash and this is
    :func:`fused_dense_mpnn_block_bwd` with zero biases (its replay is
    empty), as in the JAX package. CPU tensors take
    :func:`dense_mpnn_block_bwd_reference`.
    """
    if depth == 1:
        return fused_dense_mpnn_block_bwd(
            h0, src, dst, edge_mask, weights,
            torch.zeros(1, h0.shape[-1], dtype=torch.float32, device=h0.device), cotangent,
            depth=depth, n_nodes=n_nodes, residual=residual, reduce=reduce, matmul_dtype=matmul_dtype,
        )
    _check(h0, src, dst, edge_mask, weights, None, depth, reduce, n_nodes)
    _check_bwd(h0, hs, cotangent, depth)
    mm = operand_dtype(matmul_dtype)
    if not on_card(h0):
        return dense_mpnn_block_bwd_reference(
            h0, hs, src, dst, edge_mask, weights, cotangent,
            depth=depth, residual=residual, reduce=reduce, matmul_dtype=mm,
        )
    grads = _launch_sweep(h0, hs, src, dst, edge_mask, weights, cotangent, residual,
                          reduce == "mean", mm=mm)[:3]
    _count(fused_dense_mpnn_block_bwd_stash, mm, 1)
    return grads


def fused_dense_mpnn_block_bwd(
    edge_hiddens: torch.Tensor,  # [B, E, d] h0
    src: torch.Tensor,
    dst: torch.Tensor,
    edge_mask: torch.Tensor,
    weights: torch.Tensor,  # [depth, d, d]
    biases: torch.Tensor,  # [depth, d]: the replay needs them
    cotangent: torch.Tensor,  # [B, E, d], zero on padded lanes
    *,
    depth: int,
    n_nodes: int,
    residual: bool = True,
    reduce: str = "sum",
    matmul_dtype=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recompute backward: returns ``(g_h0, g_W, g_b)`` from ``h0``
    alone. On a CUDA device it replays layers ``0..depth-2`` with the
    forward's kernels into a scratch stash (biases included: the JAX kernel records
    the fault that leaving them out caused), then runs the reverse sweep;
    one call adds one to ``fused_dense_mpnn_block_bwd.launches``
    (``launches_bf16`` with ``matmul_dtype="bfloat16"``, whose replay keeps
    f32 layer inputs as the JAX kernel's does). CPU tensors take the plain
    versions of both halves."""
    _check(edge_hiddens, src, dst, edge_mask, weights, biases, depth, reduce, n_nodes)
    _check_bwd(edge_hiddens, None, cotangent, 1)
    mm = operand_dtype(matmul_dtype)
    kw = dict(depth=depth, residual=residual, reduce=reduce, matmul_dtype=mm)
    if not on_card(edge_hiddens):
        _, hs = dense_mpnn_block_stash_reference(
            edge_hiddens, src, dst, edge_mask, weights, biases, **kw
        )
        return dense_mpnn_block_bwd_reference(
            edge_hiddens, hs, src, dst, edge_mask, weights, cotangent, **kw
        )
    B, E, d = edge_hiddens.shape
    hs = None
    if depth > 1:
        hs = torch.empty(depth - 1, B, E, d, dtype=torch.float32, device=edge_hiddens.device)
        _launch_layers(edge_hiddens, src, dst, edge_mask, weights, biases, list(hs), residual,
                       reduce == "mean", mm=mm)
    grads = _launch_sweep(edge_hiddens, hs, src, dst, edge_mask, weights, cotangent, residual,
                          reduce == "mean", mm=mm)[:3]
    _count(fused_dense_mpnn_block_bwd, mm, 1)
    return grads


def _check_nodes(node_feats: torch.Tensor, edge_feats: torch.Tensor, name: str = "node_feats") -> None:
    if node_feats.dim() != 3:
        raise ValueError(f"{name} must be [B, V, d], got {tuple(node_feats.shape)}")
    B, V, d = node_feats.shape
    if V < 1:
        raise ValueError(f"{name} needs at least one node slot per bin")
    check_tensors({name: (node_feats, torch.float32, (edge_feats.shape[0], V, edge_feats.shape[2]))},
                   edge_feats.device)


def fused_dense_encoder_fwd(
    node_feats: torch.Tensor,  # [B, V, d] f32
    edge_feats: torch.Tensor,  # [B, E, d] f32
    src: torch.Tensor,  # [B, E] int32
    dst: torch.Tensor,  # [B, E] int32
    edge_mask: torch.Tensor,  # [B, E] bool
    weights: torch.Tensor,  # [depth, d, d] f32, [in, out]
    biases: torch.Tensor,  # [depth, d] f32
    *,
    depth: int,
    residual: bool = True,
    reduce: str = "sum",
    stash: bool = False,
    matmul_dtype=None,
    stash_dtype=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The whole encoder, gather + block + masked scatter: returns
    ``(node_hiddens [B, V, d], edge_hiddens [B, E, d], hs)``, ``hs`` the
    ``[depth-1, B, E, d]`` stash of the layer inputs h1..h_{depth-1} when
    ``stash`` and ``depth > 1`` (else ``None``), as in the JAX package.

    On a CUDA device the forward's prep also writes the gathered input
    ``node_feats[src] + edge_feats`` and the last layer's operator pass
    also writes the scatter; ``fused_dense_encoder_fwd.launches``
    (``launches_bf16`` with ``matmul_dtype="bfloat16"``) counts the layers
    run (``depth`` a call). The stash is f32, or bf16 with
    ``stash_dtype="bfloat16"``. CPU tensors take
    :func:`dense_encoder_reference`.
    """
    _check(edge_feats, src, dst, edge_mask, weights, biases, depth, reduce)
    _check_nodes(node_feats, edge_feats)
    mm, sd = operand_dtype(matmul_dtype), operand_dtype(stash_dtype, "stash_dtype")
    if not on_card(edge_feats):
        return dense_encoder_reference(
            node_feats, edge_feats, src, dst, edge_mask, weights, biases,
            depth=depth, residual=residual, reduce=reduce, stash=stash, matmul_dtype=mm, stash_dtype=sd,
        )
    node_hiddens = torch.empty_like(node_feats)
    if stash and depth > 1:
        edge_hiddens, hs, outs, stash_out = _stash_buffers(edge_feats, depth, sd)
    else:
        edge_hiddens, hs, stash_out = torch.empty_like(edge_feats), None, None
        outs = _ping_pong(edge_hiddens, depth)
    n = _launch_layers(edge_feats, src, dst, edge_mask, weights, biases, outs, residual, reduce == "mean",
                       node_feats=node_feats, node_out=node_hiddens, mm=mm, stash=stash_out)
    _count(fused_dense_encoder_fwd, mm, n)
    return node_hiddens, edge_hiddens, hs


def fused_dense_encoder_bwd(
    node_feats: torch.Tensor,  # [B, V, d]
    edge_feats: torch.Tensor,  # [B, E, d]
    hs: torch.Tensor | None,  # [depth-1, B, E, d] (None iff depth == 1)
    src: torch.Tensor,
    dst: torch.Tensor,
    edge_mask: torch.Tensor,
    weights: torch.Tensor,
    g_node: torch.Tensor,  # [B, V, d] cotangent of node_hiddens
    g_edge: torch.Tensor,  # [B, E, d] cotangent of edge_hiddens, any value on any lane
    *,
    depth: int,
    residual: bool = True,
    reduce: str = "sum",
    matmul_dtype=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The encoder's backward from the stash of
    :func:`fused_dense_encoder_fwd` (``h0`` recomputed): returns ``(g_nf,
    g_ef, g_W, g_b)``, exact for any cotangent.

    On a CUDA device one call runs the reverse sweep of
    ``csrc/dense_mpnn_bwd.cu`` with the scatter's VJP folded into the last
    layer's launches, ``h0``'s recompute into layer 0's and the gather's VJP
    in a launch after them, and adds one to
    ``fused_dense_encoder_bwd.launches`` (``launches_bf16`` with
    ``matmul_dtype="bfloat16"``). The stash is f32 or bf16. CPU tensors
    take :func:`dense_encoder_bwd_reference`.
    """
    _check(edge_feats, src, dst, edge_mask, weights, None, depth, reduce)
    _check_nodes(node_feats, edge_feats)
    _check_nodes(g_node, edge_feats, "g_node")
    _check_bwd(edge_feats, hs, g_edge, depth)
    mm = operand_dtype(matmul_dtype)
    if not on_card(edge_feats):
        return dense_encoder_bwd_reference(
            node_feats, edge_feats, hs, src, dst, edge_mask, weights, g_node, g_edge,
            depth=depth, residual=residual, reduce=reduce, matmul_dtype=mm,
        )
    g_ef, g_W, g_b, g_nf = _launch_sweep(
        edge_feats, hs, src, dst, edge_mask, weights, g_edge, residual, reduce == "mean",
        node_feats=node_feats, g_node=g_node, mm=mm,
    )
    _count(fused_dense_encoder_bwd, mm, 1)
    return g_nf, g_ef, g_W, g_b


def fused_dense_mpnn_block_dbuf(
    edge_hiddens: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    edge_mask: torch.Tensor,
    weights: torch.Tensor,
    biases: torch.Tensor,
    *,
    depth: int,
    n_nodes: int,
    residual: bool = True,
    mols_per_tile: int = 8,
    reduce: str = "sum",
    matmul_dtype=None,
) -> torch.Tensor:
    """:func:`fused_dense_mpnn_block`'s function in one launch, depth-fused:
    a group of blocks per bin keeps the bin's ``h`` in shared memory through
    every layer, each block a 64-column slice, and reads the other slices
    through L2 for the products, the group's blocks meeting at a barrier
    between layers (``csrc/dense_mpnn.cu``). Its FMAs run in row 1's order,
    so it gives row 1's bits. Calls on one device must not run on two
    streams at once: they share the groups' barriers.

    The JAX function's contract is kept: the batch must split into an even
    count of ``mols_per_tile``-bin tiles, ``mols_per_tile`` a multiple of 8,
    else ``ValueError``; on the card a group of blocks holds one bin at a
    time whatever the tile, and the width may be at most 1,024.
    No module calls it, as in the JAX package.
    ``matmul_dtype="bfloat16"`` (row 7b, ``dense_mpnn_dbuf_mma_kernel``)
    multiplies on the tensor cores in row 1b's order and rounds where row 1b
    does, so it gives row 1b's bits; its blocks exchange each hidden layer's
    ``bf16(relu(h))`` through the two bf16 halves of the scratch.
    ``fused_dense_mpnn_block_dbuf.launches`` counts its launches, one a
    call (``launches_bf16`` those of row 7b); CPU tensors take
    :func:`dense_mpnn_block_reference`.
    """
    B = edge_hiddens.shape[0]
    tile = min(mols_per_tile, B)
    if tile % 8 != 0 or B % (2 * tile) != 0:
        raise ValueError(
            f"dbuf kernel needs an even count of multiple-of-8 tiles (B={B}, tile={tile}); "
            "use fused_dense_mpnn_block"
        )
    _check(edge_hiddens, src, dst, edge_mask, weights, biases, depth, reduce, n_nodes)
    mm = operand_dtype(matmul_dtype)
    if not on_card(edge_hiddens):
        return dense_mpnn_block_reference(
            edge_hiddens, src, dst, edge_mask, weights, biases,
            depth=depth, residual=residual, reduce=reduce, matmul_dtype=mm,
        )
    _, E, d = edge_hiddens.shape
    lib, _, dbuf_fn = _layer_fns()
    cols, slices = lib.dense_mpnn_cols(), lib.dense_mpnn_dbuf_max_slices()
    _check_shape_for(lib.dense_mpnn_max_edges(), lib.dense_mpnn_max_nodes(), cols, E, 1, d)
    if d > slices * cols:
        raise ValueError(f"the depth-fused kernel takes widths of at most {slices * cols} ({slices} blocks "
                         f"of {cols} columns a bin); got d={d}")
    check_aligned(edge_hiddens=edge_hiddens, weights=weights)
    out = torch.empty_like(edge_hiddens)
    # every other layer's output, or row 7b's two bf16 exchange halves
    scratch = torch.empty_like(edge_hiddens) if depth > 1 else None
    with torch.cuda.device(edge_hiddens.device):
        err = dbuf_fn(edge_hiddens.data_ptr(), out.data_ptr(), _ptr(scratch), src.data_ptr(),
                      dst.data_ptr(), edge_mask.data_ptr(), weights.data_ptr(), biases.data_ptr(), B, E,
                      d, depth, int(residual), int(reduce == "mean"), int(mm is not None),
                      torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("fused_dense_mpnn_block_dbuf launch failed: "
                           f"{lib.dense_mpnn_error_string(err).decode()}")
    _count(fused_dense_mpnn_block_dbuf, mm, 1)
    return out


def dbuf_groups(B: int, E: int, d: int) -> dict[str, int]:
    """Row 7's launch at this shape on the current card: ``blocks`` a bin
    group (``d / 64``), the ``bins``, and ``groups``, how many the launch
    runs at once (fewer than the bins: each group takes several bins in
    turn). Builds the library if needed."""
    lib, _, _ = _layer_fns()
    return {"blocks": d // lib.dense_mpnn_cols(), "bins": B, "groups": lib.dense_mpnn_dbuf_groups(B, E, d)}


BF16_WRAPPERS = (fused_dense_mpnn_block, fused_dense_mpnn_block_stash, fused_dense_mpnn_block_bwd_stash,
                 fused_dense_mpnn_block_bwd, fused_dense_encoder_fwd, fused_dense_encoder_bwd)
for _wrapper in (*BF16_WRAPPERS, fused_dense_mpnn_block_dbuf):
    _wrapper.launches = _wrapper.launches_bf16 = 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, and copied where its storage does not start 16-byte
    aligned (the kernels read in 16-byte vectors)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


class FusedDenseMpnnBlockFn(torch.autograd.Function):
    """The fused block as an autograd node.

    Forward: the stash forward (``backward="stash"``, depth > 1) or the
    plain forward kernel (``"recompute"``, ``"jnp"``, or depth 1).
    Backward: the stash backward, the recompute backward, or for ``"jnp"``
    (the JAX package's debug path, ``fused_dense_mpnn_block_trainable``)
    the VJP of :func:`dense_mpnn_block_reference` replayed under autograd
    in exact f32, on the card too: no kernel. ``matmul_dtype`` goes to the
    kernels, ``stash_dtype`` to the stash forward. The index arrays get no
    gradient.
    """

    @staticmethod
    def forward(ctx, edge_hiddens, src, dst, edge_mask, weights, biases,
                depth: int, n_nodes: int, residual: bool, reduce: str, backward: str,
                matmul_dtype=None, stash_dtype=None):
        if backward not in BACKWARDS:
            raise ValueError(f"backward must be one of {BACKWARDS}, got {backward!r}")
        kw = dict(depth=depth, n_nodes=n_nodes, residual=residual, reduce=reduce, matmul_dtype=matmul_dtype)
        args = (edge_hiddens, src, dst, edge_mask, weights, biases)
        hs = None
        if backward == "stash":
            out, hs = fused_dense_mpnn_block_stash(*args, **kw, stash_dtype=stash_dtype)
        else:
            out = fused_dense_mpnn_block(*args, **kw)
        ctx.kw = kw
        ctx.backward = backward
        ctx.save_for_backward(*args, *(() if hs is None else (hs,)))
        return out

    @staticmethod
    def backward(ctx, cotangent):
        h0, src, dst, edge_mask, weights, biases, *stash = ctx.saved_tensors
        g = _aligned(cotangent)
        if ctx.backward == "jnp":
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (h0, weights, biases)]
                out = dense_mpnn_block_reference(
                    leaves[0], src, dst, edge_mask, *leaves[1:], depth=ctx.kw["depth"],
                    residual=ctx.kw["residual"], reduce=ctx.kw["reduce"])
                g_h0, g_W, g_b = torch.autograd.grad(out, leaves, cotangent)
        elif ctx.backward == "stash":
            hs = stash[0] if stash else None
            g_h0, g_W, g_b = fused_dense_mpnn_block_bwd_stash(
                h0, hs, src, dst, edge_mask, weights, g, **ctx.kw
            )
        else:
            g_h0, g_W, g_b = fused_dense_mpnn_block_bwd(
                h0, src, dst, edge_mask, weights, biases, g, **ctx.kw
            )
        return g_h0, None, None, None, g_W, g_b, None, None, None, None, None, None, None


class FusedDenseEncoderFn(torch.autograd.Function):
    """The whole encoder as an autograd node, ``(node_feats, edge_feats) ->
    (node_hiddens, edge_hiddens)``, as ``fused_dense_encoder``'s custom VJP
    in the JAX package: the forward is :func:`fused_dense_encoder_fwd` with
    the stash, the backward :func:`fused_dense_encoder_bwd` (``h0``
    recomputed, not stashed), with ``matmul_dtype`` and (for the stash)
    ``stash_dtype``. An output that takes no gradient gives a zero
    cotangent; the index arrays get no gradient."""

    @staticmethod
    def forward(ctx, node_feats, edge_feats, src, dst, edge_mask, weights, biases,
                depth: int, residual: bool, reduce: str, matmul_dtype=None, stash_dtype=None):
        kw = dict(depth=depth, residual=residual, reduce=reduce, matmul_dtype=matmul_dtype)
        node_hiddens, edge_hiddens, hs = fused_dense_encoder_fwd(
            node_feats, edge_feats, src, dst, edge_mask, weights, biases, stash=True,
            stash_dtype=stash_dtype, **kw
        )
        ctx.kw = kw
        ctx.save_for_backward(node_feats, edge_feats, src, dst, edge_mask, weights,
                              *(() if hs is None else (hs,)))
        return node_hiddens, edge_hiddens

    @staticmethod
    def backward(ctx, g_node, g_edge):
        node_feats, edge_feats, src, dst, edge_mask, weights, *stash = ctx.saved_tensors
        g_nf, g_ef, g_W, g_b = fused_dense_encoder_bwd(
            node_feats, edge_feats, stash[0] if stash else None, src, dst, edge_mask, weights,
            _aligned(g_node), _aligned(g_edge), **ctx.kw,
        )
        return g_nf, g_ef, None, None, None, g_W, g_b, None, None, None, None, None
