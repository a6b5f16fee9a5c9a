"""The fused dense D-MPNN block: a hand-written Hopper kernel, its plain
PyTorch version, and the wrapper that picks between them by device.

Replaces the Pallas kernel ``notorch_tpu/kernels/dense_mpnn.py``:
``fused_dense_mpnn_block`` / ``_block_kernel`` with its operator
``_edge_adjacency``. The kernel is CUDA C++ for ``sm_90a`` in
``notorch_tpu_torch/csrc/dense_mpnn.cu``, built by ``nvcc`` at first use and
bound with ``ctypes`` (:mod:`notorch_tpu_torch.kernels.build`).

What it computes, per bin ``b`` with ``rev(e) = e XOR 1``:

- ``A[e,e'] = [src[e] == dst[e']] * emask[e'] * [e' != rev(e)]`` for
  ``reduce="sum"``; for ``reduce="mean"``, ``keep / max(indeg, 1) - [e' ==
  rev(e)]`` with ``keep`` the first two factors and ``indeg`` its row sum;
- for each layer ``l``: ``h <- (h +) b_l + A @ (relu(h) @ W_l)``.

The reverse-message subtraction is folded into ``A``, so on PADDED edge
lanes the result differs from the unfolded form of
:class:`~notorch_tpu_torch.nn.chemprop_dense.DenseChempropBlock`; kernel,
plain version and the JAX kernel agree on every lane.

What bounds it on the card: the work is exact f32, so the floor is the
CUDA-core f32 rate (67 TFLOP/s on an H100 SXM). The ``W`` products need
``depth * 2 * B * E * d**2`` operations and the sparse operator ``2 * nnz(A)
* d`` per layer; the bytes (read ``h0``, ``W``, ``b`` and the index arrays
once, write the output once) take about a tenth as long, so it is bound by
operations. The design launches one kernel per layer on a (bin, 64-column)
grid: ``relu(h) @ W`` by k-tiled shared-memory FMA, with the next tile's
loads in flight during the current tile's FMAs, then ``A @ mW`` as a
row-sparse sum over bit rows of ``A`` built in shared memory, so ``A`` costs
operations only where it is nonzero and is never stored. ``fit_tile`` and
``mols_per_tile`` (the TPU's VMEM tiling policy) are dropped: a block always
holds one bin.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from notorch_tpu_torch.kernels import build

REDUCES = ("sum", "mean")


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
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: builds ``A`` densely and runs the
    layers as ``matmul`` and ``bmm`` in full f32."""
    if edge_hiddens.is_cuda:
        # the comparison with the kernel is in exact f32: no TF32 anywhere
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    A = edge_adjacency(src, dst, edge_mask, mean=reduce == "mean")
    h = edge_hiddens
    for layer in range(depth):
        mW = torch.matmul(torch.relu(h), weights[layer])
        out = biases[layer] + torch.bmm(A, mW)
        h = h + out if residual else out
    return h


def _check(edge_hiddens, src, dst, edge_mask, weights, biases, depth, reduce) -> None:
    if reduce not in REDUCES:
        raise ValueError(f"reduce must be one of {REDUCES}, got {reduce!r}")
    if edge_hiddens.dim() != 3:
        raise ValueError(f"edge_hiddens must be [B, E, d], got {tuple(edge_hiddens.shape)}")
    B, E, d = edge_hiddens.shape
    if E % 2 != 0:
        raise ValueError(f"edge lanes per bin must be even (reverse pairs), got {E}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    expect = {
        "edge_hiddens": (edge_hiddens, torch.float32, (B, E, d)),
        "src": (src, torch.int32, (B, E)),
        "dst": (dst, torch.int32, (B, E)),
        "edge_mask": (edge_mask, torch.bool, (B, E)),
        "weights": (weights, torch.float32, (depth, d, d)),
        "biases": (biases, torch.float32, (depth, d)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != edge_hiddens.device:
            raise ValueError(f"{name} is on {t.device}, edge_hiddens on {edge_hiddens.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.cache
def _layer_fn():
    lib = build.load("dense_mpnn")
    fn = lib.dense_mpnn_layer
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.dense_mpnn_error_string.argtypes = [ctypes.c_int]
    lib.dense_mpnn_error_string.restype = ctypes.c_char_p
    lib.dense_mpnn_max_edges.restype = ctypes.c_int
    lib.dense_mpnn_cols.restype = ctypes.c_int
    return lib, fn


def _launch_kernel(h0, src, dst, edge_mask, weights, biases, depth, residual, mean):
    B, E, d = h0.shape
    lib, fn = _layer_fn()
    if E > lib.dense_mpnn_max_edges() or d % lib.dense_mpnn_cols() != 0:
        raise ValueError(
            f"the CUDA kernel takes bins of at most {lib.dense_mpnn_max_edges()} edge "
            f"lanes and a width that is a multiple of {lib.dense_mpnn_cols()}; got "
            f"E={E}, d={d}"
        )
    if h0.data_ptr() % 16 or weights.data_ptr() % 16:
        raise ValueError(
            "the CUDA kernel reads edge_hiddens and weights in 16-byte vectors; "
            "their storage must start 16-byte aligned (pass a fresh tensor, not an offset view)"
        )
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty_like(h0)
        # ping-pong so that the last layer writes ``out``
        bufs = [out, torch.empty_like(h0) if depth > 1 else out]
        h_in = h0
        for layer in range(depth):
            h_out = bufs[(depth - 1 - layer) % 2]
            err = fn(
                h_in.data_ptr(), h_out.data_ptr(), src.data_ptr(), dst.data_ptr(),
                edge_mask.data_ptr(), weights[layer].data_ptr(), biases[layer].data_ptr(),
                B, E, d, int(residual), int(mean), stream,
            )
            if err != 0:
                raise RuntimeError(
                    f"dense_mpnn_layer launch failed: {lib.dense_mpnn_error_string(err).decode()}"
                )
            fused_dense_mpnn_block.launches += 1
            h_in = h_out
    return out


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
) -> torch.Tensor:
    """Run the whole D-MPNN block; returns the final edge hiddens [B, E, d].

    Tensors on the CPU take :func:`dense_mpnn_block_reference`; tensors on a
    CUDA device launch the kernel, once per layer, or raise — there is no
    fallback. ``fused_dense_mpnn_block.launches`` counts kernel launches.
    ``n_nodes`` (node slots per bin) is kept for the JAX signature; the
    operator needs only ``src``/``dst``.
    """
    _check(edge_hiddens, src, dst, edge_mask, weights, biases, depth, reduce)
    if n_nodes < 1:
        raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
    if edge_hiddens.device.type == "cpu":
        return dense_mpnn_block_reference(
            edge_hiddens, src, dst, edge_mask, weights, biases,
            depth=depth, residual=residual, reduce=reduce,
        )
    if edge_hiddens.device.type != "cuda":
        raise ValueError(f"no kernel for device {edge_hiddens.device}")
    return _launch_kernel(
        edge_hiddens, src, dst, edge_mask, weights, biases, depth, residual, reduce == "mean"
    )


fused_dense_mpnn_block.launches = 0
