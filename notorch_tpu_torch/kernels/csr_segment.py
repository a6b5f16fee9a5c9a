"""CSR segment sums over the flat edge layout: hand-written Hopper kernels,
their plain PyTorch versions, the wrappers that pick between them by
device, and the ``autograd.Function`` of the packed sum.

Replaces the Pallas kernels of ``notorch_tpu/kernels/csr_segment.py``:

================================  =========================================
TPU entry (kernel)                here
================================  =========================================
``csr_segment_sum_packed``        :func:`csr_segment_sum_packed`, the packed
(``_packed_kernel``)              kernel of ``csrc/csr_segment.cu``
``csr_segment_sum``               :func:`csr_segment_sum`, the row-pointer
(``_kernel``)                     kernel of ``csrc/csr_segment.cu``
================================  =========================================

What they compute, ``data [E, d]`` f32 into ``[num_nodes, d]``:

- packed: ``out[v] = sum of data[perm[s]]`` over the slots ``s`` of v's
  ``tile_v``-node tile with ``packed_dst[s] == v``, ``perm``/``packed_dst``
  from :func:`pack_edges_by_tile` (``-1`` in padding slots, which add
  nothing). A slot whose ``packed_dst`` lies outside its own tile, or whose
  ``perm`` is not an edge id, adds nothing either, as in the TPU kernel.
  On bf16 data (row 9b) the sum rounds where the TPU kernel's grid does:
  each ``tile_e``-slot chunk of the tile's budget gives an f32 partial of
  the node's rows (in slot order), rounded to bf16, and the partials are
  added in chunk order from zero, each add rounded to bf16
  (:func:`csr_segment_sum_packed_bf16_reference`); the result is bf16.
- row pointers: ``out[v] = sum of data[e]`` for ``e`` in ``[row_ptr[v],
  row_ptr[v+1])`` (``row_ptr`` nondecreasing, as :func:`~notorch_tpu_torch.
  data.graph.csr_row_ptr` gives it for dst-sorted edges). The sum is exact:
  the TPU kernel visits at most ``(tile_v * max_degree) // tile_e + 2``
  edge chunks per node tile and leaves out any edge past them; this one
  does not, so on such a tile the two differ. ``max_degree`` is kept for
  the signature.

Both kernels sum each output row in ascending slot (or edge) order with no
atomics, so two calls give the same bits, and the bits of their plain
versions on the CPU. The row-pointer kernel also sums rows through an order
(:func:`sorted_segments`, :func:`segment_sum_in_order`): every segment sum
and every gather's backward of the port's glue on the card goes through it
(:func:`notorch_tpu_torch.nn.ops.segment_sum` and
:func:`~notorch_tpu_torch.nn.ops.take`), so that a run on the card repeats
bit for bit. The TPU kernels build a one-hot
``[tile_v, tile_e]`` matrix per chunk and multiply it on the MXU; on the
card a segment sum is a gather-add, bound by bytes. The design of each is
described in ``csrc/csr_segment.cu``.

The CUDA source is built by ``nvcc`` for ``sm_90a`` at first use and bound
with ``ctypes`` (:mod:`notorch_tpu_torch.kernels.build`). Tensors on the
CPU take the plain versions; tensors on a CUDA device launch the kernels or
raise — there is no fallback. Each wrapper counts its launches in
``<wrapper>.launches``, its bf16 mode's in ``<wrapper>.launches_bf16``
(rows 8b and 9b); row 8's launches through :func:`segment_sum_in_order`
count in ``csr_segment_sum.launches`` too.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from notorch_tpu_torch.kernels import build
from notorch_tpu_torch.kernels.checks import check_aligned, check_tensors, on_card


def pack_edges_by_tile(
    dst,  # [E] i32, values in [0, num_nodes) (need NOT be sorted)
    num_nodes: int,
    tile_v: int = 128,
    budget: int | None = None,
):
    """Host-side packing: assign each edge a slot in its dst-tile's fixed
    budget, in edge order. Returns ``(perm, packed_dst, budget)`` where
    ``perm[slot] = edge index`` (or -1 for padding) and ``packed_dst[slot] =
    dst`` (or -1).

    ``budget`` (edge slots per node tile) defaults to the max per-tile edge
    count rounded up to a multiple of 128. Raises if any tile overflows a
    given budget.
    """
    dst = np.asarray(dst)
    n_tiles = -(-num_nodes // tile_v)
    tile_of_edge = dst // tile_v
    counts = np.bincount(tile_of_edge, minlength=n_tiles)
    needed = int(counts.max()) if len(counts) else 0
    if budget is None:
        budget = max(128, -(-needed // 128) * 128)
    elif needed > budget:
        raise ValueError(f"tile edge count {needed} exceeds budget {budget}")

    order = np.argsort(tile_of_edge, kind="stable")
    perm = np.full(n_tiles * budget, -1, dtype=np.int32)
    packed_dst = np.full(n_tiles * budget, -1, dtype=np.int32)
    offset_in_tile = np.zeros(len(dst), dtype=np.int64)
    sorted_tiles = tile_of_edge[order]
    starts = np.searchsorted(sorted_tiles, np.arange(n_tiles), side="left")
    for t in range(n_tiles):
        lo = starts[t]
        hi = starts[t + 1] if t + 1 < n_tiles else len(dst)
        offset_in_tile[order[lo:hi]] = np.arange(hi - lo)
    slots = tile_of_edge.astype(np.int64) * budget + offset_in_tile
    perm[slots] = np.arange(len(dst), dtype=np.int32)
    packed_dst[slots] = dst
    return perm, packed_dst, budget


# -- plain versions ---------------------------------------------------------------


def csr_segment_sum_packed_reference(
    data: torch.Tensor, perm: torch.Tensor, packed_dst: torch.Tensor, num_nodes: int, tile_v: int = 128
) -> torch.Tensor:
    """Plain PyTorch version of the packed kernel: one ``index_add_`` over
    all slots in slot order, the slots that add nothing (see the module
    docstring) sent to a trash row. No boolean indexing, so a CUDA graph can
    capture it."""
    E = data.shape[0]
    budget = perm.shape[0] // (num_nodes // tile_v)
    slot = torch.arange(perm.shape[0], device=perm.device)
    lo = torch.div(slot, budget, rounding_mode="floor") * tile_v
    valid = (perm >= 0) & (perm < E) & (packed_dst >= lo) & (packed_dst < lo + tile_v)
    rows = data.index_select(0, torch.where(valid, perm, 0).long())
    out = torch.zeros(num_nodes + 1, data.shape[1], dtype=data.dtype, device=data.device)
    return out.index_add_(0, torch.where(valid, packed_dst, num_nodes).long(), rows)[:num_nodes]


def csr_segment_sum_packed_bf16_reference(
    data: torch.Tensor, perm: torch.Tensor, packed_dst: torch.Tensor, num_nodes: int, tile_v: int = 128,
    tile_e: int = 128,
) -> torch.Tensor:
    """Plain version of the packed kernel's bf16 mode (row 9b): ``[num_nodes,
    d]`` bf16 from bf16 ``data``, rounded as the TPU kernel's grid rounds.
    That kernel walks each node tile's budget in chunks of ``tile_e`` slots,
    forms each chunk's sums as an f32 product (``preferred_element_type``),
    rounds them to bf16 and adds them to its bf16 output tile. So a node's
    sum is: for each chunk, the f32 sum of its slots' rows there (in slot
    order: one ``index_add_`` keyed by (node, chunk)), rounded to bf16; then
    those partials added in chunk order from zero, each add rounded to bf16.
    A node whose slots lie in one chunk gets its f32 sum rounded once. The
    slots that add nothing are those of :func:`csr_segment_sum_packed_reference`."""
    E, d = data.shape
    n_slots = perm.shape[0]
    budget = n_slots // (num_nodes // tile_v)
    chunks = budget // tile_e
    slot = torch.arange(n_slots, device=perm.device)
    lo = torch.div(slot, budget, rounding_mode="floor") * tile_v
    valid = (perm >= 0) & (perm < E) & (packed_dst >= lo) & (packed_dst < lo + tile_v)
    rows = data.index_select(0, torch.where(valid, perm, 0).long()).float()
    chunk = torch.div(slot % budget, tile_e, rounding_mode="floor")
    key = torch.where(valid, packed_dst.long() * chunks + chunk, num_nodes * chunks)
    partials = torch.zeros(num_nodes * chunks + 1, d, dtype=torch.float32, device=data.device)
    partials = partials.index_add_(0, key, rows)[:-1].reshape(num_nodes, chunks, d).to(torch.bfloat16)
    out = torch.zeros(num_nodes, d, dtype=torch.bfloat16, device=data.device)
    for c in range(chunks):
        out = out + partials[:, c]  # a bf16 add: f32 sum of the two, rounded
    return out


def csr_segment_sum_reference(data: torch.Tensor, row_ptr: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Plain PyTorch version of the row-pointer kernel: every edge ``e`` in
    ``[row_ptr[v], row_ptr[v+1])`` goes to ``v`` (``searchsorted``), then one
    ``index_add_`` in edge order; edges outside ``[row_ptr[0],
    row_ptr[num_nodes])`` go to a trash row."""
    edge = torch.arange(data.shape[0], device=data.device)
    node = torch.searchsorted(row_ptr.long(), edge, right=True) - 1
    node = torch.where((node >= 0) & (node < num_nodes), node, num_nodes)
    out = torch.zeros(num_nodes + 1, data.shape[1], dtype=data.dtype, device=data.device)
    return out.index_add_(0, node, data)[:num_nodes]


def sorted_segments(segment_ids: torch.Tensor, num_segments: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(order, row_ptr)`` of 1-D ``segment_ids``: ``order`` (int64) the
    stable sort of the ids, so that each segment's elements keep their
    ascending index order, and ``row_ptr`` (int32, ``[num_segments + 1]``)
    where each segment's run of ``order`` starts. Ids outside ``[0,
    num_segments)`` fall outside every run."""
    ids, order = torch.sort(segment_ids, stable=True)
    return order, torch.searchsorted(ids, _bounds(num_segments, ids.dtype, ids.device), out_int32=True)


@functools.lru_cache(maxsize=64)
def _bounds(num_segments: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``arange(num_segments + 1)``, made once for each size."""
    return torch.arange(num_segments + 1, dtype=dtype, device=device)


def bf16_chain_sum_reference(rows: torch.Tensor, row_ptr: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Plain version of the row-pointer kernel's bf16 mode: ``[num_nodes,
    d]`` bf16, each node the sum of its rows ``[row_ptr[v], row_ptr[v+1])``
    of ``rows [E, d]`` (bf16) from zero in ascending order, the running sum
    rounded to bf16 after every add, as XLA's scatter-add of bf16 data adds
    (``jax.ops.segment_sum``, the gather's VJP). One vectorized step per
    rank within a run: step ``r`` adds each node's ``r``-th row. Rows of
    zeros are left out, since adding one changes no sum (a gradient's padding
    rows, which would make the longest run, and so the number of steps,
    several times longer); only the sign of a zero sum can differ."""
    E, d = rows.shape
    rp = row_ptr.long().clamp(0, E)
    acc = torch.zeros(num_nodes, d, dtype=torch.bfloat16, device=rows.device)
    pos = torch.arange(E, device=rows.device)
    node = torch.searchsorted(rp, pos, right=True) - 1
    live = (node >= 0) & (node < num_nodes) & rows.ne(0).any(dim=1)
    pos, node = pos[live], node[live]
    if pos.numel() == 0:
        return acc
    rank = torch.arange(pos.numel(), device=rows.device) - torch.searchsorted(node, node)
    by_rank = torch.argsort(rank, stable=True)
    sizes = torch.bincount(rank).tolist()
    values = rows.to(torch.bfloat16).index_select(0, pos[by_rank])
    for at, x in zip(node[by_rank].split(sizes), values.split(sizes)):
        acc[at] = acc[at] + x  # a bf16 add: f32 sum of the two, rounded
    return acc


def segment_sum_in_order_reference(data: torch.Tensor, order: torch.Tensor, row_ptr: torch.Tensor,
                                   num_segments: int) -> torch.Tensor:
    """Plain version of :func:`segment_sum_in_order`: the row-pointer sum's
    plain version over ``data[order]`` (:func:`bf16_chain_sum_reference` for
    bf16 data)."""
    rows = data.index_select(0, order).reshape(order.shape[0], math.prod(data.shape[1:]))
    plain = bf16_chain_sum_reference if data.dtype == torch.bfloat16 else csr_segment_sum_reference
    return plain(rows, row_ptr, num_segments).reshape(num_segments, *data.shape[1:])


# -- the kernels ------------------------------------------------------------------


def _check_data(data: torch.Tensor, num_nodes: int, tile_v: int) -> None:
    if data.dim() != 2:
        raise ValueError(f"data must be [E, d], got {tuple(data.shape)}")
    if num_nodes <= 0 or tile_v <= 0 or num_nodes % tile_v != 0:
        raise ValueError(f"num_nodes {num_nodes} must be a positive multiple of tile_v {tile_v}")
    if not data.is_floating_point():
        raise TypeError(f"data must be floating point, got {data.dtype}")


def _check_for_kernel(data: torch.Tensor) -> None:
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA kernels take float32 or bfloat16 data, got {data.dtype}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if data.shape[1] % 4:
        raise ValueError(f"the CUDA kernels read rows in vectors of 4 values: d must be a multiple of 4, "
                         f"got {data.shape[1]}")
    check_aligned(data=data)


@functools.cache
def _lib():
    lib = build.load("csr_segment")
    lib.csr_segment_sum_packed_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.csr_segment_sum_packed_bf16.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.csr_segment_sum_rowptr_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.csr_segment_sum_rowptr_bf16.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.csr_segment_chain_latency.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.csr_segment_error_string.argtypes = [ctypes.c_int]
    lib.csr_segment_error_string.restype = ctypes.c_char_p
    lib.csr_segment_max_budget.argtypes = lib.csr_segment_max_tile.argtypes = []
    for name in ("csr_segment_sum_packed_f32", "csr_segment_sum_packed_bf16", "csr_segment_sum_rowptr_f32",
                 "csr_segment_sum_rowptr_bf16", "csr_segment_chain_latency", "csr_segment_max_budget",
                 "csr_segment_max_tile"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _raise_on(err: int, what: str, lib) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.csr_segment_error_string(err).decode()}")


def _packed_forward(data, perm, packed_dst, num_nodes: int, tile_v: int, tile_e: int) -> torch.Tensor:
    bf16 = data.dtype == torch.bfloat16
    if not on_card(data):
        if bf16:
            return csr_segment_sum_packed_bf16_reference(data, perm, packed_dst, num_nodes, tile_v, tile_e)
        return csr_segment_sum_packed_reference(data, perm, packed_dst, num_nodes, tile_v)
    lib = _lib()
    _check_for_kernel(data)
    budget = perm.shape[0] // (num_nodes // tile_v)
    if tile_v > lib.csr_segment_max_tile() or budget > lib.csr_segment_max_budget():
        raise ValueError(
            f"the packed kernel takes tiles of at most {lib.csr_segment_max_tile()} nodes and "
            f"{lib.csr_segment_max_budget()} slots; got tile_v={tile_v}, budget={budget}"
        )
    E, d = data.shape
    out = torch.empty(num_nodes, d, dtype=data.dtype, device=data.device)
    with torch.cuda.device(data.device):
        args = (data.data_ptr(), perm.data_ptr(), packed_dst.data_ptr(), out.data_ptr(), E, d, num_nodes, tile_v,
                budget)
        stream = torch.cuda.current_stream().cuda_stream
        if bf16:
            err = lib.csr_segment_sum_packed_bf16(*args, tile_e, stream)
        else:
            err = lib.csr_segment_sum_packed_f32(*args, stream)
    _raise_on(err, "csr_segment_sum_packed", lib)
    if bf16:
        csr_segment_sum_packed.launches_bf16 += 1
    else:
        csr_segment_sum_packed.launches += 1
    return out


class CsrSegmentSumPackedFn(torch.autograd.Function):
    """The packed sum as an autograd node, as the JAX custom VJP: the
    backward is one masked gather, ``d_data = where(edge_mask, g[dst], 0)``
    (plain indexing: it is plain XLA there too, not a Pallas kernel). The
    index arrays get no gradient."""

    @staticmethod
    def forward(ctx, data, perm, packed_dst, dst, edge_mask, num_nodes: int, tile_v: int, tile_e: int):
        ctx.save_for_backward(dst, edge_mask)
        return _packed_forward(data, perm, packed_dst, num_nodes, tile_v, tile_e)

    @staticmethod
    def backward(ctx, g):
        dst, edge_mask = ctx.saved_tensors
        d_data = torch.where(edge_mask[:, None], g[dst.long()], 0.0)
        return d_data, None, None, None, None, None, None, None


def csr_segment_sum_packed(
    data: torch.Tensor,  # [E, d] messages (any order)
    perm: torch.Tensor,  # [T*budget] i32 slot -> edge index (-1 padding)
    packed_dst: torch.Tensor,  # [T*budget] i32 (-1 padding)
    num_nodes: int,
    dst: torch.Tensor | None = None,  # [E] i32 (for the backward's gather)
    edge_mask: torch.Tensor | None = None,  # [E] bool (True = real edge)
    tile_v: int = 128,
    tile_e: int = 128,
) -> torch.Tensor:
    """Segment sum through the tile-packed layout, ``[num_nodes, d]``.
    ``perm``/``packed_dst`` come from :func:`pack_edges_by_tile`; the budget
    per tile (``len(perm) // (num_nodes // tile_v)``) must be a multiple of
    ``tile_e``, as the TPU grid needs. float32 data is summed whole in slot
    order (``tile_e`` is then only checked); bfloat16 data (row 9b) rounds
    each ``tile_e``-slot chunk's f32 partial and each add of the partials to
    bf16, as the TPU grid does, and gives bf16.

    Differentiable in ``data`` through :class:`CsrSegmentSumPackedFn`: the
    gradient of edge ``e`` is ``g[dst[e]]`` where ``edge_mask[e]``, else 0
    (all edges real without a mask; without ``dst`` the gradient is zero,
    as in the JAX package). CPU tensors take
    :func:`csr_segment_sum_packed_reference` (bf16:
    :func:`csr_segment_sum_packed_bf16_reference`); on a CUDA device
    ``csr_segment_sum_packed.launches`` counts the kernel's launches (one a
    call), ``csr_segment_sum_packed.launches_bf16`` those of row 9b."""
    _check_data(data, num_nodes, tile_v)
    E = data.shape[0]
    n_tiles = num_nodes // tile_v
    n_slots = perm.shape[0]
    if n_slots % n_tiles != 0:
        raise ValueError(f"{n_slots} slots do not split into {n_tiles} tiles")
    budget = n_slots // n_tiles
    if tile_e <= 0 or budget % tile_e != 0:
        raise ValueError(f"budget {budget} must be a multiple of tile_e {tile_e}")
    expect = {"perm": (perm, torch.int32, (n_slots,)), "packed_dst": (packed_dst, torch.int32, (n_slots,))}
    if dst is not None:
        expect["dst"] = (dst, torch.int32, (E,))
    if edge_mask is not None:
        expect["edge_mask"] = (edge_mask, torch.bool, (E,))
    check_tensors(expect, data.device, anchor="data")
    if not (torch.is_grad_enabled() and data.requires_grad):
        return _packed_forward(data, perm, packed_dst, num_nodes, tile_v, tile_e)
    # the backward's gather: made only where a gradient is taken, so that a
    # forward launches the kernel alone
    if dst is None:
        dst = torch.zeros(E, dtype=torch.int32, device=data.device)
        edge_mask = torch.zeros(E, dtype=torch.bool, device=data.device)
    elif edge_mask is None:
        edge_mask = torch.ones(E, dtype=torch.bool, device=data.device)
    return CsrSegmentSumPackedFn.apply(data, perm, packed_dst, dst, edge_mask, num_nodes, tile_v, tile_e)


def csr_segment_sum(
    data: torch.Tensor,  # [E, d] messages (dst-sorted)
    dst: torch.Tensor,  # [E] i32 sorted
    row_ptr: torch.Tensor,  # [V+1] i32
    num_nodes: int,
    tile_v: int = 128,
    tile_e: int = 256,
    max_degree: int = 8,
) -> torch.Tensor:
    """Segment sum of dst-sorted ``data`` into ``[num_nodes, d]`` over the
    row pointers (``dst`` is checked for shape; the sum reads ``row_ptr``).
    ``num_nodes`` must be a multiple of ``tile_v`` and ``E`` of ``tile_e``,
    as the TPU grid needs. No gradient, as in the JAX package. CPU tensors
    take :func:`csr_segment_sum_reference`; on a CUDA device
    ``csr_segment_sum.launches`` counts the kernel's launches (one a call)."""
    _check_data(data, num_nodes, tile_v)
    E = data.shape[0]
    if tile_e <= 0 or E % tile_e != 0:
        raise ValueError(f"num edges {E} must be a multiple of tile_e {tile_e}")
    check_tensors({"dst": (dst, torch.int32, (E,)), "row_ptr": (row_ptr, torch.int32, (num_nodes + 1,))},
                  data.device, anchor="data")
    if torch.is_grad_enabled() and data.requires_grad:
        raise RuntimeError("csr_segment_sum has no gradient, as in the JAX package; "
                           "use csr_segment_sum_packed to train")
    if not on_card(data):
        return csr_segment_sum_reference(data, row_ptr, num_nodes)
    return _rowptr_launch(data, row_ptr, None, num_nodes)


def _rowptr_launch(data: torch.Tensor, row_ptr: torch.Tensor, order: torch.Tensor | None,
                   num_nodes: int) -> torch.Tensor:
    """Row 8's kernel on the card: ``[num_nodes, d]`` sums over the rows
    ``data[order[e]]`` (``data[e]`` without an order) of ``data [rows, d]``,
    any ``d``; counts a launch in ``csr_segment_sum.launches``. bf16 data
    takes the bf16 kernel (row 8b): bf16 read and written in one launch, the
    running sum rounded to bf16 after every add as XLA adds bf16 rows;
    counted in ``csr_segment_sum.launches_bf16``."""
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA kernels take float32 or bfloat16 data, got {data.dtype}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    bf16 = data.dtype == torch.bfloat16
    E = data.shape[0] if order is None else order.shape[0]
    d = data.shape[1]
    out = torch.empty(num_nodes, d, dtype=data.dtype, device=data.device)
    if num_nodes == 0 or d == 0:
        return out
    lib = _lib()
    entry = lib.csr_segment_sum_rowptr_bf16 if bf16 else lib.csr_segment_sum_rowptr_f32
    args = (data.data_ptr(), row_ptr.data_ptr(), None if order is None else order.data_ptr(), out.data_ptr(),
            E, d, num_nodes, torch.cuda.current_stream(data.device).cuda_stream)
    if data.device.index == torch.cuda.current_device():  # the glue's every call: no device switch
        err = entry(*args)
    else:
        with torch.cuda.device(data.device):
            err = entry(*args)
    _raise_on(err, "csr_segment_sum", lib)
    if bf16:
        csr_segment_sum.launches_bf16 += 1
    else:
        csr_segment_sum.launches += 1
    return out


def chain_add_latency(device: torch.device | str = "cuda", adds: int = 1 << 17) -> dict:
    """The latency of one step of row 8b's chain on the card: one thread
    adds a bf16 pair ``adds`` times (rounded up to a multiple of 64), each
    add depending on the last, timed in SM cycles (``clock64``) and in
    nanoseconds (``%globaltimer``). Returns ``{"adds", "cycles_per_add",
    "ns_per_add"}``. A run of ``n`` rows takes at least ``n`` such adds:
    row 8b's chain floor."""
    lib = _lib()
    iters = -(-adds // 64)
    out = torch.zeros(3, dtype=torch.int64, device=device)
    with torch.cuda.device(out.device):
        _raise_on(lib.csr_segment_chain_latency(out.data_ptr(), iters, torch.cuda.current_stream().cuda_stream),
                  "csr_segment_chain_latency", lib)
    cycles, ns, _ = out.tolist()
    return {"adds": 64 * iters, "cycles_per_add": cycles / (64 * iters), "ns_per_add": ns / (64 * iters)}


def segment_sum_in_order(data: torch.Tensor, order: torch.Tensor, row_ptr: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """``out[v] = sum of data[order[e]]`` for ``e`` in ``[row_ptr[v],
    row_ptr[v+1])``, in ascending ``e``: ``[num_segments, *data.shape[1:]]``,
    ``order``/``row_ptr`` from :func:`sorted_segments`. Given a stable sort,
    each segment's terms are added in ascending index order from zero, as
    ``index_add_`` adds them on the CPU, so the result has its bits. On a
    CUDA device the row-pointer kernel (row 8) sums through the order, any
    width, float32 (or bfloat16, each add rounded: row 8b); CPU tensors take
    :func:`segment_sum_in_order_reference`. No gradient."""
    if not on_card(data):
        return segment_sum_in_order_reference(data, order, row_ptr, num_segments)
    check_tensors({"order": (order, torch.int64, (order.shape[0],)),
                   "row_ptr": (row_ptr, torch.int32, (num_segments + 1,))}, data.device, anchor="data")
    return sum_in_order(data, order, row_ptr, num_segments)


def sum_in_order(data: torch.Tensor, order: torch.Tensor, row_ptr: torch.Tensor, num_segments: int) -> torch.Tensor:
    """:func:`segment_sum_in_order` on a CUDA device without its checks, for
    callers whose ``order`` and ``row_ptr`` came from :func:`sorted_segments`
    on the same device (``nn/ops.py``, on every sum of a step)."""
    rows = data.reshape(data.shape[0], math.prod(data.shape[1:])).contiguous()
    return _rowptr_launch(rows, row_ptr, order, num_segments).reshape(num_segments, *data.shape[1:])


csr_segment_sum_packed.launches = 0
csr_segment_sum_packed.launches_bf16 = 0
csr_segment_sum.launches = 0
csr_segment_sum.launches_bf16 = 0
