"""The dense graph-attention core: hand-written Hopper kernels for its
forward and recompute backward, their plain PyTorch versions, the wrappers
that pick between them by device, and the ``autograd.Function`` that trains
through them.

Replaces the Pallas kernels of ``notorch_tpu/kernels/dense_attention.py``:

==================================  =======================================
TPU entry (kernel)                  here
==================================  =======================================
``fused_dense_attention_fwd``       :func:`fused_dense_attention_fwd`,
(``_attn_kernel``)                  ``attn_rows_kernel`` of
                                    ``csrc/dense_attention.cu``: a lane group
                                    per (query row, head), every bin and head
                                    in flight at once
``fused_dense_attention_bwd``       :func:`fused_dense_attention_bwd`, a
(``_attn_bwd_kernel``)              query pass (``attn_rows_kernel``) then a
                                    key pass (``attn_cols_kernel``), a lane
                                    group per (row, head)
``fused_dense_attention_fwd_v2``    :func:`fused_dense_attention_fwd_v2`,
(``_attn_kernel_v2``)               row 10's kernel (one function, one
                                    layout) in an instantiation of its own,
                                    capped at fewer registers
``fused_dense_attention_bwd_v2``    :func:`fused_dense_attention_bwd_v2`,
(``_attn_bwd_kernel_v2``)           ``attn_cluster_kernel``: both passes in
                                    one launch, a thread-block cluster per
                                    bin, the values between them in the
                                    blocks' shared memory
``fused_dense_attention``           :class:`FusedDenseAttentionFn` (and
(the custom VJP)                    :func:`fused_dense_attention`)
==================================  =======================================

Layouts are the JAX package's: ``q, k, v`` and the output ``[B, V, d]``
with ``d = num_heads * dh`` (head ``h`` in columns ``h*dh:(h+1)*dh``),
``eb`` the per-edge score bias ``[B, H, E]`` or ``None``, int32 ``src``/
``dst`` ``[B, E]``, ``edge_mask`` ``[B, E]`` bool (a float mask counts an
edge where it is nonzero). Per bin and head, ``M[i, j]`` counts the real
edges ``j -> i``; the scores ``q_i . k_j / sqrt(dh)`` plus the bias summed
over those edges are softmaxed over the ``j`` with ``M[i, j] > 0`` (the sum
floored at ``1e-12``), and the output is ``alpha @ v``. A row with no such
``j`` (padding node slots, the padding sink, a bond-less molecule) is zero,
in the output and in every gradient. The backward returns ``(g_q, g_k,
g_v, g_eb)``, ``g_eb[b, h, e] = edge_mask[b, e] * g_s[b, h, dst e, src e]``
with ``g_s`` the softmax's input gradient; without ``eb`` it is zeros, as
the TPU kernel writes.

Every entry also runs the JAX kernels' bf16 modes (rows 10b-13b): with
bf16 inputs (``dt = mm = bfloat16``: a bf16 model's q, k, v and bias; the
outputs bf16) or with ``matmul_dtype="bfloat16"`` on f32 inputs, q, k, v,
the cotangent and each edge's bias are rounded to bf16 into the products,
alpha is rounded to ``dt`` and then to bf16 for the value product, ``g_s``
to bf16, and every sum and the softmax stay f32
(:func:`dense_attention_bf16_reference` and
:func:`dense_attention_bwd_bf16_reference` say exactly where); bf16
tensors are read and written as bf16.

The CUDA source is built by ``nvcc`` for ``sm_90a`` at first use and bound
with ``ctypes`` (:mod:`notorch_tpu_torch.kernels.build`); its design and
bound are described there. Tensors on the CPU take the plain versions;
tensors on a CUDA device launch the kernels or raise — there is no
fallback. Each wrapper counts its launches in ``<wrapper>.launches``
(exact f32), ``launches_mm`` (``matmul_dtype="bfloat16"``) and
``launches_bf16`` (bf16 inputs). The
kernels take float32 or bfloat16, ``dh`` a multiple of 4 up to 512, up to 46,340 node
slots a bin, and bins whose index fits a block's shared memory: the forwards and row 11 hold the edge
list of a block's rows, 24 bytes a lane (up to about 9,600 lanes), a bf16 forward each pair's score for
every head beside it (16 + 4 max(2, H) bytes a lane: up to about 7,200 lanes at four heads); row 13
holds two such lists and each pair's values, 8 bytes a lane and head (E =
4,096 lanes at one head fit, at four heads not); the wrappers raise, naming
the shape, on anything else. ``interpret`` is accepted for the JAX
signature: on CPU tensors it changes nothing, on CUDA tensors ``True``
raises (the port has no interpret mode).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from notorch_tpu_torch.kernels import build
from notorch_tpu_torch.kernels.checks import check_aligned, check_tensors, on_card

__all__ = [
    "FusedDenseAttentionFn",
    "attention_core",
    "dense_attention_bf16_reference",
    "dense_attention_bwd_bf16_reference",
    "dense_attention_bwd_reference",
    "dense_attention_reference",
    "fit_attn_tile",
    "fused_dense_attention",
    "fused_dense_attention_bwd",
    "fused_dense_attention_bwd_v2",
    "fused_dense_attention_fwd",
    "fused_dense_attention_fwd_v2",
]


MATMUL_DTYPES = (None, "float32", "bfloat16")


def fit_attn_tile(tile: int, nodes_per_bin: int, edges_per_bin: int, batch: int) -> int:
    """Shrink a requested bins-per-kernel-tile so per-tile VMEM stays inside
    the envelope (the [V, V] per-head score tensors plus the [E, V] one-hot
    operators are the big residents) and the batch divides evenly."""
    # the TPU's budget heuristic, kept for the JAX API: no launch of the
    # port tiles bins
    while tile > 1 and tile * max(edges_per_bin, nodes_per_bin) > 4 * 256:
        tile //= 2
    while batch % tile != 0:
        tile //= 2
    return max(tile, 1)


# -- plain versions ---------------------------------------------------------------


def _live(edge_mask: torch.Tensor) -> torch.Tensor:
    return edge_mask if edge_mask.dtype == torch.bool else edge_mask != 0


def _one_hots(src, dst, edge_mask, V: int, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """``S [B, V, E]`` (dst one-hot of the real edges) and ``Gm [B, E, V]``
    (src one-hot)."""
    ids = torch.arange(V, device=src.device)
    S = (dst.long()[:, None, :] == ids[None, :, None]) & _live(edge_mask)[:, None, :]
    Gm = src.long()[:, :, None] == ids[None, None, :]
    return S.to(dtype), Gm.to(dtype)


def _heads(x: torch.Tensor, H: int) -> torch.Tensor:
    B, V, d = x.shape
    return x.reshape(B, V, H, d // H).transpose(1, 2)  # [B, H, V, dh]


def _merge(x: torch.Tensor) -> torch.Tensor:
    B, H, V, dh = x.shape
    return x.transpose(1, 2).reshape(B, V, H * dh)


def _scores(q, k, eb, S, Gm, H: int) -> torch.Tensor:
    """``[B, H, V, V]``: ``q k^T / sqrt(dh)`` plus the edge bias scattered
    through ``S eb Gm``, in q's dtype (the divisor too, as JAX's weakly
    typed scalar)."""
    dh = q.shape[-1] // H
    root = torch.full((), math.sqrt(dh), dtype=q.dtype, device=q.device)
    scores = _heads(q, H) @ _heads(k, H).transpose(-1, -2) / root
    if eb is not None:
        scores = scores + (S[:, None] * eb[:, :, None, :]) @ Gm[:, None]
    return scores


def _alpha(q, k, eb, src, dst, edge_mask, H: int) -> torch.Tensor:
    """The TPU kernels' masked softmax: masked lanes at ``-1e30``, ``exp``
    zeroed there, the row sum floored at ``1e-12``."""
    S, Gm = _one_hots(src, dst, edge_mask, q.shape[1], q.dtype)
    mask = (S @ Gm > 0)[:, None]
    neg = torch.where(mask, _scores(q, k, eb, S, Gm, H), -1e30)
    ex = torch.where(mask, torch.exp(neg - neg.amax(-1, keepdim=True)), 0.0)
    return ex / ex.sum(-1, keepdim=True).clamp_min(1e-12)


def _bf16(t: torch.Tensor | None) -> torch.Tensor | None:
    """``t`` rounded to bf16 and held as f32: a TPU kernel's ``.astype(mm)``
    operand."""
    return None if t is None else t.to(torch.bfloat16).float()


def _alpha_bf16(q, k, eb, src, dst, edge_mask, H: int) -> torch.Tensor:
    """The bf16 kernels' softmax ([B, H, V, V], f32): ``_head_alpha`` of the
    JAX kernels with ``mm = bfloat16``: q and k rounded into the scores'
    product (f32 sums) times ``1 / sqrt(dh)``, each edge's bias rounded
    before the duplicates are summed in f32, then the f32 masked softmax."""
    dh = q.shape[-1] // H
    S, Gm = _one_hots(src, dst, edge_mask, q.shape[1], torch.float32)
    mask = (S @ Gm > 0)[:, None]
    scores = _heads(_bf16(q), H) @ _heads(_bf16(k), H).transpose(-1, -2) * (1.0 / math.sqrt(dh))
    if eb is not None:
        scores = scores + (S[:, None] * _bf16(eb)[:, :, None, :]) @ Gm[:, None]
    neg = torch.where(mask, scores, -1e30)
    ex = torch.where(mask, torch.exp(neg - neg.amax(-1, keepdim=True)), 0.0)
    return ex / ex.sum(-1, keepdim=True).clamp_min(1e-12)


def dense_attention_bf16_reference(q, k, v, eb, src, dst, edge_mask, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the forward kernels' bf16 modes (rows 10b
    and 12b), ``[B, V, d]`` in q's dtype: ``alpha`` rounded to that dtype
    (``dt``), then to bf16 with v for the value product (f32 sums), the
    output rounded to ``dt``. With f32 inputs this is ``matmul_dtype=
    "bfloat16"``; with bf16 ones ``dt = mm = bfloat16``."""
    dt = q.dtype
    alpha = _alpha_bf16(q, k, eb, src, dst, edge_mask, num_heads).to(dt)
    return _merge(_bf16(alpha) @ _heads(_bf16(v), num_heads)).to(dt)


def dense_attention_bwd_bf16_reference(q, k, v, eb, src, dst, edge_mask, cotangent, num_heads: int):
    """Plain PyTorch version of the backward kernels' bf16 modes (rows 11b
    and 13b): ``(g_q, g_k, g_v, g_eb)`` in q's dtype (``dt``), rounded where
    the JAX kernels round: ``g_alpha = g(bf16) . v(bf16)`` in f32, ``g_v =
    alpha(bf16)^T g(bf16)``, ``g_s = alpha g_alpha - alpha D`` from the
    ``dt``-rounded alpha and rounded to ``dt``, ``g_q`` and ``g_k`` the
    products of ``g_s(bf16)`` with k and q (bf16) times ``1 / sqrt(dh)``,
    and ``g_eb`` each live edge's ``g_s(bf16)[dst, src]``; every output
    rounded to ``dt``."""
    H, dt = num_heads, q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1] // H)
    af = _alpha_bf16(q, k, eb, src, dst, edge_mask, H).to(dt).float()
    g = _heads(_bf16(cotangent), H)
    g_alpha = g @ _heads(_bf16(v), H).transpose(-1, -2)
    g_v = _bf16(af).transpose(-1, -2) @ g
    tmp = af * g_alpha
    g_s = _bf16((tmp - af * tmp.sum(-1, keepdim=True)).to(dt))
    g_q = g_s @ _heads(_bf16(k), H) * scale
    g_k = g_s.transpose(-1, -2) @ _heads(_bf16(q), H) * scale
    B, E = src.shape
    if eb is None:
        g_eb = torch.zeros(B, H, E, dtype=dt, device=q.device)
    else:
        S, Gm = _one_hots(src, dst, edge_mask, q.shape[1], torch.float32)
        g_eb = ((S.transpose(1, 2)[:, None] @ g_s) * Gm[:, None]).sum(-1).to(dt)
    return _merge(g_q).to(dt), _merge(g_k).to(dt), _merge(g_v).to(dt), g_eb


def dense_attention_reference(q, k, v, eb, src, dst, edge_mask, num_heads: int,
                              matmul_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of the forward kernels (rows 10 and 12):
    ``[B, V, d]``; their bf16 modes (:func:`dense_attention_bf16_reference`)
    for bf16 inputs or ``matmul_dtype="bfloat16"``."""
    if _mode(q, matmul_dtype) != EXACT:
        return dense_attention_bf16_reference(q, k, v, eb, src, dst, edge_mask, num_heads)
    return _merge(_alpha(q, k, eb, src, dst, edge_mask, num_heads) @ _heads(v, num_heads))


def dense_attention_bwd_reference(q, k, v, eb, src, dst, edge_mask, cotangent, num_heads: int,
                                  matmul_dtype=None):
    """Plain PyTorch version of the recompute backward kernels (rows 11 and
    13): ``(g_q, g_k, g_v, g_eb)``, ``g_eb`` zeros ``[B, H, E]`` without
    ``eb``; their bf16 modes (:func:`dense_attention_bwd_bf16_reference`)
    for bf16 inputs or ``matmul_dtype="bfloat16"``."""
    if _mode(q, matmul_dtype) != EXACT:
        return dense_attention_bwd_bf16_reference(q, k, v, eb, src, dst, edge_mask, cotangent, num_heads)
    H = num_heads
    dh = q.shape[-1] // H
    alpha = _alpha(q, k, eb, src, dst, edge_mask, H)
    g = _heads(cotangent, H)
    g_alpha = g @ _heads(v, H).transpose(-1, -2)
    g_v = alpha.transpose(-1, -2) @ g
    tmp = alpha * g_alpha
    g_s = tmp - alpha * tmp.sum(-1, keepdim=True)
    g_q = g_s @ _heads(k, H) / math.sqrt(dh)
    g_k = g_s.transpose(-1, -2) @ _heads(q, H) / math.sqrt(dh)
    B, E = src.shape
    if eb is None:
        g_eb = torch.zeros(B, H, E, dtype=q.dtype, device=q.device)
    else:
        # the bias VJP as the TPU kernel takes it: T = St g_s, then sum_j T * G
        S, Gm = _one_hots(src, dst, edge_mask, q.shape[1], q.dtype)
        g_eb = ((S.transpose(1, 2)[:, None] @ g_s) * Gm[:, None]).sum(-1)
    return _merge(g_q), _merge(g_k), _merge(g_v), g_eb


def attention_core(q, k, v, eb, src, dst, edge_mask, num_heads: int) -> torch.Tensor:
    """The counterpart of the JAX package's ``_jnp_attention_core``, the
    forward that ``fwd_impl="jnp"`` runs in plain tensor ops on any device
    (masked lanes at ``-inf``, a row max that is not finite taken as 0), in
    the inputs' dtype; ``matmul_dtype`` does not reach it, as in the JAX
    package."""
    S, Gm = _one_hots(src, dst, edge_mask, q.shape[1], q.dtype)
    mask = (S @ Gm > 0)[:, None]
    neg = torch.where(mask, _scores(q, k, eb, S, Gm, num_heads), float("-inf"))
    mx = neg.amax(-1, keepdim=True)
    ex = torch.where(mask, torch.exp(neg - torch.where(torch.isfinite(mx), mx, 0.0)), 0.0)
    alpha = ex / ex.sum(-1, keepdim=True).clamp_min(1e-12)
    return _merge(alpha @ _heads(v, num_heads))


# -- the kernels ------------------------------------------------------------------


def _check(q, k, v, eb, src, dst, edge_mask, num_heads: int, cotangent=None) -> tuple[int, int, int, int]:
    if q.dim() != 3:
        raise ValueError(f"q must be [B, V, d], got {tuple(q.shape)}")
    B, V, d = q.shape
    if B < 1 or V < 1:
        raise ValueError(f"q must hold at least one bin and one node slot, got {tuple(q.shape)}")
    if num_heads < 1 or d % num_heads != 0:
        raise ValueError(f"hidden dim {d} not divisible by num_heads {num_heads}")
    for name, x in (("k", k), ("v", v), ("cotangent", cotangent)):
        if x is not None and tuple(x.shape) != (B, V, d):
            raise ValueError(f"{name} must have q's shape {(B, V, d)}, got {tuple(x.shape)}")
    if src.dim() != 2 or src.shape[0] != B:
        raise ValueError(f"src must be [B, E] with B = {B}, got {tuple(src.shape)}")
    E = src.shape[1]
    for name, x in (("dst", dst), ("edge_mask", edge_mask)):
        if tuple(x.shape) != (B, E):
            raise ValueError(f"{name} must have shape {(B, E)}, got {tuple(x.shape)}")
    if eb is not None and tuple(eb.shape) != (B, num_heads, E):
        raise ValueError(f"eb must be [B, H, E] = {(B, num_heads, E)}, got {tuple(eb.shape)}")
    return B, V, d, E


def _matmul_bf16(matmul_dtype) -> bool:
    """``matmul_dtype`` as the JAX kernels take it: ``None`` (the inputs'
    dtype) or float32 gives False, bfloat16 True; anything else raises."""
    name = None if matmul_dtype is None else str(matmul_dtype).removeprefix("torch.")
    if name not in MATMUL_DTYPES:
        raise ValueError(f"matmul_dtype must be one of {MATMUL_DTYPES}, got {matmul_dtype!r}")
    return name == "bfloat16"


@functools.cache
def _lib():
    lib = build.load("dense_attention")
    tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.dense_attention_fwd_f32.argtypes = [ctypes.c_void_p] * 8 + tail
    lib.dense_attention_v1_fwd_f32.argtypes = [ctypes.c_void_p] * 8 + tail
    lib.dense_attention_bwd_f32.argtypes = [ctypes.c_void_p] * 12 + tail
    lib.dense_attention_v1_bwd_f32.argtypes = [ctypes.c_void_p] * 13 + tail  # and the scratch
    lib.dense_attention_list_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.dense_attention_cluster_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.dense_attention_list_smem_bytes.restype = ctypes.c_longlong
    lib.dense_attention_cluster_smem_bytes.restype = ctypes.c_longlong
    lib.dense_attention_error_string.argtypes = [ctypes.c_int]
    lib.dense_attention_error_string.restype = ctypes.c_char_p
    lib.dense_attention_max_smem.argtypes = lib.dense_attention_max_dh.argtypes = []
    lib.dense_attention_max_v.argtypes = []
    for name in ("dense_attention_fwd_f32", "dense_attention_bwd_f32", "dense_attention_v1_fwd_f32",
                 "dense_attention_v1_bwd_f32", "dense_attention_max_smem", "dense_attention_max_dh",
                 "dense_attention_max_v"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


# the kernels' numeric modes (csrc/dense_attention.cu kExact, kMm, kHalf)
EXACT, MATMUL_BF16, HALF = 0, 1, 2


def _mode(q: torch.Tensor, matmul_dtype) -> int:
    """The kernels' mode for these inputs: exact f32, f32 with bf16 operands
    (``matmul_dtype="bfloat16"``), or bf16 in and out (bf16 inputs, whose
    ``matmul_dtype`` must be ``None`` or bfloat16, the JAX kernels' ``mm =
    dt``)."""
    bf16_operands = _matmul_bf16(matmul_dtype)
    if q.dtype == torch.bfloat16:
        if matmul_dtype is not None and not bf16_operands:
            raise NotImplementedError(f"bf16 inputs with matmul_dtype={matmul_dtype!r}: the kernels round bf16 "
                                      "inputs' products in bf16 (matmul_dtype None or bfloat16)")
        return HALF
    return MATMUL_BF16 if bf16_operands else EXACT


def _kernel_operands(q, k, v, eb, src, dst, edge_mask, num_heads: int, cluster: bool, interpret: bool,
                     mode: int, cotangent=None):
    """The checks of a launch and its operands: contiguous 16-byte aligned
    floats, all float32 or all bfloat16, int32 ids and a byte mask on q's
    device. ``cluster``: the launch of row 13, whose blocks hold two edge
    lists and each pair's values for every head in shared memory; else one
    of the others, whose blocks hold one edge list (and, in a bf16 ``mode``,
    the forward's each pair's score for every head)."""
    if interpret:
        raise ValueError(
            "interpret=True asks for the Pallas interpreter; the port has no interpret mode: "
            "CUDA tensors launch the kernels, CPU tensors take the plain versions"
        )
    lib = _lib()
    B, V, d = q.shape
    E, dh = src.shape[1], d // num_heads
    if dh % 4 != 0 or dh > lib.dense_attention_max_dh():
        raise ValueError(
            f"the attention kernels read head rows in 16-byte vectors: dh must be a multiple of 4 "
            f"up to {lib.dense_attention_max_dh()}, got dh={dh} (hidden {d}, {num_heads} heads)"
        )
    if V > lib.dense_attention_max_v():
        raise ValueError(f"the attention kernels key a bin's pairs by row * V + other in an int32: V must be "
                         f"at most {lib.dense_attention_max_v()}, got V={V} node slots")
    limit = lib.dense_attention_max_smem()
    need = (lib.dense_attention_cluster_smem_bytes(V, E, num_heads, dh) if cluster
            else lib.dense_attention_list_smem_bytes(E, num_heads, mode))
    if need > limit:
        shape = (f"E={E} edge lanes at H={num_heads} heads (V={V} node slots, dh={dh})" if cluster
                 else f"E={E} edge lanes" + ("" if mode == EXACT else f" at H={num_heads} heads"))
        raise ValueError(f"bins of {shape} need {need} bytes of shared memory per block; the attention "
                         f"kernels have {limit}")
    floats = [x.contiguous() for x in (q, k, v, cotangent, eb) if x is not None]
    if q.dtype not in (torch.float32, torch.bfloat16) or any(x.dtype != q.dtype for x in floats):
        raise TypeError(f"the attention kernels take float32 or bfloat16, all alike, got "
                        f"{[str(x.dtype) for x in floats]}")
    check_aligned(**{f"operand{i}": x for i, x in enumerate(floats)})
    mask = _live(edge_mask).contiguous()
    check_tensors({"src": (src, torch.int32, (B, E)), "dst": (dst, torch.int32, (B, E)),
                   "edge_mask": (mask, torch.bool, (B, E))}, q.device, anchor="q")
    if any(x.device != q.device for x in floats):
        raise ValueError(f"every float operand must lie on q's device {q.device}")
    return lib, floats, mask


def _raise_on(err: int, what: str, lib) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.dense_attention_error_string(err).decode()}")


def _forward(q, k, v, eb, src, dst, edge_mask, num_heads: int, v1: bool, interpret: bool, what: str,
             mode: int = EXACT):
    """Row 10's launch (``v1``) or row 12's, in ``mode``."""
    lib, floats, mask = _kernel_operands(q, k, v, eb, src, dst, edge_mask, num_heads, False, interpret, mode)
    q, k, v = floats[:3]
    eb = floats[3] if eb is not None else None
    B, V, d = q.shape
    out = torch.empty_like(q)
    launch = lib.dense_attention_v1_fwd_f32 if v1 else lib.dense_attention_fwd_f32
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if eb is None else eb.data_ptr(),
            src.data_ptr(), dst.data_ptr(), mask.data_ptr(), out.data_ptr(),
            B, V, src.shape[1], num_heads, d // num_heads, 1.0 / math.sqrt(d // num_heads), mode,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, what, lib)
    return out


def _backward(q, k, v, eb, src, dst, edge_mask, cotangent, num_heads: int, v1: bool, interpret: bool,
              what: str, mode: int = EXACT):
    """Row 11's two launches (``v1``) or row 13's one on clusters, in
    ``mode``."""
    lib, floats, mask = _kernel_operands(q, k, v, eb, src, dst, edge_mask, num_heads, not v1, interpret, mode,
                                         cotangent)
    q, k, v, g = floats[:4]
    eb = floats[4] if eb is not None else None
    B, V, d = q.shape
    E = src.shape[1]
    g_q, g_k, g_v = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    g_eb = (torch.zeros if eb is None else torch.empty)(B, num_heads, E, dtype=q.dtype, device=q.device)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), None if eb is None else eb.data_ptr(),
            src.data_ptr(), dst.data_ptr(), mask.data_ptr(), g.data_ptr(),
            g_q.data_ptr(), g_k.data_ptr(), g_v.data_ptr(), g_eb.data_ptr()]
    if v1:  # each pair's score and g_alpha, each row's softmax: from the query pass to the key pass
        scratch = torch.empty(B * num_heads * (2 * E + 3 * V), dtype=torch.float32, device=q.device)
        ptrs.append(scratch.data_ptr())
    launch = lib.dense_attention_v1_bwd_f32 if v1 else lib.dense_attention_bwd_f32
    with torch.cuda.device(q.device):
        err = launch(*ptrs, B, V, E, num_heads, d // num_heads, 1.0 / math.sqrt(d // num_heads), mode,
                     torch.cuda.current_stream().cuda_stream)
    _raise_on(err, what, lib)
    return g_q, g_k, g_v, g_eb


def _count(wrapper, mode: int) -> None:
    """One launch of ``wrapper`` in its count of ``mode``: ``launches``
    (exact f32), ``launches_mm`` (``matmul_dtype="bfloat16"`` on f32
    inputs) or ``launches_bf16`` (bf16 inputs)."""
    name = {EXACT: "launches", MATMUL_BF16: "launches_mm", HALF: "launches_bf16"}[mode]
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def fused_dense_attention_fwd(q, k, v, eb, src, dst, edge_mask, *, num_heads: int, bins_per_tile: int = 8,
                              interpret: bool = False, matmul_dtype: str | None = None) -> torch.Tensor:
    """Attention core forward, ``[B, V, d]`` (row 10): on the card a lane
    group per (query row, head), every bin and head at once;
    ``bins_per_tile`` is kept for the signature. CPU tensors take
    :func:`dense_attention_reference`."""
    mode = _mode(q, matmul_dtype)
    _check(q, k, v, eb, src, dst, edge_mask, num_heads)
    if not on_card(q):
        return dense_attention_reference(q, k, v, eb, src, dst, edge_mask, num_heads, matmul_dtype)
    out = _forward(q, k, v, eb, src, dst, edge_mask, num_heads, True, interpret, "fused_dense_attention_fwd",
                   mode)
    _count(fused_dense_attention_fwd, mode)
    return out


def fused_dense_attention_bwd(q, k, v, eb, src, dst, edge_mask, cotangent, *, num_heads: int,
                              bins_per_tile: int = 8, interpret: bool = False,
                              matmul_dtype: str | None = None):
    """Recompute backward (row 11): ``(g_q, g_k, g_v, g_eb)``. On the card
    two launches: a query pass, a lane group per (query row, head), then a
    key pass, a lane group per (key row, head); ``bins_per_tile`` is kept
    for the signature. CPU tensors take
    :func:`dense_attention_bwd_reference`."""
    mode = _mode(q, matmul_dtype)
    _check(q, k, v, eb, src, dst, edge_mask, num_heads, cotangent)
    if not on_card(q):
        return dense_attention_bwd_reference(q, k, v, eb, src, dst, edge_mask, cotangent, num_heads, matmul_dtype)
    grads = _backward(q, k, v, eb, src, dst, edge_mask, cotangent, num_heads, True, interpret,
                      "fused_dense_attention_bwd", mode)
    _count(fused_dense_attention_bwd, mode)
    return grads


def fused_dense_attention_fwd_v2(q, k, v, eb, src, dst, edge_mask, *, num_heads: int, bins_per_tile: int = 8,
                                 interpret: bool = False, matmul_dtype: str | None = None) -> torch.Tensor:
    """Row 10's function with the head in the TPU's grid (row 12): on the
    card row 10's kernel, a lane group per (query row, head), every bin and
    head at once, with row 10's bits; ``bins_per_tile`` is kept for the
    signature. CPU tensors take :func:`dense_attention_reference`."""
    mode = _mode(q, matmul_dtype)
    _check(q, k, v, eb, src, dst, edge_mask, num_heads)
    if not on_card(q):
        return dense_attention_reference(q, k, v, eb, src, dst, edge_mask, num_heads, matmul_dtype)
    out = _forward(q, k, v, eb, src, dst, edge_mask, num_heads, False, interpret,
                   "fused_dense_attention_fwd_v2", mode)
    _count(fused_dense_attention_fwd_v2, mode)
    return out


def fused_dense_attention_bwd_v2(q, k, v, eb, src, dst, edge_mask, cotangent, *, num_heads: int,
                                 bins_per_tile: int = 8, interpret: bool = False,
                                 matmul_dtype: str | None = None):
    """Row 11's function with the head in the TPU's grid (row 13), the
    backward of every :class:`FusedDenseAttentionFn`: on the card one launch,
    a thread-block cluster per bin whose blocks meet at a cluster barrier
    between the query pass and the key pass. CPU tensors take
    :func:`dense_attention_bwd_reference`."""
    mode = _mode(q, matmul_dtype)
    _check(q, k, v, eb, src, dst, edge_mask, num_heads, cotangent)
    if not on_card(q):
        return dense_attention_bwd_reference(q, k, v, eb, src, dst, edge_mask, cotangent, num_heads, matmul_dtype)
    grads = _backward(q, k, v, eb, src, dst, edge_mask, cotangent, num_heads, False, interpret,
                      "fused_dense_attention_bwd_v2", mode)
    _count(fused_dense_attention_bwd_v2, mode)
    return grads


FWD_IMPLS = ("jnp", "pallas")


class FusedDenseAttentionFn(torch.autograd.Function):
    """The attention core as an autograd node, the counterpart of the JAX
    custom VJP: the forward follows ``fwd_impl`` (``"jnp"``:
    :func:`attention_core` in plain tensor ops, as the JAX package leaves it
    to XLA; ``"pallas"``: :func:`fused_dense_attention_fwd_v2`), the
    backward is always :func:`fused_dense_attention_bwd_v2`. ``src``,
    ``dst`` and ``edge_mask`` get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, eb, src, dst, edge_mask, num_heads: int, bins_per_tile: int = 8,
                interpret: bool = False, matmul_dtype: str | None = None, fwd_impl: str = "jnp"):
        if fwd_impl not in FWD_IMPLS:
            raise ValueError(f"fwd_impl must be one of {FWD_IMPLS}, got {fwd_impl!r}")
        _mode(q, matmul_dtype)
        ctx.save_for_backward(q, k, v, eb, src, dst, edge_mask)
        ctx.opts = dict(num_heads=num_heads, bins_per_tile=bins_per_tile, interpret=interpret,
                        matmul_dtype=matmul_dtype)
        if fwd_impl == "pallas":
            return fused_dense_attention_fwd_v2(q, k, v, eb, src, dst, edge_mask, **ctx.opts)
        _check(q, k, v, eb, src, dst, edge_mask, num_heads)
        return attention_core(q, k, v, eb, src, dst, edge_mask, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, eb, src, dst, edge_mask = ctx.saved_tensors
        g_q, g_k, g_v, g_eb = fused_dense_attention_bwd_v2(q, k, v, eb, src, dst, edge_mask, g.contiguous(),
                                                           **ctx.opts)
        return (g_q, g_k, g_v, g_eb if eb is not None else None) + (None,) * 8


def fused_dense_attention(q, k, v, eb, src, dst, edge_mask, num_heads: int, bins_per_tile: int = 8,
                          interpret: bool = False, matmul_dtype: str | None = None,
                          fwd_impl: str = "jnp") -> torch.Tensor:
    """Trainable attention core, with the JAX function's positional
    signature: :class:`FusedDenseAttentionFn` applied."""
    return FusedDenseAttentionFn.apply(q, k, v, eb, src, dst, edge_mask, num_heads, bins_per_tile,
                                       interpret, matmul_dtype, fwd_impl)


for _wrapper in (fused_dense_attention_fwd, fused_dense_attention_bwd, fused_dense_attention_fwd_v2,
                 fused_dense_attention_bwd_v2):
    _wrapper.launches = _wrapper.launches_mm = _wrapper.launches_bf16 = 0
