"""The fused GVP message convolution: hand-written Hopper kernels for its
forward and recompute backward, their plain PyTorch versions, the wrappers
that pick between them by device, and the ``autograd.Function`` that trains
through them.

Replaces the Pallas kernels of ``notorch_tpu/kernels/gvp_conv.py``:

==========================  ==================================================
TPU entry (kernel)          here
==========================  ==================================================
``fused_gvp_conv_fwd``      :func:`fused_gvp_conv_fwd`: the prologue and the
(``_fwd_kernel``)           forward kernel of ``csrc/gvp_conv.cu``
``fused_gvp_conv_bwd``      :func:`fused_gvp_conv_bwd`: the recompute and
(``_bwd_kernel``)           reverse sweep layer by layer over all rows (the
                            prologue, the ``sweep_`` kernels and tiled f32
                            products), the gather's VJP (``node_grad_``) and
                            the fixed-order weight gradients (``wgrad_``) of
                            ``csrc/gvp_conv.cu``
``fused_gvp_conv``          :class:`FusedGvpConvFn` (and :func:`fused_gvp_conv`)
(the custom VJP)
==========================  ==================================================

What they compute, for ``N`` nodes with ``K`` neighbour slots each (row
``r = n * K + k`` is slot ``k`` of node ``n``, ``j = nbrs[n, k]``): the
message inputs are the node's own features ``s_i = s[n]``, ``v_i = v[n]``,
the neighbour's ``s_j = s[j]``, ``v_j = v[j]``, the row's RBF features
``rbf2d[r]`` and unit vector ``u[r]``. Three GatedGVP layers on the 25
split weights of :func:`split_gvp_weights` (the concatenations of the GVP
inputs replaced by sums of products with weight slices), the last with a
raw gate, then the masked mean over the K slots, the divisor
``max(sum(mask), 1)``. Vectors ride as three component arrays
``vx, vy, vz [N, dv]`` and ``ux, uy, uz [N * K, 1]``, as in the JAX
package.

The neighbour gather reads ``x[j]`` on a live slot (``mask`` true) whose
``j`` lies within ``window`` rows of its node, and zero on any other slot:
what the TPU kernel's one-hot over its tile's +-``window`` halo reads for
the banded neighbour lists of ``radius_neighbors(window=...)``, without
depending on a tile. A masked slot adds nothing to any output or gradient.

Tensors on the CPU take the plain versions; tensors on a CUDA device launch
the kernels or raise, with no fallback. Each wrapper counts its launches in
``<wrapper>.launches`` (one per call, whatever number of CUDA kernels the
call runs). The wrappers make ``_prep``'s refusals (a ``window`` that is
not a multiple of 8, a node count that no tile of at least 8 divides);
``tile`` is accepted for the JAX signature and the refusals, and the card's
grid is its own, so no result depends on it. ``interpret=True`` on CUDA
tensors raises: the port has no interpret mode.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from notorch_tpu_torch.kernels import build
from notorch_tpu_torch.kernels.checks import check_tensors, on_card

__all__ = [
    "EPS",
    "N_W",
    "FusedGvpConvFn",
    "fused_gvp_conv",
    "fused_gvp_conv_bwd",
    "fused_gvp_conv_fwd",
    "gvp_conv_bwd_reference",
    "gvp_conv_preactivations",
    "gvp_conv_reference",
    "merge_gvp_weight_grads",
    "split_gvp_weights",
    "weight_shapes",
]

EPS = 1e-8
# layer-0 weights (split): Wh_i, Wh_j, wh_u, Wmu, Wm_si, Wm_sj, Wm_rbf,
# Wm_nrm, bm, Wg, bg (11); layers 1-2: Wh, Wmu, Wm_s, Wm_nrm, bm, Wg, bg (7)
N_W0 = 11
N_W12 = 7
N_W = N_W0 + 2 * N_W12  # 25


def weight_shapes(ds: int, dv: int, nb: int) -> list[tuple[int, ...]]:
    """The shapes of the 25 split weights, in :func:`split_gvp_weights`'
    order (``h0 = 2 dv + 1``, the first layer's hidden vector width)."""
    h0 = max(2 * dv + 1, dv)
    layer = [(dv, dv), (dv, dv), (ds, ds), (dv, ds), (ds,), (ds, dv), (dv,)]
    return ([(dv, h0), (dv, h0), (1, h0), (h0, dv), (ds, ds), (ds, ds), (nb, ds), (h0, ds), (ds,), (ds, dv),
             (dv,)] + layer + layer)


def split_gvp_weights(params, ds: int, dv: int, nb: int) -> tuple[torch.Tensor, ...]:
    """GvpConv ``message_i`` parameter tree (``{"W_h": {"kernel"}, "W_mu":
    {"kernel"}, "W_m": {"kernel", "bias"}, "W_g": {"kernel", "bias"}}``,
    kernels ``[in, out]`` as in flax) -> the kernels' 25 tensors (slices,
    so gradients flow back to the tree's tensors)."""
    p0 = params["message_0"]
    Wh0, Wm0 = p0["W_h"]["kernel"], p0["W_m"]["kernel"]  # [2dv+1, h0], [2ds+nb+h0, ds]
    out = [Wh0[:dv], Wh0[dv: 2 * dv], Wh0[2 * dv:], p0["W_mu"]["kernel"],
           Wm0[:ds], Wm0[ds: 2 * ds], Wm0[2 * ds: 2 * ds + nb], Wm0[2 * ds + nb:], p0["W_m"]["bias"],
           p0["W_g"]["kernel"], p0["W_g"]["bias"]]
    for li in (1, 2):
        p = params[f"message_{li}"]
        Wm = p["W_m"]["kernel"]  # [ds + dv, ds]
        out += [p["W_h"]["kernel"], p["W_mu"]["kernel"], Wm[:ds], Wm[ds:], p["W_m"]["bias"],
                p["W_g"]["kernel"], p["W_g"]["bias"]]
    return tuple(out)


def merge_gvp_weight_grads(grads) -> dict:
    """Inverse of :func:`split_gvp_weights` for gradients: 25 tensors ->
    the GvpConv parameter-tree structure."""
    g = list(grads)
    Whi, Whj, whu, gWmu, gWsi, gWsj, gWrbf, gWnrm, gbm, gWg, gbg = g[:N_W0]
    tree = {"message_0": {
        "W_h": {"kernel": torch.cat([Whi, Whj, whu], dim=0)},
        "W_mu": {"kernel": gWmu},
        "W_m": {"kernel": torch.cat([gWsi, gWsj, gWrbf, gWnrm], dim=0), "bias": gbm},
        "W_g": {"kernel": gWg, "bias": gbg},
    }}
    for li in (1, 2):
        Wh, Wmu, Ws, Wnrm, bm, Wg, bg = g[N_W0 + (li - 1) * N_W12: N_W0 + li * N_W12]
        tree[f"message_{li}"] = {
            "W_h": {"kernel": Wh},
            "W_mu": {"kernel": Wmu},
            "W_m": {"kernel": torch.cat([Ws, Wnrm], dim=0), "bias": bm},
            "W_g": {"kernel": Wg, "bias": bg},
        }
    return tree


# -- plain versions ------------------------------------------------------------------


def _norm3(vh) -> torch.Tensor:
    return torch.sqrt(vh[0] ** 2 + vh[1] ** 2 + vh[2] ** 2 + EPS)


def _layer(s_terms, vh, w, act_gate: bool):
    """One split-weight GatedGVP layer: ``s_terms`` the (x, W) pairs of the
    scalar path but the norm's, ``vh`` the three hidden vector components;
    ``w = (Wmu, Wnrm, bm, Wg, bg)``. Returns the scalar and vector outputs
    and the ReLU's pre-activation."""
    Wmu, Wnrm, bm, Wg, bg = w
    nrm = _norm3(vh)
    mid = bm + nrm @ Wnrm
    for x, Wx in s_terms:
        mid = mid + x @ Wx
    gate = bg + mid @ Wg
    if act_gate:
        gate = torch.sigmoid(gate)
    return torch.relu(mid), tuple((c @ Wmu) * gate for c in vh), mid


def _message_inputs(s, v, nbrs, mask, window: int):
    """``(s_i, s_j, v_i, v_j)`` as ``[N * K, .]`` rows; the gather reads
    zero where the slot is masked or its neighbour lies beyond ``window``
    rows of the node."""
    N, K = nbrs.shape
    rows = torch.arange(N, device=nbrs.device)[:, None]
    live = (mask != 0) & ((nbrs.long() - rows).abs() <= window)
    idx = torch.where(live, nbrs.long(), 0).reshape(-1)
    keep = live.reshape(-1, 1).to(s.dtype)

    def own(x):
        return x[:, None, :].expand(N, K, x.shape[-1]).reshape(N * K, x.shape[-1])

    return own(s), s[idx] * keep, tuple(own(c) for c in v), tuple(c[idx] * keep for c in v)


def _stack(s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, wlist, window: int):
    """The three message layers on ``[N * K, .]`` rows: ``(s2, v2, mids)``,
    ``mids`` the layers' ReLU pre-activations."""
    w = tuple(wlist)
    Whi, Whj, whu, Wmu0, Wsi, Wsj, Wrbf, Wnrm0, bm0, Wg0, bg0 = w[:N_W0]
    w1, w2 = w[N_W0: N_W0 + N_W12], w[N_W0 + N_W12:]
    s_i, s_j, v_i, v_j = _message_inputs(s, (vx, vy, vz), nbrs, mask, window)
    u = (ux, uy, uz)
    vh = tuple(v_i[c] @ Whi + v_j[c] @ Whj + u[c] @ whu for c in range(3))
    s0, v0, m0 = _layer([(s_i, Wsi), (s_j, Wsj), (rbf2d, Wrbf)], vh, (Wmu0, Wnrm0, bm0, Wg0, bg0), True)
    s1, v1, m1 = _layer([(s0, w1[2])], tuple(c @ w1[0] for c in v0), (w1[1], w1[3], w1[4], w1[5], w1[6]), True)
    s2, v2, m2 = _layer([(s1, w2[2])], tuple(c @ w2[0] for c in v1), (w2[1], w2[3], w2[4], w2[5], w2[6]), False)
    return s2, v2, (m0, m1, m2)


def gvp_conv_preactivations(s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, wlist, window: int):
    """The three layers' ReLU pre-activations ``[N * K, ds]`` of the plain
    forward. The gradient jumps where one of them crosses zero, so two
    computations that round differently may take different sides there and
    give gradients that differ by a whole term; a comparison of gradients
    reads these to know which slots lie within rounding of a kink."""
    return _stack(s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, wlist, window)[2]


def gvp_conv_reference(s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, wlist, window: int):
    """Plain PyTorch version of the forward (row 14): ``(agg_s [N, ds],
    agg_vx, agg_vy, agg_vz [N, dv])``."""
    N, K = nbrs.shape
    s2, v2, _ = _stack(s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, wlist, window)
    m = (mask != 0).to(s.dtype)[:, :, None]
    denom = torch.clamp_min(m.sum(1), 1.0)

    def mean(x):
        return (x.reshape(N, K, x.shape[-1]) * m).sum(1) / denom

    return (mean(s2),) + tuple(mean(c) for c in v2)


def gvp_conv_bwd_reference(s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, wlist, g_s, g_vx, g_vy, g_vz,
                           window: int):
    """Plain PyTorch version of the recompute backward (row 15): the
    forward recomputed and differentiated, ``(g_s, g_vx, g_vy, g_vz,
    g_rbf2d, g_ux, g_uy, g_uz, g_wlist)``."""
    leaves = [x.detach().requires_grad_() for x in (s, vx, vy, vz, rbf2d, ux, uy, uz, *wlist)]
    with torch.enable_grad():
        s_, vx_, vy_, vz_, rbf_, ux_, uy_, uz_ = leaves[:8]
        out = gvp_conv_reference(s_, vx_, vy_, vz_, nbrs, mask, rbf_, ux_, uy_, uz_, leaves[8:], window)
        grads = torch.autograd.grad(out, leaves, (g_s, g_vx, g_vy, g_vz), allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
    return tuple(grads[:8]) + (tuple(grads[8:]),)


# -- the kernels -----------------------------------------------------------------------


def _prep(s, nbrs, window: int, tile: int) -> tuple[int, int, int, int]:
    """The JAX entry's refusals (``gvp_conv.py`` ``_prep``): the halo must
    be a multiple of 8 and some tile of at least 8 must divide the node
    count."""
    N, K = nbrs.shape
    W = int(window)
    if W % 8 != 0:
        raise ValueError(f"window must be a multiple of 8 (got {W})")
    T = int(tile)
    while T > 0 and N % T != 0:
        T //= 2
    if T < 8:
        raise ValueError(f"node count {N} not tileable (tile fell to {T})")
    return N, K, W, T


def _check(s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, wlist, cotangents=()) -> tuple[int, int, int, int, int]:
    if s.dim() != 2 or nbrs.dim() != 2 or nbrs.shape[0] != s.shape[0]:
        raise ValueError(f"s must be [N, ds] and nbrs [N, K], got {tuple(s.shape)} and {tuple(nbrs.shape)}")
    (N, ds), K = s.shape, nbrs.shape[1]
    dv, nb = vx.shape[-1], rbf2d.shape[-1]
    shapes = {"vx": (vx, (N, dv)), "vy": (vy, (N, dv)), "vz": (vz, (N, dv)), "mask": (mask, (N, K)),
              "rbf2d": (rbf2d, (N * K, nb)), "ux": (ux, (N * K, 1)), "uy": (uy, (N * K, 1)),
              "uz": (uz, (N * K, 1))}
    for name, x in zip(("g_s", "g_vx", "g_vy", "g_vz"), cotangents):
        shapes[name] = (x, (N, ds) if name == "g_s" else (N, dv))
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if len(wlist) != N_W:
        raise ValueError(f"wlist must hold the {N_W} split weights, got {len(wlist)}")
    for i, (w, shape) in enumerate(zip(wlist, weight_shapes(ds, dv, nb))):
        if tuple(w.shape) != shape:
            raise ValueError(f"split weight {i} must have shape {shape}, got {tuple(w.shape)}")
    return N, K, ds, dv, nb


_PTRS = ctypes.POINTER(ctypes.c_void_p)


@functools.cache
def _lib():
    lib = build.load("gvp_conv")
    dims = [ctypes.c_int] * 6
    lib.gvp_conv_fwd_f32.argtypes = [ctypes.c_void_p] * 6 + [_PTRS] + [ctypes.c_void_p] * 3 + dims + [
        ctypes.c_void_p]
    lib.gvp_conv_bwd_f32.argtypes = ([ctypes.c_void_p] * 6 + [_PTRS] + [ctypes.c_void_p] * 6 + [_PTRS]
                                     + [ctypes.c_void_p] + dims + [ctypes.c_void_p])
    for name in ("gvp_conv_fwd_scratch_floats", "gvp_conv_bwd_scratch_floats"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 5
        getattr(lib, name).restype = ctypes.c_longlong
    lib.gvp_conv_supported.argtypes = [ctypes.c_int] * 5
    lib.gvp_conv_error_string.argtypes = [ctypes.c_int]
    lib.gvp_conv_error_string.restype = ctypes.c_char_p
    for name in ("gvp_conv_fwd_f32", "gvp_conv_bwd_f32", "gvp_conv_supported"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _operands(s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, wlist, interpret: bool):
    """The checks of a launch and its operands on s's device: float32
    contiguous floats (the vector components packed ``[3, N, dv]``, the
    unit vectors ``[3, N * K]``), int32 ids and a byte mask."""
    if interpret:
        raise ValueError(
            "interpret=True asks for the Pallas interpreter; the port has no interpret mode: "
            "CUDA tensors launch the kernels, CPU tensors take the plain versions"
        )
    lib = _lib()
    N, K = nbrs.shape
    ds, dv, nb = s.shape[1], vx.shape[1], rbf2d.shape[1]
    if lib.gvp_conv_supported(N, K, ds, dv, nb) != 0:
        raise ValueError(
            f"the GVP kernels cannot take N={N}, K={K}, ds={ds}, dv={dv}, nb={nb}: the K rows of one node "
            "and their activations must fit a block's shared memory"
        )
    floats = [s, vx, vy, vz, rbf2d, ux, uy, uz, *wlist]
    if any(x.dtype != torch.float32 for x in floats):
        raise TypeError(f"the GVP kernels take float32, got {sorted({str(x.dtype) for x in floats})}")
    if any(x.device != s.device for x in floats):
        raise ValueError(f"every float operand must lie on s's device {s.device}")
    check_tensors({"nbrs": (nbrs, torch.int32, (N, K)), "mask": (mask, torch.bool, (N, K))}, s.device,
                  anchor="s")
    v = torch.stack([vx, vy, vz])
    u = torch.stack([ux.reshape(-1), uy.reshape(-1), uz.reshape(-1)])
    weights = [w.contiguous() for w in wlist]
    return lib, s.contiguous(), v, rbf2d.contiguous(), u, weights


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _raise_on(err: int, what: str, lib) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.gvp_conv_error_string(err).decode()}")


def fused_gvp_conv_fwd(s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, wlist, *, window: int, tile: int = 64,
                       interpret: bool = False):
    """Forward (row 14): ``(agg_s, agg_vx, agg_vy, agg_vz)``. CPU tensors
    take :func:`gvp_conv_reference`."""
    N, K, W, _ = _prep(s, nbrs, window, tile)
    _, _, ds, dv, nb = _check(s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, wlist)
    if not on_card(s):
        return gvp_conv_reference(s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, wlist, W)
    lib, s, v, rbf2d, u, weights = _operands(s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, wlist, interpret)
    out_s = torch.empty_like(s)
    out_v = torch.empty_like(v)
    scratch = torch.empty(lib.gvp_conv_fwd_scratch_floats(N, K, ds, dv, nb), dtype=torch.float32,
                          device=s.device)
    ptrs = _pointers(weights)
    with torch.cuda.device(s.device):
        err = lib.gvp_conv_fwd_f32(
            s.data_ptr(), v.data_ptr(), nbrs.data_ptr(), mask.data_ptr(), rbf2d.data_ptr(), u.data_ptr(),
            ctypes.cast(ptrs, _PTRS), out_s.data_ptr(), out_v.data_ptr(), scratch.data_ptr(),
            N, K, ds, dv, nb, W, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "fused_gvp_conv_fwd", lib)
    fused_gvp_conv_fwd.launches += 1
    return out_s, out_v[0], out_v[1], out_v[2]


def fused_gvp_conv_bwd(s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, wlist, g_s, g_vx, g_vy, g_vz, *,
                       window: int, tile: int = 64, interpret: bool = False):
    """Recompute backward (row 15): ``(g_s, g_vx, g_vy, g_vz, g_rbf2d, g_ux,
    g_uy, g_uz, g_wlist)``. CPU tensors take :func:`gvp_conv_bwd_reference`."""
    N, K, W, _ = _prep(s, nbrs, window, tile)
    _, _, ds, dv, nb = _check(s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, wlist, (g_s, g_vx, g_vy, g_vz))
    if not on_card(s):
        return gvp_conv_bwd_reference(s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, wlist, g_s, g_vx, g_vy,
                                      g_vz, W)
    lib, s, v, rbf2d, u, weights = _operands(s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, wlist, interpret)
    cot = [g_s, g_vx, g_vy, g_vz]
    if any(x.dtype != torch.float32 or x.device != s.device for x in cot):
        raise TypeError("the cotangents must be float32 on s's device")
    gs_in = g_s.contiguous()
    gv_in = torch.stack([g_vx, g_vy, g_vz])
    g_s_out, g_v = torch.empty_like(s), torch.empty_like(v)
    g_rbf, g_u = torch.empty_like(rbf2d), torch.empty_like(u)
    g_w = [torch.empty_like(w) for w in weights]
    scratch = torch.empty(lib.gvp_conv_bwd_scratch_floats(N, K, ds, dv, nb), dtype=torch.float32,
                          device=s.device)
    wptrs, gptrs = _pointers(weights), _pointers(g_w)
    with torch.cuda.device(s.device):
        err = lib.gvp_conv_bwd_f32(
            s.data_ptr(), v.data_ptr(), nbrs.data_ptr(), mask.data_ptr(), rbf2d.data_ptr(), u.data_ptr(),
            ctypes.cast(wptrs, _PTRS), gs_in.data_ptr(), gv_in.data_ptr(), g_s_out.data_ptr(), g_v.data_ptr(),
            g_rbf.data_ptr(), g_u.data_ptr(), ctypes.cast(gptrs, _PTRS), scratch.data_ptr(),
            N, K, ds, dv, nb, W, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "fused_gvp_conv_bwd", lib)
    fused_gvp_conv_bwd.launches += 1
    g_u = g_u.reshape(3, N * K, 1)
    return g_s_out, g_v[0], g_v[1], g_v[2], g_rbf, g_u[0], g_u[1], g_u[2], tuple(g_w)


class FusedGvpConvFn(torch.autograd.Function):
    """The fused message convolution as an autograd node, the counterpart
    of the JAX custom VJP: forward :func:`fused_gvp_conv_fwd`, backward
    :func:`fused_gvp_conv_bwd` at the JAX backward's tile
    ``max(tile // 4, 8)``. The backward returns the cotangents of the
    features, ``rbf2d``, the unit vectors and the 25 weights; ``nbrs`` and
    ``mask`` get none."""

    @staticmethod
    def forward(ctx, s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, window: int, tile: int, interpret: bool,
                *wlist):
        ctx.save_for_backward(s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, *wlist)
        ctx.opts = dict(window=window, tile=max(tile // 4, 8), interpret=interpret)
        return fused_gvp_conv_fwd(s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, wlist, window=window, tile=tile,
                                  interpret=interpret)

    @staticmethod
    def backward(ctx, g_s, g_vx, g_vy, g_vz):
        s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, *wlist = ctx.saved_tensors
        gs, gvx, gvy, gvz, g_rbf, g_ux, g_uy, g_uz, g_w = fused_gvp_conv_bwd(
            s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, wlist, g_s.contiguous(), g_vx.contiguous(),
            g_vy.contiguous(), g_vz.contiguous(), **ctx.opts)
        return (gs, gvx, gvy, gvz, None, None, g_rbf, g_ux, g_uy, g_uz, None, None, None, *g_w)


def fused_gvp_conv(s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, wlist, window: int, tile: int = 64,
                   interpret: bool = False):
    """Trainable fused GVP message conv with the JAX function's positional
    signature: :class:`FusedGvpConvFn` applied."""
    return FusedGvpConvFn.apply(s, vx, vy, vz, nbrs, mask, rbf2d, ux, uy, uz, window, tile, interpret, *wlist)


fused_gvp_conv_fwd.launches = 0
fused_gvp_conv_bwd.launches = 0
