"""Static-shape radius-graph neighbour search in plain tensor ops.

Port of ``notorch_tpu.nn.spatial.neighbors.radius_neighbors``, with no
``torch_cluster``: masked pairwise distances and the nearest ``K`` per node
under a fixed degree budget, so every shape is static. The result is a
padded neighbour list ``[N, K]`` and its validity mask. Padding points sit
at coordinates 1e9, so they fall outside every radius of a real point.

The nearest ``K`` are taken by a stable ascending sort of the masked squared
distances, which keeps equal distances in ascending index order: the order
``lax.top_k`` gives the JAX package (``torch.topk`` leaves ties unordered),
so the indices agree bit for bit.
"""

from __future__ import annotations

import torch


def _squared(diff: torch.Tensor) -> torch.Tensor:
    return (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]


def _nearest(masked: torch.Tensor, max_neighbors: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Values and positions of the ``K`` smallest entries of each row, ties
    towards the lower position (inf-padded where a row has fewer than K)."""
    if masked.shape[1] < max_neighbors:
        pad = masked.new_full((masked.shape[0], max_neighbors - masked.shape[1]), float("inf"))
        masked = torch.cat([masked, pad], dim=1)
    vals, pos = torch.sort(masked, dim=1, stable=True)
    return vals[:, :max_neighbors], pos[:, :max_neighbors]


def radius_neighbors(
    coords: torch.Tensor,  # [N, 3]
    batch_index: torch.Tensor,  # [N] i32
    radius: float,
    max_neighbors: int,
    loop: bool = False,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(neighbors [N, K] int32, mask [N, K] bool, dists [N, K])``.

    Neighbour slots beyond the true degree are masked and point at 0; if
    more than K points fall inside the radius, the nearest K are kept.
    ``window=W`` is the banded search: each cloud's atoms are contiguous,
    so with every cloud at most ``W + 1`` atoms the candidates of a node
    are the ``2W + 1`` positions around it, and the work is O(N (2W + 1))
    instead of O(N^2) with the same result."""
    N = coords.shape[0]
    inf = torch.tensor(float("inf"), dtype=coords.dtype, device=coords.device)
    if window is not None and 2 * window + 1 < N:
        W = int(window)
        offs = torch.arange(-W, W + 1, device=coords.device)
        cand = torch.arange(N, device=coords.device)[:, None] + offs[None, :]  # [N, 2W+1]
        cand_safe = cand.clamp(0, N - 1)
        far = coords.new_full((W, 3), 1e9)
        cpad = torch.cat([far, coords, far])
        sentinel = batch_index.new_full((W,), -1)
        bpad = torch.cat([sentinel, batch_index, sentinel])
        cwin = torch.stack([cpad[k: k + N] for k in range(2 * W + 1)], dim=1)
        bwin = torch.stack([bpad[k: k + N] for k in range(2 * W + 1)], dim=1)
        d2 = _squared(coords[:, None, :] - cwin)
        ok = (batch_index[:, None] == bwin) & (d2 <= radius**2)
        if not loop:
            ok = ok & (offs != 0)[None, :]
        d2_k, pos = _nearest(torch.where(ok, d2, inf), max_neighbors)
        mask = torch.isfinite(d2_k)
        idx = torch.gather(cand_safe, 1, pos.clamp(max=2 * W))
    else:
        d2 = _squared(coords[:, None, :] - coords[None, :, :])
        ok = (batch_index[:, None] == batch_index[None, :]) & (d2 <= radius**2)
        if not loop:
            ok = ok & ~torch.eye(N, dtype=torch.bool, device=coords.device)
        d2_k, idx = _nearest(torch.where(ok, d2, inf), max_neighbors)
        mask = torch.isfinite(d2_k)
    idx = torch.where(mask, idx, 0)
    dists = torch.sqrt(torch.where(mask, d2_k, 0.0))
    return idx.to(torch.int32), mask, dists
