"""Mixture-of-Experts with dense and noisy-top-k sparse routing.

Port of ``notorch_tpu.nn.moe``:

- :class:`DenseRouter`: softmax routing and the importance CV^2 auxiliary
  loss;
- :class:`SparseRouter`: noisy top-k routing (Shazeer et al. 2017) with the
  Normal-CDF load-balancing loss over :func:`kth_excluding`. Its training
  noise is drawn from the module's own ``torch.Generator`` (seeded from the
  parameter generator in ``reset_parameters``, its state kept in the
  model's training state) on the CPU and copied to the device, so a run on
  the card and a run on the CPU from one seed see the same noise. The JAX
  package draws it from the ``dropout`` RNG stream, so the two packages
  agree only where the same noise is given to both (:meth:`SparseRouter.
  draw_noise`). In eval mode there is no noise;
- :class:`MixtureOfExperts`: the experts' parameters stacked on a leading
  expert axis, as ``nn.vmap`` stacks them (``experts.<path> [n, ...]``,
  each expert's own layout below it), run as one batched call of the
  expert through ``torch.func.vmap`` over ``functional_call``: one batched
  product a layer. An expert with dropout runs expert by expert in
  training, so that each draws its own masks (a batched call would give
  every expert one mask), and its dropouts sit in the module tree
  (``expert_dropouts``), so that the training state carries their streams.
  Under expert parallelism (:func:`~notorch_tpu_torch.parallel.expert.
  shard_expert_params`) a rank keeps a contiguous slice of the experts,
  computes those alone and sums the router-weighted combine over the
  ``expert`` group (a ``psum``, whose backward sums the cotangent). Its
  trainer takes the routers' importance and load over the global batch
  (:func:`batch_total`), as the JAX package's GSPMD step does.

The routers' widths are given (``input_dim``), where flax infers them.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn
from torch.func import functional_call, vmap

from notorch_tpu_torch.nn.dropout import Dropout
from notorch_tpu_torch.nn.init import dense, reset_dense_
from notorch_tpu_torch.parallel.collectives import batch_stats_axis, psum

__all__ = ["cv_squared", "batch_total", "kth_excluding", "keep_top_k", "DenseRouter", "SparseRouter", "router",
           "MixtureOfExperts", "MoEMLP"]


def cv_squared(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Squared coefficient of variation over every element (the population
    variance, as ``jnp.var``)."""
    if x.shape[-1] <= 1:
        return x.new_zeros(())
    return x.var(correction=0) / (x.mean() ** 2 + eps)


def batch_total(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a router's per-expert sum over its tokens) summed over the data
    ranks where a trainer takes its statistics over the global batch
    (:func:`~notorch_tpu_torch.parallel.collectives.batch_stats_axis`), as
    the JAX package's GSPMD step sums it over the whole batch; else ``x``."""
    axis = batch_stats_axis()
    return x if axis is None else psum(x, axis)


def kth_excluding(H: torch.Tensor, k: int) -> torch.Tensor:
    """For each entry ``H[i, j]``: the k-th largest value of row i when
    column j is excluded."""
    n = H.shape[-1]
    top = torch.topk(H, min(k + 1, n), dim=-1).values
    kth = top[..., k - 1 : k]
    kplus = top[..., min(k, n - 1) : min(k, n - 1) + 1]
    # an entry among the top k moves the k-th to the (k+1)-th when removed
    return torch.where(H >= kth, kplus, kth)


def keep_top_k(x: torch.Tensor, k: int, fill: float = -math.inf) -> torch.Tensor:
    """Mask all but the k largest entries of the trailing axis: every entry
    ``>=`` the k-th largest value stays, so a tie at the k-th keeps them all."""
    thresh = torch.topk(x, k, dim=-1).values[..., -1:]
    return torch.where(x >= thresh, x, fill)


class DenseRouter(nn.Module):
    """Softmax over all experts and the importance CV^2 aux loss."""

    def __init__(self, input_dim: int, num_experts: int):
        super().__init__()
        self.W_g = dense(input_dim, num_experts, bias=False)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        reset_dense_(self.W_g, generator)

    def forward(self, x: torch.Tensor):
        weights = torch.softmax(self.W_g(x), dim=-1)
        return weights, cv_squared(batch_total(weights.sum(dim=0)))


class SparseRouter(nn.Module):
    """Noisy top-k router; see the module docstring for its noise."""

    def __init__(self, input_dim: int, num_experts: int, k: int = 2):
        super().__init__()
        self.k = k
        self.W_g = dense(input_dim, num_experts, bias=False)
        self.W_noise = dense(input_dim, num_experts, bias=False)
        self.generator = torch.Generator()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        reset_dense_(self.W_g, generator)
        reset_dense_(self.W_noise, generator)
        self.generator.manual_seed(int(torch.randint(0, 2**62, (), generator=generator)))

    def draw_noise(self, like: torch.Tensor) -> torch.Tensor:
        """Standard normal noise of ``like``'s shape, drawn on the CPU from
        the module's generator and copied to ``like``'s device."""
        eps = torch.randn(like.shape, generator=self.generator, dtype=like.dtype)
        return eps.to(like.device)

    def forward(self, x: torch.Tensor):
        clean = self.W_g(x)
        noise_scale = nn.functional.softplus(self.W_noise(x)) + 1e-2
        noisy = clean + noise_scale * self.draw_noise(clean) if self.training else clean
        weights = torch.softmax(keep_top_k(noisy, self.k), dim=-1)
        # load-balancing loss: P(expert e in top k) through the Normal CDF
        kth = kth_excluding(noisy, self.k)
        normal_cdf = 0.5 * (1 + torch.erf((clean - kth) / (noise_scale * math.sqrt(2.0))))
        aux = cv_squared(batch_total(weights.sum(dim=0))) + cv_squared(batch_total(normal_cdf.sum(dim=0)))
        return weights, aux


def router(kind: str, input_dim: int, num_experts: int, k: int = 2) -> nn.Module:
    if kind == "dense":
        return DenseRouter(input_dim, num_experts)
    if kind == "sparse":
        return SparseRouter(input_dim, num_experts, k)
    raise ValueError(f"unknown router {kind!r}; expected 'dense' or 'sparse'")


class MixtureOfExperts(nn.Module):
    """Weighted sum of expert outputs: ``(output, aux_loss)``.

    ``expert_fn`` builds one expert module (with ``reset_parameters``); the
    ``num_experts`` experts' parameters are stacked on a leading axis under
    ``experts`` and the router sits under ``dense_router`` or
    ``sparse_router`` (the JAX module's ``DenseRouter_0``/``SparseRouter_0``).
    """

    def __init__(self, expert_fn: Callable[[], nn.Module], input_dim: int, num_experts: int = 4,
                 router_kind: str = "dense", k: int = 2):
        super().__init__()
        self.num_experts = num_experts
        self.router_name = f"{router_kind}_router"
        self.add_module(self.router_name, router(router_kind, input_dim, num_experts, k))
        # the expert whose forward every expert runs with its own parameters;
        # kept out of the module tree, so it holds no parameters of the model
        self._expert = [expert_fn()]
        self.expert_dropouts = nn.ModuleList(
            m for m in self._expert[0].modules() if isinstance(m, Dropout) and m.generator is not None)
        self.experts = nn.Module()
        for name, p in self._expert[0].named_parameters():
            *path, leaf = name.split(".")
            owner = self.experts
            for part in path:
                if not hasattr(owner, part):
                    owner.add_module(part, nn.Module())
                owner = getattr(owner, part)
            owner.register_parameter(leaf, nn.Parameter(p.detach().new_empty((num_experts, *p.shape))))
        # expert parallelism: the mesh axis the expert stacks are split over
        # and this rank's experts [start, stop) (all of them unsharded)
        self.expert_axis: str | None = None
        self.expert_range = (0, num_experts)

    @property
    def router(self) -> nn.Module:
        return getattr(self, self.router_name)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.router.reset_parameters(generator)
        expert = self._expert[0]
        stacked = dict(self.experts.named_parameters())
        with torch.no_grad():
            for i in range(self.num_experts):
                expert.reset_parameters(generator)
                for name, p in expert.named_parameters():
                    stacked[name][i].copy_(p)

    def forward(self, x: torch.Tensor):
        weights, aux = self.router(x)
        expert = self._expert[0].train(self.training)
        params = dict(self.experts.named_parameters())
        start, stop = self.expert_range
        if self.training and len(self.expert_dropouts):
            outs = torch.stack([functional_call(expert, {k: v[i] for k, v in params.items()}, (x,))
                                for i in range(stop - start)])
        else:
            outs = vmap(lambda p: functional_call(expert, p, (x,)))(params)  # [n, N, d]
        out = torch.einsum("ne,end->nd", weights[:, start:stop], outs)
        if self.expert_axis is not None:
            out = psum(out, self.expert_axis)
        return out, aux


def MoEMLP(
    input_dim: int,
    output_size: int,
    hidden_dim: int = 256,
    num_layers: int = 1,
    dropout: float = 0.0,
    num_experts: int = 4,
    router_kind: str = "dense",
    k: int = 2,
) -> MixtureOfExperts:
    """A mixture of expert MLPs, by name from a config. Returns ``(output,
    aux_loss)``: wire ``out_keys: [preds, aux]`` and feed the aux key to a
    ``SelfSupervisedLoss`` term."""
    from notorch_tpu_torch.nn.mlp import MLP

    return MixtureOfExperts(
        expert_fn=lambda: MLP(input_dim=input_dim, output_size=output_size, hidden_dim=hidden_dim,
                              num_layers=num_layers, dropout=dropout),
        input_dim=input_dim,
        num_experts=num_experts,
        router_kind=router_kind,
        k=k,
    )
