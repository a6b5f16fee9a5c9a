"""Small functional ops.

Port of ``notorch_tpu.nn.functional``: the multilinear inner product (MIP),
the elementwise product over a set of tensors summed over the feature axis.
"""

from __future__ import annotations

import torch


def multilinear_inner_product(*tensors: torch.Tensor, axis: int = -1) -> torch.Tensor:
    out = tensors[0]
    for t in tensors[1:]:
        out = out * t
    return out.sum(dim=axis)


MIP = multilinear_inner_product
