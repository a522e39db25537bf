"""Core layers (counterpart of snsde/nn/layers.py).

`Linear` is `torch.nn.Linear`, which stores its weight as [out, in]; the JAX
package stores [in, out] (`snsde/nn/layers.py:43`) and `snsde_torch.convert`
transposes between the two. Both initialise weight and bias from
U(-1/sqrt(fan_in), 1/sqrt(fan_in)); here the draw comes from an explicit
`torch.Generator`.

`BatchNorm` is `torch.nn.BatchNorm1d` (momentum 0.1, eps 1e-5): it keeps
the unbiased variance in its running statistics and normalises with the
biased batch variance, the semantics of `snsde/nn/layers.py:148-171`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

__all__ = ["Linear", "BatchNorm", "Dropout", "make_linear"]

Linear = nn.Linear
BatchNorm = nn.BatchNorm1d


def make_linear(in_features: int, out_features: int, *,
                generator: Optional[torch.Generator] = None,
                device=None, bias: bool = True) -> nn.Linear:
    """`nn.Linear` drawn from `generator`: weight and bias ~ U(-k, k),
    k = 1/sqrt(fan_in) (the torch default init, as in the JAX package)."""
    lin = nn.Linear(in_features, out_features, bias=bias, device=device)
    k = 1.0 / math.sqrt(max(in_features, 1))
    with torch.no_grad():
        nn.init.uniform_(lin.weight, -k, k, generator=generator)
        if bias:
            nn.init.uniform_(lin.bias, -k, k, generator=generator)
    return lin


class Dropout(nn.Module):
    """Inverted dropout drawn from an explicit generator (torch's
    `nn.Dropout` draws from the global RNG). Identity in eval mode, at
    rate 0, or without a generator — as the JAX `Dropout` is without a
    key."""

    def __init__(self, rate: float = 0.1):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.rate == 0.0 or generator is None:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
