"""Core layers (counterpart of snsde/nn/layers.py).

`Linear` is `torch.nn.Linear`, which stores its weight as [out, in]; the JAX
package stores [in, out] (`snsde/nn/layers.py:43`) and `snsde_torch.convert`
transposes between the two. Both initialise weight and bias from
U(-1/sqrt(fan_in), 1/sqrt(fan_in)); here the draw comes from an explicit
`torch.Generator`.

`BatchNorm` is `torch.nn.BatchNorm1d` (momentum 0.1, eps 1e-5): it keeps
the unbiased variance in its running statistics and normalises with the
biased batch variance, the semantics of `snsde/nn/layers.py:148-171`.
Inside a data-parallel row shard (`parallel/data_parallel.py`) it takes
its training-mode statistics over the rows of every rank, as the JAX
package's sharded jit does; `dropout` then draws the global batch's mask
and keeps this rank's rows.

The recurrent cells (`snsde/nn/layers.py:186-290`) keep the JAX parameter
names and layout, `w_ih` [in, kH], `w_hh` [H, kH], `b_ih`, `b_hh` [kH],
with the gates in torch's order, so weights carry across with no
transpose: `GRUCell` (r, z, n), `LSTMCell` (i, f, g, o) and the tanh
Elman `RNNCell`. Each draws every parameter from U(-1/sqrt(H), 1/sqrt(H)).

`lipswish` (0.909 silu), the activation table `ACTIVATIONS` under the JAX
package's names, and the tutorial `MLP` (`snsde/nn/layers.py:67-116`):
its Linears are a `ModuleList` named `layers`, so `layers.0.weight` is the
JAX leaf `layers.0.weight`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..parallel.data_parallel import active_shard, draw_rows, global_batch_norm

__all__ = ["Linear", "BatchNorm", "Dropout", "dropout", "make_linear", "RNNCell",
           "GRUCell", "LSTMCell", "lipswish", "ACTIVATIONS", "MLP"]

Linear = nn.Linear


class BatchNorm(nn.BatchNorm1d):
    """torch.nn.BatchNorm1d, whose training-mode statistics are those of
    the global batch inside a data-parallel row shard."""

    def forward(self, x):
        shard = active_shard()
        if shard is None or not self.training:
            return super().forward(x)
        return global_batch_norm(x, self, shard)


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


def lipswish(x):
    """0.909 * silu(x): the Lipschitz-constrained swish of the tutorial
    fields."""
    return 0.909 * torch.nn.functional.silu(x)


ACTIVATIONS = {
    "relu": torch.relu,
    "lipswish": lipswish,
    "tanh": torch.tanh,
    "silu": torch.nn.functional.silu,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "identity": lambda x: x,
}


class MLP(nn.Module):
    """in -> hidden -> ... -> out: Linear, act, [Linear, act] x
    (num_layers - 1), Linear, then tanh when final_tanh (the tutorial MLP).
    The Linears are drawn from `generator` in order."""

    def __init__(self, in_size: int, out_size: int, hidden_dim: int,
                 num_layers: int, activation: str = "lipswish",
                 final_tanh: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        widths = [in_size] + [hidden_dim] * num_layers + [out_size]
        self.layers = nn.ModuleList(
            make_linear(i, o, generator=generator, device=device)
            for i, o in zip(widths[:-1], widths[1:]))
        self.activation = activation
        self.final_tanh = final_tanh

    def forward(self, x):
        act = ACTIVATIONS[self.activation]
        for layer in self.layers[:-1]:
            x = act(layer(x))
        x = self.layers[-1](x)
        return torch.tanh(x) if self.final_tanh else x


def dropout(x, rate: float, generator: Optional[torch.Generator],
            training: bool):
    """Inverted dropout of x with its mask from `generator`: the identity
    unless training, at rate 0, or without a generator."""
    if not training or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = draw_rows(lambda shape: torch.rand(shape, generator=generator,
                                              device=x.device), x.shape) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Dropout(nn.Module):
    """Inverted dropout drawn from an explicit generator (torch's
    `nn.Dropout` draws from the global RNG). Identity in eval mode, at
    rate 0, or without a generator — as the JAX `Dropout` is without a
    key."""

    def __init__(self, rate: float = 0.1):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return dropout(x, self.rate, generator, self.training)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


class _Cell(nn.Module):
    """w_ih [in, G*H], w_hh [H, G*H], b_ih, b_hh [G*H], each ~ U(-k, k)
    with k = 1/sqrt(H), drawn from `generator` in that order."""

    gates = 1

    def __init__(self, input_size: int, hidden_size: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        k = 1.0 / math.sqrt(hidden_size)
        G = self.gates * hidden_size
        shapes = {"w_ih": (input_size, G), "w_hh": (hidden_size, G),
                  "b_ih": (G,), "b_hh": (G,)}
        for name, shape in shapes.items():
            p = torch.empty(shape, device=device)
            with torch.no_grad():
                nn.init.uniform_(p, -k, k, generator=generator)
            setattr(self, name, nn.Parameter(p))

    @property
    def hidden_size(self) -> int:
        return self.w_hh.shape[0]


class RNNCell(_Cell):
    """Tanh Elman cell, torch nn.RNN's parameterisation:
    h' = tanh(x w_ih + b_ih + h w_hh + b_hh)."""

    def forward(self, x, h):
        return torch.tanh(x @ self.w_ih + self.b_ih + h @ self.w_hh
                          + self.b_hh)


class GRUCell(_Cell):
    """GRU cell with torch's gate order (r, z, n)."""

    gates = 3

    def forward(self, x, h):
        H = self.hidden_size
        gi = x @ self.w_ih + self.b_ih
        gh = h @ self.w_hh + self.b_hh
        r = torch.sigmoid(gi[..., :H] + gh[..., :H])
        z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
        n = torch.tanh(gi[..., 2 * H:] + r * gh[..., 2 * H:])
        return (1 - z) * n + z * h


class LSTMCell(_Cell):
    """LSTM cell with torch's gate order (i, f, g, o); state = (h, c),
    returns (h', (h', c'))."""

    gates = 4

    def forward(self, x, state):
        h, c = state
        H = self.hidden_size
        g = x @ self.w_ih + self.b_ih + h @ self.w_hh + self.b_hh
        i = torch.sigmoid(g[..., :H])
        f = torch.sigmoid(g[..., H:2 * H])
        gg = torch.tanh(g[..., 2 * H:3 * H])
        o = torch.sigmoid(g[..., 3 * H:])
        c = f * c + i * gg
        h = o * torch.tanh(c)
        return h, (h, c)
