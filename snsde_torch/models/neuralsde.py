"""NeuralSDE models (counterpart of snsde/models/neuralsde.py:44-172,
217-256): the terminal-readout head for classification and the forecasting
head. The stream and tutorial heads are not ported yet.

Train/eval mode is torch's (`model.train()` / `model.eval()`): BatchNorm
uses batch statistics and dropout is live only in train mode. The solve is
taken on the full grid and each sample's state is gathered at its final
index, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..kernels.fused_em import fused_em_solve, supports_fused
from ..kernels.fused_srk import fused_srk_solve, supports_fused_srk
from ..nn.layers import BatchNorm, Dropout, make_linear
from ..ops.brownian import BrownianGrid
from ..ops.interp import CubicPath
from ..ops.solve import sdeint

__all__ = ["resolve_dt", "solve_dispatch", "ReadoutHead", "NeuralSDE",
           "NeuralSDEForecasting"]


def resolve_dt(times, floor: float = 1e-3) -> float:
    """torchsde-compatible default step: max(min Δt, 1e-3)."""
    if isinstance(times, torch.Tensor):
        times = times.detach().cpu().numpy()
    t = np.asarray(times, dtype=np.float64)
    return float(max(np.min(t[1:] - t[:-1]), floor))


def solve_dispatch(func, path, times, y0, *, generator, dt, method,
                   bm: Optional[BrownianGrid] = None,
                   use_fused: bool = True):
    """The fused CUDA kernels when y0 is on a CUDA device, no Brownian grid
    is injected and the field's configuration is one the kernels take: the
    EM kernels for euler (`supports_fused`), the SRK kernels for srk
    (`supports_fused_srk`). The eager `sdeint` on the same device in every
    other case."""
    if use_fused and bm is None and y0.device.type == "cuda":
        if method == "euler" and supports_fused(func):
            return fused_em_solve(func, path, times, y0, generator=generator,
                                  dt=dt)
        if method == "srk" and supports_fused_srk(func):
            return fused_srk_solve(func, path, times, y0,
                                   generator=generator, dt=dt)
    return sdeint(func.f, func.g, y0, times, generator=generator, bm=bm,
                  dt=dt, method=method)


class ReadoutHead(nn.Module):
    """Linear -> BatchNorm -> ReLU -> Dropout(0.1) -> Linear."""

    def __init__(self, hidden_channels: int, output_channels: int,
                 dropout: float = 0.1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.linear1 = make_linear(hidden_channels, hidden_channels,
                                   generator=generator, device=device)
        self.norm = BatchNorm(hidden_channels, device=device)
        self.dropout = Dropout(dropout)
        self.linear2 = make_linear(hidden_channels, output_channels,
                                   generator=generator, device=device)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = torch.relu(self.norm(self.linear1(x)))
        return self.linear2(self.dropout(h, generator=generator))


class NeuralSDE(nn.Module):
    """Terminal-readout NeuralSDE for classification.

    forward(times [L], coeffs [B, L-1, 4C], final_index [B]) -> logits
    [B, out]."""

    def __init__(self, func, input_channels: int, hidden_channels: int,
                 output_channels: int, initial: bool = True,
                 method: str = "euler", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.func = func
        self.initial_network = make_linear(input_channels, hidden_channels,
                                           generator=generator,
                                           device=device)
        self.readout = ReadoutHead(hidden_channels, output_channels,
                                   generator=generator, device=device)
        self.initial = initial
        self.method = method

    def solve(self, times, coeffs, *, generator=None, z0=None, dt=None,
              method=None, bm=None, use_fused: bool = True):
        """Bind the control path, build z0, integrate over the full grid.
        Returns zs [L, B, H]."""
        path = CubicPath(coeffs, times)
        func = self.func.bind(path)
        if z0 is None:
            if not self.initial:
                raise ValueError("expected an explicit z0 (initial=False)")
            z0 = self.initial_network(path.evaluate(path.times[0]))
        dt = resolve_dt(times) if dt is None else dt
        return solve_dispatch(func, path, times, z0, generator=generator,
                              dt=dt, method=method or self.method, bm=bm,
                              use_fused=use_fused)

    def forward(self, times, coeffs, final_index, *, generator=None,
                z0=None, dt=None, method=None, bm=None,
                use_fused: bool = True):
        zs = self.solve(times, coeffs, generator=generator, z0=z0, dt=dt,
                        method=method, bm=bm, use_fused=use_fused)
        idx = torch.as_tensor(final_index, device=zs.device).long()
        z = zs[idx, torch.arange(zs.shape[1], device=zs.device)]   # [B, H]
        return self.readout(z, generator=generator)


class NeuralSDEForecasting(nn.Module):
    """Forecasting head: solve on the full grid, keep the last
    `output_time` states, then Linear -> ReLU -> Linear.

    forward(times [L], coeffs [B, L-1, 4C]) -> [B, output_time, out]."""

    def __init__(self, func, input_channels: int, hidden_channels: int,
                 output_channels: int, output_time: int = 10,
                 method: str = "euler", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        lin = lambda i, o: make_linear(i, o, generator=generator,
                                       device=device)
        self.func = func
        self.initial_network = lin(input_channels, hidden_channels)
        self.linear1 = lin(hidden_channels, hidden_channels)
        self.linear2 = lin(hidden_channels, output_channels)
        self.output_time = output_time
        self.method = method

    def forward(self, times, coeffs, *, generator=None, dt=None, method=None,
                bm=None, use_fused: bool = True):
        path = CubicPath(coeffs, times)
        func = self.func.bind(path)
        y0 = self.initial_network(path.evaluate(path.times[0]))
        dt = resolve_dt(times) if dt is None else dt
        zs = solve_dispatch(func, path, times, y0, generator=generator,
                            dt=dt, method=method or self.method, bm=bm,
                            use_fused=use_fused)
        z = zs.movedim(0, 1)[:, -self.output_time:, :]       # [B, T, H]
        return self.linear2(torch.relu(self.linear1(z)))
