"""Neural CDE family (counterpart of snsde/models/neuralcde.py:77-316): the
FinalTanh, SingleHiddenLayer and GRU-ODE vector fields, the terminal and
stream wrappers, and the solver dispatch.

dz = f(z) dX(t) with a matrix-valued field f(z) in R^{H x C}. On a CUDA
device, FinalTanh, SingleHiddenLayer and the GRU-ODE field solve through
the fused CDE kernels on every explicit tableau (`kernels/fused_cde.py`);
every CPU tensor takes the eager `cdeint`. The JAX package's gates
(`_fused_cde_pays`: a width limit and exact-f32 kernels on euler only;
the GRU-ODE field's `SNSDE_FUSED_GRUODE` opt-in) were measured on a TPU
and do not carry over: the kernels compute in exact float32 for every
field.

Controls: the cubic family ('cubic', 'hermite', 'natural') evaluates
through `CubicPath`; the linear and rectilinear controls are not ported
yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..kernels.fused_cde import fused_cde_solve, supports_fused_cde
from ..nn.layers import make_linear
from ..ops.interp import CubicPath
from ..ops.solve import cdeint
from .neuralsde import ReadoutHead, resolve_dt

__all__ = ["FinalTanh", "SingleHiddenLayer", "GRUODEField", "NeuralCDE",
           "NeuralCDEStream", "cde_solve_dispatch"]


def cde_solve_dispatch(path, func, z0, ts, *, dt, method,
                       use_fused: bool = True):
    """The fused CDE kernels when z0 is on a CUDA device and the (field,
    method) is one they take (`supports_fused_cde`); the eager `cdeint` on
    the same device in every other case. Returns zs [T, B, H]."""
    if (use_fused and z0.device.type == "cuda"
            and supports_fused_cde(func, method)):
        return fused_cde_solve(func, path, ts, z0, dt=dt, method=method)
    return cdeint(path, func, z0, ts, dt=dt, method=method)


class FinalTanh(nn.Module):
    """z -> relu MLP -> tanh -> [H, C] (the canonical NCDE field):
    num_hidden_layers - 1 inner layers."""

    def __init__(self, input_channels: int, hidden_channels: int,
                 hidden_hidden_channels: int, num_hidden_layers: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        lin = lambda i, o: make_linear(i, o, generator=generator,
                                       device=device)
        self.input_channels = input_channels
        self.hidden_channels = hidden_channels
        self.linear_in = lin(hidden_channels, hidden_hidden_channels)
        self.linears = nn.ModuleList(
            lin(hidden_hidden_channels, hidden_hidden_channels)
            for _ in range(num_hidden_layers - 1))
        self.linear_out = lin(hidden_hidden_channels,
                              input_channels * hidden_channels)

    def forward(self, t, z):
        h = torch.relu(self.linear_in(z))
        for lin in self.linears:
            h = torch.relu(lin(h))
        out = torch.tanh(self.linear_out(h))
        return out.reshape(z.shape[:-1] + (self.hidden_channels,
                                           self.input_channels))

    def fused_weights(self):
        """(activation, input layer, inner layers, output layer): the field
        as the fused CDE kernels take it."""
        return "relu", self.linear_in, tuple(self.linears), self.linear_out


class SingleHiddenLayer(nn.Module):
    """z -> tanh(linear1) -> tanh(linear2) -> [H, C]."""

    def __init__(self, input_channels: int, hidden_channels: int,
                 hidden_hidden_channels: int, num_hidden_layers: int = 1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.input_channels = input_channels
        self.hidden_channels = hidden_channels
        self.linear1 = make_linear(hidden_channels, hidden_hidden_channels,
                                   generator=generator, device=device)
        self.linear2 = make_linear(hidden_hidden_channels,
                                   input_channels * hidden_channels,
                                   generator=generator, device=device)

    def forward(self, t, z):
        h = torch.tanh(self.linear1(z))
        out = torch.tanh(self.linear2(h))
        return out.reshape(z.shape[:-1] + (self.hidden_channels,
                                           self.input_channels))

    def fused_weights(self):
        """As FinalTanh.fused_weights: tanh, no inner layer."""
        return "tanh", self.linear1, (), self.linear2


class GRUODEField(nn.Module):
    """GRU-ODE field: continuous GRU gating producing the [H, C] update
    matrix (1 - u) (tanh(r W_h z) - z)."""

    def __init__(self, input_channels: int, hidden_channels: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        lin = lambda: make_linear(hidden_channels,
                                  input_channels * hidden_channels,
                                  generator=generator, device=device)
        self.input_channels = input_channels
        self.hidden_channels = hidden_channels
        self.W_r, self.W_z, self.W_h = lin(), lin(), lin()

    def forward(self, t, z):
        shape = z.shape[:-1] + (self.hidden_channels, self.input_channels)
        r = torch.sigmoid(self.W_r(z)).reshape(shape)
        u = torch.sigmoid(self.W_z(z)).reshape(shape)
        g = torch.tanh(r * self.W_h(z).reshape(shape))
        return (1.0 - u) * (g - z[..., :, None])

    def fused_weights(self):
        """("gruode", (W_r, W_z, W_h)): the field as the fused CDE kernels
        take it, three [H] -> [H*C] gates with h-major outputs."""
        return "gruode", (self.W_r, self.W_z, self.W_h)


def _build_path(coeffs, times, control: str):
    if control in ("cubic", "hermite", "natural"):
        return CubicPath(coeffs, times)
    if control == "linear":
        raise NotImplementedError(
            "the linear control (LinearPath) is not ported yet (ROADMAP "
            "Queue 1 items 3 and 17)")
    raise ValueError(f"unknown control type {control!r}")


class NeuralCDE(nn.Module):
    """Terminal-readout Neural CDE (the classification twin of NeuralSDE).

    forward(times [L], coeffs [B, L-1, 4C], final_index [B]) -> logits
    [B, out]; stream=True reads out every step: [B, L, out]."""

    def __init__(self, func, input_channels: int, hidden_channels: int,
                 output_channels: int, initial: bool = True,
                 method: str = "rk4", control: str = "cubic", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.func = func
        self.initial_network = make_linear(input_channels, hidden_channels,
                                           generator=generator,
                                           device=device)
        self.readout = ReadoutHead(hidden_channels, output_channels,
                                   generator=generator, device=device)
        self.initial, self.method, self.control = initial, method, control

    def forward(self, times, coeffs, final_index=None, *, generator=None,
                z0=None, stream: bool = False, dt=None, method=None,
                use_fused: bool = True):
        path = _build_path(coeffs, times, self.control)
        if z0 is None:
            if not self.initial:
                raise ValueError("expected z0 (initial=False)")
            z0 = self.initial_network(path.evaluate(path.times[0]))
        dt = resolve_dt(times, floor=0.0) if dt is None else dt
        zs = cde_solve_dispatch(path, self.func, z0, times, dt=dt,
                                method=method or self.method,
                                use_fused=use_fused)          # [L, B, H]
        if stream:
            # the readout's BatchNorm normalises the last axis over every
            # (row, step), as the JAX BatchNorm does
            z = zs.movedim(0, -2)                              # [B, L, H]
            out = self.readout(z.reshape(-1, z.shape[-1]), generator=generator)
            return out.reshape(z.shape[:-1] + out.shape[-1:])
        idx = torch.as_tensor(final_index, device=zs.device).long()
        z = zs[idx, torch.arange(zs.shape[1], device=zs.device)]
        return self.readout(z, generator=generator)


class NeuralCDEStream(nn.Module):
    """Stream variant: the whole trajectory and a per-step linear readout.

    forward(times [L], coeffs [B, L-1, 4C]) -> (out [B, L, out], z
    [B, L, H])."""

    def __init__(self, func, input_channels: int, hidden_channels: int,
                 output_channels: int, initial: bool = True,
                 method: str = "rk4", control: str = "cubic", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.func = func
        self.initial_network = make_linear(input_channels, hidden_channels,
                                           generator=generator,
                                           device=device)
        self.linear = make_linear(hidden_channels, output_channels,
                                  generator=generator, device=device)
        self.initial, self.method, self.control = initial, method, control

    def forward(self, times, coeffs, *, dt=None, method=None,
                use_fused: bool = True):
        path = _build_path(coeffs, times, self.control)
        if self.initial:
            z0 = self.initial_network(path.evaluate(path.times[0]))
        else:
            z0 = torch.zeros((path.a.shape[0], self.linear.in_features),
                             dtype=path.a.dtype, device=path.a.device)
        dt = resolve_dt(times, floor=0.0) if dt is None else dt
        zs = cde_solve_dispatch(path, self.func, z0, times, dt=dt,
                                method=method or self.method,
                                use_fused=use_fused)
        z = zs.movedim(0, 1)
        return self.linear(z), z

