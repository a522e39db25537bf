"""Neural Flows (counterpart of snsde/models/flows.py): invertible
time-indexed transformations and the NeuralFlow, NeuralFlowCDE,
NeuralMixture and NeuralControlledFlow wrappers over input_option
{n, x, y, z} × flow_option {n, r, g, c}.

Each flow layer is the identity at t = 0 through a bias-free time net
TimeTanh, φ(t) = tanh(W t), φ(0) = 0:
  * coupling:  x_b <- x_b * exp(s(x_a, t) φ(t)) + u(x_a, t) φ(t), the
    mask alternating with the layer's index;
  * resnet:    x <- x + φ(t) tanh(net([x, t]));
  * gru flow:  x <- x + φ(t) z (u - x), the reset gate scaled by 0.8 and
    the update gate by 0.4.
NeuralFlow runs no solver. NeuralFlowCDE re-fits Hermite coefficients on
the flowed stream and solves a CDE over it, NeuralMixture mixes a flow
branch with a CDE over the raw control, and NeuralControlledFlow flows the
CDE's output stream; each CDE through `cde_solve_dispatch` (the fused CDE
kernels on a CUDA device). As in the JAX package, NeuralControlledFlow
ignores input_option and never calls its `initial_flow` (its x, y and z
names differ in their initial draws alone; the unused weights get zero
gradients), and NeuralFlowCDE's x and n options cut [t ‖ x] to
initial_flow's input width.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.layers import make_linear
from ..ops.interp import CubicPath, hermite_cubic_coeffs
from .ancde import path_on_knots
from .neuralcde import cde_solve_dispatch
from .neuralsde import resolve_dt

__all__ = ["TimeTanh", "CouplingFlowLayer", "ResNetFlowLayer",
           "GRUFlowBlock", "NeuralFlow", "NeuralFlowCDE", "NeuralMixture",
           "NeuralControlledFlow"]


class TimeTanh(nn.Module):
    """φ(t) = tanh(lin(t)), lin bias-free: φ(0) = 0."""

    def __init__(self, out_dim: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.lin = make_linear(1, out_dim, bias=False, generator=generator,
                               device=device)

    def forward(self, t):
        return torch.tanh(self.lin(t))


class CouplingFlowLayer(nn.Module):
    def __init__(self, dim: int, hidden: int, parity: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.net1 = make_linear(dim + 1, hidden, **kw)
        self.net2 = make_linear(hidden, 2 * dim, **kw)
        self.time_net = TimeTanh(2 * dim, **kw)
        self.parity = parity

    def forward(self, x, t):
        D = x.shape[-1]
        idx = torch.arange(D, device=x.device)
        mask = ((idx % 2) == self.parity).to(x.dtype)
        if D == 1:
            mask = torch.zeros_like(mask)   # 'none' mask: transform all
        xa = x * mask
        h = torch.relu(self.net1(torch.cat([xa, t], dim=-1)))
        su = self.net2(h) * self.time_net(t)
        s, u = su[..., :D], su[..., D:]
        xb = x * torch.exp(s * (1 - mask)) + u * (1 - mask)
        return xa + xb * (1 - mask)


class ResNetFlowLayer(nn.Module):
    def __init__(self, dim: int, hidden: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.net1 = make_linear(dim + 1, hidden, **kw)
        self.net2 = make_linear(hidden, dim, **kw)
        self.time_net = TimeTanh(dim, **kw)

    def forward(self, x, t):
        h = torch.relu(self.net1(torch.cat([x, t], dim=-1)))
        return x + self.time_net(t) * torch.tanh(self.net2(h))


class GRUFlowBlock(nn.Module):
    def __init__(self, dim: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.lin_hh = make_linear(dim + 1, dim, **kw)
        self.lin_hz = make_linear(dim + 1, dim, **kw)
        self.lin_hr = make_linear(dim + 1, dim, **kw)
        self.time_net = TimeTanh(dim, **kw)

    def forward(self, h, t):
        inp = torch.cat([h, t], dim=-1)
        r = 0.8 * torch.sigmoid(self.lin_hr(inp))
        z = 0.4 * torch.sigmoid(self.lin_hz(inp))
        u = torch.tanh(self.lin_hh(torch.cat([r * h, t], dim=-1)))
        return h + self.time_net(t) * (z * (u - h))


def _make_flow(kind: str, dim: int, hidden: int, n_layers: int, **kw):
    if kind == "c":
        return nn.ModuleList(CouplingFlowLayer(dim, hidden, i % 2, **kw)
                             for i in range(n_layers))
    if kind == "r":
        return nn.ModuleList(ResNetFlowLayer(dim, hidden, **kw)
                             for _ in range(n_layers))
    if kind == "g":
        return nn.ModuleList(GRUFlowBlock(dim, **kw)
                             for _ in range(n_layers))
    raise ValueError(kind)


def _apply_flow(layers, x, t):
    for layer in layers:
        x = layer(x, t)
    return x


def _linears(widths, **kw):
    return nn.ModuleList(make_linear(i, o, **kw) for i, o in widths)


class _FlowBase(nn.Module):
    """The JAX `_FlowBase` leaves: initial_flow, initial_control, emb (None
    for NeuralControlledFlow), flow_layers, mlp_layers, head."""

    def __init__(self, input_option: str, flow_option: str):
        super().__init__()
        self.input_option, self.flow_option = input_option, flow_option


class NeuralFlow(_FlowBase):
    """Pointwise flow over the stream, no solver: embed [t, x] and the
    control's values, mix them by input_option, push through the flow
    network, read out. forward(x [B,L,D], seq_ts [B,L], seq_mask, coeffs
    over [t ‖ x], times) -> (head(z), z)."""

    def __init__(self, input_channels: int, hidden_channels: int,
                 num_hidden_layers: int, output_channels: int,
                 input_option: str = "z", flow_option: str = "c", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(input_option, flow_option)
        kw = dict(generator=generator, device=device)
        H = hidden_channels
        self.initial_flow = make_linear(input_channels, H, **kw)
        self.initial_control = make_linear(input_channels, H, **kw)
        self.emb = make_linear(2 * H, H, **kw)
        self.flow_layers = (
            _make_flow(flow_option, H, H, 1, **kw) if flow_option in "rgc"
            else _linears([(H, H)] * max(num_hidden_layers, 1), **kw))
        self.mlp_layers = _linears([(H, H)] * (num_hidden_layers - 1), **kw)
        self.head = make_linear(H, output_channels, **kw)

    def forward(self, x, seq_ts, seq_mask, coeffs, times, **kw):
        tcol = seq_ts[..., None]
        z_flow = self.initial_flow(torch.cat([tcol, x], dim=-1))
        z_x = self.initial_control(path_on_knots(CubicPath(coeffs, times)))
        io = self.input_option
        if io in ("n", "x"):
            z = z_flow
        elif io == "y":
            z = z_x
        else:
            z = self.emb(torch.cat([z_flow, z_x], dim=-1))
        if self.flow_option == "n":
            z = torch.relu(z)
            for lin in self.flow_layers:
                z = torch.relu(lin(z))
        else:
            z = _apply_flow(self.flow_layers, z, tcol)
        z = torch.relu(z)
        for lin in self.mlp_layers:
            z = torch.relu(lin(z))
        return self.head(z), z


class NeuralFlowCDE(_FlowBase):
    """Flow-transform the input stream, re-fit Hermite coefficients on it
    (differentiably), then solve a CDE over it."""

    def __init__(self, func, input_channels: int, hidden_channels: int,
                 num_hidden_layers: int, output_channels: int,
                 input_option: str = "z", flow_option: str = "c",
                 method: str = "rk4", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(input_option, flow_option)
        kw = dict(generator=generator, device=device)
        C, H = input_channels, hidden_channels
        self.func = func
        self.initial_flow = make_linear(C, C, **kw)
        self.initial_control = make_linear(C, H, **kw)
        self.emb = make_linear(2 * C, C, **kw)
        self.flow_layers = (
            _make_flow(flow_option, C, H, 1, **kw) if flow_option in "rgc"
            else _linears([(C, H)] + [(H, H)] * (num_hidden_layers - 1)
                          + [(H, C)], **kw))
        self.mlp_layers = _linears([(H, H)], **kw)
        self.head = make_linear(H, output_channels, **kw)
        self.method = method

    def forward(self, x, seq_ts, seq_mask, coeffs, times, method=None, *,
                use_fused: bool = True, **kw):
        tcol = seq_ts[..., None]
        io = self.input_option
        if io in ("n", "x"):
            z_flow = self.initial_flow(torch.cat([tcol, x], dim=-1)[
                ..., :self.initial_flow.in_features])
        else:
            xx = path_on_knots(CubicPath(coeffs, times))
            if io == "y":
                z_flow = self.initial_flow(xx)
            else:
                cat = torch.cat([tcol, x], dim=-1)
                z_flow = self.initial_flow(self.emb(torch.cat([cat, xx],
                                                              dim=-1)))
        if self.flow_option == "n":
            z = z_flow
            for lin in self.flow_layers[:-1]:
                z = torch.relu(lin(z))
            z_flow = self.flow_layers[-1](z)
        else:
            z_flow = _apply_flow(self.flow_layers, z_flow, tcol)
        # re-fit Hermite coefficients on the transformed stream
        Z = CubicPath(hermite_cubic_coeffs(
            torch.as_tensor(times, device=z_flow.device), z_flow), times)
        z0 = self.initial_control(Z.evaluate(Z.times[0]))
        zs = cde_solve_dispatch(Z, self.func, z0, times,
                                dt=resolve_dt(times, floor=0.0),
                                method=method or self.method,
                                use_fused=use_fused)
        zt = zs.movedim(0, 1)
        h = torch.relu(self.mlp_layers[0](torch.tanh(zt)))
        return self.head(h), zt


class NeuralMixture(_FlowBase):
    """The flow branch and a CDE over the raw control side by side, their
    streams mixed by a Linear."""

    def __init__(self, func, input_channels: int, hidden_channels: int,
                 num_hidden_layers: int, output_channels: int,
                 input_option: str = "z", flow_option: str = "c",
                 method: str = "rk4", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(input_option, flow_option)
        kw = dict(generator=generator, device=device)
        H = hidden_channels
        self.func = func
        self.initial_flow = make_linear(input_channels, H, **kw)
        self.initial_control = make_linear(input_channels, H, **kw)
        self.emb = make_linear(2 * H, H, **kw)
        self.mixture = make_linear(2 * H, H, **kw)
        self.flow_layers = (
            _make_flow(flow_option, H, H, 1, **kw) if flow_option in "rgc"
            else _linears([(H, H)] * max(num_hidden_layers, 1), **kw))
        self.mlp_layers = _linears([(H, H)], **kw)
        self.head = make_linear(H, output_channels, **kw)
        self.method = method

    def forward(self, x, seq_ts, seq_mask, coeffs, times, method=None, *,
                use_fused: bool = True, **kw):
        tcol = seq_ts[..., None]
        path = CubicPath(coeffs, times)
        z_flow = self.initial_flow(torch.cat([tcol, x], dim=-1))
        z_x = self.initial_control(path_on_knots(path))
        io = self.input_option
        if io in ("n", "x"):
            z = z_flow
        elif io == "y":
            z = z_x
        else:
            z = self.emb(torch.cat([z_flow, z_x], dim=-1))
        if self.flow_option == "n":
            for lin in self.flow_layers:
                z = torch.relu(lin(z))
        else:
            z = _apply_flow(self.flow_layers, z, tcol)
        z0 = self.initial_control(path.evaluate(path.times[0]))
        zs = cde_solve_dispatch(path, self.func, z0, times,
                                dt=resolve_dt(times, floor=0.0),
                                method=method or self.method,
                                use_fused=use_fused)
        mixed = self.mixture(torch.cat([z, zs.movedim(0, 1)], dim=-1))
        h = torch.relu(self.mlp_layers[0](torch.tanh(mixed)))
        return self.head(h), mixed


class NeuralControlledFlow(_FlowBase):
    """A CDE over the raw control path, the flow applied to its output
    stream (input_option and initial_flow unused, as in JAX)."""

    def __init__(self, func, input_channels: int, hidden_channels: int,
                 num_hidden_layers: int, output_channels: int,
                 input_option: str = "z", flow_option: str = "c",
                 method: str = "rk4", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(input_option, flow_option)
        kw = dict(generator=generator, device=device)
        H = hidden_channels
        self.func = func
        self.initial_flow = make_linear(input_channels, H, **kw)
        self.initial_control = make_linear(input_channels, H, **kw)
        self.flow_layers = (
            _make_flow(flow_option, H, H, 1, **kw) if flow_option in "rgc"
            else _linears([(H, H)] * max(num_hidden_layers, 1), **kw))
        self.mlp_layers = _linears([(H, H)], **kw)
        self.head = make_linear(H, output_channels, **kw)
        self.method = method

    def forward(self, x, seq_ts, seq_mask, coeffs, times, method=None, *,
                use_fused: bool = True, **kw):
        path = CubicPath(coeffs, times)
        z0 = self.initial_control(path.evaluate(path.times[0]))
        zs = cde_solve_dispatch(path, self.func, z0, times,
                                dt=resolve_dt(times, floor=0.0),
                                method=method or self.method,
                                use_fused=use_fused)
        z = zs.movedim(0, 1)
        tcol = path.times[None, :, None].expand(z.shape[0], -1, 1)
        if self.flow_option == "n":
            for lin in self.flow_layers:
                z = torch.relu(lin(z))
        else:
            z = _apply_flow(self.flow_layers, z, tcol)
        h = torch.relu(self.mlp_layers[0](torch.tanh(z)))
        return self.head(h), z
