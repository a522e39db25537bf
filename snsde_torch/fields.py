"""Drift/diffusion vector fields (counterpart of snsde/fields.py).

`DiffusionField` realises the whole input_option (0-6) x noise_option
(0-19) grid of the reference `Diffusion_model`, eagerly. Its submodule and
parameter names are the reference's own (`noise_t.0` / `noise_t.2` for the
two-layer noise nets), so the reference's state_dicts — the goldens in
tests/goldens/reference_{fg,em}.npz — load into it directly.

Canonical bindings: staticsde=(1,0) naivesde=(1,18) neuralsde=(3,18)
neurallsde=(2,16) neurallnsde=(4,17) neuralgsde=(6,17).

The tutorial ("pure") formulations of snsde/fields.py:335-504 are here too:
`NeuralSDEFunc`, `NeuralLSDEFunc`, `NeuralLNSDEFunc` and `NeuralGSDEFunc`,
LipSwish MLPs without the grid's tanh clipping. Their parameter names are
the JAX package's (`f_net.layers.0.weight`, ...), so its leaves carry
across through `snsde_torch.convert`. As in JAX, `NeuralSDEFunc`'s
`linear_out` lies on no path.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .nn.layers import MLP, make_linear
from .ops.interp import CubicPath

__all__ = ["DiffusionField", "NeuralSDEFunc", "NeuralLSDEFunc",
           "NeuralLNSDEFunc", "NeuralGSDEFunc", "PROPOSAL_METHOD_CONTRACT",
           "MODEL_NAME_GRID"]

PROPOSAL_METHOD_CONTRACT = {
    "lsde": (2, 16),
    "lnsde": (4, 17),
    "gsde": (6, 17),
}

MODEL_NAME_GRID = {
    "staticsde": (1, 0),
    "naivesde": (1, 18),
    "neuralsde": (3, 18),
    "neurallsde": (2, 16),
    "neurallnsde": (4, 17),
    "neuralgsde": (6, 17),
}


def time_features(t, y):
    """(t column, [sin t, cos t]) broadcast to y's batch dims."""
    tcol = torch.as_tensor(t, dtype=y.dtype, device=y.device)
    tcol = tcol.reshape(-1)[:1].expand(y.shape[:-1] + (1,))
    return tcol, torch.cat([torch.sin(tcol), torch.cos(tcol)], dim=-1)


def time_column(t, y):
    """t as a [..., 1] column of y's dtype: a scalar broadcast to y's batch
    dims, a per-row t kept (a trailing axis of 1 added when missing)."""
    t = torch.as_tensor(t, dtype=y.dtype, device=y.device)
    if t.ndim == 0:
        return t.expand(y.shape[:-1] + (1,))
    return t if t.shape[-1:] == (1,) else t[..., None]


class DiffusionField(nn.Module):
    """f(t,y): X(t) -> initial_network -> drift input (per input_option)
    -> ReLU MLP -> optional geometric z*tanh(y) -> tanh.
    g(t,y): noise family (per noise_option) -> sigmoid(theta) *
    nan_to_num -> tanh. Diagonal noise."""

    def __init__(self, input_channels: int, hidden_channels: int,
                 hidden_hidden_channels: int, num_hidden_layers: int,
                 theta: float = 1.0, sigma: float = 1.0,
                 input_option: int = 0, noise_option: int = 0, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        H, HH = hidden_channels, hidden_hidden_channels
        io, no = input_option, noise_option
        if not (0 <= io <= 6 and 0 <= no <= 19):
            raise ValueError(f"options out of range: ({io}, {no})")
        if io in (2, 4, 6) and HH != H:
            raise ValueError(
                f"input_option {io} requires hidden_channels == "
                f"hidden_hidden_channels (got {H} vs {HH})")
        if io == 0 and HH != H:
            raise ValueError(
                "input_option 0 feeds X_t (hidden_channels wide) straight "
                "into the hidden MLP — hidden_channels must equal "
                "hidden_hidden_channels")
        lin = lambda i, o: make_linear(i, o, generator=generator,
                                       device=device)
        self.input_option = io
        self.noise_option = no
        self.initial_network = lin(input_channels, H)
        self.linear_in = lin(H + 2 if io in (3, 4, 5, 6) else H, HH)
        self.emb = lin(2 * H, H) if io in (2, 4, 6) else None
        self.linears = nn.ModuleList(
            [lin(HH, HH) for _ in range(num_hidden_layers - 1)])
        self.linear_out = lin(HH, H)
        self.theta = nn.Parameter(torch.full((1, 1), float(theta),
                                             device=device))
        self.sigma = (nn.Parameter(torch.full((1,), float(sigma),
                                              device=device))
                      if no in (1, 2, 3) else None)
        self.sigma_diag = (nn.Parameter(torch.full((H,), float(sigma),
                                                   device=device))
                           if no in (4, 5, 6) else None)
        self.noise_t = self.noise_y = None
        if no in (12, 13):
            self.noise_t = lin(2, H)
        if no in (14, 15):
            self.noise_y = lin(H + 2, H)
        if no in (16, 17):
            self.noise_t = nn.Sequential(lin(2, H), nn.ReLU(), lin(H, H))
        if no in (18, 19):
            self.noise_y = nn.Sequential(lin(H + 2, H), nn.ReLU(),
                                         lin(H, H))
        self.path: Optional[CubicPath] = None

    @property
    def hidden_channels(self) -> int:
        return self.linear_out.out_features

    def bind(self, path) -> "DiffusionField":
        """Set the control path (the reference's set_X) and return self."""
        self.path = path
        return self

    def _mlp(self, z):
        z = torch.relu(z)
        for lin in self.linears:
            z = torch.relu(lin(z))
        return self.linear_out(z)

    def f(self, t, y):
        io = self.input_option
        Xt = self.initial_network(self.path.evaluate(t))
        if io in (3, 4, 5, 6):
            _, tf = time_features(t, y)
            yy = self.linear_in(torch.cat([tf, y], dim=-1))
        else:
            yy = self.linear_in(y)
        if io == 0:
            z = Xt
        elif io in (1, 3, 5):
            z = yy
        else:
            z = self.emb(torch.cat([yy, Xt], dim=-1))
        z = self._mlp(z)
        if io in (5, 6):
            z = z * torch.tanh(y)            # geometric interaction
        return torch.tanh(z)                 # drift clip

    def _raw_diffusion(self, t, y):
        no = self.noise_option
        tcol, tf = time_features(t, y)
        if no == 0:
            return torch.zeros_like(y)
        if no in (1, 2, 3):
            s = torch.exp(self.sigma).expand(y.shape)
            return s * tcol if no == 2 else (s * y if no == 3 else s)
        if no in (4, 5, 6):
            s = torch.exp(self.sigma_diag).expand(y.shape)
            return s * tcol if no == 5 else (s * y if no == 6 else s)
        if no == 7:
            return torch.sqrt(y)
        if no == 8:
            return y ** 3
        if no == 9:
            return torch.sigmoid(y)
        if no == 10:
            return torch.relu(y)
        if no == 11:
            return tcol * y
        if no in (12, 13):
            out = self.noise_t(tf)
            return out * y if no == 13 else out
        ty = torch.cat([tf, y], dim=-1)
        if no in (14, 15):
            out = self.noise_y(ty)
            return out * y if no == 15 else out
        if no in (16, 17):
            out = torch.relu(self.noise_t(tf))
            return out * y if no == 17 else out
        out = torch.relu(self.noise_y(ty))   # 18, 19
        return out * y if no == 19 else out

    def g(self, t, y):
        noise = torch.nan_to_num(self._raw_diffusion(t, y))
        return torch.tanh(torch.sigmoid(self.theta[0, 0]) * noise)


# ---------------------------------------------------------------------------
# The tutorial formulations: LipSwish MLPs, no tanh clipping
# ---------------------------------------------------------------------------


class _TutorialField(nn.Module):
    """The layers the four tutorial fields share, drawn from `generator`
    in the JAX package's order: linear_X (input_dim -> H), emb (emb_in ->
    H), f_net, linear_out, noise_in (1 -> H), g_net. `emb_in` of 2H + 1
    when the drift reads the time column, 2H when it does not."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 hidden_hidden_dim: int, num_layers: int, activation: str,
                 emb_in: int, *, generator=None, device=None):
        super().__init__()
        H = hidden_dim
        lin = lambda i, o: make_linear(i, o, generator=generator,
                                       device=device)
        mlp = lambda: MLP(H, H, hidden_hidden_dim, num_layers, activation,
                          generator=generator, device=device)
        self.linear_X = lin(input_dim, H)
        self.emb = lin(emb_in, H)
        self.f_net = mlp()
        self.linear_out = lin(H, H)
        self.noise_in = lin(1, H)
        self.g_net = mlp()
        self.path: Optional[CubicPath] = None

    def bind(self, path) -> "_TutorialField":
        """Set the control path and return self."""
        self.path = path
        return self

    def _drift(self, t, y, with_time: bool):
        Xt = self.linear_X(self.path.evaluate(t))
        parts = [time_column(t, y)] if with_time else []
        z = self.emb(torch.cat(parts + [y, Xt], dim=-1))
        return self.linear_out(self.f_net(z))

    def _time_noise(self, t, y):
        return self.g_net(self.noise_in(time_column(t, y)))


class NeuralSDEFunc(nn.Module):
    """Generic Neural SDE: f = MLP(linear_in([t, y])); g =
    MLP(noise_in([t, y])). `input_dim` is unused (no control path read)."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 hidden_hidden_dim: int, num_layers: int,
                 activation: str = "lipswish", *, generator=None,
                 device=None):
        super().__init__()
        H = hidden_dim
        lin = lambda i, o: make_linear(i, o, generator=generator,
                                       device=device)
        mlp = lambda: MLP(H, H, hidden_hidden_dim, num_layers, activation,
                          generator=generator, device=device)
        self.linear_in = lin(H + 1, H)
        self.f_net = mlp()
        self.linear_out = lin(H, H)
        self.noise_in = lin(H + 1, H)
        self.g_net = mlp()
        self.path: Optional[CubicPath] = None

    def bind(self, path) -> "NeuralSDEFunc":
        self.path = path
        return self

    def f(self, t, y):
        return self.f_net(self.linear_in(
            torch.cat([time_column(t, y), y], dim=-1)))

    def g(self, t, y):
        return self.g_net(self.noise_in(
            torch.cat([time_column(t, y), y], dim=-1)))


class NeuralLSDEFunc(_TutorialField):
    """Langevin-type SDE: f = MLP(emb([y, X(t)])); g = MLP(NN(t)), the
    diffusion independent of the state (additive)."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 hidden_hidden_dim: int, num_layers: int,
                 activation: str = "lipswish", *, generator=None,
                 device=None):
        super().__init__(input_dim, hidden_dim, hidden_hidden_dim,
                         num_layers, activation, 2 * hidden_dim,
                         generator=generator, device=device)

    def f(self, t, y):
        return self._drift(t, y, with_time=False)

    def g(self, t, y):
        return self._time_noise(t, y)


class NeuralLNSDEFunc(_TutorialField):
    """Linear-noise SDE: f = MLP(emb([t, y, X(t)])); g = NN(t) * y."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 hidden_hidden_dim: int, num_layers: int,
                 activation: str = "lipswish", *, generator=None,
                 device=None):
        super().__init__(input_dim, hidden_dim, hidden_hidden_dim,
                         num_layers, activation, 2 * hidden_dim + 1,
                         generator=generator, device=device)

    def f(self, t, y):
        return self._drift(t, y, with_time=True)

    def g(self, t, y):
        return self._time_noise(t, y) * y


class NeuralGSDEFunc(_TutorialField):
    """Geometric SDE: f = MLP(emb([t, y, X(t)])) * y; g = NN(t) * y, both
    vanishing at y = 0."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 hidden_hidden_dim: int, num_layers: int,
                 activation: str = "lipswish", *, generator=None,
                 device=None):
        super().__init__(input_dim, hidden_dim, hidden_hidden_dim,
                         num_layers, activation, 2 * hidden_dim + 1,
                         generator=generator, device=device)

    def f(self, t, y):
        return self._drift(t, y, with_time=True) * y

    def g(self, t, y):
        return self._time_noise(t, y) * y
