"""Drift/diffusion vector field (counterpart of snsde/fields.py:77-325).

`DiffusionField` realises the whole input_option (0-6) x noise_option
(0-19) grid of the reference `Diffusion_model`, eagerly. Its submodule and
parameter names are the reference's own (`noise_t.0` / `noise_t.2` for the
two-layer noise nets), so the reference's state_dicts — the goldens in
tests/goldens/reference_{fg,em}.npz — load into it directly.

Canonical bindings: staticsde=(1,0) naivesde=(1,18) neuralsde=(3,18)
neurallsde=(2,16) neurallnsde=(4,17) neuralgsde=(6,17).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .nn.layers import make_linear
from .ops.interp import CubicPath

__all__ = ["DiffusionField", "PROPOSAL_METHOD_CONTRACT", "MODEL_NAME_GRID"]

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
