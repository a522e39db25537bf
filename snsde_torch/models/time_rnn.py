"""Time-aware recurrent models (counterpart of snsde/models/time_rnn.py):
`GRUDFull` (`:331-438`), GRU-D with a trainable input decay toward the
channel means and a hidden decay, the registry's `grud`; and `ODELSTM`
(`:442-519`), the registry's `ode-lstm`.

On a CUDA device it runs the fused route of the JAX package (`_fused_path`,
`:407-438`): the x_last recurrence is a data-only forward fill (closed form
through `last_observation_excl`), the input decay and imputation and the
input projection are precomputes, and the per-sample hidden decay rides
the fused GRU kernel's hdec stream. ODELSTM with the euler solver runs
the LSTM kernels' evolve mode on a CUDA device (`:492-507`); heun and rk4
take the eager loop there too, as in the JAX package. CPU tensors and
`use_fused=False` take the eager step loop. TLSTM, PLSTM and TGLSTM wait,
with the LSTM kernel modes they need (ROADMAP Queue 1 item 19, Queue 2
K7).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..kernels.fused_rnn import (fused_gru_scan, fused_lstm_scan,
                                 supports_fused_gru, supports_fused_lstm)
from ..nn.layers import LSTMCell, make_linear
from .rnn import last_observation_excl

__all__ = ["GRUDFull", "ODELSTM"]


class GRUDFull(nn.Module):
    """GRU-D: forward(x, mask, delta), each [B, L, D] (delta = time since
    the channel's last observation) -> hs [B, L, H].

    The GRU's parameters sit on the module itself, as in JAX (`w_ih`
    [2D, 3H] over (imputed values ‖ mask), `w_hh` [H, 3H], `b_ih`, `b_hh`,
    each ~ U(-1/sqrt(H), 1/sqrt(H))); `gamma_x` and `gamma_h` map delta to
    the input and hidden decay rates. `x_mean`, the channels' empirical
    means, is a trained parameter: the JAX package's is a plain array leaf,
    which its `partition` marks trainable (`snsde/nn/core.py:143-153`)."""

    def __init__(self, input_size: int, hidden_size: int, x_mean=None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        k = 1.0 / math.sqrt(hidden_size)
        shapes = {"w_ih": (2 * input_size, 3 * hidden_size),
                  "w_hh": (hidden_size, 3 * hidden_size),
                  "b_ih": (3 * hidden_size,), "b_hh": (3 * hidden_size,)}
        for name, shape in shapes.items():
            p = torch.empty(shape, device=device)
            with torch.no_grad():
                nn.init.uniform_(p, -k, k, generator=generator)
            setattr(self, name, nn.Parameter(p))
        kw = dict(generator=generator, device=device)
        self.gamma_x = make_linear(input_size, input_size, **kw)
        self.gamma_h = make_linear(input_size, hidden_size, **kw)
        mean = (torch.zeros(input_size) if x_mean is None
                else torch.as_tensor(np.asarray(x_mean, np.float32)))
        self.x_mean = nn.Parameter(mean.to(device))

    @property
    def hidden_size(self) -> int:
        return self.w_hh.shape[0]

    def _decays(self, d):
        """(input decay gx [.., D], hidden decay gh [.., H]) at delta d."""
        return (torch.exp(-torch.relu(self.gamma_x(d))),
                torch.exp(-torch.relu(self.gamma_h(d))))

    def forward(self, x, mask, delta, *, use_fused: bool = True):
        if use_fused and x.device.type == "cuda" and supports_fused_gru(self):
            return self._fused_path(x, mask, delta)
        B, L, D = x.shape
        H = self.hidden_size
        h = x.new_zeros((B, H))
        x_last = x.new_zeros((B, D))
        hs = []
        for t in range(L):
            x_t, m_t, d_t = x[:, t], mask[:, t], delta[:, t]
            gx, gh = self._decays(d_t)
            x_hat = m_t * x_t + (1 - m_t) * (gx * x_last
                                             + (1 - gx) * self.x_mean)
            h = gh * h
            gi = torch.cat([x_hat, m_t], dim=-1) @ self.w_ih + self.b_ih
            gh_ = h @ self.w_hh + self.b_hh
            r = torch.sigmoid(gi[..., :H] + gh_[..., :H])
            z = torch.sigmoid(gi[..., H:2 * H] + gh_[..., H:2 * H])
            n = torch.tanh(gi[..., 2 * H:] + r * gh_[..., 2 * H:])
            h = (1 - z) * n + z * h
            x_last = m_t * x_t + (1 - m_t) * x_last
            hs.append(h)
        return torch.stack(hs, dim=1)

    def _fused_path(self, x, mask, delta):
        """The fused-kernel route: hs [B, L, H]."""
        xs, ms, ds = (t.movedim(1, 0) for t in (x, mask, delta))  # [L, B, D]
        # x_last before step t: the value at the last observed step < t
        last = last_observation_excl(ms > 0.5)
        gathered = torch.gather(xs, 0, last.clamp(min=0))
        x_last = torch.where(last >= 0, gathered, torch.zeros_like(gathered))
        gx, gh = self._decays(ds)
        x_hat = ms * xs + (1 - ms) * (gx * x_last + (1 - gx) * self.x_mean)
        inp = torch.cat([x_hat, ms], dim=-1)
        return fused_gru_scan(self, inp, hdec=gh).movedim(0, 1)


class ODELSTM(nn.Module):
    """ODE-LSTM: an LSTM cell at each step, its output state h then evolved
    by an MLP ODE f = f2(tanh(f1(h))) over the step's elapsed time, in
    `ode_steps` fixed steps of `solver` (euler, heun or rk4); c passes
    through (reference module/odelstm.py:13-137, the non-torchdyn branch).

    forward(x [B, L, D], timestamps [B, L] (elapsed times)) -> hs
    [B, L, H]."""

    def __init__(self, input_size: int, hidden_size: int,
                 solver: str = "euler", ode_steps: int = 1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.lstm = LSTMCell(input_size, hidden_size, **kw)
        self.f1 = make_linear(hidden_size, hidden_size, **kw)
        self.f2 = make_linear(hidden_size, hidden_size, **kw)
        self.solver = solver
        self.ode_steps = ode_steps

    def _f(self, h):
        return self.f2(torch.tanh(self.f1(h)))

    def _evolve(self, h, dt):
        dt = dt[:, None] / self.ode_steps
        for _ in range(self.ode_steps):
            if self.solver == "euler":
                h = h + dt * self._f(h)
            elif self.solver == "heun":
                k1 = self._f(h)
                k2 = self._f(h + dt * k1)
                h = h + 0.5 * dt * (k1 + k2)
            elif self.solver == "rk4":
                k1 = self._f(h)
                k2 = self._f(h + 0.5 * dt * k1)
                k3 = self._f(h + 0.5 * dt * k2)
                k4 = self._f(h + dt * k3)
                h = h + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
            else:
                raise ValueError(self.solver)
        return h

    def _kernels_take(self, x, use_fused: bool) -> bool:
        """True where the recurrence goes through the fused kernels: CUDA
        tensors with the euler solver, unless use_fused is False."""
        return (use_fused and x.device.type == "cuda"
                and self.solver == "euler" and supports_fused_lstm(self.lstm))

    def forward(self, x, timestamps, *, use_fused: bool = True):
        if self._kernels_take(x, use_fused):
            hs = fused_lstm_scan(self.lstm, x.movedim(1, 0),
                                 ode_layers=(self.f1, self.f2),
                                 odt=timestamps.movedim(1, 0),
                                 ode_steps=self.ode_steps)
            return hs.movedim(0, 1)
        B, L = x.shape[:2]
        h = c = x.new_zeros((B, self.lstm.hidden_size))
        hs = []
        for t in range(L):
            h, (_, c) = self.lstm(x[:, t], (h, c))
            h = self._evolve(h, timestamps[:, t])
            hs.append(h)
        return torch.stack(hs, dim=1)
