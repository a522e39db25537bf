"""Time-aware recurrent models (counterpart of snsde/models/time_rnn.py):
`TLSTM`, `PLSTM` and `TGLSTM` (`:41-330`), stacks of the reference's
time-aware LSTM cells, the registry's `tlstm`, `plstm` and `tglstm`;
`GRUDFull` (`:331-438`), GRU-D with a trainable input decay toward the
channel means and a hidden decay, the registry's `grud`; and `ODELSTM`
(`:442-519`), the registry's `ode-lstm`.

On a CUDA device (H <= 512) each layer of the three time-aware LSTMs runs
the LSTM kernels in the mode that layer needs (`_fused_time_lstm`, the
counterpart of `:176-233`): PLSTM's phased openness as the `sel` stream,
TGLSTM's sigmoid time gates as the `tg` stream (both computed here, so
their gradients reach the phase parameters and `weight_t` through
autograd), TLSTM's memory decomposition with W_d and the elapsed times.
The JAX package's opt-in gate `SNSDE_FUSED_TIME_RNN` was set from TPU
measurements and does not carry over. GRUDFull runs the fused route of
the JAX package (`_fused_path`, `:407-438`): the x_last recurrence is a
data-only forward fill (closed form through `last_observation_excl`), the
input decay and imputation and the input projection are precomputes, and
the per-sample hidden decay rides the fused GRU kernel's hdec stream.
ODELSTM with the euler solver runs the LSTM kernels' evolve mode on a
CUDA device (`:492-507`); heun and rk4 take the eager loop there too, as
in the JAX package. CPU tensors and `use_fused=False` take the eager step
loops; a failed build or launch raises.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..kernels.fused_rnn import (MAX_H, fused_gru_scan, fused_lstm_scan,
                                 supports_fused_gru, supports_fused_lstm)
from ..nn.layers import LSTMCell, make_linear
from .rnn import last_observation_excl

__all__ = ["TLSTMCell", "PLSTMCell", "TGLSTMCell", "TLSTM", "PLSTM",
           "TGLSTM", "GRUDFull", "ODELSTM"]

# PLSTM's leak in the closed phase (the reference's plstm.py)
_OFF_SLOPE = 1e-3


def _uniform(shape, lo, hi, generator, device):
    p = torch.empty(shape, device=device)
    with torch.no_grad():
        nn.init.uniform_(p, lo, hi, generator=generator)
    return nn.Parameter(p)


class TLSTMCell(nn.Module):
    """TLSTM (reference tlstm.py:23-71): the short-term part of the cell
    state, tanh(W_d c), is discounted by the elapsed time before the gate
    update, whose gates come as (f, i, o, a sigmoid candidate). W_all: h ->
    4H, U_all: x -> 4H, W_d: c -> H, each an `nn.Linear` with bias.

    forward(x [B, D], t_elapsed [B], (h, c)) -> (h', (h', c'))."""

    def __init__(self, input_size: int, hidden_size: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.W_all = make_linear(hidden_size, 4 * hidden_size, **kw)
        self.U_all = make_linear(input_size, 4 * hidden_size, **kw)
        self.W_d = make_linear(hidden_size, hidden_size, **kw)

    @property
    def hidden_size(self) -> int:
        return self.W_d.out_features

    def forward(self, x, t_elapsed, state):
        h, c = state
        H = self.hidden_size
        c_short = torch.tanh(self.W_d(c))
        c_adj = (c - c_short) + c_short * t_elapsed[:, None]
        outs = self.W_all(h) + self.U_all(x)
        f = torch.sigmoid(outs[..., :H])
        i = torch.sigmoid(outs[..., H:2 * H])
        o = torch.sigmoid(outs[..., 2 * H:3 * H])
        c_tmp = torch.sigmoid(outs[..., 3 * H:])
        c = f * c_adj + i * c_tmp
        h = o * torch.tanh(c)
        return h, (h, c)


class PLSTMCell(nn.Module):
    """Phased LSTM (reference plstm.py:63-190): an LSTM cell (W [in, 4H],
    U [H, 4H], bias, torch's gate order) whose update of (h, c) each unit
    takes only as far as its rhythmic openness k(t) from the learned
    period, shift and on-ratio allow, leaking 1e-3 in the closed phase.

    forward(x [B, D], t [B] (absolute times), (h, c)) -> (h', (h', c'))."""

    def __init__(self, input_size: int, hidden_size: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        std = 1.0 / math.sqrt(hidden_size)
        kw = dict(generator=generator, device=device)
        self.W = _uniform((input_size, 4 * hidden_size), -std, std, **kw)
        self.U = _uniform((hidden_size, 4 * hidden_size), -std, std, **kw)
        self.bias = _uniform((4 * hidden_size,), -std, std, **kw)
        periods = torch.empty(hidden_size, device=device)
        with torch.no_grad():
            nn.init.uniform_(periods, 0.0, 1.0, generator=generator)
        self.periods = nn.Parameter(torch.exp((3.0 - 1.0) * periods + 1.0))
        self.shifts = _uniform((hidden_size,), 0.0, 100.0, **kw)
        self.on_end = nn.Parameter(torch.full((hidden_size,), 0.05,
                                              device=device))

    @property
    def hidden_size(self) -> int:
        return self.U.shape[0]

    def time_gate(self, t):
        """t [N] -> the openness k [N, H] (plstm.py:105-130; the JAX
        package's `_time_gate`, jnp.mod as torch.remainder: both take the
        divisor's sign and the same derivatives)."""
        period = torch.abs(self.periods)[None, :]
        shift = self.shifts[None, :]
        on_mid = torch.abs(self.on_end)[None, :] * 0.5 * period
        on_end = torch.abs(self.on_end)[None, :] * period
        in_cycle = torch.remainder(t[:, None] + shift, period)
        up = in_cycle <= on_mid
        down = (in_cycle > on_mid) & (in_cycle <= on_end)
        return torch.where(up, in_cycle / on_mid,
                           torch.where(down, (on_end - in_cycle) / on_mid,
                                       _OFF_SLOPE * in_cycle))

    def forward(self, x, t_abs, state):
        h, c = state
        H = self.hidden_size
        g = x @ self.W + h @ self.U + self.bias
        i = torch.sigmoid(g[..., :H])
        f = torch.sigmoid(g[..., H:2 * H])
        gg = torch.tanh(g[..., 2 * H:3 * H])
        o = torch.sigmoid(g[..., 3 * H:])
        c_new = f * c + i * gg
        h_new = o * torch.tanh(c_new)
        k = self.time_gate(t_abs)
        c = k * c_new + (1.0 - k) * c
        h = k * h_new + (1.0 - k) * h
        return h, (h, c)


class TGLSTMCell(nn.Module):
    """Time-gated LSTM (reference tglstm.py:66-127): `weights` maps (h ‖ x)
    to the gates (torch's order); the input, forget and output gates are
    each multiplied by a sigmoid time gate, `weight_t` of the time input.

    forward(x [B, D], t [B], (h, c)) -> (h', (h', c'))."""

    def __init__(self, input_size: int, hidden_size: int,
                 time_size: int = 1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.weights = make_linear(hidden_size + input_size, 4 * hidden_size,
                                   **kw)
        self.weight_t = make_linear(time_size, 3 * hidden_size, **kw)

    @property
    def hidden_size(self) -> int:
        return self.weights.out_features // 4

    def forward(self, x, t, state):
        h, c = state
        H = self.hidden_size
        g = self.weights(torch.cat([h, x], dim=-1))
        gt = self.weight_t(t[:, None] if t.ndim == 1 else t)
        i = torch.sigmoid(g[..., :H]) * torch.sigmoid(gt[..., :H])
        f = torch.sigmoid(g[..., H:2 * H]) * torch.sigmoid(gt[..., H:2 * H])
        cand = torch.tanh(g[..., 2 * H:3 * H])
        o = torch.sigmoid(g[..., 3 * H:]) * torch.sigmoid(gt[..., 2 * H:])
        c = f * c + i * cand
        h = o * torch.tanh(c)
        return h, (h, c)


def _fused_time_lstm(cell, xs, ts):
    """One TLSTM, PLSTM or TGLSTM layer through the LSTM kernels: xs [L, B,
    D], ts [L, B] -> hs [L, B, H]. Each is an LSTM with a time modulation
    the kernels take as a mode (snsde/models/time_rnn.py:176-233): TLSTM's
    W_all and U_all biases fold into b_hh and b_ih and its decomposition
    takes W_d and the elapsed times; PLSTM's openness k(t) becomes the
    `sel` stream and TGLSTM's time gates the `tg` stream, both made here
    (their gradients reach the time parameters through autograd), with
    b_hh = 0; TGLSTM's weights split as W_hh (h's rows) and W_ih (x's)."""
    H = cell.hidden_size
    L, B = ts.shape
    if isinstance(cell, TLSTMCell):
        adapter = SimpleNamespace(w_ih=cell.U_all.weight.t(),
                                  w_hh=cell.W_all.weight.t(),
                                  b_ih=cell.U_all.bias, b_hh=cell.W_all.bias,
                                  hidden_size=H)
        return fused_lstm_scan(adapter, xs, tlstm=cell.W_d, tel=ts)
    if isinstance(cell, PLSTMCell):
        adapter = SimpleNamespace(w_ih=cell.W, w_hh=cell.U, b_ih=cell.bias,
                                  b_hh=cell.bias.new_zeros(4 * H),
                                  hidden_size=H)
        sel = cell.time_gate(ts.reshape(-1)).reshape(L, B, H)
        return fused_lstm_scan(adapter, xs, sel=sel)
    w = cell.weights.weight.t()
    adapter = SimpleNamespace(w_ih=w[H:], w_hh=w[:H], b_ih=cell.weights.bias,
                              b_hh=w.new_zeros(4 * H), hidden_size=H)
    tg = torch.sigmoid(cell.weight_t(ts[:, :, None]))      # [L, B, 3H]
    return fused_lstm_scan(adapter, xs, tg=tg)


class _TimeLSTMStack(nn.Module):
    """Stacked time-aware cells: forward(x [B, L, D], timestamps [B, L]) ->
    (out [B, L, H], finals), finals each layer's last (h, c) (on the fused
    route (h, None): the kernels return h only, as the JAX fused route's
    contract note says)."""

    cell_class = None

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.cells = nn.ModuleList(
            self.cell_class(input_size if i == 0 else hidden_size,
                            hidden_size, **kw) for i in range(num_layers))

    def _kernels_take(self, x, use_fused: bool) -> bool:
        """True where each layer goes through the fused kernels: CUDA
        tensors with H <= MAX_H, unless use_fused is False."""
        return (use_fused and x.device.type == "cuda"
                and self.cells[0].hidden_size <= MAX_H)

    def forward(self, x, timestamps, *, use_fused: bool = True):
        out = x.movedim(1, 0)                             # [L, B, D]
        ts = timestamps.movedim(1, 0)                     # [L, B]
        fused = self._kernels_take(x, use_fused)
        finals = []
        for cell in self.cells:
            if fused:
                out = _fused_time_lstm(cell, out, ts)
                finals.append((out[-1], None))
                continue
            h = c = out.new_zeros((out.shape[1], cell.hidden_size))
            hs = []
            for t in range(out.shape[0]):
                h, (_, c) = cell(out[t], ts[t], (h, c))
                hs.append(h)
            out = torch.stack(hs)
            finals.append((h, c))
        return out.movedim(0, 1), finals


class TLSTM(_TimeLSTMStack):
    """Stacked TLSTM; timestamps are the elapsed times."""

    cell_class = TLSTMCell


class PLSTM(_TimeLSTMStack):
    """Stacked phased LSTM; timestamps are absolute times."""

    cell_class = PLSTMCell


class TGLSTM(_TimeLSTMStack):
    """Stacked time-gated LSTM."""

    cell_class = TGLSTMCell


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
