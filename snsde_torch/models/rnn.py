"""Discrete-time baselines (counterpart of snsde/models/rnn.py): the
observation-gated GRUs `GRUdt`, `GRUD` and `ODERNN` (`:71-320`, the
registry's `gru-dt`, `gru-d` and `ode-rnn`), `SeqRNN`, the stacked
RNN/GRU/LSTM (optionally bidirectional) of the registry's `rnn`, `gru`,
`gru-simple`, `lstm` and `bilstm`, and `last_observation_excl`, the
forward-fill index that GRUD-full's fused route and the observation GRUs'
elapsed-time precompute use.

On a CUDA device a GRU or LSTM cell runs its whole recurrence through the
fused kernels (`kernels/fused_rnn.py`), in both directions and at every
width up to the kernels' H <= 512, and so do the observation GRUs (the
GRU kernels' obs mode, with GRU-D's decay row or ODE-RNN's evolve); the
tanh Elman cell, every CPU tensor and `use_fused=False` take the eager
loop. The JAX package's gate `_fused_rnn_enabled` (fused only on a TPU and
only at H >= 128, `snsde/models/rnn.py:31-53`) was measured on a TPU and
does not carry over. `SeqCNN` (`:446-483`, the registry's `cnn`,
`cnn-3/5/7`) and `SeqTransformer` (`:487-554`, `transformer`) have no
kernel, as in the JAX package: plain torch operations.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..kernels.fused_rnn import (MAX_H, fused_gru_scan, fused_lstm_scan,
                                 supports_fused_gru, supports_fused_lstm)
from ..nn.layers import GRUCell, LSTMCell, RNNCell, make_linear
from ..ops.interp import CubicPath

__all__ = ["GRUdt", "GRUD", "ODERNN", "SeqRNN", "SeqCNN", "SeqTransformer",
           "last_observation_excl", "scan_cell"]


def last_observation_excl(observed: torch.Tensor) -> torch.Tensor:
    """Exclusive last-observation index along axis 0: out[t] = the largest
    s < t with observed[s], or -1 (int64, observed's shape): a running
    max over the masked step indices."""
    L = observed.shape[0]
    idx = torch.arange(L, device=observed.device).reshape(
        (L,) + (1,) * (observed.ndim - 1))
    last_incl = torch.cummax(torch.where(observed, idx, -1), dim=0).values
    return torch.cat([torch.full_like(last_incl[:1], -1), last_incl[:-1]])


def _values_from_spline(times, coeffs) -> torch.Tensor:
    """The control spline at every knot -> [B, L, C] (the reference
    evaluates the interpolant at the knots, other.py:50-51)."""
    path = CubicPath(coeffs, times)
    return path.evaluate_grid(path.times_np).movedim(0, 1)


class _ObservationGRUBase(nn.Module):
    """A GRU updated only at observed steps, over the intensity-augmented
    stream [t ‖ K cumulative intensities ‖ K values] of an odd width
    `input_channels` (the reference's `_GRU` family, other.py:14-138;
    snsde/models/rnn.py:81-215). Channel 0 becomes the time since the last
    knot and the intensities per-step indicators; a step is observed where
    an indicator exceeds 0.5; the time elapsed since the last observed step
    is added to the first channel of the GRU's input; between steps the
    state evolves (`evolve`: the identity here, a decay in GRUD, an ODE in
    ODERNN). The GRU reads the values only, or the whole stream with
    use_intensity.

    forward(times [L], coeffs, final_index [B], z0=None, stream=False) ->
    (linear(h at final_index) or linear(every h) with stream, hs [B, L, H]).
    """

    def __init__(self, input_channels: int, hidden_channels: int,
                 output_channels: int, use_intensity: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        K = (input_channels - 1) // 2
        self.gru = GRUCell(input_channels if use_intensity else K,
                           hidden_channels, **kw)
        self.linear = make_linear(hidden_channels, output_channels, **kw)
        self.input_channels = input_channels
        self.use_intensity = use_intensity

    def evolve(self, h, time_diff):
        return h

    def _decay_rows(self, time_diffs):
        """The time-only decay rows [L, H] of the fused route, or None."""
        return None

    def _kernels_take(self, X, use_fused: bool) -> bool:
        """True where the recurrence goes through the fused kernels: CUDA
        tensors, unless use_fused is False, with the evolve's widths within
        the kernels' H <= MAX_H (snsde/models/rnn.py:132-135)."""
        return (use_fused and X.device.type == "cuda"
                and supports_fused_gru(self.gru)
                and all(lin.out_features <= MAX_H
                        for lin in getattr(self, "f_layers", ())))

    def _fused_path(self, X, time_diffs, z0, K):
        """hs [L, B, H] through the GRU kernels' obs mode (with GRU-D's
        decay row or ODE-RNN's evolve): the elapsed-time recurrence is
        data only, so it closes over an exclusive prefix sum and the last
        observed step (snsde/models/rnn.py:95-143)."""
        xs = X.movedim(1, 0)                             # [L, B, C]
        observed = xs[:, :, 1:1 + K].amax(-1) > 0.5      # [L, B]
        delta = xs[:, :, 0]
        # the time elapsed before step t since the last observed step
        pcs = torch.cumsum(delta, 0) - delta
        last = last_observation_excl(observed)
        dt_acc = pcs - torch.gather(pcs, 0, last + 1)
        inp = xs if self.use_intensity else xs[:, :, 1 + K:]
        inp = torch.cat([inp[:, :, :1] + dt_acc[:, :, None], inp[:, :, 1:]],
                        dim=-1)
        ode = {}
        if isinstance(self, ODERNN):
            ode = dict(ode_layers=self.f_layers, tdif=time_diffs,
                       ode_steps=self.ode_steps)
        return fused_gru_scan(self.gru, inp, h0=z0,
                              obs=observed.to(xs.dtype),
                              hdec=self._decay_rows(time_diffs), **ode)

    def forward(self, times, coeffs, final_index=None, *, z0=None,
                stream: bool = False, use_fused: bool = True):
        times_np = np.asarray(times, np.float32)
        X = _values_from_spline(times_np, coeffs)        # [B, L, C]
        # an odd [t ‖ K intensities ‖ K values] width: a wider coefficient
        # stream's extra trailing channel is ignored (the registry's
        # gru-dt/gru-d/ode-rnn contract, as in JAX)
        X = X[..., :self.input_channels]
        K = (self.input_channels - 1) // 2
        tt = torch.as_tensor(times_np, dtype=X.dtype, device=X.device)
        intens = X[:, :, 1:1 + K]
        intens = torch.cat([intens[:, :1], intens[:, 1:] - intens[:, :-1]],
                           dim=1)
        dt_chan = torch.cat([X[:, :1, 0] - tt[0], X[:, 1:, 0] - tt[:-1]],
                            dim=1)
        X = torch.cat([dt_chan[..., None], intens, X[..., 1 + K:]], dim=-1)
        B, H = X.shape[0], self.gru.hidden_size
        if z0 is None:
            z0 = X.new_zeros((B, H))
        time_diffs = torch.cat([tt.new_zeros(1), tt[1:] - tt[:-1]])
        if self._kernels_take(X, use_fused):
            out = self._fused_path(X, time_diffs, z0, K).movedim(0, 1)
        else:
            out = self._eager(X, time_diffs, z0, K)
        if stream:
            final = out
        else:
            idx = torch.as_tensor(final_index, device=X.device).long()
            final = out[torch.arange(B, device=X.device), idx]
        return self.linear(final), out

    def _eager(self, X, time_diffs, z0, K):
        """The step loop (snsde/models/rnn.py:183-215): hs [B, L, H]."""
        h, dt_acc = z0, X.new_zeros(X.shape[0])
        hs = []
        for t in range(X.shape[1]):
            Xi = X[:, t]
            h = self.evolve(h, time_diffs[t])
            observed = Xi[:, 1:1 + K].amax(1) > 0.5
            inp = Xi if self.use_intensity else Xi[:, 1 + K:]
            inp = torch.cat([inp[:, :1] + dt_acc[:, None], inp[:, 1:]],
                            dim=-1)
            h = torch.where(observed[:, None], self.gru(inp, h), h)
            dt_acc = torch.where(observed, torch.zeros_like(dt_acc),
                                 dt_acc + Xi[:, 0])
            hs.append(h)
        return torch.stack(hs, dim=1)


class GRUdt(_ObservationGRUBase):
    """GRU on (elapsed time, observed values); no evolution between
    observations (reference GRU_dt; snsde/models/rnn.py:218-235)."""


class GRUD(_ObservationGRUBase):
    """GRU-D: the state decays by exp(-relu(decay(dt))) over each step's
    elapsed time dt, a time-only row a step (reference GRU_D,
    other.py:96-104; snsde/models/rnn.py:238-268). Not `grud`
    (GRUDFull, time_rnn.py). On the card the rows ride the GRU kernels'
    decay-row mode; the decay net's gradient comes back through autograd
    of the rows."""

    def __init__(self, input_channels: int, hidden_channels: int,
                 output_channels: int, use_intensity: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(input_channels, hidden_channels, output_channels,
                         use_intensity, generator=generator, device=device)
        self.decay = make_linear(1, hidden_channels, generator=generator,
                                 device=device)

    def evolve(self, h, time_diff):
        rate = torch.relu(self.decay(time_diff.reshape(1)))
        return h * torch.exp(-rate)

    def _decay_rows(self, time_diffs):
        return torch.exp(-torch.relu(self.decay(time_diffs[:, None])))


class ODERNN(_ObservationGRUBase):
    """ODE-RNN: between steps the state follows an MLP ODE, `ode_steps`
    Euler steps over each step's elapsed time (reference other.py:121-138;
    snsde/models/rnn.py:271-320). The MLP has num_hidden_layers + 1
    layers, H -> hh -> ... -> H, tanh on the inner ones. On the card the
    evolve runs inside the GRU kernels (their evolve mode)."""

    def __init__(self, input_channels: int, hidden_channels: int,
                 output_channels: int,
                 hidden_hidden_channels: Optional[int] = None,
                 num_hidden_layers: int = 1, use_intensity: bool = False,
                 ode_steps: int = 1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(input_channels, hidden_channels, output_channels,
                         use_intensity, generator=generator, device=device)
        hh = hidden_hidden_channels or hidden_channels
        widths = ([hidden_channels] + [hh] * num_hidden_layers
                  + [hidden_channels])
        self.f_layers = nn.ModuleList(
            make_linear(i, o, generator=generator, device=device)
            for i, o in zip(widths[:-1], widths[1:]))
        self.ode_steps = ode_steps

    def _func(self, h):
        x = h
        for lin in self.f_layers[:-1]:
            x = torch.tanh(lin(x))
        return self.f_layers[-1](x)

    def evolve(self, h, time_diff):
        dt = time_diff / self.ode_steps
        for _ in range(self.ode_steps):
            h = h + dt * self._func(h)
        return h


def scan_cell(cell, xs: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """The eager loop over a cell from a zero state: xs [L, B, C] -> hs
    [L, B, H], hs[t] the output after consuming xs[t] (from the right when
    reverse, as lax.scan(reverse=True) stacks it)."""
    L, B = xs.shape[:2]
    h = xs.new_zeros((B, cell.hidden_size))
    state = (h, h) if isinstance(cell, LSTMCell) else h
    hs = [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        if isinstance(cell, LSTMCell):
            hs[t], state = cell(xs[t], state)
        else:
            hs[t] = state = cell(xs[t], state)
    return torch.stack(hs)


class SeqRNN(nn.Module):
    """Stacked RNN/GRU/LSTM (+ optional bidirectional) over a value stream,
    torch nn.RNN/GRU/LSTM constructor semantics: `rnn` is a tanh Elman cell,
    `num_layers` stacks cells with inter-layer dropout on every layer's
    output but the last (training only, drawn from the caller's
    generator), and a bidirectional layer runs `hidden_per_dir` units per
    direction and concatenates them before the next layer.

    forward(x [B, L, D]) -> (out [B, L, output_channels], stream
    [B, L, ndir * hidden_per_dir])."""

    def __init__(self, input_channels: int, hidden_channels: int,
                 output_channels: int, kind: str = "gru",
                 bidirectional: bool = False, num_layers: int = 1,
                 dropout: float = 0.0, hidden_per_dir: Optional[int] = None,
                 *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        mk = {"gru": GRUCell, "lstm": LSTMCell, "rnn": RNNCell}[kind]
        Hd = hidden_per_dir or hidden_channels
        ndir = 2 if bidirectional else 1
        kw = dict(generator=generator, device=device)
        # layer 0 reads the embedded stream (width hidden_channels); deeper
        # layers read the previous layer's ndir * Hd outputs
        in_w = [hidden_channels] + [ndir * Hd] * (num_layers - 1)
        self.cells = nn.ModuleList(mk(w, Hd, **kw) for w in in_w)
        self.cells_bwd = (nn.ModuleList(mk(w, Hd, **kw) for w in in_w)
                          if bidirectional else None)
        self.embed = make_linear(input_channels, hidden_channels, **kw)
        self.linear = make_linear(ndir * Hd, output_channels, **kw)
        self.dropout = float(dropout)

    @staticmethod
    def _run(cell, xs, reverse: bool = False, use_fused: bool = True):
        if use_fused and xs.device.type == "cuda":
            if isinstance(cell, LSTMCell) and supports_fused_lstm(cell):
                return fused_lstm_scan(cell, xs, reverse=reverse)
            if isinstance(cell, GRUCell) and supports_fused_gru(cell):
                return fused_gru_scan(cell, xs, reverse=reverse)
        return scan_cell(cell, xs, reverse)

    def forward(self, x, *, generator: Optional[torch.Generator] = None,
                use_fused: bool = True):
        xs = self.embed(x).movedim(1, 0)                 # [L, B, H]
        n = len(self.cells)
        for li, cell in enumerate(self.cells):
            hs = self._run(cell, xs, use_fused=use_fused)
            if self.cells_bwd is not None:
                hs_b = self._run(self.cells_bwd[li], xs, reverse=True,
                                 use_fused=use_fused)
                hs = torch.cat([hs, hs_b], dim=-1)
            if (li < n - 1 and self.dropout > 0.0 and self.training
                    and generator is not None):
                keep = 1.0 - self.dropout
                mask = torch.rand(hs.shape, generator=generator,
                                  device=hs.device) < keep
                hs = torch.where(mask, hs / keep, torch.zeros_like(hs))
            xs = hs
        stream = xs.movedim(0, 1)
        return self.linear(stream), stream


class SeqCNN(nn.Module):
    """A 1-D convolution stack over the time axis (the reference's
    cnn{-3,-5,-7}): `depth` convolutions of `kernel_size` with "SAME"
    padding, each followed by a ReLU, then a linear readout. The kernels
    keep the JAX layout [k, c_in, c_out] (~ U(-1/sqrt(c_in k), ..)), the
    biases start at zero.

    forward(x [B, L, C]) -> (out [B, L, output_channels], h [B, L, H])."""

    def __init__(self, input_channels: int, hidden_channels: int,
                 output_channels: int, kernel_size: int = 3, depth: int = 2,
                 *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        kernels, biases = [], []
        c_in = input_channels
        for _ in range(depth):
            k = 1.0 / np.sqrt(c_in * kernel_size)
            w = torch.empty((kernel_size, c_in, hidden_channels),
                            device=device)
            with torch.no_grad():
                nn.init.uniform_(w, -k, k, generator=generator)
            kernels.append(nn.Parameter(w))
            biases.append(nn.Parameter(torch.zeros(hidden_channels,
                                                   device=device)))
            c_in = hidden_channels
        self.kernels = nn.ParameterList(kernels)
        self.biases = nn.ParameterList(biases)
        self.linear = make_linear(hidden_channels, output_channels,
                                  generator=generator, device=device)

    def forward(self, x):
        h = x.movedim(1, 2)                               # [B, C, L]
        for kern, b in zip(self.kernels, self.biases):
            h = torch.relu(F.conv1d(h, kern.permute(2, 1, 0), b,
                                    padding="same"))
        h = h.movedim(2, 1)
        return self.linear(h), h


class SeqTransformer(nn.Module):
    """Encoder-only transformer with sinusoidal positions (the reference's
    `transformer` baseline), parametrised as the JAX package writes it, not
    as torch's `nn.TransformerEncoder`: an embedding, then per layer
    `num_heads`-head self-attention (wq, wk, wv, wo) and a ReLU
    feed-forward of width 4H (ff1, ff2), each added back and followed by a
    layer norm without scale or offset (eps 1e-5), then a linear readout.

    forward(x [B, L, C]) -> (out [B, L, output_channels], h [B, L, H])."""

    def __init__(self, input_channels: int, hidden_channels: int,
                 output_channels: int, num_heads: int = 4,
                 num_layers: int = 2, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        H = hidden_channels
        mk = lambda a, b: make_linear(a, b, generator=generator,
                                      device=device)
        self.embed = mk(input_channels, H)
        for name, (a, b) in (("wq", (H, H)), ("wk", (H, H)), ("wv", (H, H)),
                             ("wo", (H, H)), ("ff1", (H, 4 * H)),
                             ("ff2", (4 * H, H))):
            setattr(self, name, nn.ModuleList(mk(a, b)
                                              for _ in range(num_layers)))
        self.linear = mk(H, output_channels)
        self.num_heads, self.num_layers = num_heads, num_layers

    @staticmethod
    def _positions(L, H, like):
        pos = torch.arange(L, dtype=like.dtype, device=like.device)[:, None]
        i = torch.arange(0, H, 2, dtype=like.dtype, device=like.device)
        angle = pos / torch.pow(10000.0, i / H)[None, :]
        pe = like.new_zeros((L, H))
        pe[:, 0::2] = torch.sin(angle)
        pe[:, 1::2] = torch.cos(angle)[:, :H // 2]
        return pe

    @staticmethod
    def _norm(x):
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, unbiased=False, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-5)

    def forward(self, x):
        h = self.embed(x)                                 # [B, L, H]
        B, L, H = h.shape
        h = h + self._positions(L, H, h)
        nh = self.num_heads
        hd = H // nh
        for li in range(self.num_layers):
            q = self.wq[li](h).reshape(B, L, nh, hd)
            k = self.wk[li](h).reshape(B, L, nh, hd)
            v = self.wv[li](h).reshape(B, L, nh, hd)
            att = torch.einsum("blhd,bmhd->bhlm", q, k) / np.sqrt(hd)
            att = torch.softmax(att, dim=-1)
            o = torch.einsum("bhlm,bmhd->blhd", att, v).reshape(B, L, H)
            h = self._norm(h + self.wo[li](o))
            ff = self.ff2[li](torch.relu(self.ff1[li](h)))
            h = self._norm(h + ff)
        return self.linear(h), h
