"""Plain recurrent sequence baselines (counterpart of snsde/models/rnn.py:
56-68 and 322-442): `SeqRNN`, the stacked RNN/GRU/LSTM (optionally
bidirectional) of the registry's `rnn`, `gru`, `gru-simple`, `lstm` and
`bilstm`, and `last_observation_excl`, the forward-fill index GRUD-full's
fused route precomputes.

On a CUDA device a GRU or LSTM cell runs its whole recurrence through the
fused kernels (`kernels/fused_rnn.py`), in both directions and at every
width up to the kernels' H <= 512; the tanh Elman cell, every CPU tensor
and `use_fused=False` take the eager loop over the cell. The JAX package's
gate `_fused_rnn_enabled` (fused only on a TPU and only at H >= 128,
`snsde/models/rnn.py:31-53`) was measured on a TPU and does not carry over.
The other models of the JAX module (GRUdt, GRUD, ODERNN, SeqCNN,
SeqTransformer) are not ported yet (ROADMAP Queue 1 item 19).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..kernels.fused_rnn import (fused_gru_scan, fused_lstm_scan,
                                 supports_fused_gru, supports_fused_lstm)
from ..nn.layers import GRUCell, LSTMCell, RNNCell, make_linear

__all__ = ["SeqRNN", "last_observation_excl", "scan_cell"]


def last_observation_excl(observed: torch.Tensor) -> torch.Tensor:
    """Exclusive last-observation index along axis 0: out[t] = the largest
    s < t with observed[s], or -1 (int64, observed's shape): a running
    max over the masked step indices."""
    L = observed.shape[0]
    idx = torch.arange(L, device=observed.device).reshape(
        (L,) + (1,) * (observed.ndim - 1))
    last_incl = torch.cummax(torch.where(observed, idx, -1), dim=0).values
    return torch.cat([torch.full_like(last_incl[:1], -1), last_incl[:-1]])


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
