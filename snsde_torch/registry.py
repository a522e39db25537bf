"""Unified model registry (counterpart of snsde/registry.py:58-83, 172-446),
for the Neural CDE and the plain recurrent names.

`SeqLayer` normalises a model to (out_stream [N, L, H], hidden_stream)
from the stacked seq [N, 3, L, D] (values, mask, delta) and packed spline
coefficients over (time ‖ values), with times linspace(0, 1, L). The port
builds `neuralcde` (natural cubic control), `neuralcde-c` (cubic),
`neuralcde-h` (Hermite) and `gru-ode`, and the recurrent baselines `rnn`,
`gru`, `lstm`, `bilstm` (SeqRNN over the values), `gru-simple` (SeqRNN
over values ‖ mask ‖ delta) and `grud` (GRUDFull over (values, mask,
delta)); every other registry name raises NotImplementedError naming its
ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .models.neuralcde import FinalTanh, GRUODEField, NeuralCDEStream
from .models.rnn import SeqRNN
from .models.time_rnn import GRUDFull

__all__ = ["MODEL_NAMES", "PORTED_NAMES", "SeqLayer", "make_seq_layer"]


def _build_model_names():
    base = [
        "cnn", "cnn-3", "cnn-5", "cnn-7",
        "rnn", "lstm", "gru", "gru-simple", "grud",
        "bilstm", "tlstm", "plstm", "tglstm",
        "transformer", "sand", "mtan", "miam",
        "gru-dt", "gru-d", "gru-ode", "ode-rnn", "ode-lstm",
        "neuralcde", "neuralcde-l", "neuralcde-r", "neuralcde-c",
        "neuralcde-h",
        "neuralrde-1", "neuralrde-2", "neuralrde-3",
        "ancde", "exit", "leap",
        "latentsde", "latentsde-kl", "neuralsde-x", "neuralsde-y",
        "neuralsde-z",
    ]
    flows = [
        f"{fam}_{i}_{j}"
        for fam in ("neuralflow", "neuralflowcde", "neuralmixture",
                    "neuralcontrolledflow")
        for j in "nrgc"
        for i in "xyz"
    ]
    sdes = [f"neuralsde_{i}_{j:02d}" for j in range(20) for i in range(7)]
    return base + flows + sdes


MODEL_NAMES = _build_model_names()
_SEQ_RNN = ("rnn", "gru", "lstm", "bilstm", "gru-simple")
PORTED_NAMES = ("neuralcde", "neuralcde-c", "neuralcde-h", "gru-ode",
                *_SEQ_RNN, "grud")

# ROADMAP Queue 1 item of every registry name the port does not build yet
_RECURRENT = ("tlstm", "plstm", "tglstm", "transformer", "gru-dt", "gru-d",
              "ode-rnn", "ode-lstm")


def _roadmap_item(name: str) -> str:
    if name in _RECURRENT or name.startswith("cnn"):
        return "item 19 (recurrent models)"
    if name in ("neuralcde-l", "neuralcde-r"):
        return "items 3 and 17 (linear and rectilinear controls)"
    if name.startswith("neuralrde") or name in ("ancde", "exit", "leap"):
        return "item 18 (log-signature and attention CDEs)"
    if name.startswith("latentsde"):
        return "item 20 (LatentSDE)"
    if name in ("sand", "mtan", "miam") or name.split("_")[0] in (
            "neuralflow", "neuralflowcde", "neuralmixture",
            "neuralcontrolledflow"):
        return "item 21 (attention and flows)"
    return "item 14 (NeuralSDEStream and the scalar-noise SDEs)"


class SeqLayer(nn.Module):
    """The dispatcher. forward(seq [N, 3, L, D], coeffs) -> (out [N, L, H],
    hidden [N, L, H])."""

    def __init__(self, inner: nn.Module, model_name: str):
        super().__init__()
        self.inner, self.model_name = inner, model_name

    def forward(self, seq, coeffs, *,
                generator: Optional[torch.Generator] = None,
                use_fused: bool = True):
        """`generator` draws SeqRNN's inter-layer dropout in training."""
        name = self.model_name
        x, mask, delta = seq[:, 0], seq[:, 1], seq[:, 2]
        if name in ("rnn", "gru", "lstm", "bilstm"):
            return self.inner(x, generator=generator, use_fused=use_fused)
        if name == "gru-simple":
            return self.inner(torch.cat([x, mask, delta], dim=-1),
                              generator=generator, use_fused=use_fused)
        if name == "grud":
            hn = self.inner(x, mask, delta, use_fused=use_fused)
            return hn, hn
        # the CDE names: a NeuralCDEStream over the cubic coefficients
        times = np.linspace(0.0, 1.0, seq.shape[2]).astype(np.float32)
        return self.inner(times, coeffs, use_fused=use_fused)


def make_seq_layer(model_name: str, input_dim: int, seq_len: int,
                   hidden_dim: int, hidden_hidden_dim: Optional[int] = None,
                   num_layers: int = 1, num_hidden_layers: int = 1,
                   method: Optional[str] = None, dropout: float = 0.1, *,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> SeqLayer:
    """A SeqLayer for a registry name; coefficient channels = 1 + D (time
    ‖ values). `neuralcde` is NeuralCDEStream(FinalTanh, rk4 unless
    `method` says otherwise); `gru-ode` is NeuralCDEStream(GRUODEField,
    rk4); `rnn`/`gru`/`lstm` are SeqRNN of that kind, `bilstm` a
    bidirectional LSTM of hidden // 2 per direction, `gru-simple` a GRU over
    3D channels, each with `num_layers` layers and inter-layer `dropout`
    (snsde/registry.py:307-320); `grud` is GRUDFull."""
    if model_name not in MODEL_NAMES:
        raise NotImplementedError(f"unknown model name {model_name!r}")
    if model_name not in PORTED_NAMES:
        raise NotImplementedError(
            f"{model_name}: not ported yet (ROADMAP Queue 1 "
            f"{_roadmap_item(model_name)})")
    hh = hidden_hidden_dim or hidden_dim
    coeff_dim = input_dim + 1
    kw = dict(generator=generator, device=device)
    rnn = dict(num_layers=num_layers, dropout=dropout, **kw)
    if model_name in ("rnn", "gru", "lstm"):
        inner = SeqRNN(input_dim, hidden_dim, hidden_dim, model_name, **rnn)
    elif model_name == "bilstm":
        inner = SeqRNN(input_dim, hidden_dim, hidden_dim, "lstm",
                       bidirectional=True,
                       hidden_per_dir=max(hidden_dim // 2, 1), **rnn)
    elif model_name == "gru-simple":
        inner = SeqRNN(3 * input_dim, hidden_dim, hidden_dim, "gru", **rnn)
    elif model_name == "grud":
        inner = GRUDFull(input_dim, hidden_dim, **kw)
    elif model_name == "gru-ode":
        field = GRUODEField(coeff_dim, hidden_dim, **kw)
        inner = NeuralCDEStream(field, coeff_dim, hidden_dim, hidden_dim,
                                **kw)
    else:
        # neuralcde -> natural, -c -> cubic (torchcde's natural cubic, the
        # same spline family), -h -> hermite; all evaluate via CubicPath
        control = {"": "natural", "-c": "cubic",
                   "-h": "hermite"}[model_name[9:]]
        field = FinalTanh(coeff_dim, hidden_dim, hh, num_hidden_layers, **kw)
        inner = NeuralCDEStream(field, coeff_dim, hidden_dim, hidden_dim,
                                control=control, method=method or "rk4",
                                **kw)
    return SeqLayer(inner, model_name)
