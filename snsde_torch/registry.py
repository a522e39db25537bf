"""Unified model registry (counterpart of snsde/registry.py:58-446): every
name of `MODEL_NAMES`.

`SeqLayer` normalises a model to (out_stream [N, L, H], hidden_stream)
from the stacked seq [N, 3, L, D] (values, mask, delta) and packed spline
coefficients over (time ‖ values), with times linspace(0, 1, L); the
LatentSDE names and `leap` add an auxiliary loss as a third output. The
families: the 140 `neuralsde_{i}_{jj}` (a DiffusionField in a
NeuralSDEStream, srk unless told otherwise: the fused SRK kernels on the
card), `neuralsde-x/y/z` (the scalar-noise SDE, euler through the eager
solver, as the JAX package solves it), `latentsde`/`latentsde-kl` (the
latent mode of the fused EM kernels); the Neural CDEs `neuralcde`,
`neuralcde-c/-h` (cubic controls), `neuralcde-l/-r` (linear and
rectilinear), `gru-ode`, `neuralrde-1/2/3` (over log-signature windows),
`ancde`, `exit` and `leap`, and the flow families `neuralflowcde`,
`neuralmixture` and `neuralcontrolledflow` (the fused CDE kernels on the
card); `neuralflow_*` (no solver); the recurrent baselines `rnn`, `gru`,
`lstm`, `bilstm`, `gru-simple`, `grud`, the ODE-RNN hybrids `gru-dt`,
`gru-d`, `ode-rnn`, `ode-lstm`, the time-aware LSTMs `tlstm`, `plstm`,
`tglstm` and `mtan` (its bidirectional GRU) on the GRU and LSTM kernels;
and `cnn`, `cnn-3/5/7`, `transformer`, `sand` and `miam` (no kernel, as in
JAX). The SDE names draw their Brownian paths, `sand`, `miam` and the
stacked SeqRNNs their dropout masks, and `exit`, `leap` and `mtan` their
probe or sample noise from the generator the caller passes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .fields import DiffusionField
from .models.ancde import ANCDE, EXIT, LEAP, NeuralRDE, probe
from .models.attn import MIAMLayer, SAnDLayer
from .models.flows import (NeuralControlledFlow, NeuralFlow, NeuralFlowCDE,
                           NeuralMixture)
from .models.latent_sde import LatentSDE
from .models.mtan import MTANEncoder
from .models.neuralcde import FinalTanh, GRUODEField, NeuralCDEStream
from .models.neuralsde import NeuralSDEStream, resolve_dt
from .models.rnn import GRUD, ODERNN, GRUdt, SeqCNN, SeqRNN, SeqTransformer
from .models.time_rnn import ODELSTM, PLSTM, TGLSTM, TLSTM, GRUDFull
from .nn.layers import make_linear
from .ops.interp import CubicPath, fill_missing_linear, rectilinear_coeffs
from .ops.solve import sdeint

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
_SCALAR_SDE = ("neuralsde-x", "neuralsde-y", "neuralsde-z")
_LATENT = ("latentsde", "latentsde-kl")
_OBS_GRU = ("gru-dt", "gru-d", "ode-rnn")
_TIME_LSTM = {"tlstm": TLSTM, "plstm": PLSTM, "tglstm": TGLSTM}
_CONV_ATTN = ("cnn", "cnn-3", "cnn-5", "cnn-7", "transformer")
_LINEAR_CDE = ("neuralcde-l", "neuralcde-r")
_FLOWS = {"neuralflowcde": NeuralFlowCDE, "neuralmixture": NeuralMixture,
          "neuralcontrolledflow": NeuralControlledFlow}
PORTED_NAMES = tuple(MODEL_NAMES)


class _MTANStream(nn.Module):
    """mTAN_layer: the encoder on the grid linspace(0, 1, seq_len) (embed
    time 16, learned embedding) -> (mu, logvar) -> the reparameterised
    sample z = mu + eps exp(logvar / 2) -> (head(z), z). eps comes from the
    caller's generator (one seeded 0 without), or through `eps=`."""

    def __init__(self, input_dim: int, hidden_dim: int, seq_len: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.enc = MTANEncoder(input_dim, torch.linspace(0.0, 1.0, seq_len),
                               latent_dim=hidden_dim, nhidden=hidden_dim,
                               embed_time=16, learn_emb=True, **kw)
        self.head = make_linear(hidden_dim, hidden_dim, **kw)

    def forward(self, x, mask, seq_ts, *, generator=None, eps=None,
                use_fused: bool = True):
        out = self.enc(torch.cat([x, mask], dim=-1), seq_ts,
                       use_fused=use_fused)             # [B, L, 2 latent]
        mu, logvar = out.chunk(2, dim=-1)
        if eps is None:
            eps = probe(mu.shape, mu, generator)
        z = mu + eps * torch.exp(0.5 * logvar)
        return self.head(z), z


class _ScalarNoiseSDE(nn.Module):
    """`neuralsde-x/y/z`: the deprecated scalar-noise SDE (the JAX
    package's snsde/registry.py:87-140, the reference's nsde_model.py:
    87-144). Drift input by option: x the control, y the state, z both
    (through emb); a scalar learned noise tanh(exp(sigma)). Solved by the
    eager sdeint (euler), as in the JAX package: no kernel takes it.

    forward(coeffs, times) -> (readout(z) [B, L, H], z [B, L, H])."""

    def __init__(self, input_channels: int, hidden_channels: int,
                 option: str, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        H = hidden_channels
        lin = lambda i, o: make_linear(i, o, generator=generator,
                                       device=device)
        self.initial_network = lin(input_channels, H)
        self.linear_in = lin(H, H)
        self.linear_out = lin(H, H)
        self.emb = lin(2 * H, H)
        self.readout = lin(H, H)
        self.sigma = nn.Parameter(torch.zeros(1, device=device))
        self.option = option
        self.method = "euler"

    def forward(self, coeffs, times, *, generator=None, bm=None):
        path = CubicPath(coeffs, times)
        y0 = self.initial_network(path.evaluate(path.times[0]))

        def f(t, y):
            xt = self.initial_network(path.evaluate(t))
            yy = self.linear_in(y)
            if self.option == "x":
                z = xt
            elif self.option == "y":
                z = yy
            else:
                z = self.emb(torch.cat([yy, xt], dim=-1))
            return torch.tanh(self.linear_out(torch.relu(z)))

        def g(t, y):
            return torch.tanh(torch.exp(self.sigma)).expand(y.shape)

        zs = sdeint(f, g, y0, times, generator=generator, bm=bm,
                    dt=resolve_dt(times), method=self.method)
        z = zs.movedim(0, 1)
        return self.readout(z), z


class SeqLayer(nn.Module):
    """The dispatcher. forward(seq [N, 3, L, D], coeffs) -> (out [N, L, H],
    hidden [N, L, H]), and for the LatentSDE names (out, latent [N, L,
    H-1], its KL term logqp) and `leap` (out, hn, its divergence term) as
    the JAX layer's (out, hn, aux). `in_proj`
    (the values -> hidden Linear of ode-lstm and the time-aware LSTMs) is
    the JAX layer's, None for the other names."""

    def __init__(self, inner: nn.Module, model_name: str,
                 in_proj: Optional[nn.Module] = None):
        super().__init__()
        self.inner, self.model_name = inner, model_name
        self.in_proj = in_proj

    def forward(self, seq, coeffs, *,
                generator: Optional[torch.Generator] = None,
                use_fused: bool = True, eps=None):
        """`generator` draws SeqRNN's, SAnD's and MIAM's dropout in
        training, the SDE names' Brownian paths (those refuse to run
        without it), and the probe of `exit` and `leap` and the sample
        noise of `mtan`; `eps` passes that probe or noise in instead."""
        name = self.model_name
        x, mask, delta = seq[:, 0], seq[:, 1], seq[:, 2]
        times = np.linspace(0.0, 1.0, seq.shape[2]).astype(np.float32)
        noise = dict(generator=generator, eps=eps)
        if name == "mtan":
            return self.inner(x, mask, self._seq_ts(x, times), **noise,
                              use_fused=use_fused)
        if name == "sand":
            return self.inner(x, generator=generator)
        if name == "miam":
            return self.inner(x, mask, delta, self._seq_ts(x, times),
                              generator=generator)
        if name in ("exit", "leap"):
            return self.inner(times, coeffs, **noise, use_fused=use_fused)
        if name == "ancde":
            return self.inner(times, coeffs, use_fused=use_fused)
        if name.startswith("neuralrde"):
            return self._neuralrde(x, times, use_fused)
        if name.split("_")[0] in ("neuralflow", *_FLOWS):
            return self.inner(x, self._seq_ts(x, times), mask, coeffs,
                              times, use_fused=use_fused)
        if name.startswith("neuralsde_"):
            return self.inner(times, coeffs, generator=generator,
                              use_fused=use_fused)
        if name in _SCALAR_SDE:
            return self.inner(coeffs, times, generator=generator)
        if name in _LATENT:
            return self.inner(coeffs, times, generator=generator,
                              use_fused=use_fused)
        if name in ("rnn", "gru", "lstm", "bilstm"):
            return self.inner(x, generator=generator, use_fused=use_fused)
        if name in _CONV_ATTN:
            return self.inner(x)
        if name == "gru-simple":
            return self.inner(torch.cat([x, mask, delta], dim=-1),
                              generator=generator, use_fused=use_fused)
        if name == "grud":
            hn = self.inner(x, mask, delta, use_fused=use_fused)
            return hn, hn
        if name == "ode-lstm":
            hn = self.inner(self.in_proj(x), delta[..., 0],
                            use_fused=use_fused)
            return hn, hn
        if name in _TIME_LSTM:
            # the elapsed times of the first channel; plstm's absolute
            # times are the grid's (snsde/registry.py:205-209)
            ts = (torch.as_tensor(times, device=x.device).expand(
                x.shape[0], -1) if name == "plstm" else delta[..., 0])
            hn = self.inner(self.in_proj(x), ts, use_fused=use_fused)[0]
            return hn, hn
        if name in _OBS_GRU:
            # stream=True: the readout of every step (the final index is
            # then unused)
            return self.inner(times, coeffs, stream=True,
                              use_fused=use_fused)
        if name in _LINEAR_CDE:
            return self._linear_cde(x, times, use_fused)
        # the CDE names: a NeuralCDEStream over the cubic coefficients
        return self.inner(times, coeffs, use_fused=use_fused)

    @staticmethod
    def _seq_ts(x, times):
        """The grid's times for every row: [N, L]."""
        return torch.as_tensor(times, device=x.device).expand(x.shape[0], -1)

    def _neuralrde(self, x, times, use_fused):
        """`neuralrde-*` over (time ‖ x); the log-signature windows shrink
        the time axis, so each output step is repeated ceil(L / steps)
        times and the streams cut to L (snsde/registry.py:255-265)."""
        L = x.shape[1]
        tcol = self._seq_ts(x, times)[..., None]
        out, hn = self.inner(torch.cat([tcol, x], dim=-1), times,
                             use_fused=use_fused)
        reps = -(-L // out.shape[1])
        return (out.repeat_interleave(reps, dim=1)[:, :L],
                hn.repeat_interleave(reps, dim=1)[:, :L])

    def _linear_cde(self, x, times, use_fused):
        """`neuralcde-l`/`-r` (snsde/registry.py:216-233): knot values
        (time ‖ x) filled by fill_missing_linear, not the cubic
        coefficients; `-l` steps on the grid's times, `-r` on the
        rectilinear knots' index 0..2L-2 (its vertical moves have no finite
        slope in real time), sample k at knot 2k, so the even steps are
        kept."""
        tt = torch.as_tensor(times, dtype=x.dtype, device=x.device)
        tcol = tt[None, :, None].expand(x.shape[0], -1, 1)
        vals = fill_missing_linear(tt, torch.cat([tcol, x], dim=-1))
        if self.model_name == "neuralcde-l":
            return self.inner(times, vals, use_fused=use_fused)
        _, vals = rectilinear_coeffs(tt, vals)
        knots = np.arange(2 * x.shape[1] - 1, dtype=np.float32)
        out, hn = self.inner(knots, vals, use_fused=use_fused)
        return out[:, 0::2], hn[:, 0::2]


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
    (snsde/registry.py:307-320); `grud` is GRUDFull; `gru-dt`, `gru-d` and
    `ode-rnn` are GRUdt, GRUD and ODERNN(hh, num_hidden_layers) over the
    largest odd width of the coefficient channels (the JAX registry's rule,
    snsde/registry.py:369-386); `ode-lstm` is ODELSTM(H, H, solver `method`
    or euler) behind a Linear in_proj of the values
    (snsde/registry.py:332-335), `tlstm`, `plstm` and `tglstm` TLSTM, PLSTM
    and TGLSTM(H, H, num_layers) behind one too (:323-331); `cnn` (kernel
    3) and `cnn-k` SeqCNN of depth max(num_layers, 1), `transformer`
    SeqTransformer(num_layers) with 4 heads when hidden % 4 == 0, else 1
    (:303-305, :336-339); `neuralsde_{i}_{jj}`
    is NeuralSDEStream(DiffusionField(coeff_dim, H, hh, num_hidden_layers,
    i, jj), srk unless `method` says otherwise), `neuralcde-l`/`-r`
    NeuralCDEStream(FinalTanh) on the linear control, rk4 unless `method`
    says otherwise (:389-402), `neuralsde-x/y/z` the
    scalar-noise SDE and `latentsde`/`latentsde-kl` LatentSDE(coeff_dim, H,
    hh, num_hidden_layers), euler unless `method` says otherwise
    (snsde/registry.py:402-410, 429-440); `mtan` the mTAN encoder stream
    (hidden latent and width, embed time 16, a learned embedding), `sand`
    SAnDLayer(num_layers blocks) and `miam` MIAMLayer (:340-345); `ancde`,
    `exit`, `leap` ANCDE, EXIT and LEAP(coeff_dim, H, H, hh,
    num_hidden_layers) and `neuralrde-k` NeuralRDE of depth k over windows
    of 4, rk4 unless `method` says otherwise (:346-367); `neuralflow_{io}_
    {fo}` NeuralFlow(coeff_dim, H, num_hidden_layers, H) and the three
    other flow families their class around one FinalTanh(coeff_dim, H, hh,
    num_hidden_layers), with input option io and flow option fo (:410-428;
    the JAX registry builds neuralflowcde's FinalTanh twice from one key,
    the port once)."""
    if model_name not in MODEL_NAMES:
        raise NotImplementedError(f"unknown model name {model_name!r}")
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
    elif model_name in _OBS_GRU:
        # the observation GRUs declare the odd [t ‖ K intensities ‖ K
        # values] width (the reference asserts it, other.py:18-20): the
        # largest odd one, the extra channel of an even stream ignored
        ic = coeff_dim if coeff_dim % 2 == 1 else coeff_dim - 1
        if model_name == "ode-rnn":
            inner = ODERNN(ic, hidden_dim, hidden_dim, hh, num_hidden_layers,
                           **kw)
        else:
            inner = (GRUdt if model_name == "gru-dt" else GRUD)(
                ic, hidden_dim, hidden_dim, **kw)
    elif model_name in ("ode-lstm", *_TIME_LSTM):
        inner = (ODELSTM(hidden_dim, hidden_dim, solver=method or "euler",
                         **kw) if model_name == "ode-lstm" else
                 _TIME_LSTM[model_name](hidden_dim, hidden_dim, num_layers,
                                        **kw))
        return SeqLayer(inner, model_name,
                        in_proj=make_linear(input_dim, hidden_dim, **kw))
    elif model_name.startswith("cnn"):
        k = int(model_name.split("-")[1]) if "-" in model_name else 3
        inner = SeqCNN(input_dim, hidden_dim, hidden_dim, kernel_size=k,
                       depth=max(num_layers, 1), **kw)
    elif model_name == "transformer":
        inner = SeqTransformer(input_dim, hidden_dim, hidden_dim,
                               num_heads=4 if hidden_dim % 4 == 0 else 1,
                               num_layers=num_layers, **kw)
    elif model_name in _SCALAR_SDE:
        inner = _ScalarNoiseSDE(coeff_dim, hidden_dim, model_name[-1], **kw)
    elif model_name in _LATENT:
        inner = LatentSDE(coeff_dim, hidden_dim, hh, num_hidden_layers,
                          method=method or "euler", **kw)
    elif model_name.startswith("neuralsde_"):
        _, io, no = model_name.split("_")
        field = DiffusionField(coeff_dim, hidden_dim, hh, num_hidden_layers,
                               input_option=int(io), noise_option=int(no),
                               **kw)
        # the reference's torch-ists stream solves with srk unless told
        # otherwise (diff_module/NSDE/nsde_model.py:67)
        inner = NeuralSDEStream(field, coeff_dim, hidden_dim, hidden_dim,
                                method=method or "srk", **kw)
    elif model_name == "mtan":
        inner = _MTANStream(input_dim, hidden_dim, seq_len, **kw)
    elif model_name == "sand":
        inner = SAnDLayer(input_dim, seq_len, hidden_dim,
                          n_layers=num_layers, **kw)
    elif model_name == "miam":
        inner = MIAMLayer(input_dim, hidden_dim, seq_len,
                          n_layers=num_layers, **kw)
    elif model_name in ("ancde", "exit", "leap"):
        inner = {"ancde": ANCDE, "exit": EXIT, "leap": LEAP}[model_name](
            coeff_dim, hidden_dim, hidden_dim, hidden_hidden=hh,
            num_hidden_layers=num_hidden_layers, method=method or "rk4",
            **kw)
    elif model_name.startswith("neuralrde"):
        inner = NeuralRDE(coeff_dim, hidden_dim, hidden_dim,
                          depth=int(model_name[-1]), window=4,
                          hidden_hidden=hh,
                          num_hidden_layers=num_hidden_layers,
                          method=method or "rk4", **kw)
    elif model_name.startswith("neuralflow_"):
        _, io, fo = model_name.split("_")
        inner = NeuralFlow(coeff_dim, hidden_dim, num_hidden_layers,
                           hidden_dim, input_option=io, flow_option=fo, **kw)
    elif model_name.split("_")[0] in _FLOWS:
        fam, io, fo = model_name.split("_")
        field = FinalTanh(coeff_dim, hidden_dim, hh, num_hidden_layers, **kw)
        inner = _FLOWS[fam](field, coeff_dim, hidden_dim, num_hidden_layers,
                            hidden_dim, input_option=io, flow_option=fo,
                            **kw)
    elif model_name == "gru-ode":
        field = GRUODEField(coeff_dim, hidden_dim, **kw)
        inner = NeuralCDEStream(field, coeff_dim, hidden_dim, hidden_dim,
                                **kw)
    else:
        # neuralcde -> natural, -c -> cubic (torchcde's natural cubic, the
        # same spline family), -h -> hermite, all through CubicPath; -l and
        # -r through LinearPath
        control = {"": "natural", "-c": "cubic", "-h": "hermite",
                   "-l": "linear", "-r": "linear"}[model_name[9:]]
        field = FinalTanh(coeff_dim, hidden_dim, hh, num_hidden_layers, **kw)
        inner = NeuralCDEStream(field, coeff_dim, hidden_dim, hidden_dim,
                                control=control, method=method or "rk4",
                                **kw)
    return SeqLayer(inner, model_name)
