"""Fused GRU and LSTM recurrences: hand-written CUDA kernels for Hopper
(snsde_torch/csrc/fused_rnn.cu), a forward and a backward behind each of two
`torch.autograd.Function`s; each backward is two kernels, the reverse
recurrence and the weight-gradient product after it (one product kernel,
shared by both pairs).

Replaces the Pallas TPU kernels of snsde/kernels/fused_rnn.py — the GRU's
`_fused_gru` (pallas_call at :312) and `_fused_gru_bwd` (:396), the LSTM's
`_lstm_forward` (:837) and `_fused_lstm_bwd` (:934) — in the modes the
plain recurrent baselines (`SeqRNN`) and GRUD-full use: the GRU from any
h0, with or without the per-sample hidden-decay stream hdec [L, B, H], and
the LSTM from zero (h, c), in both directions; in the modes of the
ODE-RNN hybrids: the GRU's observation mask `obs` [L, B] (GRU-dt), with a
time-only decay row hdec [L, H] (GRU-D) or with the in-kernel Euler MLP
evolve before the cell (ODE-RNN; `Evolve`), and the LSTM's evolve of h
after the cell with a per-row step (ODE-LSTM); and in the modes of the
time-aware LSTMs: PLSTM's phased openness `sel` [L, B, H], TGLSTM's gate
modifiers `tg` [L, B, 3H] and TLSTM's memory decomposition (`Decomp`: W_d,
b_d and the elapsed times tel [L, B]). Mode combinations no JAX caller
reaches raise NotImplementedError; they never fall back to an eager loop.

The JAX kernels' reduced precisions (snsde/kernels/fused_rnn.py's
traj_bf16 and mm_bf16, read from SNSDE_FUSED_STREAM and SNSDE_FUSED_MATMUL
at :452-456, :506-507, :991-995, :1042-1043) are the modes `stream` and
`matmul` of every kernel, the reduced instances of the same templates
(runtime arguments of them): with bf16 streams gi, the LSTM's sel, tg, tel
and evolve steps come in bf16, the carries stay fp32 and only the written
hs (and the LSTM's cs) is rounded; the backward reads the rounded
trajectory (the GRU's h0 rounded too), ghs in bf16, and writes dgi, dsel
and dtg in bf16, W_hh's weight gradient taking the fp32 gate cotangents;
bf16 or bf16x3 operands in every in-kernel product (h W_hh and its
transpose, the evolve's layers, TLSTM's c W_d, the weight gradients),
accumulating in fp32 (_solver.mm_op). The decays, the GRU's evolve steps
and obs stay fp32 (obs is 0 or 1 either way). The scans take
`stream_dtype=` and `matmul=`, None resolving from the environment as the
JAX scans do (`_solver.resolve_precision`).

The input projection gi = xs @ w_ih + b_ih is computed outside the kernels
as one `torch.matmul`, as JAX computes it outside its `pallas_call`s; its
gradient and the chain to xs ride autograd. A bidirectional layer flips its
streams outside the kernels. When no backward will run (grad mode off, or
nothing that needs a gradient), the LSTM forward writes no cell-state
stream, as the JAX inference-only primal does (`fused_rnn.py:853-860`).

What bounds the kernels on the H100, and the design, are described in the
CUDA source. Each kernel has a plain PyTorch version beside it with the
same inputs and outputs. The `fused_{gru,lstm}_{forward,backward}`
wrappers take the plain versions only for tensors on the CPU; for CUDA
tensors they launch the kernel or raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ._solver import (SolverLib, bf16_round, check_tensors, count_precision,
                      mm_op, precision_counts, precision_ints,
                      resolve_precision, widen)

__all__ = ["fused_gru_scan", "fused_lstm_scan", "supports_fused_gru",
           "supports_fused_lstm", "FusedGRU", "FusedLSTM", "Evolve", "Decomp",
           "pack_mlp", "mlp_layers", "fused_mlp_weight_grads",
           "fused_mlp_weight_grads_reference", "force_rnn_plan",
           "fused_gru_forward", "fused_gru_backward",
           "fused_gru_forward_reference", "fused_gru_backward_reference",
           "fused_gru_backward_recurrence", "fused_gru_weight_grads",
           "fused_gru_weight_grads_reference", "fused_gru_plan",
           "fused_lstm_forward", "fused_lstm_backward",
           "fused_lstm_forward_reference", "fused_lstm_backward_reference",
           "fused_lstm_backward_recurrence", "fused_lstm_weight_grads",
           "fused_lstm_weight_grads_reference", "fused_lstm_wd_grads",
           "fused_lstm_plan", "FusedGRUGrads", "FusedLSTMGrads",
           "GRURecurrence", "LSTMRecurrence", "MAX_H", "PRECISION_LAUNCHES"]

# launches of each CUDA kernel since the count was last set to 0
GRU_FWD_LAUNCHES = 0
GRU_BWD_LAUNCHES = 0
GRU_WGRAD_LAUNCHES = 0
LSTM_FWD_LAUNCHES = 0
LSTM_BWD_LAUNCHES = 0
LSTM_WGRAD_LAUNCHES = 0
# the modes' instances, counted apart from the plain ones: the GRU's obs
# (mode 1), obs + row decay (2) and obs + evolve (3), the LSTM's evolve
GRU_OBS_FWD_LAUNCHES = 0
GRU_OBS_BWD_LAUNCHES = 0
GRU_DEC1_FWD_LAUNCHES = 0
GRU_DEC1_BWD_LAUNCHES = 0
GRU_ODE_FWD_LAUNCHES = 0
GRU_ODE_BWD_LAUNCHES = 0
LSTM_ODE_FWD_LAUNCHES = 0
LSTM_ODE_BWD_LAUNCHES = 0
# the time-aware LSTMs' modes: PLSTM's sel (mode 2), TGLSTM's tg (3), TLSTM
# (4), and TLSTM's W_d gradient (the weight-gradient kernel on c and dzd)
LSTM_SEL_FWD_LAUNCHES = 0
LSTM_SEL_BWD_LAUNCHES = 0
LSTM_TG_FWD_LAUNCHES = 0
LSTM_TG_BWD_LAUNCHES = 0
LSTM_TLSTM_FWD_LAUNCHES = 0
LSTM_TLSTM_BWD_LAUNCHES = 0
LSTM_WD_WGRAD_LAUNCHES = 0
# the evolve's weight-gradient kernel, which both pairs' backwards feed
MLP_WGRAD_LAUNCHES = 0
# every counter above counts a launch in any precision; the reduced
# instances' launches by precision, keyed "<kernel> <operand mode> <stream
# dtype>", the kernel a mode's instance (gru_fwd, gru_obs_bwd, lstm_tg_fwd,
# ...) or a weight gradient
PRECISION_LAUNCHES = precision_counts(
    [f"{pair}{m}_{part}" for pair, modes in
     (("gru", ("", "_obs", "_dec1", "_ode")),
      ("lstm", ("", "_ode", "_sel", "_tg", "_tlstm")))
     for m in modes for part in ("fwd", "bwd")]
    + ["gru_wgrad", "lstm_wgrad", "lstm_wd_wgrad", "mlp_wgrad"])

# the JAX package's width limit (snsde/kernels/fused_rnn.py:46); the CUDA
# kernels take every H up to it
MAX_H = 512


def _supports(cell, gates: int) -> bool:
    w_hh = getattr(cell, "w_hh", None)
    if w_hh is None or getattr(cell, "w_ih", None) is None:
        return False
    H = w_hh.shape[0]
    return w_hh.shape[1] == gates * H and H <= MAX_H


def supports_fused_gru(cell) -> bool:
    """True for GRUCell-shaped cells (w_ih/w_hh/b_ih/b_hh, torch (r, z, n)
    gate layout) with H <= MAX_H."""
    return _supports(cell, 3)


def supports_fused_lstm(cell) -> bool:
    """True for LSTMCell-shaped cells (torch (i, f, g, o)) with H <= MAX_H."""
    return _supports(cell, 4)


class Evolve(NamedTuple):
    """The in-kernel Euler MLP evolve (ODE-RNN before the GRU's cell,
    ODE-LSTM after the LSTM's): `steps` substeps x += dt f(x), f an MLP of
    n layers H -> hh -> ... -> hh -> H (H -> H when n = 1), tanh on the
    inner layers, its weights packed by pack_mlp."""
    mlp: torch.Tensor                    # [W_0 (in x out), b_0, W_1, ...]
    dts: torch.Tensor                    # substep sizes: [L] GRU, [L, B] LSTM
    n: int
    hh: int
    steps: int


class Decomp(NamedTuple):
    """TLSTM's memory decomposition: before each step the short-term part
    of the cell state, tanh(c W_d + b_d), is rescaled by the step's elapsed
    time, c_adj = c - c_short + c_short tel, and the gates (f, i, o, a
    sigmoid candidate) update c_adj."""
    wd: torch.Tensor                     # [H, H] (in x out)
    bd: torch.Tensor                     # [H]
    tel: torch.Tensor                    # [L, B] elapsed times, data


class FusedGRUGrads(NamedTuple):
    """Cotangents of the fused GRU's inputs (split partials summed); None
    for a mode input the call did not have."""
    dgi: torch.Tensor                    # [L, B, 3H]
    dh0: torch.Tensor                    # [B, H]
    dwhh: torch.Tensor                   # [H, 3H]
    dbhh: torch.Tensor                   # [3H]
    dhdec: Optional[torch.Tensor] = None  # [L, B, H]
    dhrow: Optional[torch.Tensor] = None  # [L, H]
    dmlp: Optional[torch.Tensor] = None   # the evolve's, packed as its mlp


class FusedLSTMGrads(NamedTuple):
    """Cotangents of the fused LSTM's inputs (split partials summed); None
    for a mode input the call did not have (tel is data: none)."""
    dgi: torch.Tensor                    # [L, B, 4H]
    dwhh: torch.Tensor                   # [H, 4H]
    dbhh: torch.Tensor                   # [4H]
    dmlp: Optional[torch.Tensor] = None   # the evolve's, packed as its mlp
    dsel: Optional[torch.Tensor] = None   # [L, B, H]
    dtg: Optional[torch.Tensor] = None    # [L, B, 3H]
    dwd: Optional[torch.Tensor] = None    # [H, H]
    dbd: Optional[torch.Tensor] = None    # [H]


# ---------------------------------------------------------------------------
# The evolve's MLP: packed weights, its layers, its substeps
# ---------------------------------------------------------------------------

def _mlp_dims(H: int, hh: int, n: int):
    """(in, out) of each layer: H -> hh ... hh -> H (H -> H when n = 1)."""
    return [(H if i == 0 else hh, H if i == n - 1 else hh) for i in range(n)]


def pack_mlp(layers) -> torch.Tensor:
    """The kernels' packed weights of a sequence of `nn.Linear`s: each
    layer's weight as [in, out] (the JAX layout), then its bias. Built with
    torch.cat, so gradients reach the layers."""
    return torch.cat([t for lin in layers
                      for t in (lin.weight.t().reshape(-1), lin.bias)])


def mlp_layers(mlp: torch.Tensor, H: int, hh: int, n: int):
    """[(W [in, out], b [out])] views of packed weights."""
    out, o = [], 0
    for i, j in _mlp_dims(H, hh, n):
        out.append((mlp[o:o + i * j].view(i, j), mlp[o + i * j:o + i * j + j]))
        o += i * j + j
    return out


def _mlp_f(x, layers, matmul="f32"):
    for w, b in layers[:-1]:
        x = torch.tanh(mm_op(x, w, matmul) + b)
    w, b = layers[-1]
    return mm_op(x, w, matmul) + b


def _evolve(h, layers, dt, steps, matmul="f32"):
    """(h after `steps` Euler substeps of size dt, the state before each)."""
    subs = []
    for _ in range(steps):
        subs.append(h)
        h = h + dt * _mlp_f(h, layers, matmul)
    return h, subs


def _stream_views(buf, K, widths):
    """Per-layer [K, width] views of a stream buffer laid out as the
    kernels write it (layer blocks in order)."""
    out, o = [], 0
    for w in widths:
        out.append(buf[o:o + K * w].view(K, w))
        o += K * w
    return out


def _evolve_back(dh, subs, layers, dt, acts, dzs, row, matmul="f32"):
    """Back through the substeps `subs` (in reverse): the cotangent of the
    state before them, writing each layer's input and output cotangent at
    stream rows row(s) of acts/dzs (per-layer [L S B, width] views)."""
    n = len(layers)
    for s in range(len(subs) - 1, -1, -1):
        xs = [subs[s]]
        for w, b in layers[:-1]:
            xs.append(torch.tanh(mm_op(xs[-1], w, matmul) + b))
        dz = dh * dt
        rows = row(s)
        for i in range(n - 1, -1, -1):
            acts[i][rows] = xs[i]
            dzs[i][rows] = dz
            dx = mm_op(dz, layers[i][0].T, matmul)
            if i > 0:
                dz = dx * (1.0 - xs[i] * xs[i])
        dh = dh + dx
    return dh


def _evolve_streams(ode: "Evolve", L, B, H, like):
    """Empty stream buffers (acts, dzs) of the evolve's backward and their
    per-layer views."""
    dims = _mlp_dims(H, ode.hh, ode.n)
    K = L * ode.steps * B
    acts = like.new_empty(K * sum(i for i, _ in dims))
    dzs = like.new_empty(K * sum(j for _, j in dims))
    return (acts, dzs, _stream_views(acts, K, [i for i, _ in dims]),
            _stream_views(dzs, K, [j for _, j in dims]))


def fused_mlp_weight_grads_reference(acts, dzs, L, B, H, ode: "Evolve", *,
                                     matmul: str = "f32"):
    """The evolve's weight gradients, packed as its mlp, from the
    backward's streams: layer i's dW = acts_i^T dzs_i, db = the sum of
    dzs_i over the K = L S B rows (one product a layer, as the kernel; its
    operands in operand mode `matmul`, fused_rnn.py:287, :292)."""
    dims = _mlp_dims(H, ode.hh, ode.n)
    K = L * ode.steps * B
    a = _stream_views(acts, K, [i for i, _ in dims])
    z = _stream_views(dzs, K, [j for _, j in dims])
    return torch.cat([t for x, d in zip(a, z)
                      for t in (mm_op(x.T, d, matmul).reshape(-1),
                                d.sum(0))])


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------
#
# Each takes the kernels' precision: `stream` 'bf16' (the JAX kernels'
# traj_bf16: the streams in bf16, the carries in the compute dtype, the
# written trajectories rounded, the backward recomputing from the rounded
# trajectory) and `matmul`, the operand mode of every product (mm_op); the
# defaults are exact fp32. The compute dtype is the weights' (float32, or
# float64 where a check runs the plain versions in it).

def _gru_cell(g, hin, whh, bhh, matmul="f32"):
    """One GRU step from the cell's input state hin [B, H] and the step's
    input row g [B, 3H]: (h', r, z, n, gh_n)."""
    H = hin.shape[1]
    gh = mm_op(hin, whh, matmul) + bhh
    r = torch.sigmoid(g[:, :H] + gh[:, :H])
    z = torch.sigmoid(g[:, H:2 * H] + gh[:, H:2 * H])
    ghn = gh[:, 2 * H:]
    n = torch.tanh(g[:, 2 * H:] + r * ghn)
    return (1.0 - z) * n + z * hin, r, z, n, ghn


def _gru_input(t, h, hdec, hrow, ode, layers, matmul="f32"):
    """(the cell's input state at step t from h before it, the evolve's
    substep states or None)."""
    if hdec is not None:
        return h * hdec[t], None
    if hrow is not None:
        return h * hrow[t], None
    if ode is not None:
        return _evolve(h, layers, ode.dts[t], ode.steps, matmul)
    return h, None


def fused_gru_forward_reference(gi, h0, whh, bhh, hdec=None, obs=None,
                                hrow=None, ode=None, *, stream: str = "f32",
                                matmul: str = "f32") -> torch.Tensor:
    """Eager GRU loop: hs [L, B, H] (h after each step) from gi [L, B, 3H]
    (the input projection with b_ih), h0 [B, H], W_hh [H, 3H], b_hh [3H]
    and the modes: the per-sample decay hdec [L, B, H] or the time-only
    row hrow [L, H] applied to the state before each step, or the Euler
    MLP evolve `ode` (Evolve, dts [L]); with obs [L, B] a step keeps the
    cell's update only where obs is 1 and passes its input state on where
    it is 0 (fused_rnn.py:95-106). With `stream` 'bf16' gi arrives in bf16,
    the carry stays in h0's dtype and hs, the written trajectory, is
    rounded (bf16, :321)."""
    gi = widen(gi, h0)
    layers = (mlp_layers(ode.mlp, h0.shape[1], ode.hh, ode.n)
              if ode is not None else None)
    h, hs = h0, []
    for t in range(gi.shape[0]):
        hin = _gru_input(t, h, hdec, hrow, ode, layers, matmul)[0]
        h = _gru_cell(gi[t], hin, whh, bhh, matmul)[0]
        if obs is not None:
            sel = obs[t][:, None]
            h = sel * h + (1.0 - sel) * hin
        hs.append(h)
    hs = torch.stack(hs)
    return hs.to(torch.bfloat16) if stream == "bf16" else hs


class GRURecurrence(NamedTuple):
    """What the GRU's reverse recurrence writes: dgi [L, B, 3H] = [dr, dz,
    dn], W_hh's cotangent dgh [L, B, 3H] = [dr, dz, dn r], dh0 [B, H],
    dhdec [L, B, H], dhrow [L, H], the cell's input states xin [L, B, H]
    (with hrow or the evolve), and the evolve's streams (acts, dzs: each
    layer's input and output cotangent, [L, S, B, width] blocks). With
    bf16 streams dgi is bf16, the rest in the compute dtype."""
    dgi: torch.Tensor
    dgh: torch.Tensor
    dh0: torch.Tensor
    dhdec: Optional[torch.Tensor] = None
    dhrow: Optional[torch.Tensor] = None
    xin: Optional[torch.Tensor] = None
    acts: Optional[torch.Tensor] = None
    dzs: Optional[torch.Tensor] = None


def _gru_reverse(gi, hs, ghs, h0, whh, bhh, hdec=None, obs=None, hrow=None,
                 ode=None, *, stream: str = "f32",
                 matmul: str = "f32") -> GRURecurrence:
    """The reverse loop of the GRU backward (the JAX `_bwd_kernel`'s):
    recompute the cell's input state (the decay, or the evolve's substeps)
    and the gates before each step, then back through the mask, the gates,
    W_hh and the decay or the evolve. With `stream` 'bf16' gi, hs and ghs
    arrive in bf16, the state before the first step is h0 rounded (:345)
    and dgi leaves in bf16 (:167)."""
    h0r = bf16_round(h0) if stream == "bf16" else h0
    gi, hs, ghs = widen(gi, h0), widen(hs, h0), widen(ghs, h0)
    L, B, H = hs.shape
    dgi, dgh = torch.empty_like(gi), torch.empty_like(gi)
    dhdec = torch.empty_like(hdec) if hdec is not None else None
    dhrow = torch.empty_like(hrow) if hrow is not None else None
    xin = (torch.empty_like(hs) if hrow is not None or ode is not None
           else None)
    layers = acts = dzs = None
    if ode is not None:
        layers = mlp_layers(ode.mlp, H, ode.hh, ode.n)
        acts, dzs, av, zv = _evolve_streams(ode, L, B, H, hs)
    gbar = torch.zeros_like(h0)
    for t in range(L - 1, -1, -1):
        gbar = gbar + ghs[t]
        h = h0r if t == 0 else hs[t - 1]
        hin, subs = _gru_input(t, h, hdec, hrow, ode, layers, matmul)
        _, r, z, n, ghn = _gru_cell(gi[t], hin, whh, bhh, matmul)
        dhn = gbar if obs is None else gbar * obs[t][:, None]
        dn_pre = dhn * (1.0 - z) * (1.0 - n * n)
        dr_pre = dn_pre * ghn * r * (1.0 - r)
        dz_pre = dhn * (hin - n) * z * (1.0 - z)
        dgh[t] = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=-1)
        dgi[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1)
        if obs is None:
            dhin = gbar * z + mm_op(dgh[t], whh.T, matmul)
        else:
            dhin = (dhn * z + gbar * (1.0 - obs[t][:, None])
                    + mm_op(dgh[t], whh.T, matmul))
        if xin is not None:
            xin[t] = hin
        if hdec is not None:
            dhdec[t] = dhin * h
            dhin = dhin * hdec[t]
        elif hrow is not None:
            dhrow[t] = (dhin * h).sum(0)
            dhin = dhin * hrow[t]
        elif ode is not None:
            dhin = _evolve_back(
                dhin, subs, layers, ode.dts[t], av, zv,
                lambda s, t=t: slice((t * ode.steps + s) * B,
                                     (t * ode.steps + s + 1) * B), matmul)
        gbar = dhin
    if stream == "bf16":
        dgi = dgi.to(torch.bfloat16)
    return GRURecurrence(dgi, dgh, gbar, dhdec, dhrow, xin, acts, dzs)


def fused_gru_weight_grads_reference(h0, hs, dgh, hdec=None, xin=None, *,
                                     matmul: str = "f32"):
    """(dW_hh [H, 3H], db_hh [3H]) from the cell's input states and W_hh's
    cotangent dgh [L, B, 3H]: the gates' h-part is x_t W_hh + b_hh with
    x_t = h_{t-1} hdec_t (h_{-1} = h0; no decay without hdec), or x_t =
    xin[t] where the backward wrote them (the row decay, the evolve), so
    dW_hh = sum_t x_t^T dgh_t and db_hh = sum dgh. One product over (step,
    row), as the weight-gradient kernel computes it, its operands in
    operand mode `matmul` (fused_rnn.py:168); h0 and hs the states the
    recurrence read (with bf16 streams the rounded h0 and hs, in bf16)."""
    H, G = hs.shape[-1], dgh.shape[-1]
    if xin is not None:
        x = xin
    else:
        x = torch.cat([widen(h0, dgh)[None], widen(hs, dgh)[:-1]])
        if hdec is not None:
            x = x * hdec
    d = dgh.reshape(-1, G)
    return mm_op(x.reshape(-1, H).T, d, matmul), d.sum(0)


def fused_gru_backward_reference(gi, hs, ghs, h0, whh, bhh, hdec=None,
                                 obs=None, hrow=None, ode=None, *,
                                 stream: str = "f32", matmul: str = "f32"):
    """FusedGRUGrads: the eager reverse loop mirroring the backward kernels
    (and the JAX `_bwd_kernel`), then the weight gradients from the cell's
    input states and dgh (fused_gru_weight_grads_reference) and, with the
    evolve, its layers' from their streams
    (fused_mlp_weight_grads_reference)."""
    rec = _gru_reverse(gi, hs, ghs, h0, whh, bhh, hdec, obs, hrow, ode,
                       stream=stream, matmul=matmul)
    h0r = bf16_round(h0) if stream == "bf16" else h0
    grads = fused_gru_weight_grads_reference(h0r, hs, rec.dgh, hdec, rec.xin,
                                             matmul=matmul)
    dmlp = (fused_mlp_weight_grads_reference(rec.acts, rec.dzs, *hs.shape,
                                             ode, matmul=matmul)
            if ode is not None else None)
    return FusedGRUGrads(rec.dgi, rec.dh0, *grads, rec.dhdec, rec.dhrow,
                         dmlp)


def _lstm_cell(g, h, c, whh, bhh, tg=None, dec=None, tel=None, matmul="f32"):
    """One cell evaluation from (h, c) before the step and the step's input
    row g: (h', c', (i, f, gg, o, extra)) in torch's gate order (i, f, g,
    o). With the modifiers tg [B, 3H] (TGLSTM) i, f and o are the raw
    sigmoids times their modifiers, extra the raw sigmoids; with the memory
    decomposition dec (TLSTM, tel [B] the step's elapsed times) the gates
    read (f, i, o, a sigmoid candidate gg) and update c_adj, extra =
    (c_short, c_adj) (snsde/kernels/fused_rnn.py:543-575)."""
    H = h.shape[1]
    a = g + mm_op(h, whh, matmul) + bhh
    if dec is not None:
        c_short = torch.tanh(mm_op(c, dec.wd, matmul) + dec.bd)
        c_adj = c - c_short + c_short * tel[:, None]
        f = torch.sigmoid(a[:, :H])
        i = torch.sigmoid(a[:, H:2 * H])
        o = torch.sigmoid(a[:, 2 * H:3 * H])
        gg = torch.sigmoid(a[:, 3 * H:])
        c2 = f * c_adj + i * gg
        return o * torch.tanh(c2), c2, (i, f, gg, o, (c_short, c_adj))
    i = torch.sigmoid(a[:, :H])
    f = torch.sigmoid(a[:, H:2 * H])
    gg = torch.tanh(a[:, 2 * H:3 * H])
    o = torch.sigmoid(a[:, 3 * H:])
    raw = None
    if tg is not None:
        raw = (i, f, o)
        i, f, o = i * tg[:, :H], f * tg[:, H:2 * H], o * tg[:, 2 * H:]
    c2 = f * c + i * gg
    return o * torch.tanh(c2), c2, (i, f, gg, o, raw)


def _lstm_step(t, gi, h, c, whh, bhh, sel, tg, dec, matmul="f32"):
    """(h, c) after step t of a mode (PLSTM's openness sel blends the cell's
    output with the state before it, both carries), and the cell's own
    (h', c', gates)."""
    h2, c2, gates = _lstm_cell(gi[t], h, c, whh, bhh,
                               tg[t] if tg is not None else None, dec,
                               dec.tel[t] if dec is not None else None,
                               matmul)
    if sel is None:
        return h2, c2, (h2, c2, gates)
    s = sel[t]
    return s * h2 + (1.0 - s) * h, s * c2 + (1.0 - s) * c, (h2, c2, gates)


def _lstm_streams(like, gi, sel, tg, dec, ode):
    """The LSTM's streams widened to like's dtype (gi, sel, tg, TLSTM's
    tel and the evolve's steps arrive in bf16 with bf16 streams)."""
    if dec is not None:
        dec = dec._replace(tel=widen(dec.tel, like))
    if ode is not None:
        ode = ode._replace(dts=widen(ode.dts, like))
    return widen(gi, like), widen(sel, like), widen(tg, like), dec, ode


def fused_lstm_forward_reference(gi, whh, bhh, save_cs: bool = True,
                                 ode=None, sel=None, tg=None, dec=None, *,
                                 stream: str = "f32", matmul: str = "f32"):
    """Eager LSTM loop from zero (h, c): (hs [L, B, H], cs [L, B, H],
    hcell), cs None when save_cs is False. With the evolve `ode` (Evolve,
    dts [L, B]) the cell's output h' is evolved after each step (hs holds
    the evolved h, the next cell's input; c passes through), and hcell
    [L, B, H] holds the cells' own h' (None without the evolve or without
    save_cs). The time-aware modes (one at a time): PLSTM's openness sel
    [L, B, H] (h = sel h' + (1 - sel) h, likewise c: hs and cs hold the
    blended states), TGLSTM's modifiers tg [L, B, 3H] of the i, f and o
    gates, TLSTM's memory decomposition dec (Decomp). With `stream` 'bf16'
    the streams arrive in bf16, the carries stay in the weights' dtype and
    hs and cs are rounded (bf16, :1057, :826), and hcell holds the cell's
    output at the rounded state (h and c before the step rounded), which
    is what the backward recomputes (:878-879) and goes back through."""
    gi, sel, tg, dec, ode = _lstm_streams(whh, gi, sel, tg, dec, ode)
    B, H = gi.shape[1], whh.shape[0]
    rounded = stream == "bf16"
    layers = (mlp_layers(ode.mlp, H, ode.hh, ode.n) if ode is not None
              else None)
    h = c = gi.new_zeros((B, H))
    hs, cs, hcell = [], [], []
    for t in range(gi.shape[0]):
        if ode is not None and save_cs and rounded:
            hcell.append(_lstm_step(t, gi, bf16_round(h), bf16_round(c), whh,
                                    bhh, sel, tg, dec, matmul)[0])
        h, c = _lstm_step(t, gi, h, c, whh, bhh, sel, tg, dec, matmul)[:2]
        if ode is not None:
            if not rounded:
                hcell.append(h)
            h = _evolve(h, layers, ode.dts[t][:, None], ode.steps,
                        matmul)[0]
        hs.append(h)
        cs.append(c)
    out = (torch.stack(hs), torch.stack(cs) if save_cs else None)
    if rounded:
        out = tuple(None if t is None else t.to(torch.bfloat16) for t in out)
    return (*out, torch.stack(hcell) if save_cs and ode is not None
            else None)


def fused_lstm_weight_grads_reference(hs, dg, *, matmul: str = "f32"):
    """(dW_hh [H, 4H], db_hh [4H]) from the hidden trajectory hs [L, B, H]
    (bf16 with bf16 streams: the states the recurrence read) and the fp32
    gate cotangents dg [L, B, 4H]: the gate pre-activation is gi + h W_hh +
    b_hh, so W_hh's cotangent is the gates' own, and dW_hh = sum_t h_{t-1}^T
    dg_t (h_{-1} = 0), db_hh = sum dg. One product over (step, row), as the
    weight-gradient kernel computes it, its operands in operand mode
    `matmul` (fused_rnn.py:692, :723). TLSTM's (dW_d, db_d) are the same
    product of the cell states cs and the cotangents dzd [L, B, H] of
    c_short's pre-activation c_{t-1} W_d + b_d (:696)."""
    H, G = hs.shape[-1], dg.shape[-1]
    x = widen(hs, dg)[:-1].reshape(-1, H)
    return (mm_op(x.T, dg[1:].reshape(-1, G), matmul),
            dg.reshape(-1, G).sum(0))


class LSTMRecurrence(NamedTuple):
    """What the LSTM's reverse recurrence writes: dgi [L, B, 4H] and, with
    the evolve, its streams (acts, dzs: each layer's input and output
    cotangent, [L, S, B, width] blocks); PLSTM's dsel [L, B, H], TGLSTM's
    dtg [L, B, 3H], and TLSTM's dzd [L, B, H] (the cotangent of c_short's
    pre-activation, which W_d's gradient takes). With bf16 streams dgi,
    dsel and dtg are bf16 and dgw holds the gate cotangents in the compute
    dtype, which W_hh's gradient takes (fused_rnn.py:723); else dgw is
    None and dgi is they."""
    dgi: torch.Tensor
    acts: Optional[torch.Tensor] = None
    dzs: Optional[torch.Tensor] = None
    dsel: Optional[torch.Tensor] = None
    dtg: Optional[torch.Tensor] = None
    dzd: Optional[torch.Tensor] = None
    dgw: Optional[torch.Tensor] = None


def _lstm_reverse(gi, hs, cs, ghs, whh, bhh, ode=None, hcell=None, sel=None,
                  tg=None, dec=None, *, stream: str = "f32",
                  matmul: str = "f32") -> LSTMRecurrence:
    """The reverse loop of the LSTM backward (the JAX `_lstm_bwd_kernel`'s,
    fused_rnn.py:616-728): recompute the cell from (h, c) before each step,
    then back through PLSTM's blend, the evolve (its substeps recomputed
    from the cell's output hcell[t], undone before the cell's backward),
    the gates (TGLSTM's modifiers, TLSTM's decomposition) and W_hh (and
    W_d). With `stream` 'bf16' gi, hs, cs, ghs and the mode's streams
    arrive in bf16 (the states before each step the rounded ones, :878-879)
    and dgi, dsel and dtg leave in bf16 (:691, :951, :953)."""
    gi, sel, tg, dec, ode = _lstm_streams(whh, gi, sel, tg, dec, ode)
    hs, cs, ghs = widen(hs, whh), widen(cs, whh), widen(ghs, whh)
    L, B, H = hs.shape
    dgi = torch.empty_like(gi)
    layers = acts = dzs = None
    if ode is not None:
        layers = mlp_layers(ode.mlp, H, ode.hh, ode.n)
        acts, dzs, av, zv = _evolve_streams(ode, L, B, H, hs)
    dsel = torch.empty_like(sel) if sel is not None else None
    dtg = torch.empty_like(tg) if tg is not None else None
    dzd = torch.empty_like(hs) if dec is not None else None
    zero = torch.zeros_like(hs[0])
    gh, gc = zero, zero
    for t in range(L - 1, -1, -1):
        gh = gh + ghs[t]
        if ode is not None:
            dt = ode.dts[t][:, None]
            subs = _evolve(hcell[t], layers, dt, ode.steps, matmul)[1]
            gh = _evolve_back(
                gh, subs, layers, dt, av, zv,
                lambda s, t=t: slice((t * ode.steps + s) * B,
                                     (t * ode.steps + s + 1) * B), matmul)
        h, c = (zero, zero) if t == 0 else (hs[t - 1], cs[t - 1])
        h2, c2, (i, f, gg, o, extra) = _lstm_step(t, gi, h, c, whh, bhh, sel,
                                                  tg, dec, matmul)[2]
        dh_carry = dc_carry = 0.0
        if sel is not None:
            # h = sel h' + (1 - sel) h (likewise c): sel's cotangent, and
            # the shares that pass the cell by
            s = sel[t]
            dsel[t] = gh * (h2 - h) + gc * (c2 - c)
            dh_carry, dc_carry = gh * (1.0 - s), gc * (1.0 - s)
            gh, gc = gh * s, gc * s
        tc = torch.tanh(c2)
        dc = gc + gh * o * (1.0 - tc * tc)
        if dec is not None:
            c_short, c_adj = extra
            dgates = torch.cat([dc * c_adj * f * (1.0 - f),
                                dc * gg * i * (1.0 - i),
                                gh * tc * o * (1.0 - o),
                                dc * i * gg * (1.0 - gg)], dim=-1)
            dc_adj = dc * f
            dzd[t] = (dc_adj * (dec.tel[t][:, None] - 1.0)
                      * (1.0 - c_short * c_short))
            gc = dc_adj + mm_op(dzd[t], dec.wd.T, matmul)
        elif tg is not None:
            si, sf, so = extra
            m = tg[t]
            di, df, do = dc * gg, dc * c, gh * tc
            dtg[t] = torch.cat([di * si, df * sf, do * so], dim=-1)
            dgates = torch.cat([di * m[:, :H] * si * (1.0 - si),
                                df * m[:, H:2 * H] * sf * (1.0 - sf),
                                dc * i * (1.0 - gg * gg),
                                do * m[:, 2 * H:] * so * (1.0 - so)], dim=-1)
            gc = dc * f
        else:
            dgates = torch.cat([dc * gg * i * (1.0 - i),
                                dc * c * f * (1.0 - f),
                                dc * i * (1.0 - gg * gg),
                                gh * tc * o * (1.0 - o)], dim=-1)
            gc = dc * f + dc_carry
        dgi[t] = dgates
        gh = mm_op(dgates, whh.T, matmul) + dh_carry
    if stream != "bf16":
        return LSTMRecurrence(dgi, acts, dzs, dsel, dtg, dzd)
    bf = lambda t: None if t is None else t.to(torch.bfloat16)
    return LSTMRecurrence(bf(dgi), acts, dzs, bf(dsel), bf(dtg), dzd, dgi)


def fused_lstm_backward_reference(gi, hs, cs, ghs, whh, bhh, ode=None,
                                  hcell=None, sel=None, tg=None, dec=None, *,
                                  stream: str = "f32", matmul: str = "f32"):
    """FusedLSTMGrads: the eager reverse loop mirroring the backward
    kernels (and the JAX `_lstm_bwd_kernel`): recompute the gates from
    (h, c) before each step (and, with the evolve, its substeps from
    hcell[t], gone back through first), then back through the cell and
    W_hh to dgi (and a mode's dsel, dtg or dzd); then the weight gradients
    from hs and the gate cotangents (fused_lstm_weight_grads_reference),
    TLSTM's W_d's from cs and dzd, and the evolve's from its streams."""
    rec = _lstm_reverse(gi, hs, cs, ghs, whh, bhh, ode, hcell, sel, tg, dec,
                        stream=stream, matmul=matmul)
    dmlp = (fused_mlp_weight_grads_reference(rec.acts, rec.dzs, *hs.shape,
                                             ode, matmul=matmul)
            if ode is not None else None)
    dwd = (fused_lstm_weight_grads_reference(cs, rec.dzd, matmul=matmul)
           if dec is not None else (None, None))
    dg = rec.dgw if rec.dgw is not None else rec.dgi
    return FusedLSTMGrads(rec.dgi, *fused_lstm_weight_grads_reference(
        hs, dg, matmul=matmul), dmlp, rec.dsel, rec.dtg, *dwd)


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

# built and loaded at first launch; one library, csrc/fused_rnn.cu. Every
# launch and plan entry takes the mode after the dimensions (GRU 0 the
# plain modes, 1 obs, 2 obs + row decay, 3 obs + evolve; LSTM 0 plain, 1
# evolve, 2 sel, 3 tg, 4 TLSTM) and the evolve's shape (hh, n layers, S
# substeps; 0 without it); every launch then the precision (the operand
# mode's code, MATMUL_CODE, and the stream flag: 1 for bf16 streams; (0,
# 0) the fp32 instances, any other the reduced ones). The weight-gradient
# entries take (L, B, H) and the precision; the evolve's (L, B, H, hh, n,
# S) and the operand mode, one kernel for both pairs, sits beside the
# GRU's entries; TLSTM's W_d gradient (the same kernel) beside the LSTM's.
_INTS = ("L", "B", "H", "mode", "HH", "n", "S", "matmul", "stream")
_SHAPE = ("H", "B", "mode", "HH", "n", "S")
_GRU = SolverLib("fused_gru", "fused GRU", 10, 19, int_names=_INTS,
                 shape_names=_SHAPE, source="fused_rnn",
                 launches={"wgrad": (5, 5), "mlpgrad": (3, 7)},
                 int_fns={"plan": 8, "wgrad_splits": 3, "mlp_splits": 3,
                          "force_plan": 2})
_LSTM = SolverLib("fused_lstm", "fused LSTM", 11, 17, int_names=_INTS,
                  shape_names=_SHAPE, source="fused_rnn",
                  launches={"wgrad": (3, 5), "wdgrad": (3, 5)},
                  int_fns={"plan": 8, "wgrad_splits": 3,
                           "wdgrad_splits": 3})
_LIBS = (_GRU, _LSTM)
_PLAN_FIELDS = ("cluster", "rows", "w_smem", "rows_per_thread",
                "active_clusters", "smem_bytes")
# the streams each pair's kernels take in bf16 with bf16 streams (ghs the
# cotangent of hs, hence bf16 too); every other tensor is float32
_GRU_BF16 = ("gi", "hs", "ghs")
_LSTM_BF16 = ("gi", "hs", "cs", "ghs", "sel", "tg", "tel", "dts")


def _dims(label, gi, whh, gates):
    if gi.ndim != 3 or whh.ndim != 2:
        raise ValueError(f"{label} kernel: gi [L, B, {gates}H] and W_hh "
                         f"[H, {gates}H] expected")
    L, B, _ = gi.shape
    H = whh.shape[0]
    if not 0 < H <= MAX_H or L == 0 or B == 0:
        raise ValueError(f"{label} kernel takes 0 < H <= {MAX_H} and a "
                         f"non-empty sequence; got L={L}, B={B}, H={H}")
    return L, B, H


def _check_evolve(label, ode, L, B, H, device, per_row, bf16=()):
    """ValueError unless the evolve's packed weights and steps fit."""
    if ode.n < 1 or ode.steps < 1 or (ode.n > 1 and ode.hh < 1):
        raise ValueError(f"{label} kernel: the evolve needs n >= 1 layers, "
                         f"steps >= 1 and hh >= 1; got {tuple(ode[2:])}")
    size = sum(i * j + j for i, j in _mlp_dims(H, ode.hh, ode.n))
    check_tensors(label, {"mlp": (size,),
                          "dts": (L, B) if per_row else (L,)},
                  {"mlp": ode.mlp, "dts": ode.dts}, device, bf16=bf16)


def check_gru_inputs(gi, h0, whh, bhh, hdec=None, hs=None, ghs=None,
                     obs=None, hrow=None, ode=None, stream: str = "f32"):
    """Raise ValueError on what the GRU kernels do not take: a dtype other
    than float32 (bfloat16 for gi, hs and ghs with `stream` 'bf16'),
    tensors on different devices, a non-contiguous tensor, a shape that
    disagrees with gi/W_hh (obs [L, B], hrow [L, H], the evolve's packed
    weights and dts [L]), or H above MAX_H. Returns (L, B, H)."""
    L, B, H = _dims("fused GRU", gi, whh, 3)
    want = {"gi": (L, B, 3 * H), "h0": (B, H), "whh": (H, 3 * H),
            "bhh": (3 * H,), "hdec": (L, B, H), "hs": (L, B, H),
            "ghs": (L, B, H), "obs": (L, B), "hrow": (L, H)}
    check_tensors("fused GRU", want, {"gi": gi, "h0": h0, "whh": whh,
                                      "bhh": bhh, "hdec": hdec, "hs": hs,
                                      "ghs": ghs, "obs": obs, "hrow": hrow},
                  gi.device, bf16=_GRU_BF16 if stream == "bf16" else ())
    if ode is not None:
        _check_evolve("fused GRU", ode, L, B, H, gi.device, per_row=False)
    return L, B, H


def check_lstm_inputs(gi, whh, bhh, hs=None, cs=None, ghs=None, hcell=None,
                      ode=None, sel=None, tg=None, dec=None,
                      stream: str = "f32"):
    """As check_gru_inputs, for the LSTM kernels (the evolve's dts [L, B];
    sel [L, B, H], tg [L, B, 3H]; the decomposition's W_d [H, H], b_d [H]
    and tel [L, B]; with `stream` 'bf16' gi, hs, cs, ghs, sel, tg, tel and
    the evolve's dts in bfloat16)."""
    L, B, H = _dims("fused LSTM", gi, whh, 4)
    bf16 = _LSTM_BF16 if stream == "bf16" else ()
    want = {"gi": (L, B, 4 * H), "whh": (H, 4 * H), "bhh": (4 * H,),
            "hs": (L, B, H), "cs": (L, B, H), "ghs": (L, B, H),
            "hcell": (L, B, H), "sel": (L, B, H), "tg": (L, B, 3 * H),
            "wd": (H, H), "bd": (H,), "tel": (L, B)}
    dec = dec or Decomp(None, None, None)
    check_tensors("fused LSTM", want, {"gi": gi, "whh": whh, "bhh": bhh,
                                       "hs": hs, "cs": cs, "ghs": ghs,
                                       "hcell": hcell, "sel": sel, "tg": tg,
                                       "wd": dec.wd, "bd": dec.bd,
                                       "tel": dec.tel}, gi.device, bf16=bf16)
    if ode is not None:
        _check_evolve("fused LSTM", ode, L, B, H, gi.device, per_row=True,
                      bf16=bf16)
    return L, B, H


def _empty(*shape, device, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=device)


def _stream_dtype(prec):
    return torch.bfloat16 if prec[1] else torch.float32


def _no_caller(what: str):
    raise NotImplementedError(
        f"{what}: no JAX caller reaches this combination, and the CUDA "
        f"kernels do not take it")


def _gru_mode(hdec, obs, hrow, ode) -> int:
    """The kernels' mode of a GRU call: 0 the plain modes (with or without
    hdec), 1 obs, 2 the row decay, 3 the evolve (2 and 3 with or without
    obs). The combinations no JAX caller reaches raise."""
    if obs is None and hrow is None and ode is None:
        return 0
    if hdec is not None or (hrow is not None and ode is not None):
        _no_caller("the GRU's per-sample decay with obs, a row decay or the "
                   "evolve, or a row decay with the evolve")
    return 3 if ode is not None else 2 if hrow is not None else 1


def _mode_ints(mode, ode):
    """(mode, HH, n, S) of a launch."""
    return (mode,) + ((ode.hh, ode.n, ode.steps) if ode is not None
                      else (0, 0, 0))


def _mode_ptrs(ode):
    """The evolve's packed weights and step sizes, or two nulls."""
    return (ode.mlp, ode.dts) if ode is not None else (None, None)


# each mode's launch counters: (forward, backward), and its instances' name
# in PRECISION_LAUNCHES
_GRU_COUNTS = {0: ("GRU_FWD_LAUNCHES", "GRU_BWD_LAUNCHES", "gru"),
               1: ("GRU_OBS_FWD_LAUNCHES", "GRU_OBS_BWD_LAUNCHES", "gru_obs"),
               2: ("GRU_DEC1_FWD_LAUNCHES", "GRU_DEC1_BWD_LAUNCHES",
                   "gru_dec1"),
               3: ("GRU_ODE_FWD_LAUNCHES", "GRU_ODE_BWD_LAUNCHES", "gru_ode")}
_LSTM_COUNTS = {0: ("LSTM_FWD_LAUNCHES", "LSTM_BWD_LAUNCHES", "lstm"),
                1: ("LSTM_ODE_FWD_LAUNCHES", "LSTM_ODE_BWD_LAUNCHES",
                    "lstm_ode"),
                2: ("LSTM_SEL_FWD_LAUNCHES", "LSTM_SEL_BWD_LAUNCHES",
                    "lstm_sel"),
                3: ("LSTM_TG_FWD_LAUNCHES", "LSTM_TG_BWD_LAUNCHES",
                    "lstm_tg"),
                4: ("LSTM_TLSTM_FWD_LAUNCHES", "LSTM_TLSTM_BWD_LAUNCHES",
                    "lstm_tlstm")}


def _count(name, kernel=None, stream="f32", matmul="f32"):
    """One more launch of the counter `name` and, in a reduced precision,
    of `kernel` in PRECISION_LAUNCHES."""
    globals()[name] += 1
    if kernel:
        count_precision(PRECISION_LAUNCHES, kernel, stream, matmul)


def _gru_fwd_launch(mode, gi, h0, whh, bhh, hdec, obs, hrow, ode, stream,
                    prec=(0, 0)):
    """hs of the GRU's forward kernel in mode `mode` on any tensors (a CUDA
    stream handle, 0 for the default); prec the library's (operand mode,
    stream flag)."""
    L, B, _ = gi.shape
    H = whh.shape[0]
    hs = _empty(L, B, H, device=gi.device, dtype=_stream_dtype(prec))
    _GRU.launch("fwd", (gi, h0, whh, bhh, hdec, obs, hrow, *_mode_ptrs(ode),
                        hs), (L, B, H) + _mode_ints(mode, ode) + prec, stream)
    return hs


def fused_gru_forward(gi, h0, whh, bhh, hdec=None, obs=None, hrow=None,
                      ode=None, *, stream: str = "f32",
                      matmul: str = "f32") -> torch.Tensor:
    """hs [L, B, H]: the CUDA forward kernel of the call's mode for CUDA
    tensors, the plain version for CPU tensors. `matmul` is the products'
    operand mode ('f32', 'bf16x3', 'bf16'); with `stream` 'bf16' gi comes
    and hs goes in bf16."""
    prec = precision_ints("fused GRU", stream, matmul)
    if gi.device.type == "cpu":
        return fused_gru_forward_reference(gi, h0, whh, bhh, hdec, obs, hrow,
                                           ode, stream=stream, matmul=matmul)
    mode = _gru_mode(hdec, obs, hrow, ode)
    L, B, H = check_gru_inputs(gi, h0, whh, bhh, hdec, obs=obs, hrow=hrow,
                               ode=ode, stream=stream)
    stream_h = _GRU.stream(gi, (H, B) + _mode_ints(mode, ode),
                           backward=False)
    hs = _gru_fwd_launch(mode, gi, h0, whh, bhh, hdec, obs, hrow, ode,
                         stream_h, prec)
    names = _GRU_COUNTS[mode]
    _count(names[0], f"{names[2]}_fwd", stream, matmul)
    return hs


def fused_gru_backward(gi, hs, ghs, h0, whh, bhh, hdec=None, obs=None,
                       hrow=None, ode=None, *, stream: str = "f32",
                       matmul: str = "f32") -> FusedGRUGrads:
    """Cotangents of the GRU's inputs given ghs = dL/dhs: for CUDA tensors
    the reverse-recurrence kernel of the call's mode
    (fused_gru_backward_recurrence), then the weight-gradient kernel
    (fused_gru_weight_grads) and, with the evolve, its layers'
    (fused_mlp_weight_grads); the plain version for CPU tensors. h0 is the
    float32 initial state (with bf16 streams the kernels read it rounded,
    as they read hs)."""
    if gi.device.type == "cpu":
        return fused_gru_backward_reference(gi, hs, ghs, h0, whh, bhh, hdec,
                                            obs, hrow, ode, stream=stream,
                                            matmul=matmul)
    rec = fused_gru_backward_recurrence(gi, hs, ghs, h0, whh, bhh, hdec, obs,
                                        hrow, ode, stream=stream,
                                        matmul=matmul)
    dmlp = (fused_mlp_weight_grads(rec.acts, rec.dzs, *hs.shape, ode,
                                   matmul=matmul)
            if ode is not None else None)
    h0k = h0.to(hs.dtype)
    return FusedGRUGrads(rec.dgi, rec.dh0, *fused_gru_weight_grads(
        h0k, hs, rec.dgh, hdec, rec.xin, matmul=matmul), rec.dhdec,
        rec.dhrow, dmlp)


def _gru_bwd_launch(mode, gi, hs, ghs, h0, whh, bhh, hdec, obs, hrow, ode,
                    stream, clusters, prec=(0, 0)) -> GRURecurrence:
    """The GRU's reverse recurrence in mode `mode` on any tensors (h0 in
    the stream dtype); the decay row's cotangent from its `clusters`
    partials, summed here in cluster order."""
    L, B, H = hs.shape
    dev = gi.device
    dgi = _empty(L, B, 3 * H, device=dev, dtype=_stream_dtype(prec))
    dgh = _empty(L, B, 3 * H, device=dev)
    dh0 = _empty(B, H, device=dev)
    dhdec = _empty(L, B, H, device=dev) if hdec is not None else None
    dhrow = _empty(clusters, L, H, device=dev) if mode == 2 else None
    xin = _empty(L, B, H, device=dev) if mode in (2, 3) else None
    acts = dzs = None
    if mode == 3:
        acts, dzs = _evolve_streams(ode, L, B, H, dgh)[:2]
    _GRU.launch("bwd", (gi, h0, hs, ghs, whh, bhh, hdec, obs, hrow,
                        *_mode_ptrs(ode), dgi, dgh, dh0, dhdec, dhrow, xin,
                        acts, dzs),
                (L, B, H) + _mode_ints(mode, ode) + prec, stream)
    return GRURecurrence(dgi, dgh, dh0, dhdec,
                         dhrow.sum(0) if dhrow is not None else None, xin,
                         acts, dzs)


def fused_gru_backward_recurrence(gi, hs, ghs, h0, whh, bhh, hdec=None,
                                  obs=None, hrow=None, ode=None, *,
                                  stream: str = "f32",
                                  matmul: str = "f32") -> GRURecurrence:
    """The reverse recurrence alone (GRURecurrence: dgi [L, B, 3H] = [dr,
    dz, dn], W_hh's cotangent dgh [L, B, 3H] = [dr, dz, dn r], dh0 [B, H],
    and where the call's mode has them dhdec, dhrow, the cell's input
    states and the evolve's streams): the CUDA kernel for CUDA tensors,
    the plain reverse loop for CPU tensors. With `stream` 'bf16' gi, hs and
    ghs come and dgi goes in bf16, and the state before the first step is
    h0 rounded."""
    prec = precision_ints("fused GRU", stream, matmul)
    if gi.device.type == "cpu":
        return _gru_reverse(gi, hs, ghs, h0, whh, bhh, hdec, obs, hrow, ode,
                            stream=stream, matmul=matmul)
    mode = _gru_mode(hdec, obs, hrow, ode)
    L, B, H = check_gru_inputs(gi, h0, whh, bhh, hdec, hs, ghs, obs, hrow,
                               ode, stream)
    shape = (H, B) + _mode_ints(mode, ode)
    stream_h = _GRU.stream(gi, shape, backward=True)
    clusters = -(-B // _GRU.kept("plan", *shape, 1, 1))
    rec = _gru_bwd_launch(mode, gi, hs, ghs, h0.to(_stream_dtype(prec)), whh,
                          bhh, hdec, obs, hrow, ode, stream_h, clusters, prec)
    names = _GRU_COUNTS[mode]
    _count(names[1], f"{names[2]}_bwd", stream, matmul)
    return rec


def _weight_grads(lib, label, gates, hs, dg, ptrs, others, entry="wgrad",
                  prec=(0, 0)):
    """(dW_hh, db_hh) of the weight-gradient kernel, launched on `ptrs`
    (the library's order) through the library's `entry` after checking hs
    (bf16 with prec's stream flag), dg and `others`: its split partials
    [S, H + 1, G H] (dW_hh's rows, then db_hh) summed here in a fixed
    order."""
    if hs.ndim != 3 or dg.shape[:2] != hs.shape[:2]:
        raise ValueError(f"{label} weight-gradient kernel: hs [L, B, H] and "
                         f"a cotangent [L, B, {gates}H] expected")
    L, B, H = hs.shape
    want = {"h0": (B, H), "hs": (L, B, H), "hdec": (L, B, H),
            "dg": (L, B, gates * H)}
    check_tensors(label, want, {**others, "hs": hs, "dg": dg}, hs.device,
                  bf16=("h0", "hs") if prec[1] else ())
    stream = lib.stream(hs, (H, B, 0, 0, 0, 0), backward=True)
    S = lib.kept(f"{entry}_splits", L, B, H)
    p = _empty(S, H + 1, gates * H, device=hs.device)
    lib.launch(entry, ptrs + (p,), (L, B, H) + prec, stream)
    s = p.sum(0)
    return s[:H], s[H]


def _stream_of(t) -> str:
    return "bf16" if t.dtype == torch.bfloat16 else "f32"


def fused_gru_weight_grads(h0, hs, dgh, hdec=None, xin=None, *,
                           matmul: str = "f32"):
    """(dW_hh, db_hh) from the cell's input states (h0 [B, H], hs [L, B,
    H], hdec [L, B, H] or None; or the stream xin [L, B, H] of them that a
    mode's backward wrote) and W_hh's cotangent dgh [L, B, 3H], the
    product's operands in operand mode `matmul`: the CUDA weight-gradient
    kernel for CUDA tensors (its split partials summed here, in a fixed
    order), the plain version for CPU tensors. h0 and hs are the states
    the recurrence read: with bf16 streams the rounded h0 and hs, both in
    bf16."""
    global GRU_WGRAD_LAUNCHES
    if hs.device.type == "cpu":
        return fused_gru_weight_grads_reference(h0, hs, dgh, hdec, xin,
                                                matmul=matmul)
    if xin is not None:
        # the kernel reads x_n as h0[n] for n < B and hs[n - B] after: xin
        # in place of both
        stream = "f32"
        prec = precision_ints("fused GRU", stream, matmul)
        out = _weight_grads(_GRU, "fused GRU", 3, xin, dgh,
                            (xin[0], xin[1:], None, dgh), {}, prec=prec)
    else:
        stream = _stream_of(hs)
        prec = precision_ints("fused GRU", stream, matmul)
        out = _weight_grads(_GRU, "fused GRU", 3, hs, dgh,
                            (h0, hs, hdec, dgh), {"h0": h0, "hdec": hdec},
                            prec=prec)
    GRU_WGRAD_LAUNCHES += 1
    count_precision(PRECISION_LAUNCHES, "gru_wgrad", stream, matmul)
    return out


def _mlp_partials(K, H, ode):
    """Floats of each evolve layer's split partials [S_i, in_i + 1,
    out_i] in the weight-gradient kernel's scratch, in layer order."""
    return [_GRU.kept("mlp_splits", K, i, j) * (i + 1) * j
            for i, j in _mlp_dims(H, ode.hh, ode.n)]


def _mlpgrad_launch(acts, dzs, L, B, H, ode, stream, mm=0):
    """The evolve's weight gradients, packed as its mlp, from the kernel
    on any tensors (mm: the operand mode's code): each layer's split
    partials summed here in a fixed order."""
    sizes = _mlp_partials(L * ode.steps * B, H, ode)
    p = _empty(sum(sizes), device=acts.device)
    _GRU.launch("mlpgrad", (acts, dzs, p),
                (L, B, H, ode.hh, ode.n, ode.steps, mm), stream)
    out, o = [], 0
    for size, (i, j) in zip(sizes, _mlp_dims(H, ode.hh, ode.n)):
        s = p[o:o + size].view(-1, i + 1, j).sum(0)
        out += [s[:i].reshape(-1), s[i]]
        o += size
    return torch.cat(out)


def fused_mlp_weight_grads(acts, dzs, L, B, H, ode: Evolve, *,
                           matmul: str = "f32") -> torch.Tensor:
    """The evolve's weight gradients, packed as its mlp, from either pair's
    backward streams (acts, dzs: each layer's input and output cotangent
    over the K = L S B rows; float32 in every precision), the products'
    operands in operand mode `matmul`: the CUDA weight-gradient kernel (one
    product a layer) for CUDA tensors, the plain version for CPU
    tensors."""
    global MLP_WGRAD_LAUNCHES
    mm = precision_ints("fused evolve", "f32", matmul)[0]
    if acts.device.type == "cpu":
        return fused_mlp_weight_grads_reference(acts, dzs, L, B, H, ode,
                                                matmul=matmul)
    K = L * ode.steps * B
    dims = _mlp_dims(H, ode.hh, ode.n)
    check_tensors("fused evolve", {"acts": (K * sum(i for i, _ in dims),),
                                   "dzs": (K * sum(j for _, j in dims),)},
                  {"acts": acts, "dzs": dzs}, acts.device)
    stream = _GRU.stream(acts, (H, B, 0, 0, 0, 0), backward=True)
    out = _mlpgrad_launch(acts, dzs, L, B, H, ode, stream, mm)
    MLP_WGRAD_LAUNCHES += 1
    count_precision(PRECISION_LAUNCHES, "mlp_wgrad", "f32", matmul)
    return out


def _lstm_mode(ode, sel, tg, dec) -> int:
    """The kernels' mode of an LSTM call: 0 plain, 1 the evolve, 2 sel, 3
    tg, 4 the memory decomposition. Two of them at once (no JAX caller
    does that) raise."""
    given = [m for m, x in ((1, ode), (2, sel), (3, tg), (4, dec))
             if x is not None]
    if len(given) > 1:
        _no_caller("two of the LSTM's evolve, sel, tg and TLSTM modes at "
                   "once")
    return given[0] if given else 0


def _lstm_mode_ptrs(ode, sel, tg, dec):
    """The evolve's packed weights and step sizes, the mode's stream (sel,
    tg or tel) and the decomposition's W_d and b_d; null where the mode has
    none."""
    aux = sel if sel is not None else tg if tg is not None else (
        dec.tel if dec is not None else None)
    return (*_mode_ptrs(ode), aux, *((dec.wd, dec.bd) if dec is not None
                                     else (None, None)))


def _lstm_fwd_launch(mode, gi, whh, bhh, ode, save_cs, stream, sel=None,
                     tg=None, dec=None, prec=(0, 0)):
    """(hs, cs, hcell) of the LSTM's forward kernel in mode `mode` on any
    tensors (cs None without save_cs, hcell None without it or the
    evolve; hs and cs in the stream dtype)."""
    L, B, _ = gi.shape
    H = whh.shape[0]
    sd = _stream_dtype(prec)
    hs = _empty(L, B, H, device=gi.device, dtype=sd)
    cs = _empty(L, B, H, device=gi.device, dtype=sd) if save_cs else None
    hcell = (_empty(L, B, H, device=gi.device) if save_cs and mode == 1
             else None)
    _LSTM.launch("fwd", (gi, whh, bhh, *_lstm_mode_ptrs(ode, sel, tg, dec),
                         hs, cs, hcell),
                 (L, B, H) + _mode_ints(mode, ode) + prec, stream)
    return hs, cs, hcell


def fused_lstm_forward(gi, whh, bhh, save_cs: bool = True, ode=None,
                       sel=None, tg=None, dec=None, *, stream: str = "f32",
                       matmul: str = "f32"):
    """(hs, cs, hcell) [L, B, H] each: the CUDA forward kernel of the
    call's mode for CUDA tensors (without save_cs it writes no cell-state
    stream: cs None), the plain version for CPU tensors. With the evolve
    `ode` (Evolve, dts [L, B]) hs is the evolved h and hcell the cells' own
    output h' (None without the evolve or without save_cs); sel, tg and
    dec (Decomp) as fused_lstm_forward_reference. `matmul` is the products'
    operand mode; with `stream` 'bf16' gi, the mode's stream and the
    evolve's steps come and hs and cs go in bf16 (hcell, float32, the
    cell's output at the rounded state)."""
    prec = precision_ints("fused LSTM", stream, matmul)
    if gi.device.type == "cpu":
        return fused_lstm_forward_reference(gi, whh, bhh, save_cs, ode, sel,
                                            tg, dec, stream=stream,
                                            matmul=matmul)
    mode = _lstm_mode(ode, sel, tg, dec)
    L, B, H = check_lstm_inputs(gi, whh, bhh, ode=ode, sel=sel, tg=tg,
                                dec=dec, stream=stream)
    stream_h = _LSTM.stream(gi, (H, B) + _mode_ints(mode, ode),
                            backward=False)
    out = _lstm_fwd_launch(mode, gi, whh, bhh, ode, save_cs, stream_h, sel,
                           tg, dec, prec)
    names = _LSTM_COUNTS[mode]
    _count(names[0], f"{names[2]}_fwd", stream, matmul)
    return out


def fused_lstm_backward(gi, hs, cs, ghs, whh, bhh, ode=None,
                        hcell=None, sel=None, tg=None, dec=None, *,
                        stream: str = "f32",
                        matmul: str = "f32") -> FusedLSTMGrads:
    """Cotangents of the LSTM's inputs given ghs = dL/dhs: for CUDA tensors
    the reverse-recurrence kernel of the call's mode
    (fused_lstm_backward_recurrence), then the weight-gradient kernel
    (fused_lstm_weight_grads; TLSTM's W_d by fused_lstm_wd_grads) and,
    with the evolve `ode`, its layers' (fused_mlp_weight_grads); the plain
    version for CPU tensors."""
    if gi.device.type == "cpu":
        return fused_lstm_backward_reference(gi, hs, cs, ghs, whh, bhh, ode,
                                             hcell, sel, tg, dec,
                                             stream=stream, matmul=matmul)
    rec = fused_lstm_backward_recurrence(gi, hs, cs, ghs, whh, bhh, ode,
                                         hcell, sel, tg, dec, stream=stream,
                                         matmul=matmul)
    dmlp = (fused_mlp_weight_grads(rec.acts, rec.dzs, *hs.shape, ode,
                                   matmul=matmul)
            if ode is not None else None)
    dwd = (fused_lstm_wd_grads(cs, rec.dzd, matmul=matmul)
           if dec is not None else (None, None))
    dg = rec.dgw if rec.dgw is not None else rec.dgi
    return FusedLSTMGrads(rec.dgi, *fused_lstm_weight_grads(
        hs, dg, matmul=matmul), dmlp, rec.dsel, rec.dtg, *dwd)


def _lstm_bwd_launch(mode, gi, hs, cs, hcell, ghs, whh, bhh, ode,
                     stream, sel=None, tg=None, dec=None,
                     prec=(0, 0)) -> LSTMRecurrence:
    """The LSTM's reverse recurrence in mode `mode` on any tensors: dgi,
    the evolve's streams (mode 1), dsel (2), dtg (3) or dzd (4); with bf16
    streams dgi, dsel and dtg in bf16 and dgw, the gate cotangents in
    float32."""
    L, B, H = hs.shape
    sd = _stream_dtype(prec)
    dgi = _empty(L, B, 4 * H, device=gi.device, dtype=sd)
    dgw = _empty(L, B, 4 * H, device=gi.device) if prec[1] else None
    acts, dzs = (_evolve_streams(ode, L, B, H, whh)[:2] if mode == 1
                 else (None, None))
    dmode = (_empty(L, B, 3 * H if mode == 3 else H, device=gi.device,
                    dtype=sd if mode in (2, 3) else torch.float32)
             if mode > 1 else None)
    _LSTM.launch("bwd", (gi, hs, cs, hcell, ghs, whh, bhh,
                         *_lstm_mode_ptrs(ode, sel, tg, dec), dgi, acts, dzs,
                         dmode, dgw),
                 (L, B, H) + _mode_ints(mode, ode) + prec, stream)
    return LSTMRecurrence(dgi, acts, dzs, *(dmode if mode == m else None
                                            for m in (2, 3, 4)), dgw)


def fused_lstm_backward_recurrence(gi, hs, cs, ghs, whh, bhh, ode=None,
                                   hcell=None, sel=None, tg=None,
                                   dec=None, *, stream: str = "f32",
                                   matmul: str = "f32") -> LSTMRecurrence:
    """The reverse recurrence alone (LSTMRecurrence: dgi [L, B, 4H] and the
    call's mode's streams): the CUDA kernel for CUDA tensors, the plain
    reverse loop for CPU tensors. With `stream` 'bf16' the streams come and
    dgi, dsel and dtg go in bf16 (dgw the float32 gate cotangents)."""
    prec = precision_ints("fused LSTM", stream, matmul)
    if gi.device.type == "cpu":
        return _lstm_reverse(gi, hs, cs, ghs, whh, bhh, ode, hcell, sel, tg,
                             dec, stream=stream, matmul=matmul)
    mode = _lstm_mode(ode, sel, tg, dec)
    L, B, H = check_lstm_inputs(gi, whh, bhh, hs, cs, ghs,
                                hcell if mode == 1 else None, ode, sel, tg,
                                dec, stream)
    if mode == 1 and hcell is None:
        raise ValueError("fused LSTM backward kernel: the evolve needs the "
                         "cells' own outputs hcell")
    stream_h = _LSTM.stream(gi, (H, B) + _mode_ints(mode, ode),
                            backward=True)
    out = _lstm_bwd_launch(mode, gi, hs, cs, hcell, ghs, whh, bhh, ode,
                           stream_h, sel, tg, dec, prec)
    names = _LSTM_COUNTS[mode]
    _count(names[1], f"{names[2]}_bwd", stream, matmul)
    return out


def fused_lstm_weight_grads(hs, dg, *, matmul: str = "f32"):
    """(dW_hh, db_hh) from hs [L, B, H] (bf16 with bf16 streams) and the
    float32 gate cotangents dg [L, B, 4H], the product's operands in
    operand mode `matmul`: the CUDA weight-gradient kernel for CUDA
    tensors (its split partials summed here, in a fixed order), the plain
    version for CPU tensors."""
    global LSTM_WGRAD_LAUNCHES
    if hs.device.type == "cpu":
        return fused_lstm_weight_grads_reference(hs, dg, matmul=matmul)
    stream = _stream_of(hs)
    prec = precision_ints("fused LSTM", stream, matmul)
    out = _weight_grads(_LSTM, "fused LSTM", 4, hs, dg, (hs, dg), {},
                        prec=prec)
    LSTM_WGRAD_LAUNCHES += 1
    count_precision(PRECISION_LAUNCHES, "lstm_wgrad", stream, matmul)
    return out


def fused_lstm_wd_grads(cs, dzd, *, matmul: str = "f32"):
    """TLSTM's (dW_d [H, H], db_d [H]) from the cell states cs [L, B, H]
    (bf16 with bf16 streams) and the cotangents dzd [L, B, H] of c_short's
    pre-activation c_{t-1} W_d + b_d (c_{-1} = 0): the weight-gradient
    kernel on those streams for CUDA tensors, the plain version for CPU
    tensors."""
    global LSTM_WD_WGRAD_LAUNCHES
    if cs.device.type == "cpu":
        return fused_lstm_weight_grads_reference(cs, dzd, matmul=matmul)
    stream = _stream_of(cs)
    prec = precision_ints("fused LSTM W_d", stream, matmul)
    out = _weight_grads(_LSTM, "fused LSTM W_d", 1, cs, dzd, (cs, dzd), {},
                        entry="wdgrad", prec=prec)
    LSTM_WD_WGRAD_LAUNCHES += 1
    count_precision(PRECISION_LAUNCHES, "lstm_wd_wgrad", stream, matmul)
    return out


def _plan(lib, shape, backward):
    return {name: lib.call("plan", *shape, int(backward), i)
            for i, name in enumerate(_PLAN_FIELDS)}


def fused_gru_plan(H: int, B: int, backward: bool, mode: int = 0,
                   ode: Optional[Evolve] = None) -> dict:
    """The CUDA library's plan of a GRU launch at (H, B) in a mode (0 the
    plain modes; 1 obs, 2 the row decay, 3 the evolve `ode`): CTAs per
    cluster, batch rows per cluster, whether the W_hh slices sit in shared
    memory, rows per thread, cudaOccupancyMaxActiveClusters (a negative
    CUDA error when the plan cannot be scheduled) and the shared bytes per
    CTA. Needs the card."""
    return _plan(_GRU, (H, B) + _mode_ints(mode, ode), backward)


def fused_lstm_plan(H: int, B: int, backward: bool,
                    ode: Optional[Evolve] = None, mode: int = 0) -> dict:
    """As fused_gru_plan, for an LSTM launch in a mode (0 plain; 1 the
    evolve `ode`, 2 sel, 3 tg, 4 TLSTM)."""
    mode = 1 if ode is not None else mode
    return _plan(_LSTM, (H, B) + _mode_ints(mode, ode), backward)


def force_rnn_plan(cluster: int = 0, rows: int = 0) -> None:
    """Make every later GRU and LSTM launch take `cluster` CTAs a cluster
    (1, 2, 4 or 8) and `rows` batch rows a cluster (8, 16 or 32), the W_hh
    slices in shared memory where they fit; 0 restores the host's own
    choice. For tests of each kind of plan. Needs the card."""
    if _GRU.call("force_plan", cluster, rows) != 0:
        raise ValueError(f"no plan of {cluster} CTAs and {rows} rows")
    for lib in _LIBS:
        lib._kept.clear()


def _evolve_of(mlp, dts, meta):
    return Evolve(mlp, dts, *meta) if mlp is not None else None


class FusedGRU(torch.autograd.Function):
    """hs = the GRU recurrence over gi [L, B, 3H] from h0 [B, H] with W_hh
    [H, 3H], b_hh [3H], an optional decay stream hdec [L, B, H] (None for
    none) and the modes: obs [L, B], the decay row hrow [L, H], the
    evolve's packed weights mlp and dts [L] with meta = (n, hh, steps), in
    the precision prec = (stream, matmul) (gi and hs bf16 with bf16
    streams); backward by the backward kernels. obs and dts are data: no
    cotangent."""

    @staticmethod
    def forward(ctx, gi, h0, whh, bhh, hdec, obs=None, hrow=None, mlp=None,
                dts=None, meta=None, prec=("f32", "f32")):
        prec = dict(zip(("stream", "matmul"), prec))
        hs = fused_gru_forward(gi, h0, whh, bhh, hdec, obs, hrow,
                               _evolve_of(mlp, dts, meta), **prec)
        ctx.meta, ctx.prec = meta, prec
        ctx.save_for_backward(gi, h0, whh, bhh, hdec, obs, hrow, mlp, dts, hs)
        return hs

    @staticmethod
    def backward(ctx, ghs):
        gi, h0, whh, bhh, hdec, obs, hrow, mlp, dts, hs = ctx.saved_tensors
        g = fused_gru_backward(gi, hs, ghs.contiguous(), h0, whh, bhh, hdec,
                               obs, hrow, _evolve_of(mlp, dts, ctx.meta),
                               **ctx.prec)
        return (g.dgi, g.dh0, g.dwhh, g.dbhh, g.dhdec, None, g.dhrow, g.dmlp,
                None, None, None)


def _decomp_of(wd, bd, tel):
    return Decomp(wd, bd, tel) if wd is not None else None


class FusedLSTM(torch.autograd.Function):
    """hs = the LSTM recurrence over gi [L, B, 4H] from zero (h, c) with
    W_hh [H, 4H], b_hh [4H] and, optionally, one mode: the evolve of h
    after each cell (packed weights mlp, dts [L, B], meta = (n, hh,
    steps)), PLSTM's sel [L, B, H], TGLSTM's tg [L, B, 3H], or TLSTM's
    memory decomposition (W_d [H, H], b_d [H], tel [L, B]), in the
    precision prec = (stream, matmul) (gi, the mode's stream, dts and hs
    bf16 with bf16 streams); the cell-state trajectory (and the cells' own
    h') is saved for the backward kernel, not returned. dts and tel are
    data: no cotangent."""

    @staticmethod
    def forward(ctx, gi, whh, bhh, mlp=None, dts=None, meta=None, sel=None,
                tg=None, wd=None, bd=None, tel=None, prec=("f32", "f32")):
        prec = dict(zip(("stream", "matmul"), prec))
        hs, cs, hcell = fused_lstm_forward(gi, whh, bhh, True,
                                           _evolve_of(mlp, dts, meta), sel,
                                           tg, _decomp_of(wd, bd, tel),
                                           **prec)
        ctx.meta, ctx.prec = meta, prec
        ctx.save_for_backward(gi, whh, bhh, hs, cs, mlp, dts, hcell, sel, tg,
                              wd, bd, tel)
        return hs

    @staticmethod
    def backward(ctx, ghs):
        (gi, whh, bhh, hs, cs, mlp, dts, hcell, sel, tg, wd, bd,
         tel) = ctx.saved_tensors
        g = fused_lstm_backward(gi, hs, cs, ghs.contiguous(), whh, bhh,
                                _evolve_of(mlp, dts, ctx.meta), hcell, sel,
                                tg, _decomp_of(wd, bd, tel), **ctx.prec)
        return (g.dgi, g.dwhh, g.dbhh, g.dmlp, None, None, g.dsel, g.dtg,
                g.dwd, g.dbd, None, None)


# ---------------------------------------------------------------------------
# Public entries: a recurrence over a sequence through the kernels
# ---------------------------------------------------------------------------

def _projection(cell, xs, reverse):
    """gi = xs @ w_ih + b_ih over the (flipped, for reverse) sequence."""
    if reverse:
        xs = torch.flip(xs, (0,))
    return (xs @ cell.w_ih + cell.b_ih).contiguous()


def _evolve_args(ode_layers, steps, dts, H, reverse, name):
    """(packed weights, substep sizes, meta) of the evolve by the
    `nn.Linear`s ode_layers over elapsed times dts (flipped for reverse),
    or (None, None, None)."""
    if ode_layers is None and dts is None:
        return None, None, None
    if ode_layers is None or dts is None or len(ode_layers) == 0:
        raise ValueError(f"the evolve needs both ode_layers and {name}")
    n = len(ode_layers)
    hh = ode_layers[0].out_features if n > 1 else H
    dts = torch.as_tensor(dts, dtype=torch.float32)
    if reverse:
        dts = torch.flip(dts, (0,))
    return (pack_mlp(ode_layers), (dts / steps).contiguous(),
            (n, hh, int(steps)))


def _precision(stream_dtype, matmul):
    """(a cast of a stream to the stream dtype, (stream, matmul)) of a scan
    (resolve_precision: None from SNSDE_FUSED_STREAM and SNSDE_FUSED_MATMUL,
    as the JAX scans read them). With fp32 streams the cast keeps the
    tensor as it is."""
    sd, mm = resolve_precision(stream_dtype, matmul)
    if sd == torch.float32:
        return (lambda t: t), ("f32", mm)
    return (lambda t: None if t is None else t.to(sd)), ("bf16", mm)


def fused_gru_scan(cell, xs, h0=None, reverse: bool = False,
                   stream_dtype=None, obs=None, hdec=None, ode_layers=None,
                   tdif=None, ode_steps: int = 1,
                   matmul=None) -> torch.Tensor:
    """The GRU recurrence through the fused kernels: xs [L, B, C] -> hs
    [L, B, H], the scan over the cell (torch (r, z, n) gates) from h0
    (zeros if None). reverse=True runs the backward direction of a
    bidirectional layer (hs[i] is the state after consuming xs[i:] from the
    right). As snsde/kernels/fused_rnn.py:432-522:
      obs [L, B]   keep the cell's update only where 1 (an unobserved
                   step passes the decayed or evolved state on); data, no
                   gradient (GRU-dt, GRU-D, ODE-RNN).
      hdec         the hidden decay applied to the state before each
                   step: a per-sample stream [L, B, H] (GRUD-full) or a
                   time-only row [L, H] (GRU-D); its cotangent reaches the
                   decay net through autograd.
      ode_layers, tdif [L], ode_steps
                   ODE-RNN: evolve the state before each step by
                   ode_steps Euler substeps of tdif[t] / ode_steps of the
                   MLP of the `nn.Linear`s ode_layers (tanh inner
                   layers, linear output); not with hdec.
    `stream_dtype` (torch.float32 or torch.bfloat16: gi and hs, and their
    cotangents, in it) and `matmul` ('f32', 'bf16x3' or 'bf16': the
    in-kernel products' operands) are the JAX scan's precision; None takes
    SNSDE_FUSED_STREAM and SNSDE_FUSED_MATMUL, exact fp32 when unset. hs is
    in xs's dtype (a bf16 trajectory widened). The per-sample decay with
    obs, a row decay or the evolve raises NotImplementedError on the
    card."""
    to_stream, prec = _precision(stream_dtype, matmul)
    if not supports_fused_gru(cell):
        raise ValueError(f"fused GRU kernels take GRUCell-shaped cells with "
                         f"H <= {MAX_H}; got {type(cell).__name__}")
    B = xs.shape[1]
    H = cell.hidden_size
    if h0 is None:
        h0 = xs.new_zeros((B, H))
    gi = _projection(cell, xs, reverse)
    flip = (lambda a: torch.flip(a, (0,))) if reverse else (lambda a: a)
    hrow = None
    if hdec is not None:
        hdec = flip(hdec).contiguous()
        if hdec.ndim == 2:
            hdec, hrow = None, hdec
    if obs is not None:
        obs = flip(obs).to(torch.float32).contiguous()
    mlp, dts, meta = _evolve_args(ode_layers, ode_steps, tdif, H, reverse,
                                  "tdif")
    if dts is not None:
        dts = dts.to(xs.device)
    hs = FusedGRU.apply(to_stream(gi), h0.contiguous(),
                        cell.w_hh.contiguous(),
                        cell.b_hh.contiguous(), hdec, obs, hrow, mlp, dts,
                        meta, prec).to(gi.dtype)
    return torch.flip(hs, (0,)) if reverse else hs


def fused_lstm_scan(cell, xs, reverse: bool = False, stream_dtype=None,
                    sel=None, tg=None, ode_layers=None, odt=None,
                    ode_steps: int = 1, tlstm=None, tel=None,
                    matmul=None) -> torch.Tensor:
    """The LSTM recurrence through the fused kernels from zero (h, c): xs
    [L, B, C] -> hs [L, B, H], the scan over the cell (torch (i, f, g, o)).
    When no gradient will be asked for, the forward kernel runs alone and
    writes no cell-state stream. As snsde/kernels/fused_rnn.py:972-1058,
    one mode at a time:
      ode_layers, odt [L, B], ode_steps
                   ODE-LSTM: h evolved after each cell by ode_steps Euler
                   substeps of odt / ode_steps of the MLP of the
                   `nn.Linear`s ode_layers (c passes through);
      sel [L, B, H]
                   PLSTM's phased openness: h and c become sel times the
                   cell's output plus (1 - sel) times the state before;
      tg [L, B, 3H]
                   TGLSTM's sigmoid modifiers of the i, f and o gates;
      tlstm, tel [L, B]
                   TLSTM's memory decomposition by the `nn.Linear` W_d
                   (tlstm) over the elapsed times tel, the gates read as
                   (f, i, o, sigmoid candidate).
    sel, tg and W_d take gradients (through autograd to whatever made
    them); odt and tel are data. A reverse run flips every stream. Two
    modes at once raise NotImplementedError. `stream_dtype` (gi, sel, tg,
    tel, the evolve's steps odt / ode_steps and hs, and their cotangents,
    in it) and `matmul` as fused_gru_scan's; hs is in xs's dtype."""
    _lstm_mode(ode_layers if ode_layers is not None else odt, sel, tg,
               tlstm if tlstm is not None else tel)
    to_stream, prec = _precision(stream_dtype, matmul)
    if not supports_fused_lstm(cell):
        raise ValueError(f"fused LSTM kernels take LSTMCell-shaped cells "
                         f"with H <= {MAX_H}; got {type(cell).__name__}")
    if (tlstm is None) != (tel is None):
        raise ValueError("TLSTM's memory decomposition needs both tlstm "
                         "and tel")
    gi = _projection(cell, xs, reverse)
    whh, bhh = cell.w_hh.contiguous(), cell.b_hh.contiguous()
    mlp, dts, meta = _evolve_args(ode_layers, ode_steps, odt,
                                  cell.hidden_size, reverse, "odt")
    if dts is not None:
        dts = to_stream(dts.to(xs.device))
    flip = (lambda a: torch.flip(a, (0,))) if reverse else (lambda a: a)
    sel = to_stream(flip(sel).contiguous()) if sel is not None else None
    tg = to_stream(flip(tg).contiguous()) if tg is not None else None
    wd = bd = None
    if tlstm is not None:
        wd, bd = tlstm.weight.t().contiguous(), tlstm.bias.contiguous()
        tel = to_stream(flip(torch.as_tensor(tel, dtype=torch.float32,
                                             device=xs.device)).contiguous())
    gis = to_stream(gi)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (gi, whh, bhh, mlp, sel, tg, wd, bd)):
        hs = FusedLSTM.apply(gis, whh, bhh, mlp, dts, meta, sel, tg, wd, bd,
                             tel, prec)
    else:
        hs = fused_lstm_forward(gis, whh, bhh, False,
                                _evolve_of(mlp, dts, meta), sel, tg,
                                _decomp_of(wd, bd, tel),
                                **dict(zip(("stream", "matmul"), prec)))[0]
    hs = hs.to(gi.dtype)
    return torch.flip(hs, (0,)) if reverse else hs
