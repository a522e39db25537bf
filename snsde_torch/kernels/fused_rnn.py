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
b_d and the elapsed times tel [L, B]). bf16 streams or bf16 / bf16x3
operands (asked by the caller or by SNSDE_FUSED_STREAM and
SNSDE_FUSED_MATMUL, `_solver.resolve_precision`), and mode
combinations no JAX caller reaches, raise NotImplementedError naming
ROADMAP Queue 2 K6/K7; they never fall back to an eager loop.

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

from ._solver import SolverLib, check_tensors, require_fp32, unported

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
           "GRURecurrence", "LSTMRecurrence", "MAX_H"]

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


def _mlp_f(x, layers):
    for w, b in layers[:-1]:
        x = torch.tanh(x @ w + b)
    w, b = layers[-1]
    return x @ w + b


def _evolve(h, layers, dt, steps):
    """(h after `steps` Euler substeps of size dt, the state before each)."""
    subs = []
    for _ in range(steps):
        subs.append(h)
        h = h + dt * _mlp_f(h, layers)
    return h, subs


def _stream_views(buf, K, widths):
    """Per-layer [K, width] views of a stream buffer laid out as the
    kernels write it (layer blocks in order)."""
    out, o = [], 0
    for w in widths:
        out.append(buf[o:o + K * w].view(K, w))
        o += K * w
    return out


def _evolve_back(dh, subs, layers, dt, acts, dzs, row):
    """Back through the substeps `subs` (in reverse): the cotangent of the
    state before them, writing each layer's input and output cotangent at
    stream rows row(s) of acts/dzs (per-layer [L S B, width] views)."""
    n = len(layers)
    for s in range(len(subs) - 1, -1, -1):
        xs = [subs[s]]
        for w, b in layers[:-1]:
            xs.append(torch.tanh(xs[-1] @ w + b))
        dz = dh * dt
        rows = row(s)
        for i in range(n - 1, -1, -1):
            acts[i][rows] = xs[i]
            dzs[i][rows] = dz
            dx = dz @ layers[i][0].T
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


def fused_mlp_weight_grads_reference(acts, dzs, L, B, H, ode: "Evolve"):
    """The evolve's weight gradients, packed as its mlp, from the
    backward's streams: layer i's dW = acts_i^T dzs_i, db = the sum of
    dzs_i over the K = L S B rows (one product a layer, as the kernel)."""
    dims = _mlp_dims(H, ode.hh, ode.n)
    K = L * ode.steps * B
    a = _stream_views(acts, K, [i for i, _ in dims])
    z = _stream_views(dzs, K, [j for _, j in dims])
    return torch.cat([t for x, d in zip(a, z)
                      for t in ((x.T @ d).reshape(-1), d.sum(0))])


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------

def _gru_cell(g, hin, whh, bhh):
    """One GRU step from the cell's input state hin [B, H] and the step's
    input row g [B, 3H]: (h', r, z, n, gh_n)."""
    H = hin.shape[1]
    gh = hin @ whh + bhh
    r = torch.sigmoid(g[:, :H] + gh[:, :H])
    z = torch.sigmoid(g[:, H:2 * H] + gh[:, H:2 * H])
    ghn = gh[:, 2 * H:]
    n = torch.tanh(g[:, 2 * H:] + r * ghn)
    return (1.0 - z) * n + z * hin, r, z, n, ghn


def _gru_input(t, h, hdec, hrow, ode, layers):
    """(the cell's input state at step t from h before it, the evolve's
    substep states or None)."""
    if hdec is not None:
        return h * hdec[t], None
    if hrow is not None:
        return h * hrow[t], None
    if ode is not None:
        return _evolve(h, layers, ode.dts[t], ode.steps)
    return h, None


def fused_gru_forward_reference(gi, h0, whh, bhh, hdec=None, obs=None,
                                hrow=None, ode=None) -> torch.Tensor:
    """Eager GRU loop: hs [L, B, H] (h after each step) from gi [L, B, 3H]
    (the input projection with b_ih), h0 [B, H], W_hh [H, 3H], b_hh [3H]
    and the modes: the per-sample decay hdec [L, B, H] or the time-only
    row hrow [L, H] applied to the state before each step, or the Euler
    MLP evolve `ode` (Evolve, dts [L]); with obs [L, B] a step keeps the
    cell's update only where obs is 1 and passes its input state on where
    it is 0 (fused_rnn.py:95-106)."""
    layers = (mlp_layers(ode.mlp, h0.shape[1], ode.hh, ode.n)
              if ode is not None else None)
    h, hs = h0, []
    for t in range(gi.shape[0]):
        hin = _gru_input(t, h, hdec, hrow, ode, layers)[0]
        h = _gru_cell(gi[t], hin, whh, bhh)[0]
        if obs is not None:
            sel = obs[t][:, None]
            h = sel * h + (1.0 - sel) * hin
        hs.append(h)
    return torch.stack(hs)


class GRURecurrence(NamedTuple):
    """What the GRU's reverse recurrence writes: dgi [L, B, 3H] = [dr, dz,
    dn], W_hh's cotangent dgh [L, B, 3H] = [dr, dz, dn r], dh0 [B, H],
    dhdec [L, B, H], dhrow [L, H], the cell's input states xin [L, B, H]
    (with hrow or the evolve), and the evolve's streams (acts, dzs: each
    layer's input and output cotangent, [L, S, B, width] blocks)."""
    dgi: torch.Tensor
    dgh: torch.Tensor
    dh0: torch.Tensor
    dhdec: Optional[torch.Tensor] = None
    dhrow: Optional[torch.Tensor] = None
    xin: Optional[torch.Tensor] = None
    acts: Optional[torch.Tensor] = None
    dzs: Optional[torch.Tensor] = None


def _gru_reverse(gi, hs, ghs, h0, whh, bhh, hdec=None, obs=None, hrow=None,
                 ode=None) -> GRURecurrence:
    """The reverse loop of the GRU backward (the JAX `_bwd_kernel`'s):
    recompute the cell's input state (the decay, or the evolve's substeps)
    and the gates before each step, then back through the mask, the gates,
    W_hh and the decay or the evolve."""
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
        h = h0 if t == 0 else hs[t - 1]
        hin, subs = _gru_input(t, h, hdec, hrow, ode, layers)
        _, r, z, n, ghn = _gru_cell(gi[t], hin, whh, bhh)
        dhn = gbar if obs is None else gbar * obs[t][:, None]
        dn_pre = dhn * (1.0 - z) * (1.0 - n * n)
        dr_pre = dn_pre * ghn * r * (1.0 - r)
        dz_pre = dhn * (hin - n) * z * (1.0 - z)
        dgh[t] = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=-1)
        dgi[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1)
        if obs is None:
            dhin = gbar * z + dgh[t] @ whh.T
        else:
            dhin = (dhn * z + gbar * (1.0 - obs[t][:, None])
                    + dgh[t] @ whh.T)
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
                                     (t * ode.steps + s + 1) * B))
        gbar = dhin
    return GRURecurrence(dgi, dgh, gbar, dhdec, dhrow, xin, acts, dzs)


def fused_gru_weight_grads_reference(h0, hs, dgh, hdec=None, xin=None):
    """(dW_hh [H, 3H], db_hh [3H]) from the cell's input states and W_hh's
    cotangent dgh [L, B, 3H]: the gates' h-part is x_t W_hh + b_hh with
    x_t = h_{t-1} hdec_t (h_{-1} = h0; no decay without hdec), or x_t =
    xin[t] where the backward wrote them (the row decay, the evolve), so
    dW_hh = sum_t x_t^T dgh_t and db_hh = sum dgh. One product over (step,
    row), as the weight-gradient kernel computes it."""
    H, G = hs.shape[-1], dgh.shape[-1]
    if xin is not None:
        x = xin
    else:
        x = torch.cat([h0[None], hs[:-1]])
        if hdec is not None:
            x = x * hdec
    return x.reshape(-1, H).T @ dgh.reshape(-1, G), dgh.reshape(-1, G).sum(0)


def fused_gru_backward_reference(gi, hs, ghs, h0, whh, bhh, hdec=None,
                                 obs=None, hrow=None,
                                 ode=None):
    """FusedGRUGrads: the eager reverse loop mirroring the backward kernels
    (and the JAX `_bwd_kernel`), then the weight gradients from the cell's
    input states and dgh (fused_gru_weight_grads_reference) and, with the
    evolve, its layers' from their streams
    (fused_mlp_weight_grads_reference)."""
    rec = _gru_reverse(gi, hs, ghs, h0, whh, bhh, hdec, obs, hrow, ode)
    grads = fused_gru_weight_grads_reference(h0, hs, rec.dgh, hdec, rec.xin)
    dmlp = (fused_mlp_weight_grads_reference(rec.acts, rec.dzs, *hs.shape,
                                             ode)
            if ode is not None else None)
    return FusedGRUGrads(rec.dgi, rec.dh0, *grads, rec.dhdec, rec.dhrow,
                         dmlp)


def _lstm_cell(g, h, c, whh, bhh, tg=None, dec=None, tel=None):
    """One cell evaluation from (h, c) before the step and the step's input
    row g: (h', c', (i, f, gg, o, extra)) in torch's gate order (i, f, g,
    o). With the modifiers tg [B, 3H] (TGLSTM) i, f and o are the raw
    sigmoids times their modifiers, extra the raw sigmoids; with the memory
    decomposition dec (TLSTM, tel [B] the step's elapsed times) the gates
    read (f, i, o, a sigmoid candidate gg) and update c_adj, extra =
    (c_short, c_adj) (snsde/kernels/fused_rnn.py:543-575)."""
    H = h.shape[1]
    a = g + h @ whh + bhh
    if dec is not None:
        c_short = torch.tanh(c @ dec.wd + dec.bd)
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


def _lstm_step(t, gi, h, c, whh, bhh, sel, tg, dec):
    """(h, c) after step t of a mode (PLSTM's openness sel blends the cell's
    output with the state before it, both carries), and the cell's own
    (h', c', gates)."""
    h2, c2, gates = _lstm_cell(gi[t], h, c, whh, bhh,
                               tg[t] if tg is not None else None, dec,
                               dec.tel[t] if dec is not None else None)
    if sel is None:
        return h2, c2, (h2, c2, gates)
    s = sel[t]
    return s * h2 + (1.0 - s) * h, s * c2 + (1.0 - s) * c, (h2, c2, gates)


def fused_lstm_forward_reference(gi, whh, bhh, save_cs: bool = True,
                                 ode=None, sel=None, tg=None, dec=None):
    """Eager LSTM loop from zero (h, c): (hs [L, B, H], cs [L, B, H],
    hcell), cs None when save_cs is False. With the evolve `ode` (Evolve,
    dts [L, B]) the cell's output h' is evolved after each step (hs holds
    the evolved h, the next cell's input; c passes through), and hcell
    [L, B, H] holds the cells' own h' (None without the evolve or without
    save_cs). The time-aware modes (one at a time): PLSTM's openness sel
    [L, B, H] (h = sel h' + (1 - sel) h, likewise c: hs and cs hold the
    blended states), TGLSTM's modifiers tg [L, B, 3H] of the i, f and o
    gates, TLSTM's memory decomposition dec (Decomp)."""
    B, H = gi.shape[1], whh.shape[0]
    layers = (mlp_layers(ode.mlp, H, ode.hh, ode.n) if ode is not None
              else None)
    h = c = gi.new_zeros((B, H))
    hs, cs, hcell = [], [], []
    for t in range(gi.shape[0]):
        h, c = _lstm_step(t, gi, h, c, whh, bhh, sel, tg, dec)[:2]
        if ode is not None:
            hcell.append(h)
            h = _evolve(h, layers, ode.dts[t][:, None], ode.steps)[0]
        hs.append(h)
        cs.append(c)
    return (torch.stack(hs), torch.stack(cs) if save_cs else None,
            torch.stack(hcell) if save_cs and ode is not None else None)


def fused_lstm_weight_grads_reference(hs, dgi):
    """(dW_hh [H, 4H], db_hh [4H]) from the hidden trajectory hs [L, B, H]
    and the gate cotangents dgi [L, B, 4H]: the gate pre-activation is
    gi + h W_hh + b_hh, so W_hh's cotangent is dgi itself, and dW_hh =
    sum_t h_{t-1}^T dgi_t (h_{-1} = 0), db_hh = sum dgi. One product over
    (step, row), as the weight-gradient kernel computes it. TLSTM's (dW_d,
    db_d) are the same product of the cell states cs and the cotangents
    dzd [L, B, H] of c_short's pre-activation c_{t-1} W_d + b_d."""
    H, G = hs.shape[-1], dgi.shape[-1]
    dwhh = hs[:-1].reshape(-1, H).T @ dgi[1:].reshape(-1, G)
    return dwhh, dgi.reshape(-1, G).sum(0)


class LSTMRecurrence(NamedTuple):
    """What the LSTM's reverse recurrence writes: dgi [L, B, 4H] and, with
    the evolve, its streams (acts, dzs: each layer's input and output
    cotangent, [L, S, B, width] blocks); PLSTM's dsel [L, B, H], TGLSTM's
    dtg [L, B, 3H], and TLSTM's dzd [L, B, H] (the cotangent of c_short's
    pre-activation, which W_d's gradient takes)."""
    dgi: torch.Tensor
    acts: Optional[torch.Tensor] = None
    dzs: Optional[torch.Tensor] = None
    dsel: Optional[torch.Tensor] = None
    dtg: Optional[torch.Tensor] = None
    dzd: Optional[torch.Tensor] = None


def _lstm_reverse(gi, hs, cs, ghs, whh, bhh, ode=None, hcell=None, sel=None,
                  tg=None, dec=None) -> LSTMRecurrence:
    """The reverse loop of the LSTM backward (the JAX `_lstm_bwd_kernel`'s,
    fused_rnn.py:616-728): recompute the cell from (h, c) before each step,
    then back through PLSTM's blend, the evolve (its substeps recomputed
    from the cell's output hcell[t], undone before the cell's backward),
    the gates (TGLSTM's modifiers, TLSTM's decomposition) and W_hh (and
    W_d)."""
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
            subs = _evolve(hcell[t], layers, dt, ode.steps)[1]
            gh = _evolve_back(
                gh, subs, layers, dt, av, zv,
                lambda s, t=t: slice((t * ode.steps + s) * B,
                                     (t * ode.steps + s + 1) * B))
        h, c = (zero, zero) if t == 0 else (hs[t - 1], cs[t - 1])
        h2, c2, (i, f, gg, o, extra) = _lstm_step(t, gi, h, c, whh, bhh, sel,
                                                  tg, dec)[2]
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
            gc = dc_adj + dzd[t] @ dec.wd.T
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
        gh = dgates @ whh.T + dh_carry
    return LSTMRecurrence(dgi, acts, dzs, dsel, dtg, dzd)


def fused_lstm_backward_reference(gi, hs, cs, ghs, whh, bhh, ode=None,
                                  hcell=None, sel=None, tg=None, dec=None):
    """FusedLSTMGrads: the eager reverse loop mirroring the backward
    kernels (and the JAX `_lstm_bwd_kernel`): recompute the gates from
    (h, c) before each step (and, with the evolve, its substeps from
    hcell[t], gone back through first), then back through the cell and
    W_hh to dgi (and a mode's dsel, dtg or dzd); then the weight gradients
    from hs and dgi (fused_lstm_weight_grads_reference), TLSTM's W_d's from
    cs and dzd, and the evolve's from its streams."""
    rec = _lstm_reverse(gi, hs, cs, ghs, whh, bhh, ode, hcell, sel, tg, dec)
    dmlp = (fused_mlp_weight_grads_reference(rec.acts, rec.dzs, *hs.shape,
                                             ode)
            if ode is not None else None)
    dwd = (fused_lstm_weight_grads_reference(cs, rec.dzd)
           if dec is not None else (None, None))
    return FusedLSTMGrads(rec.dgi, *fused_lstm_weight_grads_reference(
        hs, rec.dgi), dmlp, rec.dsel, rec.dtg, *dwd)


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

# built and loaded at first launch; one library, csrc/fused_rnn.cu. Every
# launch and plan entry takes the mode after the dimensions (GRU 0 the
# plain modes, 1 obs, 2 obs + row decay, 3 obs + evolve; LSTM 0 plain, 1
# evolve, 2 sel, 3 tg, 4 TLSTM) and the evolve's shape (hh, n layers, S
# substeps; 0 without it). The weight-gradient entries take (L, B, H); the
# evolve's (L, B, H, hh, n, S), one kernel for both pairs, sits beside the
# GRU's entries; TLSTM's W_d gradient (the same kernel) beside the LSTM's.
_INTS = ("L", "B", "H", "mode", "HH", "n", "S")
_SHAPE = ("H", "B", "mode", "HH", "n", "S")
_GRU = SolverLib("fused_gru", "fused GRU", 10, 19, int_names=_INTS,
                 shape_names=_SHAPE, source="fused_rnn",
                 launches={"wgrad": (5, 3), "mlpgrad": (3, 6)},
                 int_fns={"plan": 8, "wgrad_splits": 3, "mlp_splits": 3,
                          "force_plan": 2})
_LSTM = SolverLib("fused_lstm", "fused LSTM", 11, 16, int_names=_INTS,
                  shape_names=_SHAPE, source="fused_rnn",
                  launches={"wgrad": (3, 3), "wdgrad": (3, 3)},
                  int_fns={"plan": 8, "wgrad_splits": 3,
                           "wdgrad_splits": 3})
_LIBS = (_GRU, _LSTM)
_PLAN_FIELDS = ("cluster", "rows", "w_smem", "rows_per_thread",
                "active_clusters", "smem_bytes")


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


def _check_evolve(label, ode, L, B, H, device, per_row):
    """ValueError unless the evolve's packed weights and steps fit."""
    if ode.n < 1 or ode.steps < 1 or (ode.n > 1 and ode.hh < 1):
        raise ValueError(f"{label} kernel: the evolve needs n >= 1 layers, "
                         f"steps >= 1 and hh >= 1; got {tuple(ode[2:])}")
    size = sum(i * j + j for i, j in _mlp_dims(H, ode.hh, ode.n))
    check_tensors(label, {"mlp": (size,),
                          "dts": (L, B) if per_row else (L,)},
                  {"mlp": ode.mlp, "dts": ode.dts}, device)


def check_gru_inputs(gi, h0, whh, bhh, hdec=None, hs=None, ghs=None,
                     obs=None, hrow=None, ode=None):
    """Raise ValueError on what the GRU kernels do not take: a dtype other
    than float32, tensors on different devices, a non-contiguous tensor, a
    shape that disagrees with gi/W_hh (obs [L, B], hrow [L, H], the
    evolve's packed weights and dts [L]), or H above MAX_H. Returns (L, B,
    H)."""
    L, B, H = _dims("fused GRU", gi, whh, 3)
    want = {"gi": (L, B, 3 * H), "h0": (B, H), "whh": (H, 3 * H),
            "bhh": (3 * H,), "hdec": (L, B, H), "hs": (L, B, H),
            "ghs": (L, B, H), "obs": (L, B), "hrow": (L, H)}
    check_tensors("fused GRU", want, {"gi": gi, "h0": h0, "whh": whh,
                                      "bhh": bhh, "hdec": hdec, "hs": hs,
                                      "ghs": ghs, "obs": obs, "hrow": hrow},
                  gi.device)
    if ode is not None:
        _check_evolve("fused GRU", ode, L, B, H, gi.device, per_row=False)
    return L, B, H


def check_lstm_inputs(gi, whh, bhh, hs=None, cs=None, ghs=None, hcell=None,
                      ode=None, sel=None, tg=None, dec=None):
    """As check_gru_inputs, for the LSTM kernels (the evolve's dts [L, B];
    sel [L, B, H], tg [L, B, 3H]; the decomposition's W_d [H, H], b_d [H]
    and tel [L, B])."""
    L, B, H = _dims("fused LSTM", gi, whh, 4)
    want = {"gi": (L, B, 4 * H), "whh": (H, 4 * H), "bhh": (4 * H,),
            "hs": (L, B, H), "cs": (L, B, H), "ghs": (L, B, H),
            "hcell": (L, B, H), "sel": (L, B, H), "tg": (L, B, 3 * H),
            "wd": (H, H), "bd": (H,), "tel": (L, B)}
    dec = dec or Decomp(None, None, None)
    check_tensors("fused LSTM", want, {"gi": gi, "whh": whh, "bhh": bhh,
                                       "hs": hs, "cs": cs, "ghs": ghs,
                                       "hcell": hcell, "sel": sel, "tg": tg,
                                       "wd": dec.wd, "bd": dec.bd,
                                       "tel": dec.tel}, gi.device)
    if ode is not None:
        _check_evolve("fused LSTM", ode, L, B, H, gi.device, per_row=True)
    return L, B, H


def _empty(*shape, device):
    return torch.empty(shape, dtype=torch.float32, device=device)


def _gru_mode(hdec, obs, hrow, ode) -> int:
    """The kernels' mode of a GRU call: 0 the plain modes (with or without
    hdec), 1 obs, 2 the row decay, 3 the evolve (2 and 3 with or without
    obs). The combinations no JAX caller reaches raise."""
    if obs is None and hrow is None and ode is None:
        return 0
    if hdec is not None or (hrow is not None and ode is not None):
        unported("the GRU's per-sample decay with obs, a row decay or the "
                  "evolve, or a row decay with the evolve", "K6")
    return 3 if ode is not None else 2 if hrow is not None else 1


def _mode_ints(mode, ode):
    """(mode, HH, n, S) of a launch."""
    return (mode,) + ((ode.hh, ode.n, ode.steps) if ode is not None
                      else (0, 0, 0))


def _mode_ptrs(ode):
    """The evolve's packed weights and step sizes, or two nulls."""
    return (ode.mlp, ode.dts) if ode is not None else (None, None)


# each mode's launch counters: (forward, backward)
_GRU_COUNTS = {0: ("GRU_FWD_LAUNCHES", "GRU_BWD_LAUNCHES"),
               1: ("GRU_OBS_FWD_LAUNCHES", "GRU_OBS_BWD_LAUNCHES"),
               2: ("GRU_DEC1_FWD_LAUNCHES", "GRU_DEC1_BWD_LAUNCHES"),
               3: ("GRU_ODE_FWD_LAUNCHES", "GRU_ODE_BWD_LAUNCHES")}
_LSTM_COUNTS = {0: ("LSTM_FWD_LAUNCHES", "LSTM_BWD_LAUNCHES"),
                1: ("LSTM_ODE_FWD_LAUNCHES", "LSTM_ODE_BWD_LAUNCHES"),
                2: ("LSTM_SEL_FWD_LAUNCHES", "LSTM_SEL_BWD_LAUNCHES"),
                3: ("LSTM_TG_FWD_LAUNCHES", "LSTM_TG_BWD_LAUNCHES"),
                4: ("LSTM_TLSTM_FWD_LAUNCHES", "LSTM_TLSTM_BWD_LAUNCHES")}


def _count(name):
    globals()[name] += 1


def _gru_fwd_launch(mode, gi, h0, whh, bhh, hdec, obs, hrow, ode, stream):
    """hs of the GRU's forward kernel in mode `mode` on any tensors (a CUDA
    stream handle, 0 for the default)."""
    L, B, _ = gi.shape
    H = whh.shape[0]
    hs = _empty(L, B, H, device=gi.device)
    _GRU.launch("fwd", (gi, h0, whh, bhh, hdec, obs, hrow, *_mode_ptrs(ode),
                        hs), (L, B, H) + _mode_ints(mode, ode), stream)
    return hs


def fused_gru_forward(gi, h0, whh, bhh, hdec=None, obs=None, hrow=None,
                      ode=None) -> torch.Tensor:
    """hs [L, B, H]: the CUDA forward kernel of the call's mode for CUDA
    tensors, the plain version for CPU tensors."""
    if gi.device.type == "cpu":
        return fused_gru_forward_reference(gi, h0, whh, bhh, hdec, obs, hrow,
                                           ode)
    mode = _gru_mode(hdec, obs, hrow, ode)
    L, B, H = check_gru_inputs(gi, h0, whh, bhh, hdec, obs=obs, hrow=hrow,
                               ode=ode)
    stream = _GRU.stream(gi, (H, B) + _mode_ints(mode, ode), backward=False)
    hs = _gru_fwd_launch(mode, gi, h0, whh, bhh, hdec, obs, hrow, ode,
                         stream)
    _count(_GRU_COUNTS[mode][0])
    return hs


def fused_gru_backward(gi, hs, ghs, h0, whh, bhh, hdec=None, obs=None,
                       hrow=None, ode=None) -> FusedGRUGrads:
    """Cotangents of the GRU's inputs given ghs = dL/dhs: for CUDA tensors
    the reverse-recurrence kernel of the call's mode
    (fused_gru_backward_recurrence), then the weight-gradient kernel
    (fused_gru_weight_grads) and, with the evolve, its layers'
    (fused_mlp_weight_grads); the plain version for CPU tensors."""
    if gi.device.type == "cpu":
        return fused_gru_backward_reference(gi, hs, ghs, h0, whh, bhh, hdec,
                                            obs, hrow, ode)
    rec = fused_gru_backward_recurrence(gi, hs, ghs, h0, whh, bhh, hdec, obs,
                                        hrow, ode)
    dmlp = (fused_mlp_weight_grads(rec.acts, rec.dzs, *hs.shape, ode)
            if ode is not None else None)
    return FusedGRUGrads(rec.dgi, rec.dh0, *fused_gru_weight_grads(
        h0, hs, rec.dgh, hdec, rec.xin), rec.dhdec, rec.dhrow, dmlp)


def _gru_bwd_launch(mode, gi, hs, ghs, h0, whh, bhh, hdec, obs, hrow, ode,
                    stream, clusters) -> GRURecurrence:
    """The GRU's reverse recurrence in mode `mode` on any tensors; the
    decay row's cotangent from its `clusters` partials, summed here in
    cluster order."""
    L, B, H = hs.shape
    dev = gi.device
    dgi, dgh = _empty(L, B, 3 * H, device=dev), _empty(L, B, 3 * H,
                                                       device=dev)
    dh0 = _empty(B, H, device=dev)
    dhdec = _empty(L, B, H, device=dev) if hdec is not None else None
    dhrow = _empty(clusters, L, H, device=dev) if mode == 2 else None
    xin = _empty(L, B, H, device=dev) if mode in (2, 3) else None
    acts = dzs = None
    if mode == 3:
        acts, dzs = _evolve_streams(ode, L, B, H, hs)[:2]
    _GRU.launch("bwd", (gi, h0, hs, ghs, whh, bhh, hdec, obs, hrow,
                        *_mode_ptrs(ode), dgi, dgh, dh0, dhdec, dhrow, xin,
                        acts, dzs), (L, B, H) + _mode_ints(mode, ode), stream)
    return GRURecurrence(dgi, dgh, dh0, dhdec,
                         dhrow.sum(0) if dhrow is not None else None, xin,
                         acts, dzs)


def fused_gru_backward_recurrence(gi, hs, ghs, h0, whh, bhh, hdec=None,
                                  obs=None, hrow=None,
                                  ode=None) -> GRURecurrence:
    """The reverse recurrence alone (GRURecurrence: dgi [L, B, 3H] = [dr,
    dz, dn], W_hh's cotangent dgh [L, B, 3H] = [dr, dz, dn r], dh0 [B, H],
    and where the call's mode has them dhdec, dhrow, the cell's input
    states and the evolve's streams): the CUDA kernel for CUDA tensors,
    the plain reverse loop for CPU tensors."""
    if gi.device.type == "cpu":
        return _gru_reverse(gi, hs, ghs, h0, whh, bhh, hdec, obs, hrow, ode)
    mode = _gru_mode(hdec, obs, hrow, ode)
    L, B, H = check_gru_inputs(gi, h0, whh, bhh, hdec, hs, ghs, obs, hrow,
                               ode)
    shape = (H, B) + _mode_ints(mode, ode)
    stream = _GRU.stream(gi, shape, backward=True)
    clusters = -(-B // _GRU.kept("plan", *shape, 1, 1))
    rec = _gru_bwd_launch(mode, gi, hs, ghs, h0, whh, bhh, hdec, obs, hrow,
                          ode, stream, clusters)
    _count(_GRU_COUNTS[mode][1])
    return rec


def _weight_grads(lib, label, gates, hs, dg, ptrs, others, entry="wgrad"):
    """(dW_hh, db_hh) of the weight-gradient kernel, launched on `ptrs`
    (the library's order) through the library's `entry` after checking hs,
    dg and `others`: its split partials [S, H + 1, G H] (dW_hh's rows, then
    db_hh) summed here in a fixed order."""
    if hs.ndim != 3 or dg.shape[:2] != hs.shape[:2]:
        raise ValueError(f"{label} weight-gradient kernel: hs [L, B, H] and "
                         f"a cotangent [L, B, {gates}H] expected")
    L, B, H = hs.shape
    want = {"h0": (B, H), "hs": (L, B, H), "hdec": (L, B, H),
            "dg": (L, B, gates * H)}
    check_tensors(label, want, {**others, "hs": hs, "dg": dg}, hs.device)
    stream = lib.stream(hs, (H, B, 0, 0, 0, 0), backward=True)
    S = lib.kept(f"{entry}_splits", L, B, H)
    p = _empty(S, H + 1, gates * H, device=hs.device)
    lib.launch(entry, ptrs + (p,), (L, B, H), stream)
    s = p.sum(0)
    return s[:H], s[H]


def fused_gru_weight_grads(h0, hs, dgh, hdec=None, xin=None):
    """(dW_hh, db_hh) from the cell's input states (h0 [B, H], hs [L, B,
    H], hdec [L, B, H] or None; or the stream xin [L, B, H] of them that a
    mode's backward wrote) and W_hh's cotangent dgh [L, B, 3H]: the CUDA
    weight-gradient kernel for CUDA tensors (its split partials summed
    here, in a fixed order), the plain version for CPU tensors."""
    global GRU_WGRAD_LAUNCHES
    if hs.device.type == "cpu":
        return fused_gru_weight_grads_reference(h0, hs, dgh, hdec, xin)
    if xin is not None:
        # the kernel reads x_n as h0[n] for n < B and hs[n - B] after: xin
        # in place of both
        out = _weight_grads(_GRU, "fused GRU", 3, xin, dgh,
                            (xin[0], xin[1:], None, dgh), {})
    else:
        out = _weight_grads(_GRU, "fused GRU", 3, hs, dgh,
                            (h0, hs, hdec, dgh), {"h0": h0, "hdec": hdec})
    GRU_WGRAD_LAUNCHES += 1
    return out


def _mlp_partials(K, H, ode):
    """Floats of each evolve layer's split partials [S_i, in_i + 1,
    out_i] in the weight-gradient kernel's scratch, in layer order."""
    return [_GRU.kept("mlp_splits", K, i, j) * (i + 1) * j
            for i, j in _mlp_dims(H, ode.hh, ode.n)]


def _mlpgrad_launch(acts, dzs, L, B, H, ode, stream):
    """The evolve's weight gradients, packed as its mlp, from the kernel
    on any tensors: each layer's split partials summed here in a fixed
    order."""
    sizes = _mlp_partials(L * ode.steps * B, H, ode)
    p = _empty(sum(sizes), device=acts.device)
    _GRU.launch("mlpgrad", (acts, dzs, p),
                (L, B, H, ode.hh, ode.n, ode.steps), stream)
    out, o = [], 0
    for size, (i, j) in zip(sizes, _mlp_dims(H, ode.hh, ode.n)):
        s = p[o:o + size].view(-1, i + 1, j).sum(0)
        out += [s[:i].reshape(-1), s[i]]
        o += size
    return torch.cat(out)


def fused_mlp_weight_grads(acts, dzs, L, B, H, ode: Evolve) -> torch.Tensor:
    """The evolve's weight gradients, packed as its mlp, from either pair's
    backward streams (acts, dzs: each layer's input and output cotangent
    over the K = L S B rows): the CUDA weight-gradient kernel (one product
    a layer) for CUDA tensors, the plain version for CPU tensors."""
    global MLP_WGRAD_LAUNCHES
    if acts.device.type == "cpu":
        return fused_mlp_weight_grads_reference(acts, dzs, L, B, H, ode)
    K = L * ode.steps * B
    dims = _mlp_dims(H, ode.hh, ode.n)
    check_tensors("fused evolve", {"acts": (K * sum(i for i, _ in dims),),
                                   "dzs": (K * sum(j for _, j in dims),)},
                  {"acts": acts, "dzs": dzs}, acts.device)
    stream = _GRU.stream(acts, (H, B, 0, 0, 0, 0), backward=True)
    out = _mlpgrad_launch(acts, dzs, L, B, H, ode, stream)
    MLP_WGRAD_LAUNCHES += 1
    return out


def _lstm_mode(ode, sel, tg, dec) -> int:
    """The kernels' mode of an LSTM call: 0 plain, 1 the evolve, 2 sel, 3
    tg, 4 the memory decomposition. Two of them at once (no JAX caller
    does that) raise."""
    given = [m for m, x in ((1, ode), (2, sel), (3, tg), (4, dec))
             if x is not None]
    if len(given) > 1:
        unported("a combination of the LSTM's evolve, sel, tg and TLSTM "
                  "modes", "K7")
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
                     tg=None, dec=None):
    """(hs, cs, hcell) of the LSTM's forward kernel in mode `mode` on any
    tensors (cs None without save_cs, hcell None without it or the
    evolve)."""
    L, B, _ = gi.shape
    H = whh.shape[0]
    hs = _empty(L, B, H, device=gi.device)
    cs = _empty(L, B, H, device=gi.device) if save_cs else None
    hcell = (_empty(L, B, H, device=gi.device) if save_cs and mode == 1
             else None)
    _LSTM.launch("fwd", (gi, whh, bhh, *_lstm_mode_ptrs(ode, sel, tg, dec),
                         hs, cs, hcell),
                 (L, B, H) + _mode_ints(mode, ode), stream)
    return hs, cs, hcell


def fused_lstm_forward(gi, whh, bhh, save_cs: bool = True, ode=None,
                       sel=None, tg=None, dec=None):
    """(hs, cs, hcell) [L, B, H] each: the CUDA forward kernel of the
    call's mode for CUDA tensors (without save_cs it writes no cell-state
    stream: cs None), the plain version for CPU tensors. With the evolve
    `ode` (Evolve, dts [L, B]) hs is the evolved h and hcell the cells' own
    output h' (None without the evolve or without save_cs); sel, tg and
    dec (Decomp) as fused_lstm_forward_reference."""
    if gi.device.type == "cpu":
        return fused_lstm_forward_reference(gi, whh, bhh, save_cs, ode, sel,
                                            tg, dec)
    mode = _lstm_mode(ode, sel, tg, dec)
    L, B, H = check_lstm_inputs(gi, whh, bhh, ode=ode, sel=sel, tg=tg,
                                dec=dec)
    stream = _LSTM.stream(gi, (H, B) + _mode_ints(mode, ode), backward=False)
    out = _lstm_fwd_launch(mode, gi, whh, bhh, ode, save_cs, stream, sel, tg,
                           dec)
    _count(_LSTM_COUNTS[mode][0])
    return out


def fused_lstm_backward(gi, hs, cs, ghs, whh, bhh, ode=None,
                        hcell=None, sel=None, tg=None,
                        dec=None) -> FusedLSTMGrads:
    """Cotangents of the LSTM's inputs given ghs = dL/dhs: for CUDA tensors
    the reverse-recurrence kernel of the call's mode
    (fused_lstm_backward_recurrence), then the weight-gradient kernel
    (fused_lstm_weight_grads; TLSTM's W_d by fused_lstm_wd_grads) and,
    with the evolve `ode`, its layers' (fused_mlp_weight_grads); the plain
    version for CPU tensors."""
    if gi.device.type == "cpu":
        return fused_lstm_backward_reference(gi, hs, cs, ghs, whh, bhh, ode,
                                             hcell, sel, tg, dec)
    rec = fused_lstm_backward_recurrence(gi, hs, cs, ghs, whh, bhh, ode,
                                         hcell, sel, tg, dec)
    dmlp = (fused_mlp_weight_grads(rec.acts, rec.dzs, *hs.shape, ode)
            if ode is not None else None)
    dwd = (fused_lstm_wd_grads(cs, rec.dzd) if dec is not None
           else (None, None))
    return FusedLSTMGrads(rec.dgi, *fused_lstm_weight_grads(hs, rec.dgi),
                          dmlp, rec.dsel, rec.dtg, *dwd)


def _lstm_bwd_launch(mode, gi, hs, cs, hcell, ghs, whh, bhh, ode,
                     stream, sel=None, tg=None, dec=None) -> LSTMRecurrence:
    """The LSTM's reverse recurrence in mode `mode` on any tensors: dgi,
    the evolve's streams (mode 1), dsel (2), dtg (3) or dzd (4)."""
    L, B, H = hs.shape
    dgi = _empty(L, B, 4 * H, device=gi.device)
    acts, dzs = (_evolve_streams(ode, L, B, H, hs)[:2] if mode == 1
                 else (None, None))
    dmode = (_empty(L, B, 3 * H if mode == 3 else H, device=gi.device)
             if mode > 1 else None)
    _LSTM.launch("bwd", (gi, hs, cs, hcell, ghs, whh, bhh,
                         *_lstm_mode_ptrs(ode, sel, tg, dec), dgi, acts, dzs,
                         dmode),
                 (L, B, H) + _mode_ints(mode, ode), stream)
    return LSTMRecurrence(dgi, acts, dzs, *(dmode if mode == m else None
                                            for m in (2, 3, 4)))


def fused_lstm_backward_recurrence(gi, hs, cs, ghs, whh, bhh, ode=None,
                                   hcell=None, sel=None, tg=None,
                                   dec=None) -> LSTMRecurrence:
    """The reverse recurrence alone (LSTMRecurrence: dgi [L, B, 4H] and the
    call's mode's streams): the CUDA kernel for CUDA tensors, the plain
    reverse loop for CPU tensors."""
    if gi.device.type == "cpu":
        return _lstm_reverse(gi, hs, cs, ghs, whh, bhh, ode, hcell, sel, tg,
                             dec)
    mode = _lstm_mode(ode, sel, tg, dec)
    L, B, H = check_lstm_inputs(gi, whh, bhh, hs, cs, ghs,
                                hcell if mode == 1 else None, ode, sel, tg,
                                dec)
    if mode == 1 and hcell is None:
        raise ValueError("fused LSTM backward kernel: the evolve needs the "
                         "cells' own outputs hcell")
    stream = _LSTM.stream(gi, (H, B) + _mode_ints(mode, ode), backward=True)
    out = _lstm_bwd_launch(mode, gi, hs, cs, hcell, ghs, whh, bhh, ode,
                           stream, sel, tg, dec)
    _count(_LSTM_COUNTS[mode][1])
    return out


def fused_lstm_weight_grads(hs, dgi):
    """(dW_hh, db_hh) from hs [L, B, H] and dgi [L, B, 4H]: the CUDA
    weight-gradient kernel for CUDA tensors (its split partials summed
    here, in a fixed order), the plain version for CPU tensors."""
    global LSTM_WGRAD_LAUNCHES
    if hs.device.type == "cpu":
        return fused_lstm_weight_grads_reference(hs, dgi)
    out = _weight_grads(_LSTM, "fused LSTM", 4, hs, dgi, (hs, dgi), {})
    LSTM_WGRAD_LAUNCHES += 1
    return out


def fused_lstm_wd_grads(cs, dzd):
    """TLSTM's (dW_d [H, H], db_d [H]) from the cell states cs [L, B, H]
    and the cotangents dzd [L, B, H] of c_short's pre-activation
    c_{t-1} W_d + b_d (c_{-1} = 0): the weight-gradient kernel on those
    streams for CUDA tensors, the plain version for CPU tensors."""
    global LSTM_WD_WGRAD_LAUNCHES
    if cs.device.type == "cpu":
        return fused_lstm_weight_grads_reference(cs, dzd)
    out = _weight_grads(_LSTM, "fused LSTM W_d", 1, cs, dzd, (cs, dzd), {},
                        entry="wdgrad")
    LSTM_WD_WGRAD_LAUNCHES += 1
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
    evolve's packed weights mlp and dts [L] with meta = (n, hh, steps);
    backward by the backward kernels. obs and dts are data: no
    cotangent."""

    @staticmethod
    def forward(ctx, gi, h0, whh, bhh, hdec, obs=None, hrow=None, mlp=None,
                dts=None, meta=None):
        hs = fused_gru_forward(gi, h0, whh, bhh, hdec, obs, hrow,
                               _evolve_of(mlp, dts, meta))
        ctx.meta = meta
        ctx.save_for_backward(gi, h0, whh, bhh, hdec, obs, hrow, mlp, dts, hs)
        return hs

    @staticmethod
    def backward(ctx, ghs):
        gi, h0, whh, bhh, hdec, obs, hrow, mlp, dts, hs = ctx.saved_tensors
        g = fused_gru_backward(gi, hs, ghs.contiguous(), h0, whh, bhh, hdec,
                               obs, hrow, _evolve_of(mlp, dts, ctx.meta))
        return (g.dgi, g.dh0, g.dwhh, g.dbhh, g.dhdec, None, g.dhrow, g.dmlp,
                None, None)


def _decomp_of(wd, bd, tel):
    return Decomp(wd, bd, tel) if wd is not None else None


class FusedLSTM(torch.autograd.Function):
    """hs = the LSTM recurrence over gi [L, B, 4H] from zero (h, c) with
    W_hh [H, 4H], b_hh [4H] and, optionally, one mode: the evolve of h
    after each cell (packed weights mlp, dts [L, B], meta = (n, hh,
    steps)), PLSTM's sel [L, B, H], TGLSTM's tg [L, B, 3H], or TLSTM's
    memory decomposition (W_d [H, H], b_d [H], tel [L, B]); the cell-state
    trajectory (and the cells' own h') is saved for the backward kernel,
    not returned. dts and tel are data: no cotangent."""

    @staticmethod
    def forward(ctx, gi, whh, bhh, mlp=None, dts=None, meta=None, sel=None,
                tg=None, wd=None, bd=None, tel=None):
        hs, cs, hcell = fused_lstm_forward(gi, whh, bhh, True,
                                           _evolve_of(mlp, dts, meta), sel,
                                           tg, _decomp_of(wd, bd, tel))
        ctx.meta = meta
        ctx.save_for_backward(gi, whh, bhh, hs, cs, mlp, dts, hcell, sel, tg,
                              wd, bd, tel)
        return hs

    @staticmethod
    def backward(ctx, ghs):
        (gi, whh, bhh, hs, cs, mlp, dts, hcell, sel, tg, wd, bd,
         tel) = ctx.saved_tensors
        g = fused_lstm_backward(gi, hs, cs, ghs.contiguous(), whh, bhh,
                                _evolve_of(mlp, dts, ctx.meta), hcell, sel,
                                tg, _decomp_of(wd, bd, tel))
        return (g.dgi, g.dwhh, g.dbhh, g.dmlp, None, None, g.dsel, g.dtg,
                g.dwd, g.dbd, None)


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


def fused_gru_scan(cell, xs, h0=None, reverse: bool = False,
                   stream_dtype=None, obs=None, hdec=None, ode_layers=None,
                   tdif=None, ode_steps: int = 1) -> torch.Tensor:
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
    bf16 streams or operands (`stream_dtype`, SNSDE_FUSED_STREAM,
    SNSDE_FUSED_MATMUL), and the per-sample decay with any of the others,
    raise NotImplementedError (ROADMAP Queue 2 K6)."""
    require_fp32("the fused GRU recurrence", "K6", stream_dtype)
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
    hs = FusedGRU.apply(gi, h0.contiguous(), cell.w_hh.contiguous(),
                        cell.b_hh.contiguous(), hdec, obs, hrow, mlp, dts,
                        meta)
    return torch.flip(hs, (0,)) if reverse else hs


def fused_lstm_scan(cell, xs, reverse: bool = False, stream_dtype=None,
                    sel=None, tg=None, ode_layers=None, odt=None,
                    ode_steps: int = 1, tlstm=None,
                    tel=None) -> torch.Tensor:
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
    modes at once and bf16 streams or operands (`stream_dtype`,
    SNSDE_FUSED_STREAM, SNSDE_FUSED_MATMUL) raise NotImplementedError
    (ROADMAP Queue 2 K7)."""
    _lstm_mode(ode_layers if ode_layers is not None else odt, sel, tg,
               tlstm if tlstm is not None else tel)
    require_fp32("the fused LSTM recurrence", "K7", stream_dtype)
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
        dts = dts.to(xs.device)
    flip = (lambda a: torch.flip(a, (0,))) if reverse else (lambda a: a)
    sel = flip(sel).contiguous() if sel is not None else None
    tg = flip(tg).contiguous() if tg is not None else None
    wd = bd = None
    if tlstm is not None:
        wd, bd = tlstm.weight.t().contiguous(), tlstm.bias.contiguous()
        tel = flip(torch.as_tensor(tel, dtype=torch.float32,
                                   device=xs.device)).contiguous()
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (gi, whh, bhh, mlp, sel, tg, wd, bd)):
        hs = FusedLSTM.apply(gi, whh, bhh, mlp, dts, meta, sel, tg, wd, bd,
                             tel)
    else:
        hs = fused_lstm_forward(gi, whh, bhh, False,
                                _evolve_of(mlp, dts, meta), sel, tg,
                                _decomp_of(wd, bd, tel))[0]
    return torch.flip(hs, (0,)) if reverse else hs
