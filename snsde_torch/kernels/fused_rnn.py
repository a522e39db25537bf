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
the LSTM from zero (h, c), in both directions. The other modes of the JAX
kernels (`obs`, the time-only decay row, the ODE-RNN and ODE-LSTM evolves,
PLSTM's `sel`, TGLSTM's `tg`, TLSTM, bf16 streams) raise
NotImplementedError naming ROADMAP Queue 2 K6/K7; they never fall back to
an eager loop.

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

from ._solver import SolverLib, check_tensors

__all__ = ["fused_gru_scan", "fused_lstm_scan", "supports_fused_gru",
           "supports_fused_lstm", "FusedGRU", "FusedLSTM",
           "fused_gru_forward", "fused_gru_backward",
           "fused_gru_forward_reference", "fused_gru_backward_reference",
           "fused_gru_backward_recurrence", "fused_gru_weight_grads",
           "fused_gru_weight_grads_reference", "fused_gru_plan",
           "fused_lstm_forward", "fused_lstm_backward",
           "fused_lstm_forward_reference", "fused_lstm_backward_reference",
           "fused_lstm_backward_recurrence", "fused_lstm_weight_grads",
           "fused_lstm_weight_grads_reference",
           "fused_lstm_plan", "FusedGRUGrads", "FusedLSTMGrads", "MAX_H"]

# launches of each CUDA kernel since the count was last set to 0
GRU_FWD_LAUNCHES = 0
GRU_BWD_LAUNCHES = 0
GRU_WGRAD_LAUNCHES = 0
LSTM_FWD_LAUNCHES = 0
LSTM_BWD_LAUNCHES = 0
LSTM_WGRAD_LAUNCHES = 0

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


class FusedGRUGrads(NamedTuple):
    """Cotangents of the fused GRU's inputs (split partials summed)."""
    dgi: torch.Tensor                    # [L, B, 3H]
    dh0: torch.Tensor                    # [B, H]
    dwhh: torch.Tensor                   # [H, 3H]
    dbhh: torch.Tensor                   # [3H]
    dhdec: Optional[torch.Tensor]        # [L, B, H], None without hdec


class FusedLSTMGrads(NamedTuple):
    """Cotangents of the fused LSTM's inputs (split partials summed)."""
    dgi: torch.Tensor                    # [L, B, 4H]
    dwhh: torch.Tensor                   # [H, 4H]
    dbhh: torch.Tensor                   # [4H]


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


def fused_gru_forward_reference(gi, h0, whh, bhh, hdec=None) -> torch.Tensor:
    """Eager GRU loop: hs [L, B, H] (h after each step) from gi [L, B, 3H]
    (the input projection with b_ih), h0 [B, H], W_hh [H, 3H], b_hh [3H]
    and, when given, the per-sample decay hdec [L, B, H] applied to the
    state before each step."""
    h, hs = h0, []
    for t in range(gi.shape[0]):
        hin = h * hdec[t] if hdec is not None else h
        h = _gru_cell(gi[t], hin, whh, bhh)[0]
        hs.append(h)
    return torch.stack(hs)


def _gru_backward_loop(gi, hs, ghs, h0, whh, bhh, hdec=None):
    """The reverse loop of the GRU backward (the JAX `_bwd_kernel`'s):
    recompute the gates from the cell's input state before each step, then
    back through the gates, W_hh and the decay. (dgi [L, B, 3H] = [dr, dz,
    dn], dgh [L, B, 3H] = [dr, dz, dn r] (W_hh's cotangent), dh0, dhdec or
    None.)"""
    dgi, dgh = torch.empty_like(gi), torch.empty_like(gi)
    dhdec = torch.empty_like(hdec) if hdec is not None else None
    gbar = torch.zeros_like(h0)
    for t in range(gi.shape[0] - 1, -1, -1):
        gbar = gbar + ghs[t]
        h = h0 if t == 0 else hs[t - 1]
        hin = h * hdec[t] if hdec is not None else h
        _, r, z, n, ghn = _gru_cell(gi[t], hin, whh, bhh)
        dn_pre = gbar * (1.0 - z) * (1.0 - n * n)
        dr_pre = dn_pre * ghn * r * (1.0 - r)
        dz_pre = gbar * (hin - n) * z * (1.0 - z)
        dgh[t] = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=-1)
        dgi[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1)
        dhin = gbar * z + dgh[t] @ whh.T
        if hdec is not None:
            dhdec[t] = dhin * h
            dhin = dhin * hdec[t]
        gbar = dhin
    return dgi, dgh, gbar, dhdec


def fused_gru_weight_grads_reference(h0, hs, dgh, hdec=None):
    """(dW_hh [H, 3H], db_hh [3H]) from the cell's input states and W_hh's
    cotangent dgh [L, B, 3H]: the gates' h-part is x_t W_hh + b_hh with
    x_t = h_{t-1} hdec_t (h_{-1} = h0; no decay without hdec), so dW_hh =
    sum_t x_t^T dgh_t and db_hh = sum dgh. One product over (step, row),
    as the weight-gradient kernel computes it."""
    H, G = hs.shape[-1], dgh.shape[-1]
    x = torch.cat([h0[None], hs[:-1]])
    if hdec is not None:
        x = x * hdec
    return x.reshape(-1, H).T @ dgh.reshape(-1, G), dgh.reshape(-1, G).sum(0)


def fused_gru_backward_reference(gi, hs, ghs, h0, whh, bhh,
                                 hdec=None) -> FusedGRUGrads:
    """Eager reverse loop mirroring the backward kernels (and the JAX
    `_bwd_kernel`), then the weight gradients from the cell's input states
    and dgh (fused_gru_weight_grads_reference)."""
    dgi, dgh, dh0, dhdec = _gru_backward_loop(gi, hs, ghs, h0, whh, bhh,
                                              hdec)
    return FusedGRUGrads(dgi, dh0, *fused_gru_weight_grads_reference(
        h0, hs, dgh, hdec), dhdec)


def _lstm_cell(g, h, c, whh, bhh):
    """One LSTM step: (h', c', i, f, gg, o)."""
    H = h.shape[1]
    a = g + h @ whh + bhh
    i = torch.sigmoid(a[:, :H])
    f = torch.sigmoid(a[:, H:2 * H])
    gg = torch.tanh(a[:, 2 * H:3 * H])
    o = torch.sigmoid(a[:, 3 * H:])
    c2 = f * c + i * gg
    return o * torch.tanh(c2), c2, i, f, gg, o


def fused_lstm_forward_reference(gi, whh, bhh, save_cs: bool = True):
    """Eager LSTM loop from zero (h, c): (hs [L, B, H], cs [L, B, H] or None
    when save_cs is False)."""
    B, H = gi.shape[1], whh.shape[0]
    h = c = gi.new_zeros((B, H))
    hs, cs = [], []
    for t in range(gi.shape[0]):
        h, c = _lstm_cell(gi[t], h, c, whh, bhh)[:2]
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), (torch.stack(cs) if save_cs else None)


def fused_lstm_weight_grads_reference(hs, dgi):
    """(dW_hh [H, 4H], db_hh [4H]) from the hidden trajectory hs [L, B, H]
    and the gate cotangents dgi [L, B, 4H]: the gate pre-activation is
    gi + h W_hh + b_hh, so W_hh's cotangent is dgi itself, and dW_hh =
    sum_t h_{t-1}^T dgi_t (h_{-1} = 0), db_hh = sum dgi. One product over
    (step, row), as the weight-gradient kernel computes it."""
    H, G = hs.shape[-1], dgi.shape[-1]
    dwhh = hs[:-1].reshape(-1, H).T @ dgi[1:].reshape(-1, G)
    return dwhh, dgi.reshape(-1, G).sum(0)


def fused_lstm_backward_reference(gi, hs, cs, ghs, whh,
                                  bhh) -> FusedLSTMGrads:
    """Eager reverse loop mirroring the backward kernels (and the JAX
    `_lstm_bwd_kernel`): recompute the gates from (h, c) before each step,
    then back through the cell and W_hh to dgi; then the weight gradients
    from hs and dgi (fused_lstm_weight_grads_reference)."""
    dgi = torch.empty_like(gi)
    zero = torch.zeros_like(hs[0])
    gh, gc = zero, zero
    for t in range(gi.shape[0] - 1, -1, -1):
        gh = gh + ghs[t]
        h, c = (zero, zero) if t == 0 else (hs[t - 1], cs[t - 1])
        _, c2, i, f, gg, o = _lstm_cell(gi[t], h, c, whh, bhh)
        tc = torch.tanh(c2)
        dc = gc + gh * o * (1.0 - tc * tc)
        dgates = torch.cat([dc * gg * i * (1.0 - i), dc * c * f * (1.0 - f),
                            dc * i * (1.0 - gg * gg),
                            gh * tc * o * (1.0 - o)], dim=-1)
        dgi[t] = dgates
        gh = dgates @ whh.T
        gc = dc * f
    return FusedLSTMGrads(dgi, *fused_lstm_weight_grads_reference(hs, dgi))


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

# built and loaded at first launch; one library, csrc/fused_rnn.cu
_GRU = SolverLib("fused_gru", "fused GRU", 6, 11, int_names=("L", "B", "H"),
                 shape_names=("H", "B"), source="fused_rnn",
                 launches={"wgrad": 5},
                 int_fns={"plan": 4, "wgrad_splits": 3})
_LSTM = SolverLib("fused_lstm", "fused LSTM", 5, 7,
                  int_names=("L", "B", "H"), shape_names=("H", "B"),
                  source="fused_rnn", launches={"wgrad": 3},
                  int_fns={"plan": 4, "wgrad_splits": 3})
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


def check_gru_inputs(gi, h0, whh, bhh, hdec=None, hs=None, ghs=None):
    """Raise ValueError on what the GRU kernels do not take: a dtype other
    than float32, tensors on different devices, a non-contiguous tensor, a
    shape that disagrees with gi/W_hh, or H above MAX_H. Returns (L, B, H)."""
    L, B, H = _dims("fused GRU", gi, whh, 3)
    want = {"gi": (L, B, 3 * H), "h0": (B, H), "whh": (H, 3 * H),
            "bhh": (3 * H,), "hdec": (L, B, H), "hs": (L, B, H),
            "ghs": (L, B, H)}
    check_tensors("fused GRU", want, {"gi": gi, "h0": h0, "whh": whh,
                                      "bhh": bhh, "hdec": hdec, "hs": hs,
                                      "ghs": ghs}, gi.device)
    return L, B, H


def check_lstm_inputs(gi, whh, bhh, hs=None, cs=None, ghs=None):
    """As check_gru_inputs, for the LSTM kernels."""
    L, B, H = _dims("fused LSTM", gi, whh, 4)
    want = {"gi": (L, B, 4 * H), "whh": (H, 4 * H), "bhh": (4 * H,),
            "hs": (L, B, H), "cs": (L, B, H), "ghs": (L, B, H)}
    check_tensors("fused LSTM", want, {"gi": gi, "whh": whh, "bhh": bhh,
                                       "hs": hs, "cs": cs, "ghs": ghs},
                  gi.device)
    return L, B, H


def _empty(*shape, device):
    return torch.empty(shape, dtype=torch.float32, device=device)


def fused_gru_forward(gi, h0, whh, bhh, hdec=None) -> torch.Tensor:
    """hs [L, B, H]: the CUDA forward kernel for CUDA tensors, the plain
    version for CPU tensors."""
    global GRU_FWD_LAUNCHES
    if gi.device.type == "cpu":
        return fused_gru_forward_reference(gi, h0, whh, bhh, hdec)
    L, B, H = check_gru_inputs(gi, h0, whh, bhh, hdec)
    stream = _GRU.stream(gi, (H, B), backward=False)
    hs = _empty(L, B, H, device=gi.device)
    _GRU.launch("fwd", (gi, h0, whh, bhh, hdec, hs), (L, B, H), stream)
    GRU_FWD_LAUNCHES += 1
    return hs


def fused_gru_backward(gi, hs, ghs, h0, whh, bhh, hdec=None) -> FusedGRUGrads:
    """Cotangents of the GRU's inputs given ghs = dL/dhs: for CUDA tensors
    the reverse-recurrence kernel (dgi, dh0, dhdec and W_hh's cotangent
    dgh), then the weight-gradient kernel (fused_gru_weight_grads); the
    plain version for CPU tensors."""
    if gi.device.type == "cpu":
        return fused_gru_backward_reference(gi, hs, ghs, h0, whh, bhh, hdec)
    dgi, dgh, dh0, dhdec = fused_gru_backward_recurrence(gi, hs, ghs, h0,
                                                         whh, bhh, hdec)
    return FusedGRUGrads(dgi, dh0, *fused_gru_weight_grads(h0, hs, dgh,
                                                           hdec), dhdec)


def fused_gru_backward_recurrence(gi, hs, ghs, h0, whh, bhh, hdec=None):
    """(dgi, dgh, dh0, dhdec), the reverse recurrence alone: dgi [L, B,
    3H] = [dr, dz, dn], W_hh's cotangent dgh [L, B, 3H] = [dr, dz, dn r],
    dh0 [B, H] and dhdec [L, B, H] (None without hdec). The CUDA kernel for
    CUDA tensors, the plain reverse loop for CPU tensors."""
    global GRU_BWD_LAUNCHES
    if gi.device.type == "cpu":
        return _gru_backward_loop(gi, hs, ghs, h0, whh, bhh, hdec)
    L, B, H = check_gru_inputs(gi, h0, whh, bhh, hdec, hs, ghs)
    stream = _GRU.stream(gi, (H, B), backward=True)
    dev = gi.device
    dgi, dgh = _empty(L, B, 3 * H, device=dev), _empty(L, B, 3 * H,
                                                       device=dev)
    dh0 = _empty(B, H, device=dev)
    dhdec = _empty(L, B, H, device=dev) if hdec is not None else None
    _GRU.launch("bwd", (gi, h0, hs, ghs, whh, bhh, hdec, dgi, dgh, dh0,
                        dhdec), (L, B, H), stream)
    GRU_BWD_LAUNCHES += 1
    return dgi, dgh, dh0, dhdec


def _weight_grads(lib, label, gates, hs, dg, ptrs, others):
    """(dW_hh, db_hh) of the weight-gradient kernel, launched on `ptrs`
    (the library's order) after checking hs, dg and `others`: its split
    partials [S, H + 1, G H] (dW_hh's rows, then db_hh) summed here in a
    fixed order."""
    if hs.ndim != 3 or dg.shape[:2] != hs.shape[:2]:
        raise ValueError(f"{label} weight-gradient kernel: hs [L, B, H] and "
                         f"a cotangent [L, B, {gates}H] expected")
    L, B, H = hs.shape
    want = {"h0": (B, H), "hs": (L, B, H), "hdec": (L, B, H),
            "dg": (L, B, gates * H)}
    check_tensors(label, want, {**others, "hs": hs, "dg": dg}, hs.device)
    stream = lib.stream(hs, (H, B), backward=True)
    S = lib.kept("wgrad_splits", L, B, H)
    p = _empty(S, H + 1, gates * H, device=hs.device)
    lib.launch("wgrad", ptrs + (p,), (L, B, H), stream)
    s = p.sum(0)
    return s[:H], s[H]


def fused_gru_weight_grads(h0, hs, dgh, hdec=None):
    """(dW_hh, db_hh) from the cell's input states (h0 [B, H], hs [L, B,
    H], hdec [L, B, H] or None) and W_hh's cotangent dgh [L, B, 3H]: the
    CUDA weight-gradient kernel for CUDA tensors (its split partials summed
    here, in a fixed order), the plain version for CPU tensors."""
    global GRU_WGRAD_LAUNCHES
    if hs.device.type == "cpu":
        return fused_gru_weight_grads_reference(h0, hs, dgh, hdec)
    out = _weight_grads(_GRU, "fused GRU", 3, hs, dgh, (h0, hs, hdec, dgh),
                        {"h0": h0, "hdec": hdec})
    GRU_WGRAD_LAUNCHES += 1
    return out


def fused_lstm_forward(gi, whh, bhh, save_cs: bool = True):
    """(hs, cs) [L, B, H] each, cs None when save_cs is False: the CUDA
    forward kernel for CUDA tensors (without save_cs it writes no
    cell-state stream), the plain version for CPU tensors."""
    global LSTM_FWD_LAUNCHES
    if gi.device.type == "cpu":
        return fused_lstm_forward_reference(gi, whh, bhh, save_cs)
    L, B, H = check_lstm_inputs(gi, whh, bhh)
    stream = _LSTM.stream(gi, (H, B), backward=False)
    hs = _empty(L, B, H, device=gi.device)
    cs = _empty(L, B, H, device=gi.device) if save_cs else None
    _LSTM.launch("fwd", (gi, whh, bhh, hs, cs), (L, B, H), stream)
    LSTM_FWD_LAUNCHES += 1
    return hs, cs


def fused_lstm_backward(gi, hs, cs, ghs, whh, bhh) -> FusedLSTMGrads:
    """Cotangents of the LSTM's inputs given ghs = dL/dhs: for CUDA tensors
    the reverse-recurrence kernel (dgi), then the weight-gradient kernel
    (fused_lstm_weight_grads); the plain version for CPU tensors."""
    if gi.device.type == "cpu":
        return fused_lstm_backward_reference(gi, hs, cs, ghs, whh, bhh)
    dgi = fused_lstm_backward_recurrence(gi, hs, cs, ghs, whh, bhh)
    return FusedLSTMGrads(dgi, *fused_lstm_weight_grads(hs, dgi))


def fused_lstm_backward_recurrence(gi, hs, cs, ghs, whh, bhh):
    """dgi [L, B, 4H], the reverse recurrence alone: the CUDA kernel for
    CUDA tensors, the plain reverse loop for CPU tensors."""
    global LSTM_BWD_LAUNCHES
    if gi.device.type == "cpu":
        return fused_lstm_backward_reference(gi, hs, cs, ghs, whh, bhh).dgi
    L, B, H = check_lstm_inputs(gi, whh, bhh, hs, cs, ghs)
    stream = _LSTM.stream(gi, (H, B), backward=True)
    dgi = _empty(L, B, 4 * H, device=gi.device)
    _LSTM.launch("bwd", (gi, hs, cs, ghs, whh, bhh, dgi), (L, B, H), stream)
    LSTM_BWD_LAUNCHES += 1
    return dgi


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


def _plan(lib, H, B, backward):
    return {name: lib.call("plan", H, B, int(backward), i)
            for i, name in enumerate(_PLAN_FIELDS)}


def fused_gru_plan(H: int, B: int, backward: bool) -> dict:
    """The CUDA library's plan of a GRU launch at (H, B): CTAs per
    cluster, batch rows per cluster, whether the W_hh slices sit in shared
    memory, rows per thread, cudaOccupancyMaxActiveClusters (a negative
    CUDA error when the plan cannot be scheduled) and the shared bytes per
    CTA. Needs the card."""
    return _plan(_GRU, H, B, backward)


def fused_lstm_plan(H: int, B: int, backward: bool) -> dict:
    """As fused_gru_plan, for an LSTM launch."""
    return _plan(_LSTM, H, B, backward)


class FusedGRU(torch.autograd.Function):
    """hs = the GRU recurrence over gi [L, B, 3H] from h0 [B, H] with W_hh
    [H, 3H], b_hh [3H] and an optional decay stream hdec [L, B, H] (None
    for none); backward by the backward kernel."""

    @staticmethod
    def forward(ctx, gi, h0, whh, bhh, hdec):
        hs = fused_gru_forward(gi, h0, whh, bhh, hdec)
        ctx.save_for_backward(gi, h0, whh, bhh, hdec, hs)
        return hs

    @staticmethod
    def backward(ctx, ghs):
        gi, h0, whh, bhh, hdec, hs = ctx.saved_tensors
        g = fused_gru_backward(gi, hs, ghs.contiguous(), h0, whh, bhh, hdec)
        return g.dgi, g.dh0, g.dwhh, g.dbhh, g.dhdec


class FusedLSTM(torch.autograd.Function):
    """hs = the LSTM recurrence over gi [L, B, 4H] from zero (h, c) with
    W_hh [H, 4H], b_hh [4H]; the cell-state trajectory is saved for the
    backward kernel, not returned."""

    @staticmethod
    def forward(ctx, gi, whh, bhh):
        hs, cs = fused_lstm_forward(gi, whh, bhh, save_cs=True)
        ctx.save_for_backward(gi, whh, bhh, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, ghs):
        gi, whh, bhh, hs, cs = ctx.saved_tensors
        return tuple(fused_lstm_backward(gi, hs, cs, ghs.contiguous(), whh,
                                         bhh))


# ---------------------------------------------------------------------------
# Public entries: a recurrence over a sequence through the kernels
# ---------------------------------------------------------------------------

def _unported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to the CUDA kernels yet (ROADMAP Queue 2 "
        f"{item})")


def _check_stream_dtype(stream_dtype, item):
    if stream_dtype not in (None, torch.float32):
        _unported(f"stream_dtype={stream_dtype}", item)


def _projection(cell, xs, reverse):
    """gi = xs @ w_ih + b_ih over the (flipped, for reverse) sequence."""
    if reverse:
        xs = torch.flip(xs, (0,))
    return (xs @ cell.w_ih + cell.b_ih).contiguous()


def fused_gru_scan(cell, xs, h0=None, reverse: bool = False,
                   stream_dtype=None, obs=None, hdec=None, ode_layers=None,
                   tdif=None, ode_steps: int = 1) -> torch.Tensor:
    """The GRU recurrence through the fused kernels: xs [L, B, C] -> hs
    [L, B, H], the scan over the cell (torch (r, z, n) gates) from h0
    (zeros if None). reverse=True runs the backward direction of a
    bidirectional layer (hs[i] is the state after consuming xs[i:] from the
    right). hdec [L, B, H] is GRUD-full's per-sample hidden decay, applied
    to the state before each step; its cotangent reaches the decay net
    through autograd. As snsde/kernels/fused_rnn.py:432-522; `obs`, a
    time-only decay row (rank-2 hdec), the ODE-RNN evolve and bf16 streams
    raise NotImplementedError."""
    if obs is not None:
        _unported("the observation mask `obs` (GRU-dt, GRU-D)", "K6")
    if ode_layers is not None or tdif is not None:
        _unported("the ODE-RNN evolve (`ode_layers`, `tdif`)", "K6")
    if hdec is not None and hdec.ndim != 3:
        _unported("a time-only hidden-decay row (rank-2 hdec, GRU-D)", "K6")
    _check_stream_dtype(stream_dtype, "K6")
    if not supports_fused_gru(cell):
        raise ValueError(f"fused GRU kernels take GRUCell-shaped cells with "
                         f"H <= {MAX_H}; got {type(cell).__name__}")
    B = xs.shape[1]
    H = cell.hidden_size
    if h0 is None:
        h0 = xs.new_zeros((B, H))
    gi = _projection(cell, xs, reverse)
    if hdec is not None and reverse:
        hdec = torch.flip(hdec, (0,))
    if hdec is not None:
        hdec = hdec.contiguous()
    hs = FusedGRU.apply(gi, h0.contiguous(), cell.w_hh.contiguous(),
                        cell.b_hh.contiguous(), hdec)
    return torch.flip(hs, (0,)) if reverse else hs


def fused_lstm_scan(cell, xs, reverse: bool = False, stream_dtype=None,
                    sel=None, tg=None, ode_layers=None, odt=None,
                    ode_steps: int = 1, tlstm=None,
                    tel=None) -> torch.Tensor:
    """The LSTM recurrence through the fused kernels from zero (h, c): xs
    [L, B, C] -> hs [L, B, H], the scan over the cell (torch (i, f, g, o)).
    When no gradient will be asked for, the forward kernel runs alone and
    writes no cell-state stream. As snsde/kernels/fused_rnn.py:972-1058;
    PLSTM's `sel`, TGLSTM's `tg`, the ODE-LSTM evolve, TLSTM and bf16
    streams raise NotImplementedError."""
    if sel is not None:
        _unported("the PLSTM time gate `sel`", "K7")
    if tg is not None:
        _unported("the TGLSTM gate modifiers `tg`", "K7")
    if ode_layers is not None or odt is not None:
        _unported("the ODE-LSTM evolve (`ode_layers`, `odt`)", "K7")
    if tlstm is not None or tel is not None:
        _unported("the TLSTM memory decomposition (`tlstm`, `tel`)", "K7")
    _check_stream_dtype(stream_dtype, "K7")
    if not supports_fused_lstm(cell):
        raise ValueError(f"fused LSTM kernels take LSTMCell-shaped cells "
                         f"with H <= {MAX_H}; got {type(cell).__name__}")
    gi = _projection(cell, xs, reverse)
    whh, bhh = cell.w_hh.contiguous(), cell.b_hh.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (gi, whh, bhh)):
        hs = FusedLSTM.apply(gi, whh, bhh)
    else:
        hs, _ = fused_lstm_forward(gi, whh, bhh, save_cs=False)
    return torch.flip(hs, (0,)) if reverse else hs
