"""Fused explicit Runge–Kutta CDE solve: two hand-written CUDA kernels for
Hopper (snsde_torch/csrc/fused_cde.cu) behind a `torch.autograd.Function`.

Replaces the Pallas TPU kernel pair of snsde/kernels/fused_cde.py —
`_fused_cde_forward` (pallas_call at :364, body `_fwd_kernel` :320, field
`_field_forward` :184) and `_fused_cde_backward` (pallas_call at :505, body
`_bwd_kernel` :385, field `_field_bwd` :218), the custom VJP `_fused_cde`
(:546-573) — for every field kind the JAX kernel takes: the FinalTanh
field (relu MLP, any number of inner layers), the SingleHiddenLayer field
(tanh) and the GRU-ODE field (the `gruode` kind, :190-202 and :223-248),
on every tableau of `_TABLEAUS` (euler, midpoint, heun = rk2, rk4).

Per step, each stage evaluates the matrix field O(y) as [H, C] (h-major
[H*C]) at its stage state and contracts it with the control derivative
dX/dt at its stage time: O = tanh(MLP(y)) for the MLP fields, and for the
GRU-ODE field O = (1 - u)(tanh(r zh) - y[h]) with the gates r =
sigmoid(y W_r + b_r), u = sigmoid(y W_z + b_z), zh = y W_h + b_h, each
[H, H*C] with h-major columns (stacked as wg [3, H, H*C], bg [3, H*C]).
The derivative stream is precomputed outside the kernels by
`CubicPath.derivative_grid` at the distinct stage times of every step (one
row [NT*C] per step and batch row) and, unlike the SDE kernels' Brownian
stream, it is differentiated: the backward kernel returns its cotangent
ddx, and autograd carries it to the spline coefficients.

One launch solves K members (a seed ensemble) when every tensor but dts
has a leading K axis (z0 [K, B, H], ...): each member on its own weights,
initial state and control stream, and member k bit for bit its solo
launch under one plan (kernels/multi.py's `fused_cde_solve_packed`).

The JAX kernels' reduced precisions (K5) are kernels of their own
(csrc/fused_cde_red.cu), so the fp32 instances compile as they did: bf16
streams (dx, ys, gys, and ddx handed back, in bf16; the carry fp32 and only
the trajectory rounded, `fused_cde.py:343`; the backward from the rounded
state, z0 rounded too, `:464`) and bf16x3 or bf16 operands of the MLP
fields' in-kernel products and one-hot contractions (`_field`,
`_field_bwd`); the GRU-ODE field's operands stay exact fp32 (`:691-697`).
The entries take `stream_dtype=` and `matmul=`, None resolving from
SNSDE_FUSED_STREAM and SNSDE_FUSED_MATMUL as the JAX entry does.

What bounds the kernels on the H100, and the design, are described in the
CUDA sources. Each kernel has a plain PyTorch version beside it with the
same inputs and outputs. `fused_cde_forward`/`fused_cde_backward` take the
plain versions only for tensors on the CPU; for CUDA tensors they launch
the kernel or raise.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.solve import make_grid
from ._solver import (SolverLib, bf16_round, check_tensors, count_precision,
                      member_count, member_shapes, mm_op, one_hot_op,
                      per_member, precision_counts, precision_ints,
                      resolve_precision, widen, widen_output)

__all__ = ["fused_cde_solve", "fused_cde_inputs", "supports_fused_cde",
           "FusedCDE", "fused_cde_forward", "fused_cde_backward",
           "fused_cde_forward_reference", "fused_cde_backward_reference",
           "FusedCDEGrads", "check_kernel_inputs", "FUSED_CDE_METHODS",
           "fused_cde_plan", "force_cde_plan"]

# launches of each CUDA kernel since the count was last set to 0: solo
# launches of the MLP fields, of the GRU-ODE field (GRU_), and launches
# with a member axis of any field (PACKED_)
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
GRU_FWD_LAUNCHES = 0
GRU_BWD_LAUNCHES = 0
PACKED_FWD_LAUNCHES = 0
PACKED_BWD_LAUNCHES = 0

# Explicit RK tableaus: method -> (c, A, b), as snsde/kernels/fused_cde.py:
# 67-77. Stage i evaluates at t + c[i] dt on state z + dt sum_j A[i][j] k_j;
# the step adds dt sum_i b[i] k_i.
_TABLEAUS = {
    "euler": ((0.0,), ((),), (1.0,)),
    "midpoint": ((0.0, 0.5), ((), (0.5,)), (0.0, 1.0)),
    "heun": ((0.0, 1.0), ((), (1.0,)), (0.5, 0.5)),
    "rk4": (
        (0.0, 0.5, 0.5, 1.0),
        ((), (0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
        (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0),
    ),
}
_TABLEAUS["rk2"] = _TABLEAUS["heun"]

FUSED_CDE_METHODS = frozenset(_TABLEAUS)

# the C interface's codes (csrc/fused_cde.cu); act is the field kind
_METHOD_CODE = {"euler": 0, "midpoint": 1, "heun": 2, "rk2": 2, "rk4": 3}
_ACT_CODE = {"relu": 0, "tanh": 1, "gruode": 2}


def _stage_times(method):
    """Distinct stage-time offsets (ordered) + per-stage index into them."""
    c, _, _ = _TABLEAUS[method]
    uniq = sorted(set(c))
    return tuple(uniq), tuple(uniq.index(ci) for ci in c)


def _stage_grid(grid, hs, ut):
    """Stage times [M * len(ut)] (step-major) in the float32 arithmetic of
    the eager steppers (t0 + 0.5 dt, t0 + dt on float32 scalars), so a
    stage time lands in the same knot interval on both paths."""
    t32 = grid[:-1].astype(np.float32)
    h32 = hs.astype(np.float32)
    cols = []
    for u in ut:
        if u == 0.0:
            cols.append(t32)
        elif u == 1.0:
            cols.append(t32 + h32)
        else:
            cols.append(t32 + np.float32(u) * h32)
    return np.stack(cols, axis=1).reshape(-1)


def supports_fused_cde(func, method: str = "rk4") -> bool:
    """True when the CUDA kernels take (field, method): a field with
    `fused_weights()` (FinalTanh, SingleHiddenLayer, GRUODEField) on any
    tableau of _TABLEAUS, at any width: every field the JAX package's gate
    takes (snsde/kernels/fused_cde.py:600-631, H*C up to 4096) and more.
    Wout (the GRU-ODE field's gates) is split over a thread-block cluster;
    what does not fit a CTA's shared memory even so is read from device
    memory (the plan's levels, csrc/fused_cde.cu); only a field whose tiles
    do not fit even at one batch row a cluster raises ValueError at launch,
    never a quiet route to the eager solver."""
    return method in _TABLEAUS and hasattr(func, "fused_weights")


class FusedCDEGrads(NamedTuple):
    """Cotangents of the fused CDE solve's inputs (each with a leading
    member axis in a packed launch); None for the weights the field kind
    does not have (the MLP's for the GRU-ODE field, the gates' for the
    MLP fields)."""
    dz0: torch.Tensor                     # [B, H]
    ddx: torch.Tensor                     # [M, B, NT*C]
    dwin: Optional[torch.Tensor]          # [H, HH]
    dbin: Optional[torch.Tensor]          # [HH]
    dw_inner: Optional[torch.Tensor]      # [n_inner, HH, HH]
    db_inner: Optional[torch.Tensor]      # [n_inner, HH]
    dwout: Optional[torch.Tensor]         # [HH, H*C]
    dbout: Optional[torch.Tensor]         # [H*C]
    dwg: Optional[torch.Tensor] = None    # [3, H, H*C]: W_r, W_z, W_h
    dbg: Optional[torch.Tensor] = None    # [3, H*C]


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------

class _Weights(NamedTuple):
    """A field's weights as the plain versions read them (None where the
    kind has none) and the hidden layers' activation function `fn`."""
    act: str
    win: Optional[torch.Tensor]
    bin: Optional[torch.Tensor]
    w_inner: Optional[torch.Tensor]
    b_inner: Optional[torch.Tensor]
    wout: Optional[torch.Tensor]
    bout: Optional[torch.Tensor]
    wg: Optional[torch.Tensor]
    bg: Optional[torch.Tensor]
    fn: object


def _act_d(act, h):
    return (h > 0).to(h.dtype) if act == "relu" else 1.0 - h * h


def _field(y, d, w: _Weights, matmul: str = "f32"):
    """One field evaluation at stage state y [B, H] against the stage's
    control derivative d [B, C]: (k [B, H], what the backward reads (the
    hidden activations, or the gates r, u, zh and tanh(r zh)), O
    [B, H*C]). The MLP's products take operand mode `matmul`, and so do
    the JAX kernel's two one-hot contractions (fused_cde.py:200-201): d
    through E (each d_c rounded or split) and O Dx through S (each term
    rounded or split before the sum over c); the GRU-ODE field's are
    exact fp32 (its operands pinned, :691-697)."""
    B, H, C = y.shape[0], y.shape[1], d.shape[1]
    if w.act == "gruode":
        r = torch.sigmoid(y @ w.wg[0] + w.bg[0])
        u = torch.sigmoid(y @ w.wg[1] + w.bg[1])
        zh = y @ w.wg[2] + w.bg[2]
        g = torch.tanh(r * zh)
        o = (1.0 - u) * (g - y.repeat_interleave(C, dim=1))
        aux = (r, u, zh, g)
    else:
        aux = [w.fn(mm_op(y, w.win, matmul) + w.bin)]
        for l in range(w.w_inner.shape[0]):
            aux.append(w.fn(mm_op(aux[-1], w.w_inner[l], matmul)
                            + w.b_inner[l]))
        o = torch.tanh(mm_op(aux[-1], w.wout, matmul) + w.bout)
    dr = one_hot_op(d, matmul)
    k = one_hot_op(o.reshape(B, H, C) * dr[:, None, :], matmul).sum(-1)
    return k, aux, o


def _stage_rows(dx_u, NT):
    """The step's control row [B, NT*C] split per distinct stage time."""
    return dx_u.reshape(dx_u.shape[0], NT, -1).unbind(1)


def _stage_states(z, h, ds, tidx, A, w, matmul="f32"):
    """Stage states and increments of one step from the state z."""
    states, ks = [], []
    for i in range(len(tidx)):
        y = z
        for j, aij in enumerate(A[i]):
            if aij:
                y = y + (aij * h) * ks[j]
        states.append(y)
        ks.append(_field(y, ds[tidx[i]], w, matmul)[0])
    return states, ks


def _weights(act, win, bin, w_inner, b_inner, wout, bout, wg, bg, relu):
    if act not in _ACT_CODE:
        raise ValueError(f"fused CDE: no field kind {act!r}")
    return _Weights(act, win, bin, w_inner, b_inner, wout, bout, wg, bg,
                    relu if act == "relu" else torch.tanh)


def fused_cde_forward_reference(z0, dx, dts, win, bin, w_inner, b_inner,
                                wout, bout, wg=None, bg=None, *,
                                method: str, act: str, stream: str = "f32",
                                matmul: str = "f32",
                                relu=torch.relu) -> torch.Tensor:
    """Eager explicit-RK loop: ys [M, B, H] (z after each step). Weights in
    [in, out] layout (the GRU-ODE field's gates wg [3, H, H*C], bg
    [3, H*C], the MLP's None); dx [M, B, NT*C]. With act "relu" every
    hidden activation is `relu` (a stand-in may probe the
    pre-activations). The MLP fields' products and one-hot contractions
    take operand mode `matmul` (_field). With `stream` 'bf16' (the JAX
    kernel's traj_bf16) dx arrives in bf16, the carry stays in z0's dtype
    and only the written trajectory is rounded (fused_cde.py:343)."""
    _, A, btab = _TABLEAUS[method]
    _, tidx = _stage_times(method)
    NT = max(tidx) + 1
    w = _weights(act, win, bin, w_inner, b_inner, wout, bout, wg, bg, relu)
    dx = widen(dx, z0)
    z = z0
    ys = []
    for u in range(dts.shape[0]):
        h = dts[u]
        _, ks = _stage_states(z, h, _stage_rows(dx[u], NT), tidx, A, w,
                              matmul)
        for i, bi in enumerate(btab):
            if bi:
                z = z + (bi * h) * ks[i]
        ys.append(z)
    ys = torch.stack(ys)
    return ys.to(torch.bfloat16) if stream == "bf16" else ys


def _field_bwd(y, aux, o, d, dk, w: _Weights, acc, matmul="f32"):
    """Back through one field evaluation given dk = dL/dk: adds the weight
    gradients into acc; returns (dy, the stage's control cotangent
    [B, C]). The GRU-ODE field's as the JAX kernel's (fused_cde.py:
    223-248). In operand mode `matmul` every product rounds or splits its
    operands, and so do the one-hot contractions' transposes (:227-229,
    :445): dk through S^T (each dk_h), the control's cotangent through
    E^T (each term before the sum over h), and the forward's Dx is the
    rounded or split d."""
    B, H, C = y.shape[0], y.shape[1], d.shape[1]
    mm = lambda p, q: mm_op(p, q, matmul)
    oc = o.reshape(B, H, C)
    dp = one_hot_op(dk, matmul)[:, :, None]
    dd = one_hot_op(dp * oc, matmul).sum(1)
    do = (dp * one_hot_op(d, matmul)[:, None, :]).reshape(B, H * C)
    if w.act == "gruode":
        r, u, zh, g = aux
        dgg = do * (1.0 - u)
        dgate = dgg * (1.0 - g * g)
        dzs = (dgate * zh * r * (1.0 - r),
               -do * (g - y.repeat_interleave(C, dim=1)) * u * (1.0 - u),
               dgate * r)
        dy = None
        for i, dz in enumerate(dzs):
            acc["wg"][i] += y.T @ dz
            acc["bg"][i] += dz.sum(0)
            dy = dz @ w.wg[i].T if dy is None else dy + dz @ w.wg[i].T
        return dy - dgg.reshape(B, H, C).sum(-1), dd
    hs = aux
    dzout = do * (1.0 - o * o)
    acc["wout"] += mm(hs[-1].T, dzout)
    acc["bout"] += dzout.sum(0)
    dh = mm(dzout, w.wout.T)
    for l in range(w.w_inner.shape[0] - 1, -1, -1):
        dz = dh * _act_d(w.act, hs[l + 1])
        acc["w_inner"][l] += mm(hs[l].T, dz)
        acc["b_inner"][l] += dz.sum(0)
        dh = mm(dz, w.w_inner[l].T)
    dz1 = dh * _act_d(w.act, hs[0])
    acc["win"] += mm(y.T, dz1)
    acc["bin"] += dz1.sum(0)
    return mm(dz1, w.win.T), dd


_GRAD_NAMES = ("win", "bin", "w_inner", "b_inner", "wout", "bout", "wg", "bg")


def fused_cde_backward_reference(z0, ys, gys, dx, dts, win, bin, w_inner,
                                 b_inner, wout, bout, wg=None, bg=None, *,
                                 method: str, act: str, stream: str = "f32",
                                 matmul: str = "f32",
                                 relu=torch.relu) -> FusedCDEGrads:
    """Eager reverse loop mirroring the backward kernel (and the JAX
    `_bwd_kernel`): recompute the stage states from the state before the
    step, then reverse the tableau from the last stage to the first.
    `relu` as in the forward; its derivative is read from its output
    (> 0). Operand mode `matmul` as the forward's (_field_bwd); with
    `stream` 'bf16' the states are the rounded trajectory's (z0 rounded
    too, fused_cde.py:464), gys and dx arrive in bf16 and ddx leaves in
    bf16 (:486), every other cotangent in z0's dtype."""
    _, A, btab = _TABLEAUS[method]
    _, tidx = _stage_times(method)
    NT = max(tidx) + 1
    w = _weights(act, win, bin, w_inner, b_inner, wout, bout, wg, bg, relu)
    acc = {n: None if t is None else torch.zeros_like(t)
           for n, t in zip(_GRAD_NAMES, (win, bin, w_inner, b_inner, wout,
                                         bout, wg, bg))}
    ddx_dtype = dx.dtype
    z0 = bf16_round(z0) if stream == "bf16" else z0
    ys, gys, dx = widen(ys, z0), widen(gys, z0), widen(dx, z0)
    ddx = torch.empty_like(dx)
    gbar = torch.zeros_like(z0)
    for u in range(dts.shape[0] - 1, -1, -1):
        gbar = gbar + gys[u]
        z = z0 if u == 0 else ys[u - 1]
        h = dts[u]
        ds = _stage_rows(dx[u], NT)
        states, _ = _stage_states(z, h, ds, tidx, A, w, matmul)
        dks = [(bi * h) * gbar if bi else torch.zeros_like(gbar)
               for bi in btab]
        dd = [torch.zeros_like(d) for d in ds]
        for i in range(len(btab) - 1, -1, -1):
            _, aux, o = _field(states[i], ds[tidx[i]], w, matmul)
            dy, dd_i = _field_bwd(states[i], aux, o, ds[tidx[i]], dks[i], w,
                                  acc, matmul)
            dd[tidx[i]] = dd[tidx[i]] + dd_i
            gbar = gbar + dy
            for j, aij in enumerate(A[i]):
                if aij:
                    dks[j] = dks[j] + (aij * h) * dy
        ddx[u] = torch.cat(dd, dim=-1)
    return FusedCDEGrads(gbar, ddx.to(ddx_dtype),
                         *(acc[n] for n in _GRAD_NAMES))


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

# built and loaded at first launch
_LIB = SolverLib("fused_cde", "fused CDE", 10, 15,
                 int_names=("M", "B", "H", "HH", "C", "n_inner", "method",
                            "act", "members"),
                 shape_names=("B", "H", "HH", "C", "n_inner", "method",
                              "act", "members"),
                 int_fns={"plan": 10, "force_placement": 1, "force_plan": 2})

# the reduced precisions' library (csrc/fused_cde_red.cu): kernels of
# their own, so that the fp32 instances above compile as they did; its
# launches take the operand mode (MATMUL_CODE) and the stream flag (1: bf16
# streams) after the members
_RED = SolverLib("fused_cde_red", "fused CDE (reduced precision)", 10, 15,
                 int_names=_LIB.int_names + ("matmul", "stream"),
                 shape_names=_LIB.shape_names, int_fns={"plan": 10})
# launches of the reduced precisions' kernels (solo or packed), keyed
# "<kernel> <operand mode> <stream dtype>"
PRECISION_LAUNCHES = precision_counts(("fwd", "bwd"))

_PLAN_FIELDS = ("level", "rows", "cluster", "keep", "active_clusters",
                "smem_bytes")


def fused_cde_plan(B: int, H: int, HH: int, C: int, n_inner: int,
                   method: str, backward: bool, act: str = "relu",
                   members: int = 1) -> dict:
    """The CUDA library's plan of a CDE launch of a field kind (the
    GRU-ODE field: HH = H, n_inner = 0) over `members` members: its level
    (0 everything in shared memory ... 6 fewer rows, csrc/fused_cde.cu),
    batch rows and CTAs a cluster, whether the backward keeps the stage
    activations, cudaOccupancyMaxActiveClusters (a negative CUDA error when
    the plan cannot be scheduled) and the shared bytes a CTA. Needs the
    card."""
    shape = (B, H, HH, C, n_inner, _METHOD_CODE[method], _ACT_CODE[act],
             members, int(backward))
    return {name: _LIB.call("plan", *shape, i)
            for i, name in enumerate(_PLAN_FIELDS)}


def force_cde_plan(cluster: int = 0, rows: int = 0) -> None:
    """Make later launches take clusters of `cluster` CTAs and `rows`
    batch rows a cluster (0: the plan's own choice of each); for tests of
    each plan. Raises ValueError on a size the kernels do not take."""
    if _LIB.call("force_plan", cluster, rows) != 0:
        raise ValueError(f"no CDE plan with {cluster} CTAs and {rows} rows "
                         f"a cluster")
    _LIB._kept.clear()


def _checked(z0, dx, dts, win, bin, w_inner, b_inner, wout, bout, wg, bg,
             method, act, ys, gys, stream="f32"):
    """check_kernel_inputs's checks; (dims, K: 0 for a solo launch)."""
    if method not in _METHOD_CODE or act not in _ACT_CODE:
        raise ValueError(f"fused CDE kernels take methods "
                         f"{sorted(_METHOD_CODE)} and field kinds "
                         f"{sorted(_ACT_CODE)}; got {method!r}, {act!r}")
    gru = act == "gruode"
    mlp = (win, bin, w_inner, b_inner, wout, bout)
    if any((t is None) != gru for t in mlp) or any(
            (t is None) == gru for t in (wg, bg)):
        raise ValueError("fused CDE kernel: the GRU-ODE field takes wg and "
                         "bg alone, an MLP field win, bin, w_inner, "
                         "b_inner, wout and bout alone")
    K = member_count(z0)
    k = int(K > 0)
    if (z0.ndim != 2 + k or dts.ndim != 1 or dx.ndim != 3 + k
            or (not gru and (win.ndim != 2 + k or w_inner.ndim != 3 + k))):
        raise ValueError("fused CDE kernel: z0 [B,H], win [H,HH], w_inner "
                         "[n_inner,HH,HH], dts [M] and dx [M,B,NT*C] "
                         "expected (each but dts with a leading member "
                         "axis in a packed launch)")
    NT = len(_stage_times(method)[0])
    M, (B, H) = dts.shape[0], z0.shape[k:]
    HH, n_inner = (H, 0) if gru else (win.shape[k + 1], w_inner.shape[k])
    C = dx.shape[k + 2] // NT
    if dx.shape[k + 2] != NT * C or C == 0:
        raise ValueError(f"fused CDE kernel: dx has shape {tuple(dx.shape)}, "
                         f"expected (M, B, {NT} * C) for {method}")
    want = {"z0": (B, H), "dx": (M, B, NT * C), "dts": (M,), "win": (H, HH),
            "bin": (HH,), "w_inner": (n_inner, HH, HH),
            "b_inner": (n_inner, HH), "wout": (HH, H * C),
            "bout": (H * C,), "wg": (3, H, H * C), "bg": (3, H * C),
            "ys": (M, B, H), "gys": (M, B, H)}
    if K:
        want = member_shapes(want, K)
    got = {"z0": z0, "dx": dx, "dts": dts, "win": win, "bin": bin,
           "w_inner": w_inner, "b_inner": b_inner, "wout": wout,
           "bout": bout, "wg": wg, "bg": bg, "ys": ys, "gys": gys}
    check_tensors("fused CDE", want, got, z0.device,
                  bf16=("dx", "ys", "gys") if stream == "bf16" else ())
    return (M, B, H, HH, C, n_inner), K


def check_kernel_inputs(z0, dx, dts, win, bin, w_inner, b_inner, wout, bout,
                        wg=None, bg=None, *, method: str, act: str, ys=None,
                        gys=None, stream: str = "f32"):
    """Raise ValueError on what the kernels do not take: an unknown method
    or field kind, the weights of another kind, a dtype other than
    float32 (bfloat16 for dx, ys and gys with `stream` 'bf16'), tensors on
    different devices, a non-contiguous tensor, or a
    shape that disagrees with z0/win/w_inner/dts/dx (each but dts with a
    leading member axis in a packed launch). Returns (M, B, H, HH, C,
    n_inner) (HH = H, n_inner = 0 for the GRU-ODE field)."""
    return _checked(z0, dx, dts, win, bin, w_inner, b_inner, wout, bout, wg,
                    bg, method, act, ys, gys, stream)[0]


def _grad_shapes(H, HH, C, n_inner, act):
    """The weight gradients' shapes in the order of the library's summed
    output (csrc/fused_cde.cu: cde_parts), a member's."""
    if act == "gruode":
        return {"wg": (3, H, H * C), "bg": (3, H * C)}
    return {"win": (H, HH), "bin": (HH,), "w_inner": (n_inner, HH, HH),
            "b_inner": (n_inner, HH), "wout": (HH, H * C), "bout": (H * C,)}


def _shape(dims, method, act, K):
    """The ints of the library's plans at a launch's dims."""
    M, B, H, HH, C, n_inner = dims
    return (B, H, HH, C, n_inner, _METHOD_CODE[method], _ACT_CODE[act],
            max(K, 1))


def _empty(*shape, device, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=device)


def _launch_forward(dims, method, act, tensors, stream, K: int,
                    prec=(0, 0)):
    """ys of K members (0: a solo launch, without the member axis) from the
    forward's tensors (z0, dx, dts, win, bin, w_inner, b_inner, wout, bout,
    wg, bg; on any device: the library is called with their pointers);
    prec: the (operand mode, stream flag) of a reduced precision, launched
    on its own kernels."""
    M, B, H = dims[:3]
    z0, dx, dts, win, bin, wi, bi, wout, bout, wg, bg = tensors
    gru = act == "gruode"
    ys = _empty(*((K,) if K else ()), M, B, H, device=z0.device,
                dtype=torch.bfloat16 if prec[1] else torch.float32)
    red = prec != (0, 0)
    (_RED if red else _LIB).launch(
        "fwd", (z0, dx, dts, win, bin, wi, bi, wg if gru else wout,
                bg if gru else bout, ys),
        dims + (_METHOD_CODE[method], _ACT_CODE[act], max(K, 1))
        + (tuple(prec) if red else ()), stream)
    return ys


def _launch_backward(dims, method, act, tensors, stream,
                     K: int, prec=(0, 0)) -> FusedCDEGrads:
    """The backward's outputs from (z0, ys, gys, dx, dts, win, bin,
    w_inner, b_inner, wout, bout, wg, bg), as _launch_forward: ddx (in dx's
    dtype), dz0 and the weight gradients, which the library sums from its
    per-cluster partials in a fixed order. With bf16 streams z0 is the
    rounded state, in bf16 as ys."""
    M, B, H, HH, C, n_inner = dims
    z0, ys, gys, dx, dts, win, bin, wi, bi, wout, bout, wg, bg = tensors
    gru, m, dev = act == "gruode", (K,) if K else (), z0.device
    red = prec != (0, 0)
    lib = _RED if red else _LIB
    nb = -(-B // lib.rows(_shape(dims, method, act, K), backward=True))
    shapes = _grad_shapes(H, HH, C, n_inner, act)
    sizes = [math.prod(s) for s in shapes.values()]
    part = _empty(max(K, 1), nb, sum(sizes), device=dev)
    w = _empty(*m, sum(sizes), device=dev)
    ddx = _empty(*dx.shape, device=dev, dtype=dx.dtype)
    dz0 = _empty(*z0.shape, device=dev)
    lib.launch("bwd", (z0, ys, gys, dx, dts, win, bin, wi, bi,
                       wg if gru else wout, bg if gru else bout, ddx, dz0,
                       part, w),
               dims + (_METHOD_CODE[method], _ACT_CODE[act], max(K, 1))
               + (tuple(prec) if red else ()), stream)
    grads = {n: t.reshape(*m, *s) for (n, s), t in
             zip(shapes.items(), torch.split(w, sizes, dim=-1))}
    return FusedCDEGrads(dz0, ddx, *(grads.get(n) for n in _GRAD_NAMES))


_FWD_NAMES = ("z0", "dx", "dts", "win", "bin", "w_inner", "b_inner", "wout",
              "bout", "wg", "bg")
_BWD_NAMES = ("z0", "ys", "gys") + _FWD_NAMES[1:]


def _count(act, K, part):
    """One more launch of `part` ('FWD', 'BWD') on its counter."""
    key = ("PACKED_" if K else "GRU_" if act == "gruode" else "") + part
    globals()[f"{key}_LAUNCHES"] += 1


def _precision(act: str, stream: str, matmul: str) -> tuple:
    """A launch's precision ints (_solver.precision_ints); ValueError on
    reduced operands of the GRU-ODE field, which are exact fp32 (the
    entries pin them, fused_cde.py:691-697)."""
    if act == "gruode" and matmul != "f32":
        raise ValueError(f"fused CDE: the GRU-ODE field's operands are "
                         f"exact fp32; got {matmul!r}")
    return precision_ints("fused CDE", stream, matmul)


def fused_cde_forward(z0, dx, dts, win, bin, w_inner, b_inner, wout, bout,
                      wg=None, bg=None, *, method: str, act: str,
                      stream: str = "f32",
                      matmul: str = "f32") -> torch.Tensor:
    """ys [M, B, H] (with a leading member axis in a packed launch, z0
    [K, B, H]): the CUDA forward kernel for CUDA tensors, the plain version
    for CPU tensors (member by member in a packed launch). `matmul` is the
    MLP fields' operand mode ('f32', 'bf16x3', 'bf16'; the GRU-ODE field's
    is 'f32'); with `stream` 'bf16', dx comes and ys goes in bf16. A
    reduced precision runs on kernels of its own."""
    args = (z0, dx, dts, win, bin, w_inner, b_inner, wout, bout, wg, bg)
    prec = _precision(act, stream, matmul)
    kw = dict(method=method, act=act, stream=stream, matmul=matmul)
    if z0.device.type == "cpu":
        K = member_count(z0)
        if K:
            return per_member(fused_cde_forward_reference, _FWD_NAMES, args,
                              K, **kw)
        return fused_cde_forward_reference(*args, **kw)
    dims, K = _checked(*args, method, act, None, None, stream)
    red = prec != (0, 0)
    stream_h = (_RED if red else _LIB).stream(
        z0, _shape(dims, method, act, K), backward=False)
    ys = _launch_forward(dims, method, act, args, stream_h, K, prec)
    if red:
        count_precision(PRECISION_LAUNCHES, "fwd", stream, matmul)
    else:
        _count(act, K, "FWD")
    return ys


def fused_cde_backward(z0, ys, gys, dx, dts, win, bin, w_inner, b_inner,
                       wout, bout, wg=None, bg=None, *, method: str,
                       act: str, stream: str = "f32",
                       matmul: str = "f32") -> FusedCDEGrads:
    """Cotangents of the solve's inputs given gys = dL/dys: the CUDA
    backward kernel for CUDA tensors (its per-cluster partials summed in
    the library), the plain version for CPU tensors (member by member in a
    packed launch). The precision as fused_cde_forward's; with bf16 streams
    ys, gys and dx come and ddx goes in bf16, z0 float32 (the kernel reads
    it rounded)."""
    args = (dx, dts, win, bin, w_inner, b_inner, wout, bout, wg, bg)
    prec = _precision(act, stream, matmul)
    kw = dict(method=method, act=act, stream=stream, matmul=matmul)
    if z0.device.type == "cpu":
        K = member_count(z0)
        if K:
            return per_member(fused_cde_backward_reference, _BWD_NAMES,
                              (z0, ys, gys) + args, K, **kw)
        return fused_cde_backward_reference(z0, ys, gys, *args, **kw)
    dims, K = _checked(z0, *args, method, act, ys, gys, stream)
    red = prec != (0, 0)
    stream_h = (_RED if red else _LIB).stream(
        z0, _shape(dims, method, act, K), backward=True)
    z0k = z0.to(torch.bfloat16) if prec[1] else z0
    grads = _launch_backward(dims, method, act, (z0k, ys, gys) + args,
                             stream_h, K, prec)
    if red:
        count_precision(PRECISION_LAUNCHES, "bwd", stream, matmul)
    else:
        _count(act, K, "BWD")
    return grads


_ARG_ORDER = _FWD_NAMES


class FusedCDE(torch.autograd.Function):
    """ys = explicit-RK CDE solve; backward by the backward kernel. Inputs
    in _ARG_ORDER, then method and act, and optionally the precision (a
    dict of `stream` and `matmul`, exact fp32 without it): z0 [B,H], dx
    [M,B,NT*C], dts [M] (not differentiated), win [H,HH], bin [HH],
    w_inner [n_inner,HH,HH], b_inner [n_inner,HH], wout [HH,H*C], bout
    [H*C] (an MLP field; else None), wg [3,H,H*C], bg [3,H*C] (the GRU-ODE
    field; else None); in a packed solve of K members each but dts with a
    leading K axis, and ys [K, M, B, H]. With `stream` 'bf16', dx is bf16
    and so is ys (and the cotangent autograd hands back)."""

    @staticmethod
    def forward(ctx, *args):
        prec = args[-1] if isinstance(args[-1], dict) else {}
        *tensors, method, act = args[:len(args) - bool(prec)]
        ys = fused_cde_forward(*tensors, method=method, act=act, **prec)
        ctx.save_for_backward(*tensors, ys)
        ctx.flags = (method, act, prec)
        return ys

    @staticmethod
    def backward(ctx, gys):
        z0, *rest, ys = ctx.saved_tensors
        method, act, prec = ctx.flags
        gr = fused_cde_backward(z0, ys, gys.contiguous(), *rest,
                                method=method, act=act, **prec)
        return (gr.dz0, gr.ddx, None, gr.dwin, gr.dbin, gr.dw_inner,
                gr.db_inner, gr.dwout, gr.dbout, gr.dwg, gr.dbg, None,
                None) + (None,) * bool(prec)


# ---------------------------------------------------------------------------
# Public entry: solve a Neural CDE with the fused kernels
# ---------------------------------------------------------------------------

def fused_cde_inputs(func, path, grid: np.ndarray, z0: torch.Tensor,
                     method: str = "rk4") -> dict:
    """The kernels' inputs for a supported field on a host step grid: the
    control-derivative stream dx [M, B, NT*C] (dX/dt at each step's NT
    distinct stage times, from `path.derivative_grid`; differentiable
    through autograd), the step sizes, the weights in [in, out] layout (an
    MLP field's, or the GRU-ODE field's gates stacked as wg [3, H, H*C] and
    bg [3, H*C] in the order r, z, h; None where the kind has none) and the
    field kind, from the field's `fused_weights()`
    (snsde/kernels/fused_cde.py:676-739)."""
    if not supports_fused_cde(func, method):
        raise ValueError(f"fused CDE kernels take FinalTanh, "
                         f"SingleHiddenLayer or GRUODEField on "
                         f"{sorted(_TABLEAUS)}; got {type(func).__name__} "
                         f"with {method!r}")
    act, *layers = func.fused_weights()
    dev = z0.device
    hs = np.diff(grid)
    ut, _ = _stage_times(method)
    M, NT, B, C = len(hs), len(ut), z0.shape[0], func.input_channels
    dvals = path.derivative_grid(_stage_grid(grid, hs, ut))  # [M*NT, B, C]
    dx = dvals.reshape(M, NT, B, C).transpose(1, 2).reshape(M, B, NT * C)
    out = {"z0": z0.contiguous(),
           "dx": dx.to(device=dev, dtype=torch.float32).contiguous(),
           "dts": torch.as_tensor(hs.astype(np.float32), device=dev),
           "method": method, "act": act}
    out.update(dict.fromkeys(_FWD_NAMES[3:]))
    if act == "gruode":
        gates = layers[0]
        out["wg"] = torch.stack([l.weight.t() for l in gates]).contiguous()
        out["bg"] = torch.stack([l.bias for l in gates])
        return out
    lin_in, inners, lin_out = layers
    HH = lin_in.out_features
    if len(inners):
        w_inner = torch.stack([l.weight.t() for l in inners])
        b_inner = torch.stack([l.bias for l in inners])
    else:
        w_inner = torch.zeros((0, HH, HH), dtype=torch.float32, device=dev)
        b_inner = torch.zeros((0, HH), dtype=torch.float32, device=dev)
    out.update(win=lin_in.weight.t().contiguous(), bin=lin_in.bias,
               w_inner=w_inner.contiguous(), b_inner=b_inner.contiguous(),
               wout=lin_out.weight.t().contiguous(), bout=lin_out.bias)
    return out


def precision_inputs(inputs: dict, stream_dtype=None, matmul=None) -> dict:
    """The kernels' inputs in a precision (resolve_precision: None from
    SNSDE_FUSED_STREAM and SNSDE_FUSED_MATMUL, as fused_cde.py:650-655 and
    :697-698 resolve them): the derivative stream dx in the stream dtype
    (:710, :719-720) and `prec`, FusedCDE's precision ({'stream', 'matmul'};
    the GRU-ODE field's operands exact fp32 whatever is asked, :691-697)."""
    sd, mm = resolve_precision(stream_dtype, matmul)
    out = dict(inputs, dx=inputs["dx"].to(sd))
    out["prec"] = {"stream": "bf16" if sd == torch.bfloat16 else "f32",
                   "matmul": "f32" if inputs["act"] == "gruode" else mm}
    return out


def fused_cde_solve(func, path, times, z0: torch.Tensor,
                    dt: Optional[float] = None,
                    method: str = "rk4",
                    stream_dtype: Optional[torch.dtype] = None,
                    matmul: Optional[str] = None) -> torch.Tensor:
    """Fused solve of dz = f(z) dX(t) on make_grid(times, dt); zs [T, B, H]
    on the output times (cdeint's layout). Matches cdeint(method=...) on the
    same grid up to float32 summation order; gradients reach the field's
    weights, z0 and the control path's coefficients. `stream_dtype`
    (torch.float32 or torch.bfloat16) holds the derivative, trajectory and
    cotangent streams, `matmul` ('f32', 'bf16x3' or 'bf16') the MLP
    fields' in-kernel products' operands, as in the JAX entry
    (fused_cde.py:634-754; the GRU-ODE field's operands are exact fp32
    whatever is asked, as JAX pins them, :691-697); None takes
    SNSDE_FUSED_STREAM and SNSDE_FUSED_MATMUL, exact fp32 when unset. The
    result is float32 (a bf16 trajectory widened, its first row the
    rounded z0)."""
    grid, out_idx = make_grid(times, dt)
    inp = precision_inputs(fused_cde_inputs(func, path, grid, z0, method),
                           stream_dtype, matmul)
    ys = FusedCDE.apply(*(inp[k] for k in _ARG_ORDER), inp["method"],
                        inp["act"], inp["prec"])
    return widen_output(z0, ys)[torch.as_tensor(out_idx, device=z0.device)]
