"""Fused explicit Runge–Kutta CDE solve: two hand-written CUDA kernels for
Hopper (snsde_torch/csrc/fused_cde.cu) behind a `torch.autograd.Function`.

Replaces the Pallas TPU kernel pair of snsde/kernels/fused_cde.py —
`_fused_cde_forward` (pallas_call at :364, body `_fwd_kernel` :320, field
`_field_forward` :184) and `_fused_cde_backward` (pallas_call at :505, body
`_bwd_kernel` :385, field `_field_bwd` :218), the custom VJP `_fused_cde`
(:546-573) — for the FinalTanh field (relu MLP, any number of inner
layers) and the SingleHiddenLayer field (tanh), on every tableau of
`_TABLEAUS` (euler, midpoint, heun = rk2, rk4). The GRU-ODE field takes
the eager `cdeint` (see `supports_fused_cde`).

Per step, each stage evaluates the matrix field O(y) = tanh(MLP(y)) as
[H, C] (h-major [H*C]) at its stage state and contracts it with the
control derivative dX/dt at its stage time. The derivative stream is
precomputed outside the kernels by `CubicPath.derivative_grid` at the
distinct stage times of every step (one row [NT*C] per step and batch
row) and, unlike the SDE kernels' Brownian stream, it is differentiated:
the backward kernel returns its cotangent ddx, and autograd carries it to
the spline coefficients.

What bounds the kernels on the H100, and the design, are described in the
CUDA source. Each kernel has a plain PyTorch version beside it with the
same inputs and outputs. `fused_cde_forward`/`fused_cde_backward` take the
plain versions only for tensors on the CPU; for CUDA tensors they launch
the kernel or raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.solve import make_grid
from ._solver import SolverLib, check_tensors

__all__ = ["fused_cde_solve", "fused_cde_inputs", "supports_fused_cde",
           "FusedCDE", "fused_cde_forward", "fused_cde_backward",
           "fused_cde_forward_reference", "fused_cde_backward_reference",
           "FusedCDEGrads", "check_kernel_inputs", "FUSED_CDE_METHODS",
           "fused_cde_plan", "force_cde_plan"]

# launches of each CUDA kernel since the count was last set to 0
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

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

# the C interface's codes (csrc/fused_cde.cu)
_METHOD_CODE = {"euler": 0, "midpoint": 1, "heun": 2, "rk2": 2, "rk4": 3}
_ACT_CODE = {"relu": 0, "tanh": 1}


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
    `fused_weights()` (FinalTanh, SingleHiddenLayer; not GRU-ODE) on any
    tableau of _TABLEAUS, at any width: every field the JAX package's gate
    takes (snsde/kernels/fused_cde.py:600-631, H*C up to 4096) and more.
    Wout is split over a thread-block cluster; what does not fit a CTA's
    shared memory even so is read from device memory (the plan's levels,
    csrc/fused_cde.cu); only a field whose tiles do not fit even at one
    batch row a cluster raises ValueError at launch, never a quiet route
    to the eager solver."""
    return method in _TABLEAUS and hasattr(func, "fused_weights")


class FusedCDEGrads(NamedTuple):
    """Cotangents of the fused CDE solve's inputs (per-block partials
    summed)."""
    dz0: torch.Tensor        # [B, H]
    ddx: torch.Tensor        # [M, B, NT*C]
    dwin: torch.Tensor       # [H, HH]
    dbin: torch.Tensor       # [HH]
    dw_inner: torch.Tensor   # [n_inner, HH, HH]
    db_inner: torch.Tensor   # [n_inner, HH]
    dwout: torch.Tensor      # [HH, H*C]
    dbout: torch.Tensor      # [H*C]


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------

def _act_d(act, h):
    return (h > 0).to(h.dtype) if act == "relu" else 1.0 - h * h


def _field(y, d, win, bin, w_inner, b_inner, wout, bout, act):
    """One field evaluation at stage state y [B, H] against the stage's
    control derivative d [B, C], `act` the hidden layers' activation
    function: (k [B, H], hidden activations, O [B, H*C])."""
    hs = [act(y @ win + bin)]
    for l in range(w_inner.shape[0]):
        hs.append(act(hs[-1] @ w_inner[l] + b_inner[l]))
    o = torch.tanh(hs[-1] @ wout + bout)
    B, H, C = y.shape[0], y.shape[1], d.shape[1]
    k = (o.reshape(B, H, C) * d[:, None, :]).sum(-1)
    return k, hs, o


def _stage_rows(dx_u, NT):
    """The step's control row [B, NT*C] split per distinct stage time."""
    return dx_u.reshape(dx_u.shape[0], NT, -1).unbind(1)


def _stage_states(z, h, ds, tidx, A, w):
    """Stage states and increments of one step from the state z."""
    states, ks = [], []
    for i in range(len(tidx)):
        y = z
        for j, aij in enumerate(A[i]):
            if aij:
                y = y + (aij * h) * ks[j]
        states.append(y)
        ks.append(_field(y, ds[tidx[i]], *w)[0])
    return states, ks


def fused_cde_forward_reference(z0, dx, dts, win, bin, w_inner, b_inner,
                                wout, bout, *, method: str, act: str,
                                relu=torch.relu) -> torch.Tensor:
    """Eager explicit-RK loop: ys [M, B, H] (z after each step). Weights in
    [in, out] layout; dx [M, B, NT*C]. With act "relu" every hidden
    activation is `relu` (a stand-in may probe the pre-activations)."""
    _, A, btab = _TABLEAUS[method]
    _, tidx = _stage_times(method)
    NT = max(tidx) + 1
    w = (win, bin, w_inner, b_inner, wout, bout,
         relu if act == "relu" else torch.tanh)
    z = z0
    ys = []
    for u in range(dts.shape[0]):
        h = dts[u]
        _, ks = _stage_states(z, h, _stage_rows(dx[u], NT), tidx, A, w)
        for i, bi in enumerate(btab):
            if bi:
                z = z + (bi * h) * ks[i]
        ys.append(z)
    return torch.stack(ys)


def _field_bwd(y, hs, o, d, dk, win, w_inner, wout, act, acc):
    """Back through one field evaluation given dk = dL/dk: adds the weight
    gradients into acc; returns (dy, the stage's control cotangent
    [B, C])."""
    B, H, C = y.shape[0], y.shape[1], d.shape[1]
    oc = o.reshape(B, H, C)
    dp = dk[:, :, None]
    dd = (dp * oc).sum(1)
    dzout = ((dp * d[:, None, :]) * (1.0 - oc * oc)).reshape(B, H * C)
    acc["wout"] += hs[-1].T @ dzout
    acc["bout"] += dzout.sum(0)
    dh = dzout @ wout.T
    for l in range(w_inner.shape[0] - 1, -1, -1):
        dz = dh * _act_d(act, hs[l + 1])
        acc["w_inner"][l] += hs[l].T @ dz
        acc["b_inner"][l] += dz.sum(0)
        dh = dz @ w_inner[l].T
    dz1 = dh * _act_d(act, hs[0])
    acc["win"] += y.T @ dz1
    acc["bin"] += dz1.sum(0)
    return dz1 @ win.T, dd


def fused_cde_backward_reference(z0, ys, gys, dx, dts, win, bin, w_inner,
                                 b_inner, wout, bout, *, method: str,
                                 act: str,
                                 relu=torch.relu) -> FusedCDEGrads:
    """Eager reverse loop mirroring the backward kernel (and the JAX
    `_bwd_kernel`): recompute the stage states from the state before the
    step, then reverse the tableau from the last stage to the first.
    `relu` as in the forward; its derivative is read from its output
    (> 0)."""
    _, A, btab = _TABLEAUS[method]
    _, tidx = _stage_times(method)
    NT = max(tidx) + 1
    w = (win, bin, w_inner, b_inner, wout, bout,
         relu if act == "relu" else torch.tanh)
    acc = {"win": torch.zeros_like(win), "bin": torch.zeros_like(bin),
           "w_inner": torch.zeros_like(w_inner),
           "b_inner": torch.zeros_like(b_inner),
           "wout": torch.zeros_like(wout), "bout": torch.zeros_like(bout)}
    ddx = torch.empty_like(dx)
    gbar = torch.zeros_like(z0)
    for u in range(dts.shape[0] - 1, -1, -1):
        gbar = gbar + gys[u]
        z = z0 if u == 0 else ys[u - 1]
        h = dts[u]
        ds = _stage_rows(dx[u], NT)
        states, _ = _stage_states(z, h, ds, tidx, A, w)
        dks = [(bi * h) * gbar if bi else torch.zeros_like(gbar)
               for bi in btab]
        dd = [torch.zeros_like(d) for d in ds]
        for i in range(len(btab) - 1, -1, -1):
            _, hs, o = _field(states[i], ds[tidx[i]], *w)
            dy, dd_i = _field_bwd(states[i], hs, o, ds[tidx[i]], dks[i], win,
                                  w_inner, wout, act, acc)
            dd[tidx[i]] = dd[tidx[i]] + dd_i
            gbar = gbar + dy
            for j, aij in enumerate(A[i]):
                if aij:
                    dks[j] = dks[j] + (aij * h) * dy
        ddx[u] = torch.cat(dd, dim=-1)
    return FusedCDEGrads(gbar, ddx, acc["win"], acc["bin"], acc["w_inner"],
                         acc["b_inner"], acc["wout"], acc["bout"])


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

# built and loaded at first launch
_LIB = SolverLib("fused_cde", "fused CDE", 10, 19,
                 int_names=("M", "B", "H", "HH", "C", "n_inner", "method",
                            "act"),
                 shape_names=("B", "H", "HH", "C", "n_inner", "method"),
                 int_fns={"plan": 8, "force_placement": 1, "force_plan": 2})

_PLAN_FIELDS = ("level", "rows", "cluster", "keep", "active_clusters",
                "smem_bytes")


def fused_cde_plan(B: int, H: int, HH: int, C: int, n_inner: int,
                   method: str, backward: bool) -> dict:
    """The CUDA library's plan of a CDE launch: its level (0 everything in
    shared memory ... 6 fewer rows, csrc/fused_cde.cu), batch rows and
    CTAs a cluster, whether the backward keeps the stage activations,
    cudaOccupancyMaxActiveClusters (a negative CUDA error when the plan
    cannot be scheduled) and the shared bytes a CTA. Needs the card."""
    shape = (B, H, HH, C, n_inner, _METHOD_CODE[method], int(backward))
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


def check_kernel_inputs(z0, dx, dts, win, bin, w_inner, b_inner, wout, bout,
                        *, method: str, act: str, ys=None, gys=None):
    """Raise ValueError on what the kernels do not take: an unknown method
    or activation, a dtype other than float32, tensors on different
    devices, a non-contiguous tensor, or a shape that disagrees with
    z0/win/w_inner/dts/dx. Returns (M, B, H, HH, C, n_inner)."""
    if method not in _METHOD_CODE or act not in _ACT_CODE:
        raise ValueError(f"fused CDE kernels take methods "
                         f"{sorted(_METHOD_CODE)} and activations "
                         f"{sorted(_ACT_CODE)}; got {method!r}, {act!r}")
    if (z0.ndim != 2 or win.ndim != 2 or w_inner.ndim != 3 or dts.ndim != 1
            or dx.ndim != 3):
        raise ValueError("fused CDE kernel: z0 [B,H], win [H,HH], w_inner "
                         "[n_inner,HH,HH], dts [M] and dx [M,B,NT*C] "
                         "expected")
    NT = len(_stage_times(method)[0])
    M, (B, H), HH, n_inner = dts.shape[0], z0.shape, win.shape[1], \
        w_inner.shape[0]
    C = dx.shape[2] // NT
    want = {"z0": (B, H), "dx": (M, B, NT * C), "dts": (M,), "win": (H, HH),
            "bin": (HH,), "w_inner": (n_inner, HH, HH),
            "b_inner": (n_inner, HH), "wout": (HH, H * C),
            "bout": (H * C,), "ys": (M, B, H), "gys": (M, B, H)}
    got = {"z0": z0, "dx": dx, "dts": dts, "win": win, "bin": bin,
           "w_inner": w_inner, "b_inner": b_inner, "wout": wout,
           "bout": bout, "ys": ys, "gys": gys}
    if dx.shape[2] != NT * C or C == 0:
        raise ValueError(f"fused CDE kernel: dx has shape {tuple(dx.shape)}, "
                         f"expected (M, B, {NT} * C) for {method}")
    check_tensors("fused CDE", want, got, z0.device)
    return M, B, H, HH, C, n_inner


def fused_cde_forward(z0, dx, dts, win, bin, w_inner, b_inner, wout, bout, *,
                      method: str, act: str) -> torch.Tensor:
    """ys [M, B, H]: the CUDA forward kernel for CUDA tensors, the plain
    version for CPU tensors."""
    global FWD_LAUNCHES
    args = (z0, dx, dts, win, bin, w_inner, b_inner, wout, bout)
    if z0.device.type == "cpu":
        return fused_cde_forward_reference(*args, method=method, act=act)
    dims = check_kernel_inputs(*args, method=method, act=act)
    M, B, H, HH, C, n_inner = dims
    code = _METHOD_CODE[method]
    stream = _LIB.stream(z0, (B, H, HH, C, n_inner, code), backward=False)
    ys = torch.empty((M, B, H), dtype=torch.float32, device=z0.device)
    _LIB.launch("fwd", args + (ys,), dims + (code, _ACT_CODE[act]), stream)
    FWD_LAUNCHES += 1
    return ys


def fused_cde_backward(z0, ys, gys, dx, dts, win, bin, w_inner, b_inner,
                       wout, bout, *, method: str,
                       act: str) -> FusedCDEGrads:
    """Cotangents of the solve's inputs given gys = dL/dys: the CUDA
    backward kernel for CUDA tensors (per-cluster partials summed here),
    the plain version for CPU tensors."""
    global BWD_LAUNCHES
    args = (dx, dts, win, bin, w_inner, b_inner, wout, bout)
    if z0.device.type == "cpu":
        return fused_cde_backward_reference(z0, ys, gys, *args,
                                            method=method, act=act)
    dims = check_kernel_inputs(z0, *args, method=method, act=act, ys=ys,
                               gys=gys)
    M, B, H, HH, C, n_inner = dims
    code = _METHOD_CODE[method]
    shape = (B, H, HH, C, n_inner, code)
    stream = _LIB.stream(z0, shape, backward=True)
    nb = -(-B // _LIB.rows(shape, backward=True))   # clusters
    empty = lambda *size: torch.empty(size, dtype=torch.float32,
                                      device=z0.device)
    ddx, dz0 = empty(*dx.shape), empty(B, H)
    p_win, p_bin = empty(nb, H, HH), empty(nb, HH)
    p_wi, p_bi = empty(nb, n_inner, HH, HH), empty(nb, n_inner, HH)
    p_wo, p_bo = empty(nb, HH, H * C), empty(nb, H * C)
    _LIB.launch("bwd", (z0, ys, gys) + args + (
        ddx, dz0, p_win, p_bin, p_wi, p_bi, p_wo, p_bo),
        dims + (code, _ACT_CODE[act]), stream)
    BWD_LAUNCHES += 1
    return FusedCDEGrads(dz0, ddx, p_win.sum(0), p_bin.sum(0), p_wi.sum(0),
                         p_bi.sum(0), p_wo.sum(0), p_bo.sum(0))


_ARG_ORDER = ("z0", "dx", "dts", "win", "bin", "w_inner", "b_inner", "wout",
              "bout")


class FusedCDE(torch.autograd.Function):
    """ys = explicit-RK CDE solve; backward by the backward kernel. Inputs
    in _ARG_ORDER, then method and act: z0 [B,H], dx [M,B,NT*C], dts [M]
    (not differentiated), win [H,HH], bin [HH], w_inner [n_inner,HH,HH],
    b_inner [n_inner,HH], wout [HH,H*C], bout [H*C]."""

    @staticmethod
    def forward(ctx, *args):
        *tensors, method, act = args
        ys = fused_cde_forward(*tensors, method=method, act=act)
        ctx.save_for_backward(*tensors, ys)
        ctx.flags = (method, act)
        return ys

    @staticmethod
    def backward(ctx, gys):
        z0, *rest, ys = ctx.saved_tensors
        method, act = ctx.flags
        gr = fused_cde_backward(z0, ys, gys.contiguous(), *rest,
                                method=method, act=act)
        return (gr.dz0, gr.ddx, None, gr.dwin, gr.dbin, gr.dw_inner,
                gr.db_inner, gr.dwout, gr.dbout, None, None)


# ---------------------------------------------------------------------------
# Public entry: solve a Neural CDE with the fused kernels
# ---------------------------------------------------------------------------

def fused_cde_inputs(func, path, grid: np.ndarray, z0: torch.Tensor,
                     method: str = "rk4") -> dict:
    """The kernels' inputs for a supported field on a host step grid: the
    control-derivative stream dx [M, B, NT*C] (dX/dt at each step's NT
    distinct stage times, from `path.derivative_grid`; differentiable
    through autograd), the step sizes, the weights in [in, out] layout and
    the activation, from the field's `fused_weights()`
    (snsde/kernels/fused_cde.py:676-739)."""
    if not supports_fused_cde(func, method):
        raise ValueError(f"fused CDE kernels take FinalTanh or "
                         f"SingleHiddenLayer on {sorted(_TABLEAUS)}; got "
                         f"{type(func).__name__} with {method!r}")
    act, lin_in, inners, lin_out = func.fused_weights()
    dev = z0.device
    hs = np.diff(grid)
    ut, _ = _stage_times(method)
    M, NT, B, C = len(hs), len(ut), z0.shape[0], func.input_channels
    dvals = path.derivative_grid(_stage_grid(grid, hs, ut))  # [M*NT, B, C]
    dx = dvals.reshape(M, NT, B, C).transpose(1, 2).reshape(M, B, NT * C)
    HH = lin_in.out_features
    if len(inners):
        w_inner = torch.stack([l.weight.t() for l in inners])
        b_inner = torch.stack([l.bias for l in inners])
    else:
        w_inner = torch.zeros((0, HH, HH), dtype=torch.float32, device=dev)
        b_inner = torch.zeros((0, HH), dtype=torch.float32, device=dev)
    return {"z0": z0.contiguous(),
            "dx": dx.to(device=dev, dtype=torch.float32).contiguous(),
            "dts": torch.as_tensor(hs.astype(np.float32), device=dev),
            "win": lin_in.weight.t().contiguous(), "bin": lin_in.bias,
            "w_inner": w_inner.contiguous(), "b_inner": b_inner.contiguous(),
            "wout": lin_out.weight.t().contiguous(), "bout": lin_out.bias,
            "method": method, "act": act}


def fused_cde_solve(func, path, times, z0: torch.Tensor,
                    dt: Optional[float] = None,
                    method: str = "rk4") -> torch.Tensor:
    """Fused solve of dz = f(z) dX(t) on make_grid(times, dt); zs [T, B, H]
    on the output times (cdeint's layout). Matches cdeint(method=...) on the
    same grid up to float32 summation order; gradients reach the field's
    weights, z0 and the control path's coefficients."""
    grid, out_idx = make_grid(times, dt)
    inp = fused_cde_inputs(func, path, grid, z0, method)
    ys = FusedCDE.apply(*(inp[k] for k in _ARG_ORDER), inp["method"],
                        inp["act"])
    full = torch.cat([z0[None], ys], dim=0)
    return full[torch.as_tensor(out_idx, device=z0.device)]
