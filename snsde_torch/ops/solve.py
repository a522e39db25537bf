"""SDE, ODE and CDE solvers (counterpart of snsde/ops/solve.py).

`make_grid` is host numpy, a copy of the JAX package's, both modes.
`sdeint` is an eager loop differentiated by torch autograd, with every
method of the JAX package: euler (Euler–Maruyama), milstein (its
correction the full Jacobian-vector product (dg/dy) g, by forward-mode
AD), heun (Stratonovich Heun), srk (Rößler's SRIW1, strong order 1.5 for
diagonal Ito noise, the scheme torchsde's 'srk' applies) and
reversible_heun (the algebraically reversible Heun of Kidger et al.
2021, carrying the (y, ŷ) pair). The srk loop is the yardstick of the
fused SRK kernels' plain versions, the euler loop the EM kernels'; the
other methods have no kernel, in the JAX package either.

`sdeint_adaptive` is adaptive Euler–Maruyama by step doubling on a
`VirtualBrownianTree`. `odeint` is the fixed-grid ODE loop (euler,
midpoint, heun = rk2, rk4) and dispatches the adaptive and extra methods
(dopri5 in ops/dopri.py; rk23, rk12, ode23s, sym12 in
ops/extra_solvers.py); `cdeint` reduces dz = f(z) dX(t) to it. The
fixed-grid loops are the yardstick of the fused CDE kernels' plain
versions. Stage times are float32 scalars on the device, as the JAX scan
computes them (t0 + 0.5 dt).

The adaptive loops decide accept/reject on the host: each trial step reads
its error norm back from the device (one synchronisation a trial step on
the card). Step sizes and times are host numbers in the solve's precision
(numpy float32 for float32 states), so gradients flow through the state
chain on the realised grid only, as the JAX package's stop_gradient makes
them; with `differentiable=False` the result refuses reverse mode as the
JAX package's while_loop does (ops/_guards.py).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ._guards import nondiff_guard
from .brownian import (BrownianGrid, VirtualBrownianTree, _host_float,
                       brownian_increments, space_time_levy_area)

__all__ = ["make_grid", "sdeint", "sdeint_adaptive", "odeint", "cdeint",
           "SOLVER_ORDERS"]


def make_grid(ts, dt: Optional[float],
              mode: str = "equal") -> Tuple[np.ndarray, np.ndarray]:
    """Build the solver step grid and output-time indices.

    ts: [T] strictly increasing output times. dt: max step size (None ->
    step exactly on ts). mode 'equal' splits each [ts[i], ts[i+1]] into
    ceil(span/dt) equal steps; 'torchsde' takes full dt steps then one
    truncated step landing on ts[i+1].

    Returns (grid [M+1] float64 holding every ts point, out_idx [T] int32
    with grid[out_idx] == ts)."""
    if isinstance(ts, torch.Tensor):
        ts = ts.detach().cpu().numpy()
    ts = np.asarray(ts, dtype=np.float64)
    if ts.ndim != 1 or ts.shape[0] < 2:
        raise ValueError("ts must be 1-D with at least two times")
    if mode not in ("equal", "torchsde"):
        raise ValueError(f"unknown grid mode {mode!r}")
    pieces = [np.array([ts[0]])]
    for t0, t1 in zip(ts[:-1], ts[1:]):
        span = t1 - t0
        if dt is None:
            piece = np.array([t1])
        elif mode == "equal":
            n = max(int(np.ceil(span / dt - 1e-9)), 1)
            piece = t0 + span * np.arange(1, n + 1) / n
            piece[-1] = t1
        else:
            n_full = int(np.floor(span / dt + 1e-9))
            inner = t0 + dt * np.arange(1, n_full + 1)
            if n_full and inner[-1] >= t1 - 1e-9 * max(abs(t1), 1.0):
                inner = inner[:-1]
            piece = np.concatenate([inner, [t1]])
        pieces.append(piece)
    grid = np.concatenate(pieces)
    out_idx = np.minimum(np.searchsorted(grid, ts), grid.shape[0] - 1)
    np.testing.assert_allclose(grid[out_idx], ts, rtol=0, atol=1e-9)
    return grid.astype(np.float64), out_idx.astype(np.int32)


# SRIW1 tableau (Rößler 2010), as snsde/ops/solve.py:121-153 writes it.
_SRK_C0 = (0.0, 3.0 / 4.0, 0.0, 0.0)
_SRK_C1 = (0.0, 1.0 / 4.0, 1.0, 1.0 / 4.0)
_SRK_A0 = (
    (0.0, 0.0, 0.0, 0.0),
    (3.0 / 4.0, 0.0, 0.0, 0.0),
    (0.0, 0.0, 0.0, 0.0),
    (0.0, 0.0, 0.0, 0.0),
)
_SRK_A1 = (
    (0.0, 0.0, 0.0, 0.0),
    (1.0 / 4.0, 0.0, 0.0, 0.0),
    (1.0, 0.0, 0.0, 0.0),
    (0.0, 0.0, 1.0 / 4.0, 0.0),
)
_SRK_B0 = (
    (0.0, 0.0, 0.0, 0.0),
    (3.0 / 2.0, 0.0, 0.0, 0.0),
    (0.0, 0.0, 0.0, 0.0),
    (0.0, 0.0, 0.0, 0.0),
)
_SRK_B1 = (
    (0.0, 0.0, 0.0, 0.0),
    (1.0 / 2.0, 0.0, 0.0, 0.0),
    (-1.0, 0.0, 0.0, 0.0),
    (-5.0, 3.0, 1.0 / 2.0, 0.0),
)
_SRK_ALPHA = (1.0 / 3.0, 2.0 / 3.0, 0.0, 0.0)
_SRK_BETA1 = (-1.0, 4.0 / 3.0, 2.0 / 3.0, 0.0)
_SRK_BETA2 = (-1.0, 4.0 / 3.0, -1.0 / 3.0, 0.0)
_SRK_BETA3 = (2.0, -4.0 / 3.0, -2.0 / 3.0, 0.0)
_SRK_BETA4 = (-2.0, 5.0 / 3.0, -2.0 / 3.0, 1.0)
# stages whose drift enters the step: through the y-update (alpha) or a
# later stage's state (A0, A1). Stage 3's does not.
_SRK_F_USED = tuple(bool(_SRK_ALPHA[j]) or any(_SRK_A0[i][j] or _SRK_A1[i][j]
                                               for i in range(4))
                    for j in range(4))


def _step_euler(f, g, t0, dt, y, dW, U):
    return y + f(t0, y) * dt + g(t0, y) * dW


def _step_milstein(f, g, t0, dt, y, dW, U):
    """Milstein for diagonal noise (strong order 1.0): the correction is
    the Jacobian-vector product (dg/dy) g, the full product, since the
    noise nets mix channels."""
    gy = g(t0, y)
    g_dg = torch.func.jvp(lambda yy: g(t0, yy), (y,), (gy,))[1]
    return y + f(t0, y) * dt + gy * dW + 0.5 * g_dg * (dW * dW - dt)


def _step_heun(f, g, t0, dt, y, dW, U):
    """Stratonovich Heun: the average of the drift and the diffusion at
    both ends of an Euler predictor."""
    f0 = f(t0, y)
    g0 = g(t0, y)
    y1 = y + f0 * dt + g0 * dW
    f1 = f(t0 + dt, y1)
    g1 = g(t0 + dt, y1)
    return y + 0.5 * (f0 + f1) * dt + 0.5 * (g0 + g1) * dW


def _step_srk(f, g, t0, dt, y, dW, U):
    """One SRIW1 step; U is the space-time Lévy area I_(1,0). The drift
    runs twice per step: at stage 0 and stage 1. Stage 2's drift state is
    y at t0, so it reuses stage 0's value, and stage 3's is never used."""
    rdt = 1.0 / dt
    sqrt_dt = torch.sqrt(dt)
    I1 = dW
    I11 = 0.5 * (dW * dW - dt)
    I111 = (dW * dW * dW - 3.0 * dt * dW) / 6.0
    I10 = U

    fH, gH = [], []
    for i in range(4):
        h0 = y
        h1 = y
        for j in range(i):
            if _SRK_A0[i][j]:
                h0 = h0 + _SRK_A0[i][j] * fH[j] * dt
            if _SRK_B0[i][j]:
                h0 = h0 + _SRK_B0[i][j] * gH[j] * (I10 * rdt)
            if _SRK_A1[i][j]:
                h1 = h1 + _SRK_A1[i][j] * fH[j] * dt
            if _SRK_B1[i][j]:
                h1 = h1 + _SRK_B1[i][j] * gH[j] * sqrt_dt
        if not _SRK_F_USED[i]:
            fH.append(None)
        elif i and h0 is y and _SRK_C0[i] == 0.0:
            fH.append(fH[0])
        else:
            fH.append(f(t0 + _SRK_C0[i] * dt, h0))
        gH.append(g(t0 + _SRK_C1[i] * dt, h1))

    y1 = y
    for i in range(4):
        if _SRK_ALPHA[i]:
            y1 = y1 + _SRK_ALPHA[i] * fH[i] * dt
        coeff = (_SRK_BETA1[i] * I1 + _SRK_BETA2[i] * I11 / sqrt_dt
                 + _SRK_BETA3[i] * I10 * rdt + _SRK_BETA4[i] * I111 * rdt)
        y1 = y1 + coeff * gH[i]
    return y1


_STEPPERS = {"euler": _step_euler, "milstein": _step_milstein,
             "heun": _step_heun, "srk": _step_srk}

SOLVER_ORDERS = {"euler": 0.5, "milstein": 1.0, "heun": 0.5, "srk": 1.5,
                 "reversible_heun": 0.5}


def _reversible_heun(f, g, y0, t_lo, dts, dW):
    """Algebraically reversible Heun (Kidger et al. 2021, arXiv:2105.13493;
    torchsde's 'reversible_heun'), carrying (y, ŷ):
        ŷ' = 2 y - ŷ + f(t, ŷ) h + g(t, ŷ) dW
        y' = y + (f(t, ŷ) + f(t + h, ŷ')) h/2 + (g(t, ŷ) + g(t + h, ŷ')) dW/2
    Stratonovich, strong order 0.5. Returns ([y0, y_1, ..., y_M], ŷ_M):
    the last pair, from which the steps can be run back exactly."""
    y, yh = y0, y0
    ys = [y0]
    for k in range(dts.shape[0]):
        t0, h, dw = t_lo[k], dts[k], dW[k]
        f0, g0 = f(t0, yh), g(t0, yh)
        yh = 2.0 * y - yh + f0 * h + g0 * dw
        f1, g1 = f(t0 + h, yh), g(t0 + h, yh)
        y = y + 0.5 * (f0 + f1) * h + 0.5 * (g0 + g1) * dw
        ys.append(y)
    return ys, yh


def sdeint(f: Callable, g: Callable, y0: torch.Tensor, ts, *,
           generator: Optional[torch.Generator] = None,
           bm: Optional[BrownianGrid] = None, dt: Optional[float] = None,
           method: str = "euler", grid_mode: str = "equal",
           return_brownian: bool = False):
    """Integrate dy = f(t,y) dt + g(t,y) dW (diagonal noise) over output
    times ts with `method` (euler, milstein, heun, srk, reversible_heun).
    y0: [..., H]. Brownian increments (and, for srk, the Lévy area) come
    from `bm` when given, else from `generator`: dW first, then the Lévy
    area. Returns ys [T, ...y0.shape] (time-major), and with
    `return_brownian` also the BrownianGrid it stepped on (U only for
    srk)."""
    if method not in _STEPPERS and method != "reversible_heun":
        raise ValueError(f"unknown SDE method {method!r}")
    if isinstance(ts, torch.Tensor):
        ts = ts.detach().cpu().numpy()
    if bm is not None:
        grid = np.asarray(bm.grid, np.float64)
        ts_np = np.asarray(ts, np.float64)
        # nearest match: the stored grid may have been through float32
        out_idx = np.abs(grid[None, :] - ts_np[:, None]).argmin(axis=1)
        tol = 1e-5 * max(float(grid[-1] - grid[0]), 1.0)
        np.testing.assert_allclose(grid[out_idx], ts_np, rtol=0, atol=tol)
        dW, U = bm.dW, bm.U
        if method == "srk" and U is None:
            raise ValueError("method 'srk' needs the Lévy area in bm (U)")
    else:
        if generator is None:
            raise ValueError("sdeint needs either generator= or bm=")
        grid, out_idx = make_grid(ts, dt, mode=grid_mode)
        dW = brownian_increments(generator, grid, tuple(y0.shape), y0.dtype,
                                 y0.device)
        U = (space_time_levy_area(generator, grid, tuple(y0.shape), dW)
             if method == "srk" else None)

    t_lo = torch.as_tensor(grid[:-1], dtype=y0.dtype, device=y0.device)
    dts = torch.as_tensor(np.diff(grid), dtype=y0.dtype, device=y0.device)
    if method == "reversible_heun":
        ys, _ = _reversible_heun(f, g, y0, t_lo, dts, dW)
    else:
        stepper = _STEPPERS[method]
        ys = [y0]
        y = y0
        for k in range(dts.shape[0]):
            y = stepper(f, g, t_lo[k], dts[k], y, dW[k],
                        None if U is None else U[k])
            ys.append(y)
    out = torch.stack(ys)[torch.as_tensor(out_idx, device=y0.device)]
    if return_brownian:
        return out, BrownianGrid(grid, dW, U if method == "srk" else None)
    return out


def _ode_euler(f, t0, dt, y):
    return y + f(t0, y) * dt


def _ode_midpoint(f, t0, dt, y):
    k1 = f(t0, y)
    return y + f(t0 + 0.5 * dt, y + 0.5 * dt * k1) * dt


def _ode_heun(f, t0, dt, y):
    k1 = f(t0, y)
    k2 = f(t0 + dt, y + dt * k1)
    return y + 0.5 * dt * (k1 + k2)


def _ode_rk4(f, t0, dt, y):
    k1 = f(t0, y)
    k2 = f(t0 + 0.5 * dt, y + 0.5 * dt * k1)
    k3 = f(t0 + 0.5 * dt, y + 0.5 * dt * k2)
    k4 = f(t0 + dt, y + dt * k3)
    return y + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


_ODE_STEPPERS = {
    "euler": _ode_euler,
    "midpoint": _ode_midpoint,
    "heun": _ode_heun,
    "rk2": _ode_heun,
    "rk4": _ode_rk4,
}

def odeint(f: Callable, y0: torch.Tensor, ts, *, dt: Optional[float] = None,
           method: str = "rk4", differentiable: bool = False,
           max_steps: int = 4096) -> torch.Tensor:
    """ODE integration of dy/dt = f(t, y) over the output times ts; ys
    [T, ...y0.shape] (time-major). The fixed-grid methods step on
    make_grid(ts, dt); dopri5, rk23 and rk12 are adaptive, with at most
    `max_steps` trial steps, and refuse reverse mode unless
    `differentiable`; ode23s and sym12 (or sym12async) step on
    make_grid(ts, dt) (snsde/ops/solve.py:371-421)."""
    if method == "dopri5":
        from .dopri import odeint_dopri5

        return odeint_dopri5(f, y0, ts, differentiable=differentiable,
                             max_steps=max_steps)
    if method in ("rk23", "rk12"):
        from . import extra_solvers

        return getattr(extra_solvers, f"odeint_{method}")(
            f, y0, ts, differentiable=differentiable, max_steps=max_steps)
    if method == "ode23s":
        from .extra_solvers import odeint_ode23s

        return odeint_ode23s(f, y0, ts, dt=dt)
    if method in ("sym12", "sym12async"):
        from .extra_solvers import odeint_sym12

        return odeint_sym12(f, y0, ts, dt=dt)
    if method not in _ODE_STEPPERS:
        raise ValueError(f"unknown ODE method {method!r}")
    stepper = _ODE_STEPPERS[method]
    grid, out_idx = make_grid(ts, dt)
    t_lo = torch.as_tensor(grid[:-1], dtype=y0.dtype, device=y0.device)
    dts = torch.as_tensor(np.diff(grid), dtype=y0.dtype, device=y0.device)
    ys = [y0]
    y = y0
    for k in range(dts.shape[0]):
        y = stepper(f, t_lo[k], dts[k], y)
        ys.append(y)
    return torch.stack(ys)[torch.as_tensor(out_idx, device=y0.device)]


def cdeint(X, func: Callable, z0: torch.Tensor, ts, *,
           dt: Optional[float] = None, method: str = "rk4",
           differentiable: bool = False,
           max_steps: int = 4096) -> torch.Tensor:
    """Controlled differential equation dz = f(z) dX(t), reduced to the ODE
    dz/dt = f(t, z) @ dX/dt. X has .derivative(t) -> [..., C] (CubicPath,
    LinearPath); func(t, z) -> [..., H, C]. `differentiable` and
    `max_steps` reach the adaptive methods (odeint). Returns zs
    [T, ...z0.shape]."""

    def ode_f(t, z):
        dX = X.derivative(t)                           # [..., C]
        return torch.einsum("...hc,...c->...h", func(t, z), dX)

    return odeint(ode_f, z0, ts, dt=dt, method=method,
                  differentiable=differentiable, max_steps=max_steps)


def sdeint_adaptive(f: Callable, g: Callable, y0: torch.Tensor, ts, *,
                    seed: Optional[int] = None,
                    tree: Optional[VirtualBrownianTree] = None,
                    rtol: float = 1e-3, atol: float = 1e-4,
                    dt0: Optional[float] = None, max_steps: int = 4096,
                    vbt_depth: int = 18,
                    differentiable: bool = False) -> torch.Tensor:
    """Adaptive Euler–Maruyama with step-doubling error control
    (snsde/ops/solve.py:463-610). The Brownian path is a
    VirtualBrownianTree over [ts[0], ts[-1]] of depth `vbt_depth` keyed by
    `seed`, or `tree` when given: W(t) is a pure function of t, so a
    rejected step re-queries the same path.

    Each trial step compares one full Euler step with two half steps on
    the same increments; the error norm is the root mean square of the
    difference over atol + rtol |y|, and the step is accepted when it is
    at most 1, the two half steps kept. The next step is h times
    clip(0.9 / sqrt(err), 0.2, 2.0), at least span 2^-vbt_depth. Each
    output interval takes at most `max_steps` trial steps; an interval
    that runs out of them leaves NaN from there on, never a partial
    integration. `differentiable=False` refuses reverse mode as the JAX
    package's while_loop does; `differentiable=True` gives the same
    values and lets gradients through the state chain on the realised
    grid (the JAX package's masked scan). Returns ys [T, *y0.shape]."""
    ts_np = np.asarray(ts.detach().cpu() if isinstance(ts, torch.Tensor)
                       else ts, dtype=np.float64)
    if ts_np.ndim != 1 or ts_np.shape[0] < 2:
        raise ValueError("ts must be 1-D with at least two times")
    f32 = _host_float(y0.dtype)
    t_lo, t_hi = float(ts_np[0]), float(ts_np[-1])
    if tree is None:
        if seed is None:
            raise ValueError("sdeint_adaptive needs either seed= or tree=")
        tree = VirtualBrownianTree(t_lo, t_hi, tuple(y0.shape), seed=seed,
                                   depth=vbt_depth, dtype=y0.dtype,
                                   device=y0.device)
    h = f32(dt0 if dt0 is not None else (t_hi - t_lo) / 100.0)
    h_min = f32((t_hi - t_lo) * 2.0 ** (-float(vbt_depth)))
    eps_done = 1e-12 * max(abs(t_hi), 1.0)
    scalar = lambda v: torch.tensor(v, dtype=y0.dtype, device=y0.device)
    # the last trial's Brownian queries: the next trial starts at one of
    # them (its end after an acceptance, its start after a rejection)
    seen = {}

    def W(t):
        w = seen.get(t)
        return tree.evaluate(t) if w is None else w

    ys, y, done = [y0], y0, True
    for t_start, t_end in zip(ts_np[:-1].astype(f32), ts_np[1:].astype(f32)):
        if not done:
            # an exhausted interval left NaN, on which every later interval
            # runs out of trial steps too (a NaN error never accepts)
            ys.append(y)
            continue
        t, h, done = t_start, min(h, t_end - t_start), False
        for _ in range(max_steps):
            h_eff = min(h, t_end - t)
            tm, te = t + f32(0.5) * h_eff, t + h_eff
            w0, wm, we = W(t), W(tm), W(te)
            seen = {t: w0, tm: wm, te: we}
            f0, g0 = f(scalar(t), y), g(scalar(t), y)
            y_full = y + f0 * float(h_eff) + g0 * (we - w0)
            y_half = y + f0 * float(f32(0.5) * h_eff) + g0 * (wm - w0)
            y_half = (y_half + f(scalar(tm), y_half) * float(f32(0.5) * h_eff)
                      + g(scalar(tm), y_half) * (we - wm))
            with torch.no_grad():
                tol = atol + rtol * y.abs()
                err = torch.sqrt(((y_full - y_half) / tol).square().mean()
                                 + 1e-12)
            err = f32(err.item())                  # one sync a trial step
            rsqrt = f32(1.0) / np.sqrt(max(err, f32(1e-10)))
            h = max(h_eff * np.clip(f32(0.9) * rsqrt, f32(0.2), f32(2.0)),
                    h_min)
            if err <= 1.0:
                t, y = t + h_eff, y_half
            if t >= t_end - eps_done:
                done = True
                break
        if not done:
            y = torch.full_like(y, float("nan"))
        ys.append(y)
    out = torch.stack(ys)
    if differentiable:
        return out
    return nondiff_guard(
        out, "sdeint_adaptive(differentiable=False)",
        "Pass differentiable=True (identical results) or use a fixed-grid "
        "method.")
