"""Fixed-grid SDE, ODE and CDE solvers (counterpart of
snsde/ops/solve.py:48-91, 121-199, 249-456).

`make_grid` is host numpy, a copy of the JAX package's, both modes.
`sdeint` is an eager loop differentiated by torch autograd, with the
methods euler (Euler–Maruyama) and srk (Rößler's SRIW1, strong order 1.5
for diagonal Ito noise, the scheme torchsde's 'srk' applies); the other
methods of the JAX package (milstein, heun, reversible_heun) are not ported
yet. The srk loop is the yardstick of the fused SRK kernels' plain
versions.

`odeint` is the fixed-grid ODE loop (euler, midpoint, heun = rk2, rk4) and
`cdeint` reduces dz = f(z) dX(t) to it; both are eager loops differentiated
by torch autograd, the yardstick of the fused CDE kernels' plain versions.
Stage times are float32 scalars on the device, as the JAX scan computes
them (t0 + 0.5 dt). The adaptive methods (dopri5, rk23, rk12, ode23s,
sym12) are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .brownian import BrownianGrid, brownian_increments, space_time_levy_area

__all__ = ["make_grid", "sdeint", "odeint", "cdeint"]


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


_STEPPERS = {"euler": _step_euler, "srk": _step_srk}


def sdeint(f: Callable, g: Callable, y0: torch.Tensor, ts, *,
           generator: Optional[torch.Generator] = None,
           bm: Optional[BrownianGrid] = None, dt: Optional[float] = None,
           method: str = "euler", grid_mode: str = "equal") -> torch.Tensor:
    """Integrate dy = f(t,y) dt + g(t,y) dW (diagonal noise) over output
    times ts. y0: [..., H]. Brownian increments (and, for srk, the Lévy
    area) come from `bm` when given, else from `generator`: dW first, then
    the Lévy area. Returns ys [T, ...y0.shape] (time-major)."""
    if method not in _STEPPERS:
        raise NotImplementedError(
            f"sdeint method {method!r} is not ported yet (ROADMAP Queue 1 "
            "item 13: the other SDE solvers); 'euler' and 'srk' run"
        )
    stepper = _STEPPERS[method]
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
    ys = [y0]
    y = y0
    for k in range(dts.shape[0]):
        y = stepper(f, g, t_lo[k], dts[k], y, dW[k],
                    None if U is None else U[k])
        ys.append(y)
    return torch.stack(ys)[torch.as_tensor(out_idx, device=y0.device)]


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

_ADAPTIVE = ("dopri5", "rk23", "rk12", "ode23s", "sym12", "sym12async")


def odeint(f: Callable, y0: torch.Tensor, ts, *, dt: Optional[float] = None,
           method: str = "rk4") -> torch.Tensor:
    """Fixed-grid ODE integration of dy/dt = f(t, y) over the output times
    ts on make_grid(ts, dt); ys [T, ...y0.shape] (time-major)."""
    if method in _ADAPTIVE:
        raise NotImplementedError(
            f"odeint method {method!r} is not ported yet (ROADMAP Queue 1 "
            "item 16: the adaptive ODE solvers); euler, midpoint, heun, rk2 "
            "and rk4 run")
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
           dt: Optional[float] = None, method: str = "rk4") -> torch.Tensor:
    """Controlled differential equation dz = f(z) dX(t), reduced to the ODE
    dz/dt = f(t, z) @ dX/dt. X has .derivative(t) -> [..., C] (CubicPath);
    func(t, z) -> [..., H, C]. Returns zs [T, ...z0.shape]."""

    def ode_f(t, z):
        dX = X.derivative(t)                           # [..., C]
        return torch.einsum("...hc,...c->...h", func(t, z), dX)

    return odeint(ode_f, z0, ts, dt=dt, method=method)
