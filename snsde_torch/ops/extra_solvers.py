"""Extra ODE solvers (counterpart of snsde/ops/extra_solvers.py:30-237):

  * `odeint_rk23`: adaptive Bogacki–Shampine 2(3);
  * `odeint_rk12`: adaptive Heun–Euler 1(2);
  * `odeint_ode23s`: Rosenbrock(2,3) for stiff systems on a fixed grid,
    with each row's dense Jacobian by forward-mode AD
    (`torch.func.vmap(torch.func.jacfwd(...))`) and a dense solve
    (`torch.linalg.solve`), the JAX package's own dense approach;
  * `odeint_sym12`: the Sym12Async asynchronous leapfrog on a fixed grid.

The adaptive loops keep their step control on the host, as ops/dopri.py
does: one synchronisation a trial step on the card, and gradients through
the state chain on the realised grid only.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ._guards import nondiff_guard
from .brownian import _host_float
from .dopri import _host_times, _poison
from .solve import make_grid

__all__ = ["odeint_rk23", "odeint_rk12", "odeint_ode23s", "odeint_sym12"]


def _adaptive_embedded(f, y0, ts, A, b_high, b_low, c, order, rtol, atol,
                       max_steps, differentiable=False):
    """An embedded adaptive explicit RK pair over the output times ts
    (snsde/ops/extra_solvers.py:30-140): first step a hundredth of the
    span; the error of the lower-order solution against atol + rtol
    max(|y|, |y_new|), in root mean square; the next step h times
    clip(0.9 ratio^-1/order, 0.2, 5); output times inside an accepted step
    interpolated linearly; NaN for the outputs not reached in
    `max_steps` trial steps. `differentiable=False` refuses reverse
    mode."""
    F = _host_float(y0.dtype)
    ts_np = _host_times(ts)
    T = ts_np.shape[0]
    tsh = ts_np.astype(F)
    t, t_final = tsh[0], tsh[-1]
    h = F((ts_np[-1] - ts_np[0]) / 100.0)
    scalar = lambda v: torch.tensor(v, dtype=y0.dtype, device=y0.device)

    def rk_step(t, y, h):
        ks = []
        for i in range(len(b_high)):
            yi = y
            for j, aij in enumerate(A[i]):
                if aij != 0.0:
                    yi = yi + float(h * F(aij)) * ks[j]
            ks.append(f(scalar(t + F(c[i]) * h), yi))
        y_hi, y_lo = y, y
        for i in range(len(b_high)):
            if b_high[i] != 0.0:
                y_hi = y_hi + float(h * F(b_high[i])) * ks[i]
            if b_low[i] != 0.0:
                y_lo = y_lo + float(h * F(b_low[i])) * ks[i]
        return y_hi, y_hi - y_lo

    out = [y0] + [None] * (T - 1)
    nxt, y = 1, y0
    for _ in range(max_steps):
        if nxt >= T:
            break
        h = np.clip(h, F(1e-10), t_final - t + F(1e-10))
        y_new, y_err = rk_step(t, y, h)
        with torch.no_grad():
            tol = atol + rtol * torch.maximum(y.abs(), y_new.abs())
            ratio = torch.sqrt(torch.mean((y_err / tol) ** 2) + 1e-30)
        ratio = F(ratio.item())                 # one sync a trial step
        factor = np.clip(F(0.9) * np.power(max(ratio, F(1e-10)),
                                              F(-1.0 / order)),
                         F(0.2), F(5.0))
        if ratio <= 1.0:
            t_new = t + h
            while nxt < T and tsh[nxt] <= t_new + F(1e-12):
                w = ((tsh[nxt] - t) / (t_new - t) if t_new > t
                     else F(0.0))
                out[nxt] = y + float(w) * (y_new - y)
                nxt += 1
            t, y = t_new, y_new
        h = h * factor
    out = _poison(out, y0)
    if differentiable:
        return out
    return nondiff_guard(
        out, "adaptive embedded RK (rk12/rk23)",
        "For training losses use a fixed-grid method (euler/rk4/...), or "
        "pass differentiable=True.")


def odeint_rk23(f: Callable, y0: torch.Tensor, ts, rtol: float = 1e-4,
                atol: float = 1e-6, max_steps: int = 4096,
                differentiable: bool = False) -> torch.Tensor:
    """Bogacki–Shampine 2(3)."""
    A = ((), (0.5,), (0.0, 0.75), (2 / 9, 1 / 3, 4 / 9))
    b_high = (2 / 9, 1 / 3, 4 / 9, 0.0)
    b_low = (7 / 24, 1 / 4, 1 / 3, 1 / 8)
    c = (0.0, 0.5, 0.75, 1.0)
    return _adaptive_embedded(f, y0, ts, A, b_high, b_low, c, 3, rtol, atol,
                              max_steps, differentiable)


def odeint_rk12(f: Callable, y0: torch.Tensor, ts, rtol: float = 1e-3,
                atol: float = 1e-5, max_steps: int = 8192,
                differentiable: bool = False) -> torch.Tensor:
    """Heun–Euler 1(2)."""
    return _adaptive_embedded(f, y0, ts, ((), (1.0,)), (0.5, 0.5),
                              (1.0, 0.0), (0.0, 1.0), 2, rtol, atol,
                              max_steps, differentiable)


def _grid(y0, ts, dt):
    grid, out_idx = make_grid(_host_times(ts), dt)
    as_t = lambda a: torch.as_tensor(a, dtype=y0.dtype, device=y0.device)
    return as_t(grid[:-1]), as_t(np.diff(grid)), out_idx


def odeint_ode23s(f: Callable, y0: torch.Tensor, ts, dt=None,
                  max_steps: int = 4096) -> torch.Tensor:
    """Rosenbrock(2,3) for stiff ODEs on make_grid(ts, dt). y0 [..., D]:
    each row's Jacobian over D, W = I - h d J with d = 1/(2 + sqrt 2),
    then k1 = W^-1 f(t, y), k2 = W^-1 (f(t + h/2, y + h/2 k1) - k1) + k1
    and y + h k2. Differentiable (a fixed grid)."""
    t_lo, hs, out_idx = _grid(y0, ts, dt)
    D = y0.shape[-1]
    d = 1.0 / (2.0 + np.sqrt(2.0))
    eye = torch.eye(D, dtype=y0.dtype, device=y0.device)
    ys, y = [y0], y0
    for k in range(hs.shape[0]):
        t0, h = t_lo[k], hs[k]
        J = torch.func.vmap(torch.func.jacfwd(
            lambda r: f(t0, r[None])[0]))(y.reshape(-1, D))
        W = eye - h * d * J.reshape(y.shape[:-1] + (D, D))
        k1 = torch.linalg.solve(W, f(t0, y)[..., None])[..., 0]
        f1 = f(t0 + 0.5 * h, y + 0.5 * h * k1)
        k2 = torch.linalg.solve(W, (f1 - k1)[..., None])[..., 0] + k1
        y = y + h * k2
        ys.append(y)
    return torch.stack(ys)[torch.as_tensor(out_idx, device=y0.device)]


def odeint_sym12(f: Callable, y0: torch.Tensor, ts, dt=None,
                 v0=None) -> torch.Tensor:
    """Sym12Async-style asynchronous leapfrog on make_grid(ts, dt) with
    the augmented state (y, v), v0 = f(t0, y0) unless given:
        v_half = (v + f(t, y)) / 2,  y' = y + h v_half,
        v' = 2 f(t + h, y') - v_half.
    Differentiable (a fixed grid)."""
    t_lo, hs, out_idx = _grid(y0, ts, dt)
    v = f(t_lo[0], y0) if v0 is None else v0
    ys, y = [y0], y0
    for k in range(hs.shape[0]):
        t0, h = t_lo[k], hs[k]
        v_half = 0.5 * (v + f(t0, y))
        y = y + h * v_half
        v = 2.0 * f(t0 + h, y) - v_half
        ys.append(y)
    return torch.stack(ys)[torch.as_tensor(out_idx, device=y0.device)]
