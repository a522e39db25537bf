"""Adaptive Dormand–Prince 5(4) ODE solver (counterpart of
snsde/ops/dopri.py:49-219).

An eager loop on the device with the step control on the host: each trial
step reads its error ratio back (one synchronisation a trial step on the
card), and the step sizes and times are host numbers in the solve's
precision (numpy float32 for float32 states), the arithmetic of the JAX
package's device scalars, so gradients flow through the state chain on the
realised grid only.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ._guards import nondiff_guard
from .brownian import _host_float

__all__ = ["odeint_dopri5"]

# Dormand–Prince tableau (snsde/ops/dopri.py:20-34)
_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
       187 / 2100, 1 / 40)


def _host_times(ts) -> np.ndarray:
    """Output times as host float64 (from a tensor, an array or a list)."""
    if isinstance(ts, torch.Tensor):
        ts = ts.detach().cpu().numpy()
    return np.asarray(ts, dtype=np.float64)


def _poison(out, y0):
    """The outputs [T, ...] with the unreached ones (None) NaN."""
    nan = torch.full_like(y0, float("nan"))
    return torch.stack([nan if o is None else o for o in out])


def odeint_dopri5(f: Callable, y0: torch.Tensor, ts, *, rtol: float = 1e-5,
                  atol: float = 1e-7, max_steps: int = 4096,
                  safety: float = 0.9, min_factor: float = 0.2,
                  max_factor: float = 10.0,
                  differentiable: bool = False) -> torch.Tensor:
    """Adaptive RK45 over the output times ts; returns [T, *y0.shape].

    Hairer's initial step from the scale of y0 and f(t0, y0); the error of
    the embedded 4th-order solution against atol + rtol max(|y|, |y_new|),
    in root mean square; accept at a ratio of at most 1; the next step h
    times clip(safety ratio^-1/5, min_factor, max_factor). Output times
    inside an accepted step take the cubic Hermite interpolant of (y, f)
    at both ends. At most `max_steps` trial steps in all: the outputs not
    reached by then are NaN, never a silent partial integration.

    `differentiable=True` gives the same values as `False` (the JAX
    package's masked scan and while_loop agree) and lets reverse mode
    through; `False` refuses it, as the JAX package's while_loop does."""
    F = _host_float(y0.dtype)
    ts_np = _host_times(ts)
    T = ts_np.shape[0]
    tsh = ts_np.astype(F)
    t, t_final = tsh[0], tsh[-1]
    scalar = lambda v: torch.tensor(v, dtype=y0.dtype, device=y0.device)

    f_t = f(scalar(t), y0)
    with torch.no_grad():
        # Hairer's initial step
        scale = atol + y0.abs() * rtol
        d0 = torch.sqrt(torch.mean((y0 / scale) ** 2))
        d1 = torch.sqrt(torch.mean((f_t / scale) ** 2))
        h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5),
                         torch.tensor(1e-6, dtype=y0.dtype, device=y0.device),
                         0.01 * d0 / d1)
    h = min(F(h0.item()), t_final - t)

    def rk_step(t, y, f_t, h):
        ks = [f_t]
        for i in range(1, 7):
            yi = y
            for j, aij in enumerate(_A[i]):
                if aij != 0.0:
                    yi = yi + float(h * F(aij)) * ks[j]
            ks.append(f(scalar(t + F(_C[i]) * h), yi))
        y5 = y
        y_err = torch.zeros_like(y)
        for i in range(7):
            if _B5[i] != 0.0:
                y5 = y5 + float(h * F(_B5[i])) * ks[i]
            diff = _B5[i] - _B4[i]
            if diff != 0.0:
                y_err = y_err + float(h * F(diff)) * ks[i]
        return y5, y_err, ks[6]                # FSAL: k7 = f(t + h, y5)

    out = [y0] + [None] * (T - 1)
    nxt, y = 1, y0
    for _ in range(max_steps):
        if nxt >= T:
            break
        h = max(min(h, t_final - t), F(1e-12))
        y_new, y_err, f_new = rk_step(t, y, f_t, h)
        with torch.no_grad():
            tol = atol + rtol * torch.maximum(y.abs(), y_new.abs())
            ratio = torch.sqrt(torch.mean((y_err / tol) ** 2))
        ratio = F(ratio.item())                 # one sync a trial step
        factor = np.clip(F(safety) * np.power(max(ratio, F(1e-10)),
                                                 F(-0.2)),
                         F(min_factor), F(max_factor))
        if ratio <= 1.0:
            t_new = t + h
            hh = t_new - t
            # every output time inside (t, t_new]: cubic Hermite
            while nxt < T and tsh[nxt] <= t_new + F(1e-12):
                s = (tsh[nxt] - t) / hh if hh > 0 else F(0.0)
                h00 = (1 + 2 * s) * (1 - s) ** 2
                h10 = s * (1 - s) ** 2
                h01 = s * s * (3 - 2 * s)
                h11 = s * s * (s - 1)
                out[nxt] = (float(h00) * y + float(h10 * hh) * f_t
                            + float(h01) * y_new + float(h11 * hh) * f_new)
                nxt += 1
            t, y, f_t = t_new, y_new, f_new
        h = h * factor
    out = _poison(out, y0)
    if differentiable:
        return out
    return nondiff_guard(
        out, "odeint_dopri5",
        "For training losses use a fixed-grid method (euler/rk4/...), or "
        "odeint/cdeint with differentiable=True.")
