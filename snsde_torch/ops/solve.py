"""Fixed-grid SDE solver (counterpart of snsde/ops/solve.py:48-91, 249-332).

`make_grid` is host numpy, a copy of the JAX package's, both modes.
`sdeint` is an eager Euler–Maruyama loop differentiated by torch autograd;
the other methods of the JAX package (milstein, heun, srk,
reversible_heun) are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .brownian import BrownianGrid, brownian_increments

__all__ = ["make_grid", "sdeint"]


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


def sdeint(f: Callable, g: Callable, y0: torch.Tensor, ts, *,
           generator: Optional[torch.Generator] = None,
           bm: Optional[BrownianGrid] = None, dt: Optional[float] = None,
           method: str = "euler", grid_mode: str = "equal") -> torch.Tensor:
    """Integrate dy = f(t,y) dt + g(t,y) dW (diagonal noise) over output
    times ts. y0: [..., H]. Brownian increments come from `bm` when given,
    else from `generator`. Returns ys [T, ...y0.shape] (time-major)."""
    if method != "euler":
        raise NotImplementedError(
            f"sdeint method {method!r} is not ported yet (ROADMAP Queue 1 "
            "item 13: the other SDE solvers); only 'euler' runs"
        )
    if isinstance(ts, torch.Tensor):
        ts = ts.detach().cpu().numpy()
    if bm is not None:
        grid = np.asarray(bm.grid, np.float64)
        ts_np = np.asarray(ts, np.float64)
        # nearest match: the stored grid may have been through float32
        out_idx = np.abs(grid[None, :] - ts_np[:, None]).argmin(axis=1)
        tol = 1e-5 * max(float(grid[-1] - grid[0]), 1.0)
        np.testing.assert_allclose(grid[out_idx], ts_np, rtol=0, atol=tol)
        dW = bm.dW
    else:
        if generator is None:
            raise ValueError("sdeint needs either generator= or bm=")
        grid, out_idx = make_grid(ts, dt, mode=grid_mode)
        dW = brownian_increments(generator, grid, tuple(y0.shape), y0.dtype,
                                 y0.device)

    t_lo = torch.as_tensor(grid[:-1], dtype=y0.dtype, device=y0.device)
    dts = torch.as_tensor(np.diff(grid), dtype=y0.dtype, device=y0.device)
    ys = [y0]
    y = y0
    for k in range(dts.shape[0]):
        t0 = t_lo[k]
        y = y + f(t0, y) * dts[k] + g(t0, y) * dW[k]
        ys.append(y)
    return torch.stack(ys)[torch.as_tensor(out_idx, device=y0.device)]
