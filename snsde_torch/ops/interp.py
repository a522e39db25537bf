"""Control-path interpolation (counterpart of snsde/ops/interp.py:56-636).

The NaN-aware natural cubic spline (a masked Thomas solve over the observed
knots of every series at once), linear fill of missing values, Hermite
cubic coefficients with backward differences (torchcde semantics), the
packed coefficient layout [..., L-1, 4C] = [a | b | 2c | 3d], and
`CubicPath` evaluation and derivative; the linear and rectilinear controls
(`linear_coeffs`, `rectilinear_coeffs`) and `LinearPath`.

Bucket rule, as in the JAX package: the interval of time t is
searchsorted(times, t, side="left") - 1, clipped to [0, L-2], so a knot
time evaluates at the END of the interval before it. A linear path's
derivative jumps at a knot, so a time one ulp across a knot takes another
slope: the fused CDE solve's stage times follow the eager steppers'
float32 arithmetic for that reason (kernels/fused_cde.py:_stage_grid).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["tridiagonal_solve", "natural_cubic_coeffs", "fill_missing_linear",
           "hermite_cubic_coeffs", "linear_coeffs", "rectilinear_coeffs",
           "pack_coeffs", "unpack_coeffs", "CubicPath", "LinearPath"]


def tridiagonal_solve(b, A_upper, A_diagonal, A_lower):
    """Solve A x = b for tridiagonal A (Thomas algorithm), batched over the
    leading dims. b, A_diagonal: [..., N]; A_upper, A_lower: [..., N-1]
    (broadcast to b). Denominators below 1e-30 in magnitude are clamped to
    +-1e-30, as in the JAX package."""
    N = b.shape[-1]
    lead = b.shape[:-1]
    up = torch.broadcast_to(torch.as_tensor(A_upper, dtype=b.dtype,
                                            device=b.device), lead + (N - 1,))
    lo = torch.broadcast_to(torch.as_tensor(A_lower, dtype=b.dtype,
                                            device=b.device), lead + (N - 1,))
    dg = torch.broadcast_to(torch.as_tensor(A_diagonal, dtype=b.dtype,
                                            device=b.device), b.shape)
    zero = torch.zeros(lead, dtype=b.dtype, device=b.device)
    eps = torch.tensor(1e-30, dtype=b.dtype, device=b.device)

    def safe_div(num, den):
        den = torch.where(den.abs() < eps, torch.where(den < 0, -eps, eps),
                          den)
        return num / den

    cp_prev, e_prev = zero, zero
    cps, es = [], []
    for i in range(N):
        u_i = up[..., i] if i < N - 1 else zero
        l_im1 = lo[..., i - 1] if i > 0 else zero
        denom = dg[..., i] - l_im1 * cp_prev
        cp_prev = safe_div(u_i, denom)
        e_prev = safe_div(b[..., i] - l_im1 * e_prev, denom)
        cps.append(cp_prev)
        es.append(e_prev)
    x_next = zero
    xs = [None] * N
    for i in range(N - 1, -1, -1):
        x_next = es[i] - cps[i] * x_next
        xs[i] = x_next
    return torch.stack(xs, dim=-1)


def _natural_coeffs_clean(times, path):
    """times [L]; path [..., L] (no NaN). Returns (a, b, two_c, three_d),
    each [..., L-1]: the knot-derivative tridiagonal system with natural
    boundary conditions, then the per-interval coefficients."""
    L = path.shape[-1]
    if L == 2:
        a = path[..., :1]
        b = (path[..., 1:] - path[..., :1]) / (times[1:] - times[:1])
        zero = torch.zeros_like(a)
        return a, b, zero, zero
    h = times[1:] - times[:-1]                          # [L-1]
    rh = 1.0 / h
    rh2 = rh * rh
    diffs = path[..., 1:] - path[..., :-1]              # [..., L-1]
    three_diffs_scaled = 3.0 * diffs * rh2
    diag = torch.zeros((L,), dtype=path.dtype, device=path.device)
    diag[:-1] = diag[:-1] + rh
    diag[1:] = diag[1:] + rh
    diag = 2.0 * diag
    rhs = torch.zeros(path.shape, dtype=path.dtype, device=path.device)
    rhs[..., :-1] = rhs[..., :-1] + three_diffs_scaled
    rhs[..., 1:] = rhs[..., 1:] + three_diffs_scaled
    knot_derivs = tridiagonal_solve(rhs, rh, diag, rh)  # [..., L]
    m0 = knot_derivs[..., :-1]
    m1 = knot_derivs[..., 1:]
    two_c = (6.0 * diffs * rh - 4.0 * m0 - 2.0 * m1) * rh
    three_d = (-6.0 * diffs * rh + 3.0 * (m0 + m1)) * rh2
    return path[..., :-1], m0, two_c, three_d


def _natural_coeffs_missing(times, x):
    """NaN-aware natural cubic fit of every row of x [N, L] at once (the
    JAX package's per-series `_natural_coeffs_missing_1d`, batched):
    impute the end points with the first/last observed value, compact the
    observed knots to the front (stable sort), solve the masked tridiagonal
    system over the compacted knots, then shift each compacted interval's
    cubic back to every grid interval. A row with no observation gives
    zeros; a row observed once gives a constant."""
    N, L = x.shape
    dtype, dev = x.dtype, x.device
    pos = torch.arange(L, device=dev)
    obs = torch.isfinite(x)
    any_obs = obs.any(dim=-1, keepdim=True)

    idx_first = torch.argmax(obs.to(torch.uint8), dim=-1, keepdim=True)
    idx_last = L - 1 - torch.argmax(obs.flip(-1).to(torch.uint8), dim=-1,
                                    keepdim=True)
    safe = torch.where(obs, x, torch.zeros_like(x))
    first_val = torch.gather(safe, -1, idx_first)
    last_val = torch.gather(safe, -1, idx_last)
    path = torch.where(obs, x, torch.full_like(x, float("nan")))
    path = torch.cat([torch.where(obs[:, :1], path[:, :1], first_val),
                      path[:, 1:-1],
                      torch.where(obs[:, -1:], path[:, -1:], last_val)], -1)
    obs = torch.isfinite(path)
    n = obs.sum(dim=-1, keepdim=True)                   # >= 2 if any_obs

    # observed knots first, in their order
    order = torch.sort((~obs).to(torch.uint8), dim=-1, stable=True).indices
    t_obs = times[order]
    x_obs = torch.where(torch.gather(obs, -1, order),
                        torch.gather(path, -1, order), torch.zeros_like(x))
    # pad the tail with an increasing grid so h > 0; masked out below
    valid = pos < n
    last = (n - 1).clamp(min=0)
    t_pad = torch.gather(t_obs, -1, last) + (pos - (n - 1)).to(dtype)
    t_obs = torch.where(valid, t_obs, t_pad)
    x_obs = torch.where(valid, x_obs, torch.gather(x_obs, -1, last))

    h = t_obs[:, 1:] - t_obs[:, :-1]
    rh = torch.where(pos[:-1] < (n - 1), 1.0 / h, torch.zeros_like(h))
    rh2 = rh * rh
    diffs = x_obs[:, 1:] - x_obs[:, :-1]
    three_diffs_scaled = 3.0 * diffs * rh2
    diag = torch.zeros((N, L), dtype=dtype, device=dev)
    diag[:, :-1] = diag[:, :-1] + rh
    diag[:, 1:] = diag[:, 1:] + rh
    diag = 2.0 * diag
    one = torch.ones_like(diag)
    diag = torch.where(valid, diag, one)                # knots beyond n
    diag = torch.where(diag == 0.0, one, diag)          # n == 1
    rhs = torch.zeros((N, L), dtype=dtype, device=dev)
    rhs[:, :-1] = rhs[:, :-1] + three_diffs_scaled
    rhs[:, 1:] = rhs[:, 1:] + three_diffs_scaled
    rhs = torch.where(valid, rhs, torch.zeros_like(rhs))
    knot_derivs = tridiagonal_solve(rhs, rh, diag, rh)

    m0 = knot_derivs[:, :-1]
    m1 = knot_derivs[:, 1:]
    a_c = x_obs[:, :-1]
    two_c_c = (6.0 * diffs * rh - 4.0 * m0 - 2.0 * m1) * rh
    three_d_c = (-6.0 * diffs * rh + 3.0 * (m0 + m1)) * rh2

    # grid interval i starts at tau_i inside compacted interval j
    tau = times[:-1].expand(N, L - 1).contiguous()
    j = torch.searchsorted(t_obs.contiguous(), tau, right=True) - 1
    j = torch.minimum(j.clamp(min=0), (n - 2).clamp(min=0))
    offset = torch.gather(t_obs, -1, j) - tau           # <= 0
    aj, bj = torch.gather(a_c, -1, j), torch.gather(m0, -1, j)
    cj2, dj3 = torch.gather(two_c_c, -1, j), torch.gather(three_d_c, -1, j)
    a_i = aj + (((0.5 * cj2 - dj3 * offset / 3.0) * offset - bj) * offset)
    b_i = bj + (dj3 * offset - cj2) * offset
    two_c_i = cj2 - 2.0 * dj3 * offset
    zeros = torch.zeros_like(a_i)
    return tuple(torch.where(any_obs, v, zeros)
                 for v in (a_i, b_i, two_c_i, dj3))


def natural_cubic_coeffs(times, series, *, pack: bool = False):
    """Natural cubic spline coefficients. times: [L] strictly increasing;
    series: [..., L, C], NaN = missing. Returns (a, b, two_c, three_d),
    each [..., L-1, C], or the packed [..., L-1, 4C] when pack=True. A
    series with NaNs takes the NaN-aware fit, all series of the batch at
    once."""
    series = torch.as_tensor(series)
    times = torch.as_tensor(times, dtype=series.dtype, device=series.device)
    x = series.transpose(-1, -2)                        # [..., C, L]
    if not bool(torch.isnan(series).any()):
        out = _natural_coeffs_clean(times, x)
    else:
        flat = _natural_coeffs_missing(times, x.reshape(-1, x.shape[-1]))
        shape = x.shape[:-1] + (x.shape[-1] - 1,)
        out = tuple(v.reshape(shape) for v in flat)
    out = tuple(v.transpose(-1, -2) for v in out)
    return pack_coeffs(*out) if pack else out


def fill_missing_linear(times, series):
    """Linearly interpolate NaNs per channel; constant extension at the
    ends; all-NaN channels become zeros. series: [..., L, C]."""
    series = torch.as_tensor(series)
    times = torch.as_tensor(times, dtype=series.dtype, device=series.device)
    x = series.transpose(-1, -2)                        # [..., C, L]
    L = x.shape[-1]
    pos = torch.arange(L, device=x.device)

    obs = torch.isfinite(x)
    xv = torch.where(obs, x, torch.zeros_like(x))
    # index of the most recent observation at or before each position, and
    # of the next one at or after it
    prev_idx = torch.cummax(torch.where(obs, pos, -1), dim=-1).values
    next_idx = torch.where(obs, pos, L).flip(-1).cummin(dim=-1).values.flip(-1)

    has_prev = prev_idx >= 0
    has_next = next_idx < L
    pi = prev_idx.clamp(0, L - 1)
    ni = next_idx.clamp(0, L - 1)
    xp = torch.gather(xv, -1, pi)
    xn = torch.gather(xv, -1, ni)
    tp = times[pi]
    tn = times[ni]
    denom = torch.where(ni == pi, torch.ones_like(tp), tn - tp)
    w = (times - tp) / denom
    interp = xp + w * (xn - xp)

    zero = torch.zeros_like(xp)
    filled = torch.where(
        has_prev & has_next,
        torch.where(prev_idx == next_idx, xp, interp),
        torch.where(has_prev, xp, torch.where(has_next, xn, zero)),
    )
    return filled.transpose(-1, -2)


def hermite_cubic_coeffs(times, series, *, pack: bool = True):
    """Hermite cubic coefficients with backward differences.

    times: [L]; series: [..., L, C] (NaN = missing). Knot derivative
    m_k = (x_k - x_{k-1})/h_{k-1} for k >= 1, m_0 = m_1. Returns packed
    [..., L-1, 4C], or the 4-tuple (a, b, 2c, 3d) when pack=False."""
    series = torch.as_tensor(series)
    times = torch.as_tensor(times, dtype=series.dtype, device=series.device)
    x = fill_missing_linear(times, series)              # [..., L, C]
    h = (times[1:] - times[:-1])[:, None]               # [L-1, 1]
    slopes = (x[..., 1:, :] - x[..., :-1, :]) / h       # [..., L-1, C]
    m = torch.cat([slopes[..., :1, :], slopes], dim=-2)
    m0 = m[..., :-1, :]
    m1 = m[..., 1:, :]
    a = x[..., :-1, :]
    b = m0
    two_c = 2.0 * (3.0 * slopes - 2.0 * m0 - m1) / h
    three_d = 3.0 * (m0 + m1 - 2.0 * slopes) / (h * h)
    out = (a, b, two_c, three_d)
    return pack_coeffs(*out) if pack else out


def linear_coeffs(times, series):
    """The linear control's knot values: the series with its NaNs filled
    (fill_missing_linear), [..., L, C]."""
    return fill_missing_linear(times, series)


def rectilinear_coeffs(times, series, time_index: int = 0):
    """The rectilinear control (snsde/ops/interp.py:368-389): the filled
    series held between observations, with time and value moves
    interleaved, which doubles the length axis. Returns (new_times [2L-1],
    values [..., 2L-1, C]) for a LinearPath; the channel `time_index`
    (None: none) is overwritten by new_times."""
    series = torch.as_tensor(series)
    times = torch.as_tensor(times, dtype=series.dtype, device=series.device)
    x = fill_missing_linear(times, series)
    L = x.shape[-2]
    reps = x.repeat_interleave(2, dim=-2)[..., :2 * L - 1, :]
    vals = torch.cat([x[..., :1, :], reps[..., :-1, :]], dim=-2)
    t_reps = times.repeat_interleave(2)[1:]
    new_times = torch.cat([times[:1], t_reps[:-1]])
    if time_index is not None:
        vals[..., time_index] = new_times.expand(vals.shape[:-1])
    return new_times, vals


def pack_coeffs(a, b, two_c, three_d):
    return torch.cat([a, b, two_c, three_d], dim=-1)


def unpack_coeffs(packed) -> Tuple[torch.Tensor, ...]:
    C = packed.shape[-1] // 4
    return (packed[..., :C], packed[..., C:2 * C], packed[..., 2 * C:3 * C],
            packed[..., 3 * C:])


class CubicPath:
    """Piecewise-cubic control path over packed coefficients
    [..., L-1, 4C] (or the 4-tuple) and knot times [L].

    The knot times are kept on the host as numpy, because solver grids are
    host constants: `evaluate_grid` resolves buckets on the host in float64
    and casts the fractions to float32, as `snsde/ops/interp.py:493-525`
    does. `evaluate` takes one time on the device."""

    def __init__(self, coeffs, times):
        if isinstance(coeffs, (tuple, list)):
            a, b, two_c, three_d = coeffs
        else:
            a, b, two_c, three_d = unpack_coeffs(torch.as_tensor(coeffs))
        self.a, self.b, self.two_c, self.three_d = a, b, two_c, three_d
        if isinstance(times, torch.Tensor):
            times = times.detach().cpu().numpy()
        self.times_np = np.asarray(times)
        self.times = torch.as_tensor(self.times_np, dtype=a.dtype,
                                     device=a.device)

    @property
    def channels(self) -> int:
        return self.a.shape[-1]

    def _bucket(self, t, coeffs):
        """The rows of `coeffs` (each [..., L-1, C]) in the interval of one
        time t on the device, each [..., C], and t's offset into it."""
        t = torch.as_tensor(t, dtype=self.a.dtype, device=self.a.device)
        idx = torch.searchsorted(self.times, t.reshape(1), side="left") - 1
        idx = idx.clamp(0, self.a.shape[-2] - 1)
        rows = [c.index_select(-2, idx).squeeze(-2) for c in coeffs]
        return rows, t - self.times[idx[0]]

    def _grid_bucket(self, ts, coeffs):
        """The same for a host grid of times [M], the buckets resolved on
        the host in float64 (rows [M, ..., C], offsets [M, 1.., 1] cast to
        float32), as `snsde/ops/interp.py:493-561` does."""
        ts = np.asarray(ts, np.float64)
        times = self.times_np.astype(np.float64)
        idx = np.clip(np.searchsorted(times, ts, side="left") - 1,
                      0, self.a.shape[-2] - 1)
        idx_t = torch.as_tensor(idx, device=self.a.device)
        rows = [c.index_select(-2, idx_t).movedim(-2, 0) for c in coeffs]
        frac = torch.as_tensor((ts - times[idx]).astype(np.float32),
                               device=self.a.device)
        return rows, frac.reshape((len(idx),) + (1,) * (self.a.ndim - 1))

    @staticmethod
    def _value(rows, frac):
        a, b, two_c, three_d = rows
        inner = 0.5 * two_c + three_d * frac / 3.0
        return a + (b + inner * frac) * frac

    @staticmethod
    def _slope(rows, frac):
        b, two_c, three_d = rows
        return b + (two_c + three_d * frac) * frac

    def evaluate(self, t):
        """X(t) for one time t -> [..., C]."""
        return self._value(*self._bucket(
            t, (self.a, self.b, self.two_c, self.three_d)))

    def evaluate_grid(self, ts) -> torch.Tensor:
        """X at a host grid of times [M] -> [M, ..., C]."""
        return self._value(*self._grid_bucket(
            ts, (self.a, self.b, self.two_c, self.three_d)))

    def derivative(self, t):
        """dX/dt at one time t -> [..., C] (t on the device, bucketed in
        the coefficients' precision, as `evaluate`)."""
        return self._slope(*self._bucket(t, (self.b, self.two_c,
                                             self.three_d)))

    def derivative_grid(self, ts) -> torch.Tensor:
        """dX/dt at a host grid of times [M] -> [M, ..., C] (the
        control-derivative stream of the fused CDE solve)."""
        return self._slope(*self._grid_bucket(ts, (self.b, self.two_c,
                                                   self.three_d)))


class LinearPath:
    """Piecewise-linear control path over knot values [..., L, C] and knot
    times [L] (snsde/ops/interp.py:566-636), the times kept on the host as
    numpy and on the values' device. `evaluate` and `derivative` take one
    time on the device and divide by the float32 knot gap;
    `derivative_grid` resolves the buckets of a host grid in float64 and
    divides by the knot gap cast from float64 to float32, as the JAX
    package does each."""

    def __init__(self, times, values):
        values = torch.as_tensor(values)
        if isinstance(times, torch.Tensor):
            times = times.detach().cpu().numpy()
        self.values = values
        self.times_np = np.asarray(times)
        self.times = torch.as_tensor(self.times_np, dtype=values.dtype,
                                     device=values.device)

    def _knots(self, t):
        """The knot values at both ends of one device time t's interval,
        each [..., C], its offset into the interval and the interval's
        float32 gap."""
        t = torch.as_tensor(t, dtype=self.values.dtype,
                            device=self.values.device)
        idx = torch.searchsorted(self.times, t.reshape(1), side="left") - 1
        idx = idx.clamp(0, self.values.shape[-2] - 2)
        x0 = self.values.index_select(-2, idx).squeeze(-2)
        x1 = self.values.index_select(-2, idx + 1).squeeze(-2)
        return x0, x1, t - self.times[idx[0]], (self.times[idx[0] + 1]
                                               - self.times[idx[0]])

    def evaluate(self, t):
        """X(t) for one time t -> [..., C]."""
        x0, x1, frac, h = self._knots(t)
        return x0 + (frac / h) * (x1 - x0)

    def derivative(self, t):
        """dX/dt at one time t -> [..., C]."""
        x0, x1, _, h = self._knots(t)
        return (x1 - x0) / h

    def derivative_grid(self, ts) -> torch.Tensor:
        """dX/dt at a host grid of times [M] -> [M, ..., C] (the
        control-derivative stream of the fused CDE solve)."""
        ts = np.asarray(ts, np.float64)
        times = self.times_np.astype(np.float64)
        idx = np.clip(np.searchsorted(times, ts, side="left") - 1,
                      0, self.values.shape[-2] - 2)
        take = lambda i: self.values.index_select(
            -2, torch.as_tensor(i, device=self.values.device)).movedim(-2, 0)
        h = torch.as_tensor((times[idx + 1] - times[idx]).astype(np.float32),
                            device=self.values.device)
        return (take(idx + 1) - take(idx)) / h.reshape(
            (len(idx),) + (1,) * (self.values.ndim - 1))
