"""Control-path interpolation (counterpart of snsde/ops/interp.py:295-560).

Linear fill of missing values, Hermite cubic coefficients with backward
differences (torchcde semantics), the packed coefficient layout
[..., L-1, 4C] = [a | b | 2c | 3d], and `CubicPath` evaluation.

Bucket rule, as in the JAX package: the interval of time t is
searchsorted(times, t, side="left") - 1, clipped to [0, L-2], so a knot
time evaluates at the END of the interval before it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["fill_missing_linear", "hermite_cubic_coeffs", "pack_coeffs",
           "unpack_coeffs", "CubicPath"]


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

    def evaluate(self, t):
        """X(t) for one time t -> [..., C]."""
        t = torch.as_tensor(t, dtype=self.a.dtype, device=self.a.device)
        idx = torch.searchsorted(self.times, t.reshape(1), side="left") - 1
        idx = idx.clamp(0, self.a.shape[-2] - 1)
        frac = t - self.times[idx[0]]
        take = lambda c: c.index_select(-2, idx).squeeze(-2)
        a, b = take(self.a), take(self.b)
        two_c, three_d = take(self.two_c), take(self.three_d)
        inner = 0.5 * two_c + three_d * frac / 3.0
        inner = b + inner * frac
        return a + inner * frac

    def evaluate_grid(self, ts) -> torch.Tensor:
        """X at a host grid of times [M] -> [M, ..., C]."""
        ts = np.asarray(ts, np.float64)
        times = self.times_np.astype(np.float64)
        idx = np.clip(np.searchsorted(times, ts, side="left") - 1,
                      0, self.a.shape[-2] - 1)
        idx_t = torch.as_tensor(idx, device=self.a.device)
        take = lambda c: c.index_select(-2, idx_t).movedim(-2, 0)
        a, b = take(self.a), take(self.b)
        two_c, three_d = take(self.two_c), take(self.three_d)
        frac = torch.as_tensor((ts - times[idx]).astype(np.float32),
                               device=self.a.device)
        frac = frac.reshape((len(idx),) + (1,) * (a.ndim - 1))
        inner = 0.5 * two_c + three_d * frac / 3.0
        return a + (b + inner * frac) * frac
