"""Synthetic sepsis- and MuJoCo-shaped data (counterpart of
snsde/data/synthetic.py:20-50, 86-100, the port's own copy: the same
arrays, bit for bit, from the same seed).

The sepsis archive and the MuJoCo trajectory bank are not downloaded here,
so the harnesses run on data with the same shapes (and, for sepsis, the
same missingness and a learnable label).
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_sepsis", "synthetic_mujoco"]


def synthetic_sepsis(n: int = 4096, length: int = 72, channels: int = 34,
                     static_dim: int = 4, pos_frac: float = 0.1,
                     missing_rate: float = 0.9, seed: int = 0):
    """Sepsis-shaped: [n, 72, 34] heavily-missing vitals + 4 static features
    + binary label with ~10% positives (reference sepsis.py:42-154 shape).
    Label depends on a drift signature in a random channel subset so models
    must read the temporal structure."""
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < pos_frac).astype(np.int64)
    t = np.linspace(0, 1, length)
    base = rng.normal(0, 1, (n, length, channels)).astype(np.float32)
    # smooth with a short moving average for physiological feel
    k = 5
    kernel = np.ones(k) / k
    base = np.apply_along_axis(
        lambda m: np.convolve(m, kernel, mode="same"), 1, base
    ).astype(np.float32)
    informative = rng.choice(channels, size=6, replace=False)
    drift = (t[None, :] ** 1.5)[..., None] * rng.uniform(
        0.8, 1.6, size=(n, 1, len(informative))
    )
    base[:, :, informative] += drift * y[:, None, None]
    # missingness: keep ~ (1-missing_rate) of entries
    mask = rng.random((n, length, channels)) < missing_rate
    base[mask] = np.nan
    lengths = rng.integers(low=length // 2, high=length + 1, size=n)
    for i in range(n):
        base[i, lengths[i]:, :] = np.nan
    static = rng.normal(0, 1, (n, static_dim)).astype(np.float32)
    static[:, 0] += 0.5 * y
    return base, static, y, lengths.astype(np.int64), t.astype(np.float32)


def synthetic_mujoco(n: int = 2048, length: int = 60, channels: int = 14,
                     seed: int = 0):
    """MuJoCo-shaped windows [n, 60, 14] (50 in + 10 out): smooth
    pseudo-physical trajectories from coupled damped oscillators."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 3, length, dtype=np.float32)
    freqs = rng.uniform(0.5, 2.0, (n, channels)).astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, (n, channels)).astype(np.float32)
    amps = rng.uniform(0.5, 1.5, (n, channels)).astype(np.float32)
    X = amps[:, None, :] * np.sin(
        2 * np.pi * freqs[:, None, :] * t[None, :, None] + phases[:, None, :]
    )
    X += 0.02 * rng.normal(0, 1, X.shape).astype(np.float32)
    return X.astype(np.float32), t
