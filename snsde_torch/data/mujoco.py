"""MuJoCo forecasting windows (counterpart of snsde/data/mujoco.py:33-95).

A trajectory bank [n_traj, T, D] (the reference's `mujoco.npy`, 100
trajectories of 100 steps and 14 channels) becomes stride-1 sliding
windows of `time_seq` input rows and `y_seq` target rows; whole input
rows are dropped as missing with a seed-56789 torch generator. The bank is
not part of this repository: `get_data` reads it only from an explicit
`npy_path`, and otherwise returns synthetic windows of the same shape.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .synthetic import synthetic_mujoco

__all__ = ["load_windows", "drop_timestep_rows", "get_data"]


def load_windows(npy_path: str, time_seq: int = 50, y_seq: int = 10,
                 stride: int = 1):
    """Stride-1 windows of a trajectory bank; the last y_seq rows of each
    trajectory never start a window (the reference's range without +1).
    Returns (X [N, time_seq, D], y [N, y_seq, D]) in float32."""
    raw = np.load(npy_path)                 # [n_traj, T, D]
    if raw.ndim == 2:
        raw = raw[None]
    total = time_seq + y_seq
    X, y = [], []
    for traj in raw:
        for start in range(0, traj.shape[0] - total, stride):
            X.append(traj[start:start + time_seq])
            y.append(traj[start + time_seq:start + total])
    return np.asarray(X, np.float32), np.asarray(y, np.float32)


def drop_timestep_rows(X: np.ndarray, missing_rate: float,
                       seed: int = 56789) -> np.ndarray:
    """Set int(L * missing_rate) whole rows of each window to NaN, drawn
    window by window from one torch.Generator(seed) by randperm, as the
    reference does."""
    if missing_rate <= 0:
        return X
    X = X.copy()
    L = X.shape[1]
    k = int(L * missing_rate)
    g = torch.Generator().manual_seed(seed)
    for i in range(X.shape[0]):
        rows = torch.randperm(L, generator=g)[:k].sort().values.numpy()
        X[i, rows] = np.nan
    return X


def get_data(npy_path: Optional[str] = None, time_seq: int = 50,
             y_seq: int = 10, missing_rate: float = 0.0,
             n_synthetic: int = 2048, seed: int = 0):
    """(X_in [N, time_seq, D], y_out [N, y_seq, D], times [time_seq]):
    windows of the bank at `npy_path` (FileNotFoundError if it is given and
    absent), or n_synthetic synthetic windows when it is None."""
    if npy_path is not None:
        if not os.path.exists(npy_path):
            raise FileNotFoundError(f"{npy_path} not found")
        X_in, y_out = load_windows(npy_path, time_seq, y_seq)
    else:
        X, _ = synthetic_mujoco(n=n_synthetic, length=time_seq + y_seq,
                                seed=seed)
        X_in, y_out = X[:, :time_seq], X[:, time_seq:]
    X_in = drop_timestep_rows(X_in, missing_rate)
    times = np.arange(time_seq, dtype=np.float32)
    return X_in, y_out, times
