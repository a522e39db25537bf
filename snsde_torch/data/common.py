"""Classification preprocessing (counterpart of snsde/data/common.py).

Train-stats normalisation, the time and cumulative-intensity channels, the
stratified 70/15/15 split, Hermite or natural cubic spline coefficients,
and the seeded per-channel missingness of the robustness runs, on the
host. The coefficients come from the port's own `ops.interp` (on the CPU).

The loaders' cache (`cache_path`, `load_cached`, `save_cached`; JAX's
:163-179) keeps a tuple of arrays as `.npz`, loaded without pickles, in a
directory the caller names (the loaders use their data directory): a
`<name>_<hash>.npz` beside the JAX package's `<name>_<hash>.pkl` never
collides with it.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.interp import hermite_cubic_coeffs, natural_cubic_coeffs

__all__ = ["normalize_with_train_stats", "append_time_intensity",
           "stratified_split", "inject_missingness",
           "preprocess_classification", "cache_path", "load_cached",
           "save_cached"]


def normalize_with_train_stats(X: np.ndarray, train_idx) -> np.ndarray:
    """Per-channel (x - mean)/std from the training rows only; NaNs are
    ignored in the statistics and kept in the output."""
    X = np.asarray(X, np.float32)
    tr = X[train_idx]
    mean = np.nanmean(tr.reshape(-1, tr.shape[-1]), axis=0)
    std = np.nanstd(tr.reshape(-1, tr.shape[-1]), axis=0)
    std = np.where(std < 1e-8, 1.0, std)
    return (X - mean) / std


def append_time_intensity(X: np.ndarray, times: np.ndarray,
                          use_intensity: bool) -> np.ndarray:
    """Prepend a time channel and, with use_intensity, the per-channel
    cumulative observation counts."""
    B, L, C = X.shape
    tchan = np.broadcast_to(np.asarray(times, np.float32)[None, :, None],
                            (B, L, 1))
    pieces = [tchan]
    if use_intensity:
        pieces.append(np.cumsum((~np.isnan(X)).astype(np.float32), axis=1))
    pieces.append(X)
    return np.concatenate(pieces, axis=-1)


def stratified_split(y: np.ndarray, fractions=(0.7, 0.15, 0.15),
                     seed: int = 0) -> Tuple[np.ndarray, ...]:
    """Per-class shuffled split into len(fractions) sorted index groups."""
    y = np.asarray(y).ravel()
    rng = np.random.default_rng(seed)
    groups = [[] for _ in fractions]
    for cls in np.unique(y):
        idx = np.flatnonzero(y == cls)
        rng.shuffle(idx)
        bounds = np.cumsum([int(round(f * len(idx))) for f in fractions])
        bounds[-1] = len(idx)
        start = 0
        for gi, b in enumerate(bounds):
            groups[gi].append(idx[start:b])
            start = b
    return tuple(np.sort(np.concatenate(g)) for g in groups)


def inject_missingness(X: np.ndarray, missing_rate: float,
                       seed: int = 56789) -> np.ndarray:
    """Seeded per-channel random masking (generator seed 56789); never
    masks the first observation of a channel."""
    if missing_rate <= 0:
        return X
    X = np.array(X, np.float32, copy=True)
    rng = np.random.default_rng(seed)
    B, L, C = X.shape
    for c in range(C):
        n_drop = int(missing_rate * L)
        for b in range(B):
            drop = rng.permutation(L - 1)[:n_drop] + 1
            X[b, drop, c] = np.nan
    return X


def preprocess_classification(X: np.ndarray, y: np.ndarray,
                              lengths: Optional[np.ndarray] = None,
                              use_intensity: bool = False,
                              interpolation: str = "hermite", seed: int = 0,
                              times: Optional[np.ndarray] = None) -> Dict:
    """Full pipeline -> dict of numpy arrays ready for fit_classifier.

    X: [B, L, C] raw series with NaN for missing; y: [B] int labels;
    lengths: per-sample observed length (final_index = lengths - 1)."""
    splines = {"hermite": hermite_cubic_coeffs,
               "natural": lambda t, x: natural_cubic_coeffs(t, x, pack=True)}
    if interpolation not in splines:
        raise ValueError(f"unknown interpolation {interpolation!r}")
    B, L, C = X.shape
    if times is None:
        times = np.arange(L, dtype=np.float32)
    if lengths is None:
        lengths = np.full((B,), L, np.int64)
    final_index = np.asarray(lengths, np.int64) - 1

    tr, va, te = stratified_split(y, seed=seed)
    Xa = append_time_intensity(normalize_with_train_stats(X, tr), times,
                               use_intensity)
    coeffs = splines[interpolation](
        torch.as_tensor(times, dtype=torch.float32),
        torch.as_tensor(Xa)).numpy()

    def subset(idx):
        return {"coeffs": coeffs[idx], "y": np.asarray(y)[idx],
                "final_index": final_index[idx]}

    return {
        "times": np.asarray(times, np.float32),
        "input_channels": Xa.shape[-1],
        "train": subset(tr),
        "val": subset(va),
        "test": subset(te),
    }


def cache_path(name: str, directory: str, **params) -> str:
    """<directory>/<name>_<hash>.npz, the hash JAX's: the first 12 hex
    digits of the SHA-1 of repr(sorted(params.items()))."""
    blob = repr(sorted(params.items())).encode()
    return os.path.join(directory,
                        f"{name}_{hashlib.sha1(blob).hexdigest()[:12]}.npz")


def load_cached(path: str) -> Optional[Tuple[np.ndarray, ...]]:
    """The tuple of arrays `save_cached` wrote to `path`, or None."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        return tuple(z[f"a{i}"] for i in range(len(z.files)))


def save_cached(path: str, arrays) -> None:
    """Write a tuple of arrays to `path` (.npz, no pickles)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{f"a{i}": np.asarray(a) for i, a in enumerate(arrays)})
