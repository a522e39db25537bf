"""UEA/UCR multivariate archive (counterpart of snsde/data/uea.py, the
port's own copy): a `.ts` parser, linear resampling to one length, label
re-indexing, and the archive's zip extraction.

Nothing downloads the archive: `get_data` reads `<name>/<name>_TRAIN.ts`
and `_TEST.ts` (or extracts them from `Multivariate2018_ts.zip`) only from
an explicit `data_dir`, caches the arrays there as `.npz`, and otherwise
returns `synthetic_uea` data unless told not to.
"""

from __future__ import annotations

import os
import zipfile
from typing import List, Optional, Tuple

import numpy as np

from .common import cache_path, load_cached, save_cached
from .synthetic import synthetic_uea

__all__ = ["ARCHIVE", "parse_ts_file", "equal_length", "load_dataset",
           "get_data"]

ARCHIVE = "Multivariate2018_ts.zip"


def parse_ts_file(path: str) -> Tuple[List[List[np.ndarray]], List[str]]:
    """A .ts file -> (cases: one float32 array a dimension, labels): the
    '@' headers skipped, dimensions split on ':', values on ',', '?' or an
    empty value NaN, the class label last."""
    cases, labels = [], []
    in_data = False
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if line.lower().startswith("@data"):
                in_data = True
                continue
            if line.startswith("@") or not in_data:
                continue
            parts = line.split(":")
            cases.append([np.asarray([float(v) if v and v != "?" else np.nan
                                      for v in dim.split(",")], np.float32)
                          for dim in parts[:-1]])
            labels.append(parts[-1])
    return cases, labels


def equal_length(cases, target_len: Optional[int] = None) -> np.ndarray:
    """Every dimension linearly resampled over [0, 1] to one length (the
    longest, or target_len) -> [N, L, D], through its finite points; a
    series of one point is held, one with fewer than two finite points
    takes its first value (0 for NaN)."""
    n_dims = len(cases[0])
    max_len = target_len or max(max(len(d) for d in dims) for dims in cases)
    out = np.zeros((len(cases), max_len, n_dims), np.float32)
    xs_new = np.linspace(0.0, 1.0, max_len)
    for i, dims in enumerate(cases):
        for d, arr in enumerate(dims):
            if len(arr) == max_len:
                out[i, :, d] = arr
            elif len(arr) < 2:
                out[i, :, d] = arr[0] if len(arr) else 0.0
            else:
                xs_old = np.linspace(0.0, 1.0, len(arr))
                finite = np.isfinite(arr)
                if finite.sum() < 2:
                    out[i, :, d] = np.nan_to_num(arr[:1]).repeat(max_len)
                else:
                    out[i, :, d] = np.interp(xs_new, xs_old[finite],
                                             arr[finite])
    return out


def _extract(data_dir: str, name: str, base: str) -> None:
    """<name>'s .ts members of data_dir/ARCHIVE into base, by base name;
    a member with '..' or an absolute path is skipped."""
    zpath = os.path.join(data_dir, ARCHIVE)
    if not os.path.exists(zpath):
        return
    with zipfile.ZipFile(zpath) as zf:
        for m in zf.namelist():
            if (f"/{name}/" in f"/{m}" and m.endswith(".ts")
                    and ".." not in m and not m.startswith("/")):
                os.makedirs(base, exist_ok=True)
                with zf.open(m) as src, \
                        open(os.path.join(base, os.path.basename(m)),
                             "wb") as dst:
                    dst.write(src.read())


def load_dataset(name: str, data_dir: str):
    """(X [N, L, D], y [N]) of data_dir/<name>/<name>_{TRAIN,TEST}.ts, train
    cases first; extracted from data_dir/Multivariate2018_ts.zip when
    missing; labels numbered in sorted order. FileNotFoundError when
    neither is there."""
    base = os.path.join(data_dir, name)
    train_p = os.path.join(base, f"{name}_TRAIN.ts")
    test_p = os.path.join(base, f"{name}_TEST.ts")
    if not (os.path.exists(train_p) and os.path.exists(test_p)):
        _extract(data_dir, name, base)
    if not (os.path.exists(train_p) and os.path.exists(test_p)):
        raise FileNotFoundError(
            f"{train_p} missing: extract the UEA archive into {data_dir} "
            f"(nothing here downloads it)")
    tr_cases, tr_labels = parse_ts_file(train_p)
    te_cases, te_labels = parse_ts_file(test_p)
    X = equal_length(tr_cases + te_cases)
    label_map = {l: i for i, l in
                 enumerate(sorted(set(tr_labels + te_labels)))}
    y = np.asarray([label_map[l] for l in tr_labels + te_labels], np.int64)
    return X, y


def get_data(name: str = "BasicMotions", data_dir: Optional[str] = None,
             n_synthetic: int = 512, synthetic_fallback: bool = True,
             seed: int = 0):
    """(X [N, L, D], y [N], times [L] = linspace(0, 1, L)): the cached
    arrays in data_dir, else `load_dataset(name, data_dir)` (then cached),
    else, with no data there (or no data_dir), `synthetic_uea(n_synthetic,
    seed=seed)`, or FileNotFoundError with synthetic_fallback=False."""
    cp = None
    if data_dir is not None:
        cp = cache_path("uea", data_dir, dataset=name)
        cached = load_cached(cp)
        if cached is not None:
            return cached
    try:
        if data_dir is None:
            raise FileNotFoundError("no data_dir holding the UEA archive")
        X, y = load_dataset(name, data_dir)
    except FileNotFoundError:
        if not synthetic_fallback:
            raise
        return synthetic_uea(n=n_synthetic, seed=seed)
    out = (X, y, np.linspace(0.0, 1.0, X.shape[1], dtype=np.float32))
    save_cached(cp, out)
    return out
