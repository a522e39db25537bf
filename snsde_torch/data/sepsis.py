"""PhysioNet Sepsis 2019 (counterpart of snsde/data/sepsis.py, the port's
own copy): `.psv` records onto the hourly ICULOS grid (at most 72 hours,
the 34 vital and lab columns, NaN where unobserved), five static features
(age, gender, unit 1, unit 2, hospital admission time) and the label
max(SepsisLabel).

`parse_psv` tries the native parser first (`data/native.py`, the port's
copy of `snsde/_native/snsde_data.cc:snsde_parse_psv`), as
`snsde/data/sepsis.py:37` does, and otherwise parses in Python by the same
rules: columns counted on the header line (at most 64), at most 512 rows,
an empty field or `NaN` NaN, a short row padded with NaN, each value read
as float32.

Nothing downloads the archives: `get_data` reads `training_setA.zip` and
`training_setB.zip` only from an explicit `data_dir`, caches the parsed
arrays there as `.npz`, and otherwise returns `synthetic_sepsis` data of
the same shapes unless told not to. `loader(data_dir)` is a `data_fn` for
`harness.classification.run_sepsis`.
"""

from __future__ import annotations

import os
import re
import zipfile
from typing import Optional, Tuple

import numpy as np

from .common import cache_path, load_cached, save_cached
from .native import parse_psv_native
from .synthetic import synthetic_sepsis

__all__ = ["ARCHIVES", "MAX_HOURS", "TS_COLUMNS", "parse_psv",
           "load_from_archives", "get_data", "loader"]

ARCHIVES = ("training_setA.zip", "training_setB.zip")
MAX_HOURS = 72
TS_COLUMNS = 34      # vital/lab time-series columns per PSV spec
MAX_ROWS, MAX_COLS = 512, 64
_NUMBER = re.compile(r"\s*[+-]?(?:inf(?:inity)?|nan|(?:\d+\.?\d*|\.\d+)"
                     r"(?:[eE][+-]?\d+)?)", re.IGNORECASE)


def _field(s: str) -> float:
    """One field as strtof reads it: its longest numeric prefix, 0 when
    there is none."""
    if s == "" or s == "NaN":
        return np.nan
    try:
        return float(s)
    except ValueError:
        m = _NUMBER.match(s[:63])
        return float(m.group(0)) if m else 0.0


def parse_psv(text: bytes):
    """One PSV record -> (values [rows, cols] float32, header list)."""
    native = parse_psv_native(text, max_rows=MAX_ROWS, max_cols=MAX_COLS)
    lines = text.decode(errors="replace").split("\n")
    header = lines[0].split("|")
    if native is not None:
        arr, _ = native
        return arr[:, :len(header)], header
    cols = min(len(header), MAX_COLS)
    body = lines[1:]
    if body and body[-1] == "" and text.endswith(b"\n"):
        body = body[:-1]
    body = body[:MAX_ROWS]
    out = np.full((len(body), cols), np.nan, np.float32)
    for r, line in enumerate(body):
        for c, f in enumerate(line.split("|")[:cols]):
            out[r, c] = _field(f)
    return out, header


def _process_record(values: np.ndarray, header) -> Optional[Tuple]:
    """One patient record -> (series [72, 34], static [5], label), or None
    without an hour in 1..72."""
    cols = {name: i for i, name in enumerate(header)}
    iculos = values[:, cols["ICULOS"]].astype(int)
    keep = (iculos >= 1) & (iculos <= MAX_HOURS)
    if not keep.any():
        return None
    values = values[keep]
    iculos = iculos[keep]

    series = np.full((MAX_HOURS, TS_COLUMNS), np.nan, np.float32)
    series[iculos - 1] = values[:, :TS_COLUMNS]

    def stat(name, default=np.nan):
        i = cols.get(name)
        if i is None:
            return default
        v = values[:, i]
        v = v[np.isfinite(v)]
        return float(v[0]) if v.size else default

    static = np.nan_to_num(np.asarray(
        [stat("Age"), stat("Gender"), stat("Unit1", 0.0),
         stat("Unit2", 0.0), stat("HospAdmTime", 0.0)], np.float32))
    label_col = cols.get("SepsisLabel")
    # as the JAX package: a label in column 0 reads as 0
    label = int(np.nanmax(values[:, label_col])) if label_col else 0
    return series, static, label


def load_from_archives(data_dir: str):
    """(X [N, 72, 34], static [N, 5], y [N], lengths [N], times [72]) of
    every .psv record in data_dir's two archives, in archive order;
    FileNotFoundError when one is missing."""
    all_series, all_static, all_labels = [], [], []
    for name in ARCHIVES:
        zpath = os.path.join(data_dir, name)
        if not os.path.exists(zpath):
            raise FileNotFoundError(
                f"{zpath} missing: put the PhysioNet 2019 archives into "
                f"{data_dir} (nothing here downloads them)")
        with zipfile.ZipFile(zpath) as zf:
            for member in zf.namelist():
                if not member.endswith(".psv"):
                    continue
                rec = _process_record(*parse_psv(zf.read(member)))
                if rec is not None:
                    all_series.append(rec[0])
                    all_static.append(rec[1])
                    all_labels.append(rec[2])
    X = np.stack(all_series)
    lengths = np.full((X.shape[0],), MAX_HOURS, np.int64)
    return (X, np.stack(all_static), np.asarray(all_labels, np.int64),
            lengths, np.arange(MAX_HOURS, dtype=np.float32))


def get_data(data_dir: Optional[str] = None, n_synthetic: int = 4096,
             synthetic_fallback: bool = True, seed: int = 0):
    """(X [N, 72, 34], static [N, S], y [N], lengths [N], times [72]): the
    cached arrays in data_dir, else the archives' (then cached there),
    else, without them (or without a data_dir), `synthetic_sepsis(
    n_synthetic, seed=seed)`, or FileNotFoundError with
    synthetic_fallback=False."""
    cp = None
    if data_dir is not None:
        cp = cache_path("sepsis_parsed", data_dir)
        cached = load_cached(cp)
        if cached is not None:
            return cached
    try:
        if data_dir is None:
            raise FileNotFoundError("no data_dir holding the archives")
        out = load_from_archives(data_dir)
    except FileNotFoundError:
        if not synthetic_fallback:
            raise
        return synthetic_sepsis(n=n_synthetic, seed=seed)
    save_cached(cp, out)
    return out


def loader(data_dir: Optional[str], synthetic_fallback: bool = True):
    """A `data_fn(n, seed)` for run_sepsis: get_data(data_dir), n the
    synthetic fallback's size."""
    def data_fn(n: int, seed: int = 0):
        return get_data(data_dir, n_synthetic=n,
                        synthetic_fallback=synthetic_fallback, seed=seed)
    return data_fn
