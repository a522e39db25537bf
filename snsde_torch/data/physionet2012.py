"""PhysioNet 2012 (Mortality) for the interpolation harness (counterpart
of snsde/data/physionet2012.py).

Parses the set-a / set-b record files (time-stamped parameter, value
lines), quantises each record onto a q = 0.016 grid of the 48 h horizon
and returns (values, mask, timepoints) union-grid arrays, in numpy. The
archives are read only from a directory that holds them; nothing
downloads them (`URLS` names the source). Without them `get_data` falls
back to the PhysioNet-shaped `synthetic_physionet` of the interpolation
harness.
"""

from __future__ import annotations

import os
import tarfile
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["URLS", "PARAMS", "QUANT", "parse_record", "record_to_grid",
           "load_from_archives", "get_data"]

URLS = [
    "https://physionet.org/files/challenge-2012/1.0.0/set-a.tar.gz",
    "https://physionet.org/files/challenge-2012/1.0.0/set-b.tar.gz",
]

PARAMS = [
    "Albumin", "ALP", "ALT", "AST", "Bilirubin", "BUN", "Cholesterol",
    "Creatinine", "DiasABP", "FiO2", "GCS", "Glucose", "HCO3", "HCT", "HR",
    "K", "Lactate", "Mg", "MAP", "MechVent", "Na", "NIDiasABP", "NIMAP",
    "NISysABP", "PaCO2", "PaO2", "pH", "Platelets", "RespRate", "SaO2",
    "SysABP", "Temp", "TroponinI", "TroponinT", "Urine", "WBC",
]
QUANT = 0.016  # fraction of the 48 h horizon per grid cell


def parse_record(text: str) -> List[Tuple[float, str, float]]:
    """One record file -> [(hours, param, value)]; the header line, lines
    of another shape, unknown parameters and unparsable values are
    skipped."""
    events = []
    for line in text.strip().split("\n")[1:]:
        parts = line.split(",")
        if len(parts) != 3:
            continue
        ts, param, value = parts
        if param not in PARAMS:
            continue
        try:
            h, m = ts.split(":")
            hours = int(h) + int(m) / 60.0
            events.append((hours, param, float(value)))
        except ValueError:
            continue
    return events


def record_to_grid(events, horizon: float = 48.0, quant: float = QUANT):
    """Quantise events onto the union grid, averaging the values that share
    a cell -> (values [L, D], mask [L, D], tp [L])."""
    L = int(round(1.0 / quant))
    D = len(PARAMS)
    pidx = {p: i for i, p in enumerate(PARAMS)}
    vals = np.zeros((L, D), np.float32)
    cnt = np.zeros((L, D), np.float32)
    for hours, param, value in events:
        cell = min(int(hours / horizon / quant), L - 1)
        j = pidx[param]
        vals[cell, j] += value
        cnt[cell, j] += 1.0
    mask = (cnt > 0).astype(np.float32)
    vals = np.where(cnt > 0, vals / np.maximum(cnt, 1.0), 0.0)
    tp = np.linspace(0.0, 1.0, L, dtype=np.float32)
    return vals.astype(np.float32), mask, tp


def load_from_archives(data_dir: str):
    """Every record with an event in both archives under data_dir ->
    (values [N, L, D], mask [N, L, D], tp [N, L]); FileNotFoundError when
    an archive is missing."""
    xs, ms, tps = [], [], []
    for url in URLS:
        tpath = os.path.join(data_dir, os.path.basename(url))
        if not os.path.exists(tpath):
            raise FileNotFoundError(
                f"{tpath} missing: put the PhysioNet 2012 archives in "
                f"{data_dir}")
        with tarfile.open(tpath, "r:gz") as tf:
            for member in tf.getmembers():
                if not member.name.endswith(".txt"):
                    continue
                text = tf.extractfile(member).read().decode(errors="replace")
                events = parse_record(text)
                if not events:
                    continue
                v, m, tp = record_to_grid(events)
                xs.append(v)
                ms.append(m)
                tps.append(tp)
    return np.stack(xs), np.stack(ms), np.stack(tps)


def get_data(data_dir: Optional[str] = None, n_synthetic: int = 1024,
             synthetic_fallback: bool = True, seed: int = 0):
    """(values [N, L, D], mask [N, L, D], timepoints [N, L]) from the
    archives in data_dir (by default ~/.cache/snsde/physionet2012), else
    synthetic_physionet(n=n_synthetic, seed=seed) unless
    synthetic_fallback is False."""
    data_dir = data_dir or os.path.join(
        os.path.expanduser("~"), ".cache", "snsde", "physionet2012")
    try:
        return load_from_archives(data_dir)
    except FileNotFoundError:
        if not synthetic_fallback:
            raise
        from ..harness.interpolation import synthetic_physionet

        return synthetic_physionet(n=n_synthetic, seed=seed)
